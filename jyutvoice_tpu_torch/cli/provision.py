"""Provision pretrained weights for the PyTorch port: convert (and, where the
network allows, fetch) the reference's CosyVoice2 artifacts into `.npz`
parameter trees and assemble the fine-tune's starting point.

  python -m jyutvoice_tpu_torch.cli.provision --flow-pt pretrained_models/flow.pt \\
      --hift-pt pretrained_models/hift.pt --assemble-pretrain [--verify]
  python -m jyutvoice_tpu_torch.cli.provision --download --assemble-pretrain

Then fine-tune with the frozen decoder and hand the result back to the
reference:

  python -m jyutvoice_tpu_torch.cli.train --dataset <dir> \\
      --pretrain pretrained_models_tpu/tts_init.npz --tb-dir runs
  python -m jyutvoice_tpu_torch.cli.provision --export-torch tts.npz tts.ckpt

The counterpart of the JAX package's `cli/provision.py`, with the same
options and --device. --verify synthesizes a sentence from the provisioned
trees (`weights/provision.py::verify`) and prints one JSON line; it runs on
the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger("jyutvoice_tpu_torch.provision")


def main(argv=None, cfg=None):
    parser = argparse.ArgumentParser(
        description="Convert / download JyutVoice pretrained weights (PyTorch port)")
    parser.add_argument("--flow-pt", default=None, help="CosyVoice2 flow.pt")
    parser.add_argument("--hift-pt", default=None, help="CosyVoice2 hift.pt")
    parser.add_argument("--tts-ckpt", default=None, help="full JyutVoiceTTS torch checkpoint")
    parser.add_argument("--campplus-onnx", default=None, help="campplus.onnx -> campplus.npz")
    parser.add_argument("--tokenizer-torch", default=None,
                        help="speech_tokenizer_v2 torch ckpt -> s3_tokenizer.npz")
    parser.add_argument("--out-dir", default="pretrained_models_tpu")
    parser.add_argument("--download", action="store_true",
                        help="fetch missing artifacts from HuggingFace (skipped offline)")
    parser.add_argument("--download-dir", default="pretrained_models")
    parser.add_argument("--assemble-pretrain", action="store_true",
                        help="also write tts_init.npz: random init + frozen CosyVoice2 "
                             "decoder (reference pretrain.pt)")
    parser.add_argument("--seed", type=int, default=42,
                        help="seed for the random (trainable) half of tts_init.npz")
    parser.add_argument("--export-torch", nargs=2, metavar=("NPZ", "CKPT"), default=None,
                        help="convert a trained tts .npz tree back to a reference-loadable "
                             "torch .ckpt")
    parser.add_argument("--verify", action="store_true",
                        help="strict key-coverage audit -> convert -> synthesize a sentence "
                             "-> print xRT (+ mel MAE with --reference-mel)")
    parser.add_argument("--reference-mel", default=None,
                        help="stored reference mel (.npy, (T, 80)) to compare with in --verify")
    parser.add_argument("--verify-text", default=None, help="override the --verify sentence")
    parser.add_argument("--verify-lang", default="en")
    parser.add_argument("--verify-phone", default=None)
    parser.add_argument("--device", default="cuda",
                        help="--verify's device: cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from jyutvoice_tpu_torch.weights import provision as prov

    if args.verify:
        kwargs = {"text": args.verify_text} if args.verify_text else {}
        return prov.verify(
            flow_pt=args.flow_pt, hift_pt=args.hift_pt, tts_ckpt=args.tts_ckpt,
            out_dir=args.out_dir, cfg=cfg, lang=args.verify_lang, phone=args.verify_phone,
            reference_mel=args.reference_mel, download=args.download,
            download_dir=args.download_dir, device=args.device, **kwargs,
        )

    if args.export_torch:
        from jyutvoice_tpu_torch.weights.from_jax import load_pytree_npz
        from jyutvoice_tpu_torch.weights.torch_export import save_torch_checkpoint

        npz_path, ckpt_path = args.export_torch
        save_torch_checkpoint(ckpt_path, load_pytree_npz(npz_path))
        log.info("exported %s -> %s (reference-loadable)", npz_path, ckpt_path)
        return {"torch_ckpt": ckpt_path}

    written = prov.provision(
        flow_pt=args.flow_pt, hift_pt=args.hift_pt, tts_ckpt=args.tts_ckpt,
        campplus_onnx=args.campplus_onnx, tokenizer_torch=args.tokenizer_torch,
        out_dir=args.out_dir, cfg=cfg, assemble_pretrain=args.assemble_pretrain,
        seed=args.seed, download=args.download, download_dir=args.download_dir,
    )
    if not written:
        log.warning("nothing provisioned: pass --flow-pt/--hift-pt/--tts-ckpt or --download")
    for name, path in written.items():
        log.info("%s -> %s", name, path)
    return written


if __name__ == "__main__":
    main()
