"""Text (+ optional phonetics, + optional reference audio) -> .wav with the
PyTorch port.

Example:
  python -m jyutvoice_tpu_torch.cli.infer \
      --text "佢 係 邊 個" --lang yue --phone "keoi5 hai6 bin1 go3" \
      --ckpt tts.npz --hift hift.npz --output out.wav

--ckpt, --hift and --flow-encoder take `.npz` parameter trees in the JAX
package's format (`save_pytree_npz`) or the reference's torch files
(`.pt` / `.ckpt`, converted by `weights/torch_convert.py`); without --ckpt /
--hift the weights are random, drawn from --seed. Voice cloning takes
--ref-audio with the CAM++ ONNX (--campplus-onnx), the speech tokenizer
(--tokenizer-torch or a name-preserving --tokenizer-onnx) and the flow
encoder (--flow-encoder), as the reference does. --stream synthesizes
chunk by chunk (--chunk-frames mel frames each), logs the first chunk's
latency and writes the chunks joined. --text-file synthesizes one utterance
per line ("text" or "text|phonetics") in batches of --batch-size through
`Synthesizer.synthesize_batch` and writes <output stem>_NNNN.wav. Runs on
the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
import wave

import numpy as np

log = logging.getLogger("jyutvoice_tpu_torch.infer")


def save_wav(path: str, audio: np.ndarray, sr: int = 24000) -> None:
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def load_wav(path: str):
    """16-bit PCM .wav -> (float32 samples in [-1, 1), mono, sample rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
        if f.getnchannels() > 1:
            data = data.reshape(-1, f.getnchannels()).mean(axis=1)
    return data.astype(np.float32) / 32768.0, sr


def load_params(path: str, kind: str, cfg):
    """A JAX-layout parameter tree from an .npz tree or a torch checkpoint;
    kind is "tts", "hift" or "flow_encoder"."""
    from jyutvoice_tpu_torch.weights import torch_convert as tc
    from jyutvoice_tpu_torch.weights.from_jax import load_pytree_npz

    if path.endswith(".npz"):
        return load_pytree_npz(path)
    sd = tc.load_torch_state_dict(path)
    if kind == "tts":
        return tc.convert_tts(sd, cfg.tts)
    if kind == "hift":
        return tc.convert_hift(sd, cfg.hift)
    if kind == "flow_encoder":
        return tc.convert_flow_encoder(sd, cfg.flow_encoder)
    raise ValueError(kind)


def main(argv=None, cfg=None):
    parser = argparse.ArgumentParser(description="JyutVoice inference (PyTorch port)")
    parser.add_argument("--text", default=None)
    parser.add_argument("--text-file", default=None,
                        help="batch mode: one utterance per line (optionally "
                             "'text|phonetics'), synthesized in batches; writes "
                             "<output stem>_NNNN.wav")
    parser.add_argument("--batch-size", type=int, default=8, help="batch-mode group size")
    parser.add_argument("--lang", default="yue", choices=["yue", "zh", "en", "multilingual"])
    parser.add_argument("--phone", default=None,
                        help="explicit jyutping/pinyin (space separated)")
    parser.add_argument("--ckpt", default=None, help="tts parameters (.npz/.ckpt/.pt)")
    parser.add_argument("--hift", default=None, help="vocoder parameters (.npz/.ckpt/.pt)")
    parser.add_argument("--flow-encoder", default=None,
                        help="flow-encoder parameters (.npz/.ckpt/.pt)")
    parser.add_argument("--campplus-onnx", default=None)
    parser.add_argument("--tokenizer-onnx", default=None)
    parser.add_argument("--tokenizer-torch", default=None,
                        help="speech_tokenizer_v2 torch checkpoint")
    parser.add_argument("--ref-audio", default=None, help="voice-cloning prompt (.wav)")
    parser.add_argument("--output", default="output.wav")
    parser.add_argument("--n-timesteps", type=int, default=10)
    parser.add_argument("--length-scale", type=float, default=0.9)
    parser.add_argument("--stream", action="store_true",
                        help="chunked streaming synthesis (overlap-cached decoder and "
                             "vocoder; logs the first chunk's latency)")
    parser.add_argument("--chunk-frames", type=int, default=100,
                        help="mel frames per streaming chunk (100 = 2 s of audio)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights used without --ckpt/--hift")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    if (args.text is None) == (args.text_file is None):
        parser.error("exactly one of --text / --text-file is required")
    logging.basicConfig(level=logging.INFO)

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    cfg = cfg or JyutVoiceConfig()
    if args.ckpt:
        params_tts = load_params(args.ckpt, "tts", cfg)
    else:
        log.warning("no --ckpt given: using RANDOM tts weights")
        params_tts = random_init.init_tts_tree(cfg.tts, seed=args.seed)
    if args.hift:
        params_hift = load_params(args.hift, "hift", cfg)
    else:
        log.warning("no --hift given: using RANDOM vocoder weights")
        params_hift = random_init.init_hift_tree(cfg.hift, seed=args.seed + 1)

    spk_embed = prompt_feat = prompt_h = None
    if args.ref_audio:
        from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor

        extractor = PromptExtractor(
            flow_encoder_params=(load_params(args.flow_encoder, "flow_encoder", cfg)
                                 if args.flow_encoder else None),
            flow_encoder_cfg=cfg.flow_encoder,
            campplus_onnx=args.campplus_onnx,
            tokenizer_onnx=args.tokenizer_onnx,
            tokenizer_torch=args.tokenizer_torch,
            device=args.device,
        )
        audio, sr = load_wav(args.ref_audio)
        feats = extractor(audio, sr)
        spk_embed, prompt_feat, prompt_h = feats.spk_embed, feats.prompt_feat, feats.prompt_h
        if prompt_h is None:
            log.warning("no speech tokenizer / flow encoder: cloning uses mel prompt only")
            prompt_feat = None

    def segment(text: str, phone) -> str:
        if args.lang in ("yue", "zh") and phone is None:
            from jyutvoice_tpu_torch.text.word_seg import word_seg

            return word_seg(text)
        return text

    # Synthesizer turns TF32 off on the GPU (parity with the f32 reference)
    synth = Synthesizer(cfg, params_tts, params_hift, device=args.device)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        stem, ext = os.path.splitext(args.output)
        results = []
        for lo in range(0, len(lines), args.batch_size):
            items = []
            for ln in lines[lo : lo + args.batch_size]:
                text, _, phone = (part.strip() for part in ln.partition("|"))
                phone = phone or None
                items.append(dict(text=segment(text, phone), lang=args.lang, phone=phone,
                                  spk_embed=spk_embed, prompt_feat=prompt_feat,
                                  prompt_h=prompt_h))
            results += synth.synthesize_batch(
                items, n_timesteps=args.n_timesteps, length_scale=args.length_scale,
                return_mel=False,
            )
        for i, res in enumerate(results):
            save_wav(f"{stem}_{i:04d}{ext or '.wav'}", res.wav)
        log.info("wrote %d wavs to %s_*%s", len(results), stem, ext or ".wav")
        return results

    text = segment(args.text, args.phone)
    if args.stream:
        t0 = time.perf_counter()
        chunks = []
        for i, chunk in enumerate(synth.synthesize_streaming(
            text, lang=args.lang, phone=args.phone, spk_embed=spk_embed,
            prompt_feat=prompt_feat, prompt_h=prompt_h, chunk_frames=args.chunk_frames,
            length_scale=args.length_scale, n_timesteps=args.n_timesteps,
        )):
            if i == 0:
                log.info("first chunk (%.2fs audio) after %.0f ms", len(chunk) / 24000,
                         (time.perf_counter() - t0) * 1e3)
            chunks.append(chunk)
        wav = np.concatenate(chunks)
        elapsed = time.perf_counter() - t0
        save_wav(args.output, wav)
        log.info("wrote %s (streamed, %d chunks): %.2fs audio, rtf=%.3f", args.output,
                 len(chunks), len(wav) / 24000, elapsed / max(len(wav) / 24000, 1e-9))
        return wav
    result = synth.synthesize(
        text, lang=args.lang, phone=args.phone, spk_embed=spk_embed,
        prompt_feat=prompt_feat, prompt_h=prompt_h, n_timesteps=args.n_timesteps,
        length_scale=args.length_scale,
    )
    save_wav(args.output, result.wav)
    log.info(
        "wrote %s: %.2fs audio, rtf=%.3f, timings=%s", args.output,
        len(result.wav) / 24000, result.rtf,
        {k: round(v, 4) for k, v in result.timings.items()},
    )
    return result


if __name__ == "__main__":
    main()
