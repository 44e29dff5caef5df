"""Text (+ optional phonetics) -> .wav with the PyTorch port.

Example:
  python -m jyutvoice_tpu_torch.cli.infer \
      --text "佢 係 邊 個" --lang yue --phone "keoi5 hai6 bin1 go3" \
      --ckpt tts.npz --hift hift.npz --output out.wav

--ckpt / --hift take `.npz` parameter trees in the JAX package's format
(`save_pytree_npz`); without them the weights are random, drawn from --seed.
Runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import logging
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


def main(argv=None, cfg=None):
    parser = argparse.ArgumentParser(description="JyutVoice inference (PyTorch port)")
    parser.add_argument("--text", required=True)
    parser.add_argument("--lang", default="yue", choices=["yue", "zh", "en", "multilingual"])
    parser.add_argument("--phone", default=None,
                        help="explicit jyutping/pinyin (space separated)")
    parser.add_argument("--ckpt", default=None, help="tts parameter tree (.npz)")
    parser.add_argument("--hift", default=None, help="vocoder parameter tree (.npz)")
    parser.add_argument("--output", default="output.wav")
    parser.add_argument("--n-timesteps", type=int, default=10)
    parser.add_argument("--length-scale", type=float, default=0.9)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights used without --ckpt/--hift")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_pytree_npz

    cfg = cfg or JyutVoiceConfig()
    if args.ckpt:
        params_tts = load_pytree_npz(args.ckpt)
    else:
        log.warning("no --ckpt given: using RANDOM tts weights")
        params_tts = random_init.init_tts_tree(cfg.tts, seed=args.seed)
    if args.hift:
        params_hift = load_pytree_npz(args.hift)
    else:
        log.warning("no --hift given: using RANDOM vocoder weights")
        params_hift = random_init.init_hift_tree(cfg.hift, seed=args.seed + 1)

    text = args.text
    if args.lang in ("yue", "zh") and args.phone is None:
        from jyutvoice_tpu_torch.text.word_seg import word_seg

        text = word_seg(text)
    # Synthesizer turns TF32 off on the GPU (parity with the f32 reference)
    synth = Synthesizer(cfg, params_tts, params_hift, device=args.device)
    result = synth.synthesize(
        text, lang=args.lang, phone=args.phone, n_timesteps=args.n_timesteps,
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
