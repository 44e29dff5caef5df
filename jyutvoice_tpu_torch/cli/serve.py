"""Serve the PyTorch port over HTTP (pipeline/http_server.py: dynamic
batching, and a lane of live streams with --streaming).

Example:
  python -m jyutvoice_tpu_torch.cli.serve --ckpt tts.npz --hift hift.npz \\
      --port 8080 --streaming

  curl -s localhost:8080/tts -d '{"text":"佢係邊個","lang":"yue"}' > out.wav
  curl -sN localhost:8080/tts/stream -d '{"text":"佢係邊個"}' > stream.wav

--ckpt / --hift / --flow-encoder take `.npz` parameter trees or the
reference's `.pt` / `.ckpt` files (cli/infer.py::load_params);
--config names the model's configuration (a JSON file; the DiT decoder's
is one); --random-init serves random weights drawn with seeds 0 and 1. Runs on the
GPU unless --device cpu is given. SIGTERM or SIGINT drains the server:
requests in flight finish, new ones are refused.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time

log = logging.getLogger("jyutvoice_tpu_torch.serve")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="JyutVoice HTTP server (PyTorch port)")
    ap.add_argument("--ckpt", help="tts weights (.npz tree or torch .ckpt/.pt)")
    ap.add_argument("--hift", help="vocoder weights (.npz tree or torch .pt)")
    ap.add_argument("--config", help="the model's configuration as JSON (config.py::"
                    "load_config), e.g. portbench/configs/jyutvoice-cv3dit.json for CosyVoice "
                    "3's DiT decoder; default the base configuration")
    ap.add_argument("--random-init", action="store_true",
                    help="serve random weights (smoke and load testing)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--n-timesteps", type=int, default=10)
    ap.add_argument("--length-scale", type=float, default=1.0)
    ap.add_argument("--streaming", action="store_true", help="enable POST /tts/stream")
    ap.add_argument("--campplus", help="campplus.onnx for ref_audio_b64's speaker embedding")
    ap.add_argument("--s3-tokenizer",
                    help="speech tokenizer weights (.onnx or torch) for ref_audio_b64")
    ap.add_argument("--flow-encoder",
                    help="flow-encoder weights (.npz/.pt) for ref_audio_b64's prompt states")
    ap.add_argument("--max-streams", type=int, default=4)
    ap.add_argument("--chunk-frames", type=int, default=100)
    ap.add_argument(
        "--stream-prompt-frames", type=int, default=0,
        help="prompt capacity of the streaming lane (a PROMPT_BUCKETS value, e.g. 64/128): "
        "lets /tts/stream graft ref_audio_b64 cloning prompts; every tick then decodes "
        "the prompt-extended segment. 0 (default): the speaker embedding only")
    ap.add_argument(
        "--warmup", action="store_true",
        help="before serving, drive the interactive shapes (text <= 128 tokens, mel <= "
        "1024 frames by default) at every power-of-two batch up to --max-batch, and one "
        "stream with --streaming: builds the kernels and warms cuDNN and the allocator")
    ap.add_argument("--warmup-text", help="comma-separated text buckets to warm "
                    "(default: 32,64,96,128)")
    ap.add_argument("--warmup-mel", help="comma-separated mel buckets to warm "
                    "(default: 128..1024)")
    ap.add_argument(
        "--warmup-long", action="store_true",
        help="before serving, also drive the long-form shapes of synthesize_long once "
        "(Synthesizer.warmup_long's defaults: text buckets 1024-8192, every 512-aligned "
        "mel length 2048-12288 and the windowed vocoder) under --long-attention")
    ap.add_argument(
        "--long-attention", choices=("auto", "banded", "exact"), default="auto",
        help="long-form attention of the requests served by synthesize_long: 'auto' "
        "(banded past the config's threshold), 'banded' or 'exact'")
    ap.add_argument(
        "--warmup-long-prompts", action="store_true",
        help="with --warmup-long: also drive the cloning shapes (the solve with the "
        "512-frame prompt head per mel size); doubles the long-form warm-up")
    ap.add_argument(
        "--sp-devices", type=int, default=0,
        help="shard long-form solves (text past the interactive buckets) over a "
        "sequence-parallel mesh of this many local devices (dist/sp.py: one process "
        "per device, this one the first): per-device attention memory and work drop "
        "N-fold. 0 (default): long solves on one device")
    ap.add_argument(
        "--sp-attention", choices=("scores", "ring", "banded"), default="scores",
        help="sequence-parallel attention: 'scores' (K/V gathered, per-device (2B,H,T/N,T) "
        "scores), 'ring' (ring attention, per-device (T/N,T/N) tiles; for decodes past "
        "the dense memory wall), 'banded' (the linear chunk band, approximate)")
    ap.add_argument("--verbose", action="store_true")
    return ap


def _buckets(spec):
    return tuple(int(v) for v in spec.split(",")) if spec else None


def main(argv=None, cfg=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if not args.random_init and not (args.ckpt and args.hift):
        raise SystemExit("--ckpt and --hift are required (or pass --random-init)")

    if args.sp_devices:
        import torch

        if args.sp_devices < 2:
            # a one-device mesh would send long solves through the plain score
            # path and lose the single-device kernel-3 route
            raise SystemExit(
                f"--sp-devices must be >= 2 (got {args.sp_devices}); "
                f"omit it for single-chip long solves"
            )
        n_dev = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
        if args.sp_devices > n_dev:
            raise SystemExit(
                f"--sp-devices {args.sp_devices} but only {n_dev} device(s) "
                f"visible"
            )

    from jyutvoice_tpu_torch.cli.infer import load_params
    from jyutvoice_tpu_torch.config import JyutVoiceConfig, load_config
    from jyutvoice_tpu_torch.pipeline.http_server import TTSServer, device_name
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    cfg = cfg or (load_config(args.config) if args.config else JyutVoiceConfig())
    if args.random_init:
        log.warning("serving RANDOM weights (smoke and load testing only)")
        params_tts = random_init.init_tts_tree(cfg.tts, seed=0)
        params_hift = random_init.init_hift_tree(cfg.hift, seed=1)
    else:
        params_tts = load_params(args.ckpt, "tts", cfg)
        params_hift = load_params(args.hift, "hift", cfg)

    extractor = None
    if args.campplus or args.s3_tokenizer or args.flow_encoder:
        from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor

        s3 = args.s3_tokenizer or ""
        extractor = PromptExtractor(
            flow_encoder_params=(load_params(args.flow_encoder, "flow_encoder", cfg)
                                 if args.flow_encoder else None),
            flow_encoder_cfg=cfg.flow_encoder,
            campplus_onnx=args.campplus,
            tokenizer_onnx=s3 if s3.endswith(".onnx") else None,
            tokenizer_torch=s3 if s3 and not s3.endswith(".onnx") else None,
            device=args.device,
        )

    # Synthesizer turns TF32 off on the GPU (parity with the f32 reference)
    synth = Synthesizer(cfg, params_tts, params_hift, device=args.device)
    sp_mesh = None
    if args.sp_devices:
        from jyutvoice_tpu_torch.dist.sp import make_sp_mesh

        # one rank per device, from the synthesizer's on: it is rank 0
        n_dev, first = torch.cuda.device_count(), synth.device.index or 0
        sp_mesh = make_sp_mesh(args.sp_devices, devices=[
            f"cuda:{(first + i) % n_dev}" for i in range(args.sp_devices)])
        log.info("long-form solves sequence-parallel over %d devices (%s)",
                 args.sp_devices, args.sp_attention)
    if args.warmup:
        sizes = [1]
        while sizes[-1] < min(args.max_batch, 8):  # the engine splits past 8
            sizes.append(sizes[-1] * 2)
        t0 = time.perf_counter()
        n = synth.warmup(
            text_buckets=_buckets(args.warmup_text), mel_buckets=_buckets(args.warmup_mel),
            n_timesteps=(args.n_timesteps,), batch_sizes=sizes,
            pcm16=True,  # the engine serves PCM16
            log_fn=lambda m: log.info("%s", m),
        )
        log.info("warmup: %d shapes in %.1f s", n, time.perf_counter() - t0)
    if args.warmup_long:
        t0 = time.perf_counter()
        n = synth.warmup_long(
            n_timesteps=(args.n_timesteps,),
            pcm16=True,  # the engine serves PCM16
            log_fn=lambda m: log.info("%s", m),
            with_prompt=args.warmup_long_prompts,
            # warm the solves the engine runs: sharded ones on the mesh, else
            # synthesize_long with --long-attention
            mesh=sp_mesh, sp_attention=args.sp_attention,
            attention=args.long_attention if sp_mesh is None else "auto",
        )
        log.info("warmup-long: %d shapes in %.1f s", n, time.perf_counter() - t0)
    server = TTSServer(
        synth, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, n_timesteps=args.n_timesteps,
        length_scale=args.length_scale, streaming=args.streaming,
        max_streams=args.max_streams, chunk_frames=args.chunk_frames,
        stream_prompt_frames=args.stream_prompt_frames, verbose=args.verbose,
        prompt_extractor=extractor, sp_mesh=sp_mesh, sp_attention=args.sp_attention,
        long_attention=args.long_attention,
    )
    try:
        if args.warmup and args.streaming:
            t0 = time.perf_counter()
            for _ in server.lane.submit("佢", lang="yue", phone="keoi5"):
                pass
            log.info("warmup: one stream through the lane in %.1f s", time.perf_counter() - t0)
        log.info("serving on http://%s:%d (device: %s, streaming: %s)", server.host,
                 server.port, device_name(synth.device), args.streaming)
        # block until SIGTERM / SIGINT, then drain: requests in flight finish,
        # new submits are refused
        stop = threading.Event()
        try:
            signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
            signal.signal(signal.SIGINT, lambda signum, frame: stop.set())
        except ValueError:
            pass  # not the main thread: the caller stops the process
        stop.wait()
        log.info("shutdown signal received: draining")
    finally:
        server.close()
        if sp_mesh is not None:
            sp_mesh.close()


if __name__ == "__main__":
    main()
