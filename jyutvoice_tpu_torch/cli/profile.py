"""Profile one full-width request of the port on the GPU with torch.profiler.

    python -m jyutvoice_tpu_torch.cli.profile [--frames 480] [--n-timesteps 10]
        [--stream [--chunk-frames 100] [--prompt-frames 250]]

Builds the default JyutVoiceConfig with seeded random weights, scales one
Cantonese request's durations to about --frames mel frames, runs it once to
warm up, then once under the profiler. Prints the phase timings, the device
busy share (summed kernel time over the request's wall time; one stream, so
kernels do not overlap) and the kernels with the most device time. --stream
profiles `synthesize_streaming` instead (all its chunks; --prompt-frames
adds a seeded random cloning prompt of that many frames).
"""

from __future__ import annotations

import argparse
import json
import time


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=480)
    ap.add_argument("--n-timesteps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--chunk-frames", type=int, default=100)
    ap.add_argument("--prompt-frames", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    cfg = JyutVoiceConfig()
    synth = Synthesizer(cfg, random_init.init_tts_tree(cfg.tts, seed=0),
                        random_init.init_hift_tree(cfg.hift, seed=1), device="cuda")
    req = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    arrs, n, _ = synth.prepare_text(**req)
    spk = torch.zeros((1, cfg.tts.spk_embed_dim), device="cuda")
    req.update(length_scale=args.frames / synth.duration_frames(arrs, n, spk),
               n_timesteps=args.n_timesteps)
    if args.stream:
        rng = np.random.default_rng(0)
        if args.prompt_frames:
            req.update(prompt_feat=rng.standard_normal((args.prompt_frames, 80)).astype(np.float32),
                       prompt_h=rng.standard_normal((args.prompt_frames, 80)).astype(np.float32))
        req["chunk_frames"] = args.chunk_frames

        def run():
            return list(synth.synthesize_streaming(**req))
    else:
        def run():
            return synth.synthesize(**req)
    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows (kernels, memcpy, memset) only: the operator rows
    # above them repeat their kernels' time
    rows = [
        (e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and _device_us(e) > 0
    ]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    if args.stream:
        samples = sum(len(c) for c in res)
        print(f"streamed {len(res)} chunks, {samples} samples (prompt {args.prompt_frames} "
              f"frames) wall_ms={wall_ms:.3f} (the profiler slows the host)")
    else:
        print(f"mel_frames={res.mel_frames} wall_ms={wall_ms:.3f} timings="
              f"{json.dumps({k: round(v * 1e3, 3) for k, v in res.timings.items() if k != 'audio_seconds'})}"
              f" (ms), audio {res.timings['audio_seconds']} s (the profiler slows the host)")
    print(f"device kernel time {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f} % of the "
          f"{'stream' if args.stream else 'request'}'s wall time")
    for key, ms, count in rows[: args.top]:
        print(f"{ms:10.3f} ms  {count:6d}x  {key[:110]}")


if __name__ == "__main__":
    main()
