#!/usr/bin/env python3
"""Drive the PyTorch port (jyutvoice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is turned off (parity with the f32 reference path);
  2. build: the three CUDA kernels from jyutvoice_tpu_torch/csrc/, nvcc in
     parallel;
  3. kernel 1 (flash attention) against its plain version at the estimator's
     shapes (T = 512, 576, 640, chunk rules 50/-1 and 100/2), with CUDA-event
     times of the kernel, the plain version and torch's SDPA as a yardstick;
  4. kernel 3 (stock flash, segment ids) against its plain version on every
     row at the long-form shapes (T = 2048, 2560, 4096), with the times of
     the kernel, the plain version, SDPA with the segment mask, and the
     banded attention the long-form gate takes instead; then kernel 3 and
     banded times alone at T = 8192, 12288, 15360;
  5. kernel 2 (HiFT ResBlock stage) against its plain version at
     (C=128, T=20480) and (C=64, T=61441), batch 1 and 2;
  6. the main path: a full-width Synthesizer with seeded random weights
     (default JyutVoiceConfig) answers 5 requests: one at the 512-frame mel
     bucket twice (cold, then warm), raw Cantonese text, Mandarin, and one
     with a voice-cloning prompt; one short request is checked against the
     same model run on the CPU through the plain versions;
  7. the long-form path: synthesize_long with exact attention at 4096 frames
     (kernel 3), the same in auto mode (banded), exact with a 100-frame
     prompt (2560 frames in all, kernel 3), and synthesize past the
     15000-frame bucket with PCM16 (delegated, banded); then two long-form
     requests (exact with a prompt at 2560 frames, banded at 2048) against
     the same model on the CPU.
Launch counts are zeroed before and read after each request of phases 6
and 7. The line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
Exits non-zero without printing a result when no CUDA device is available.
"""

import json
import subprocess
import sys
import time

# H100 SXM datasheet peaks (NVIDIA), dense
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

ATTN_TOL = (5e-3, 2e-2)  # atol, rtol: bf16 products, f32 accumulation
STOCK_TOL = (5e-3, 1e-2)  # the JAX package's bar for the stock flash kernel
STAGE_TOL = (2e-5, 1e-4)  # f32 throughout


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_time_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def within(out, ref, tol):
    atol, rtol = tol
    return bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32

    disable_tf32()
    return smi


def phase_build():
    from jyutvoice_tpu_torch import kernels

    t = time.perf_counter()
    kernels.build_all()
    for name in kernels.KERNEL_SOURCES:
        kernels.load(name)
    log(f"build: {', '.join(kernels.KERNEL_SOURCES)} in {time.perf_counter() - t:.1f} s")


def phase_flash():
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn.flash_attention import (
        flash_attention,
        flash_attention_plain,
        key_keep_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, d = 2, 8, 64  # the CFG-doubled batch of one request, 8 heads x 64
    cases = [(512, [512, 389], 0, -1), (576, [576, 333], 0, -1), (640, [640, 501], 0, -1),
             (640, [640, 600], 50, -1), (512, [400, 512], 100, 2)]
    worst, first = 0.0, None
    for t, lens, chunk, left in cases:
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, chunk_size=chunk, num_left_chunks=left)
        out = flash_attention(q, k, v, lengths, **kw)
        ref = flash_attention_plain(q, k, v, lengths, **kw)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for i, n in enumerate(lens):
            err = max(err, float((out[i, :n] - ref[i, :n]).abs().max()))
            ok &= within(out[i, :n], ref[i, :n], ATTN_TOL)
        worst = max(worst, err)
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 200)
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, lengths, **kw), 20)
        keep = key_keep_mask(lengths, t, chunk, left)  # (B, 1, T, T)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=kw["scale"]),
            200,
        )
        pairs = int(keep.sum()) * h  # visible (query, key) pairs
        bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
        log(f"flash T={t} lengths={lens} chunk={chunk}/{left}: max_abs_err={err:.3e} "
            f"ok={ok} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
        if not ok:
            fail(f"flash attention disagrees with its plain version at T={t} chunk={chunk}")
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms)
    return dict(max_abs_err=worst, **first)


def phase_flash_stock():
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn.attention import banded_sdpa
    from jyutvoice_tpu_torch.nn.flash_stock import (
        flash_stock,
        flash_stock_plain,
        segment_keep_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, d = 2, 8, 64
    worst, main = 0.0, None
    for t, lens in ((2048, [2048, 1700]), (2560, [2560, 2148]), (4096, [4096, 3001])):
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        out = flash_stock(q, k, v, lengths, scale=scale)
        ref = flash_stock_plain(q, k, v, lengths, scale=scale)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())  # every row, padded ones included
        ok = within(out, ref, STOCK_TOL)
        worst = max(worst, err)
        ms = cuda_time_ms(lambda: flash_stock(q, k, v, lengths, scale=scale), 50)
        plain_ms = cuda_time_ms(lambda: flash_stock_plain(q, k, v, lengths, scale=scale), 10)
        keep = segment_keep_mask(lengths, t)  # (B, 1, T, T)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=scale), 50
        )
        banded_ms = cuda_time_ms(
            lambda: banded_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                lengths, chunk=128, left=2, right=2), 50
        )
        pairs = sum(n * n + (t - n) * (t - n) for n in lens) * h  # visible (query, key) pairs
        bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
        log(f"flash_stock T={t} lengths={lens}: max_abs_err={err:.3e} ok={ok} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} banded_ms={banded_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={4 * pairs * d / ms / 1e9:.1f}")
        if not ok:
            fail(f"flash_stock disagrees with its plain version at T={t}")
        if t == 4096:  # the shape of the long-form request at 4096 frames
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
    # exact against banded further up the long-form range, for the banded
    # gate's threshold (times only: these lengths are past the plain version's
    # memory, and the kernel is held to it above)
    for t in (8192, 12288, 15360):
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor([t, t - 1000], dtype=torch.int32, device="cuda")
        ms = cuda_time_ms(lambda: flash_stock(q, k, v, lengths, scale=d ** -0.5), 10)
        banded_ms = cuda_time_ms(
            lambda: banded_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                lengths, chunk=128, left=2, right=2), 10
        )
        log(f"flash_stock vs banded T={t} lengths={lengths.tolist()}: ms={ms:.4f} "
            f"banded_ms={banded_ms:.4f}")
    return dict(max_abs_err=worst, **main)


def phase_stage(synth):
    import torch

    from jyutvoice_tpu_torch.nn.resblock_stage import (
        pack_stage_weights,
        resblock_stage,
        resblock_stage_plain,
    )

    cfg = synth.cfg.hift
    ks = tuple(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    n = len(ks)
    g = torch.Generator(device="cuda").manual_seed(1)
    worst, pair = 0.0, None
    # stages 1 and 2 of the vocoder at the 512-frame mel bucket
    for stage, t in ((1, 20480), (2, 61441)):
        w = pack_stage_weights(synth.hift.resblocks[stage * n : (stage + 1) * n], dil)
        c = synth.hift.resblocks[stage * n].convs1[0].weight.shape[0]
        for b in (1, 2):
            x = torch.randn(b, t, c, device="cuda", generator=g) * 0.5
            kw = dict(kernel_sizes=ks, dilations=dil)
            out = resblock_stage(x, w, **kw)
            ref = resblock_stage_plain(x, w, **kw)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = within(out, ref, STAGE_TOL)
            worst = max(worst, err)
            ms = cuda_time_ms(lambda: resblock_stage(x, w, **kw), 5, warmup=1)
            plain_ms = cuda_time_ms(lambda: resblock_stage_plain(x, w, **kw), 5, warmup=1)
            flops = b * t * c * c * 4 * len(dil) * sum(ks)  # 252 C^2 T at (3, 7, 11)
            bound_ms, bound_by = bound(2 * x.numel() * 4 + w.numel() * 4, flops, PEAK_F32_FLOPS)
            log(f"resblock_stage C={c} T={t} B={b}: max_abs_err={err:.3e} ok={ok} "
                f"ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by})")
            if not ok:
                fail(f"resblock stage disagrees with its plain version at C={c} T={t} B={b}")
            if b == 1:
                # the main path's pair of launches: one C=128 and one C=64 stage
                pair = pair or dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=bound_by)
                pair["ms"] += ms
                pair["plain_ms"] += plain_ms
                pair["bound_ms"] += bound_ms
    return dict(max_abs_err=worst, library_ms=None, **pair)


def run_request(synth, label, expect_bucket=None, **kw):
    import numpy as np

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.pipeline import buckets

    steps = kw.get("n_timesteps", 10)
    kernels.reset_launch_counts()
    res = synth.synthesize(**kw)
    launches = dict(kernels.LAUNCHES)
    bucket = buckets.pick_bucket(res.mel_frames, buckets.MEL_BUCKETS)
    est = synth.cfg.tts.cfm.estimator
    want_flash = steps * (est.num_mid_blocks + 2) * est.n_blocks
    ok = (
        np.isfinite(res.wav).all()
        and res.wav.shape == (res.mel_frames * 480,)
        and launches == {"flash_attention": want_flash, "resblock_stage": 2, "flash_stock": 0}
        and (expect_bucket is None or bucket == expect_bucket)
    )
    t = {k: round(v, 6) for k, v in res.timings.items()}
    log(f"request {label}: mel_bucket={bucket} mel_frames={res.mel_frames} "
        f"wav_samples={res.wav.shape[0]} finite={bool(np.isfinite(res.wav).all())} "
        f"launches={launches} (want flash {want_flash}, stage 2) timings={json.dumps(t)}")
    if not ok:
        fail(f"request {label} failed its checks")
    return res, launches


def phase_main_path(synth):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    zero_spk = torch.zeros((1, synth.cfg.tts.spk_embed_dim), device=synth.device)
    frames = synth.duration_frames(*synth.prepare_text(**yue)[:2], zero_spk)
    scale = 480.0 / frames  # random weights: scale the durations into the 512 bucket
    counts = {"flash_attention": 0, "resblock_stage": 0, "flash_stock": 0}
    runs = [
        ("yue+phone@512 (cold)", 512, dict(yue, length_scale=scale)),
        ("yue+phone@512", 512, dict(yue, length_scale=scale)),
        ("yue raw text", None, dict(text="佢係邊個", lang="yue")),
        ("zh", None, dict(text="我们是朋友", lang="zh")),
        ("yue prompted (100-frame prompt)", None, dict(
            text="好", lang="yue", phone="hou2",
            spk_embed=rng.standard_normal(192).astype(np.float32),
            prompt_feat=rng.standard_normal((100, 80)).astype(np.float32),
            prompt_h=rng.standard_normal((100, 80)).astype(np.float32),
        )),
    ]
    results = {}
    for label, bucket, kw in runs:
        res, launches = run_request(synth, label, expect_bucket=bucket, n_timesteps=10, **kw)
        results[label] = res
        for k in counts:
            counts[k] += launches[k]
    return results, counts


def phase_reference(synth, params_tts, params_hift):
    """The same full-width model on the CPU (plain versions) on a short request."""
    import numpy as np

    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    cpu = Synthesizer(synth.cfg, params_tts, params_hift, device="cpu")
    kw = dict(text="佢", lang="yue", phone="keoi5", n_timesteps=2)
    ref = cpu.synthesize(**kw)
    out = synth.synthesize(**kw)
    mae = float(np.abs(out.mel - ref.mel).mean()) if out.mel.shape == ref.mel.shape else float("inf")
    wav_err = float(np.abs(out.wav - ref.wav).max()) if out.wav.shape == ref.wav.shape else float("inf")
    log(f"reference (CPU, plain versions) vs card: mel_frames {out.mel_frames}/{ref.mel_frames} "
        f"mel_mae={mae:.3e} wav_max_abs_err={wav_err:.3e}")
    if out.mel_frames != ref.mel_frames or not mae < 1e-2 or not wav_err < 2e-2:
        fail("the card's output does not agree with the CPU reference")


def scale_for(synth, frames_wanted, text, lang, phone):
    """length_scale that stretches the random weights' durations to about
    frames_wanted mel frames."""
    import torch

    zero_spk = torch.zeros((1, synth.cfg.tts.spk_embed_dim), device=synth.device)
    frames = synth.duration_frames(*synth.prepare_text(text, lang, phone)[:2], zero_spk)
    return frames_wanted / frames


def phase_long_form(synth):
    """Long-form requests at full width, 10 steps: exact (kernel 3), auto
    (banded), exact with a prompt (kernel 3), and the delegation past the
    bucket table with PCM16 (banded)."""
    import numpy as np

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.pipeline.synthesize import long_form_shapes

    rng = np.random.default_rng(1)
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    est = synth.cfg.tts.cfm.estimator
    per_request = 10 * (est.num_mid_blocks + 2) * est.n_blocks
    prompt = dict(prompt_feat=rng.standard_normal((100, 80)).astype(np.float32),
                  prompt_h=rng.standard_normal((100, 80)).astype(np.float32))
    runs = [
        # label, entry point, kwargs, t_total, launches of (kernel 1, kernel 3)
        ("(a) exact, 4096 frames", "synthesize_long",
         dict(yue, attention="exact", length_scale=scale_for(synth, 4000, **yue)),
         4096, (0, per_request)),
        ("(a') auto (banded), 4096 frames", "synthesize_long",
         dict(yue, length_scale=scale_for(synth, 4000, **yue)), 4096, (0, 0)),
        ("(b) exact, 100-frame prompt, 2560 frames", "synthesize_long",
         dict(yue, attention="exact", length_scale=scale_for(synth, 2000, **yue), **prompt),
         2560, (0, per_request)),
        ("(c) synthesize past 15000 frames, pcm16", "synthesize",
         dict(yue, pcm16=True, length_scale=scale_for(synth, 15100, **yue)), 15360, (0, 0)),
    ]
    counts = {"flash_attention": 0, "resblock_stage": 0, "flash_stock": 0}
    mel_ms = {}
    for label, entry, kw, t_total, (want_k1, want_k3) in runs:
        kernels.reset_launch_counts()
        res = getattr(synth, entry)(n_timesteps=10, **kw)
        launches = dict(kernels.LAUNCHES)
        head, t_mel = long_form_shapes(res.mel_frames, "prompt_feat" in kw,
                                       kw.get("attention", "auto"))
        ok = (
            np.isfinite(res.wav).all() and np.isfinite(res.mel).all()
            and res.wav.shape == (res.mel_frames * 480,)
            and res.mel.shape == (res.mel_frames, 80)
            and head + t_mel == t_total
            and launches == {"flash_attention": want_k1, "flash_stock": want_k3,
                             "resblock_stage": 2}
        )
        t = {k: round(v, 6) for k, v in res.timings.items()}
        log(f"long-form {label}: mel_frames={res.mel_frames} t_total={head + t_mel} "
            f"wav_samples={res.wav.shape[0]} launches={launches} "
            f"(want flash_attention {want_k1}, flash_stock {want_k3}, resblock_stage 2) "
            f"timings={json.dumps(t)}")
        if not ok:
            fail(f"long-form request {label} failed its checks")
        mel_ms[label] = res.timings["mel"] * 1e3
        for k in counts:
            counts[k] += launches[k]
    exact, banded = (mel_ms[label] for label, *_ in runs[:2])
    log(f"long-form mel phase at 4096 frames: exact (kernel 3) {exact:.1f} ms, "
        f"banded {banded:.1f} ms")
    return counts


def phase_long_reference(synth, params_tts, params_hift):
    """The same full-width model on the CPU against the card, two long-form
    requests at 2 steps: exact with a prompt at 2560 frames (kernel 3 on the
    card, exact plain attention on the CPU) and banded at 2048 frames."""
    import numpy as np

    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    cpu = Synthesizer(synth.cfg, params_tts, params_hift, device="cpu")
    rng = np.random.default_rng(2)
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    pf = rng.standard_normal((100, 80)).astype(np.float32)
    cases = [
        ("exact, 100-frame prompt, 2560 frames",
         dict(yue, attention="exact", prompt_feat=pf, prompt_h=pf * 0.5,
              length_scale=scale_for(synth, 2000, **yue))),
        ("banded, 2048 frames",
         dict(yue, attention="banded", length_scale=scale_for(synth, 2000, **yue))),
    ]
    for label, kw in cases:
        t = time.perf_counter()
        ref = cpu.synthesize_long(n_timesteps=2, **kw)
        cpu_s = time.perf_counter() - t
        out = synth.synthesize_long(n_timesteps=2, **kw)
        same = out.mel.shape == ref.mel.shape
        mae = float(np.abs(out.mel - ref.mel).mean()) if same else float("inf")
        wav_err = float(np.abs(out.wav - ref.wav).max()) if same else float("inf")
        log(f"long-form reference (CPU) vs card, {label}: mel_frames "
            f"{out.mel_frames}/{ref.mel_frames} mel_mae={mae:.3e} "
            f"wav_max_abs_err={wav_err:.3e} (CPU {cpu_s:.1f} s)")
        if out.mel_frames != ref.mel_frames or not mae < 1e-2:
            fail(f"the card's long-form output ({label}) does not agree with the CPU")


def main():
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs only on a GPU")
        return 2
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    smi = phase_device()
    phase_build()

    cfg = JyutVoiceConfig()
    t = time.perf_counter()
    params_tts = random_init.init_tts_tree(cfg.tts, seed=0)
    params_hift = random_init.init_hift_tree(cfg.hift, seed=1)
    synth = Synthesizer(cfg, params_tts, params_hift, device="cuda")
    log(f"full-width Synthesizer (random weights, seeds 0/1) ready in {time.perf_counter() - t:.1f} s")

    flash = phase_flash()
    stock = phase_flash_stock()
    stage = phase_stage(synth)
    _, counts = phase_main_path(synth)
    phase_reference(synth, params_tts, params_hift)
    long_counts = phase_long_form(synth)
    phase_long_reference(synth, params_tts, params_hift)
    counts = {k: counts[k] + long_counts[k] for k in counts}

    line = {"kernels": [
        dict(name="flash_attention", route="cuda",
             source="jyutvoice_tpu_torch/csrc/flash_attention.cu",
             replaces="jyutvoice_tpu/nn/pallas/attention.py:113",
             launches=counts["flash_attention"], **flash),
        dict(name="resblock_stage", route="cuda",
             source="jyutvoice_tpu_torch/csrc/resblock_stage.cu",
             replaces="jyutvoice_tpu/nn/pallas/resblock.py:127",
             launches=counts["resblock_stage"], **stage),
        dict(name="flash_stock", route="cuda",
             source="jyutvoice_tpu_torch/csrc/flash_stock.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
                      "(forward pallas_call of flash_attention, called at "
                      "jyutvoice_tpu/models/estimator.py:215-249)",
             launches=counts["flash_stock"], **stock),
    ]}
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
