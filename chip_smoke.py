#!/usr/bin/env python3
"""Drive the PyTorch port (jyutvoice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is turned off (parity with the f32 reference path);
  2. build: the six CUDA kernel sources from jyutvoice_tpu_torch/csrc/,
     nvcc in parallel; per compiled kernel, ptxas's registers and spills and
     the count of HGMMA (wgmma) instructions in its SASS (kernels 1 and 3,
     kernel 2 at C=128 and C=64, every dK/dV and dQ kernel of kernels 4
     and 5 at D=64 and D=128 and the f32 GEMM must have them; the int8 GEMM
     its IGMMA, the integer wgmma), and ptxas's warnings;
  3. kernel 1 (flash attention) against its plain version on the valid rows
     at the estimator's shapes (T = 512, 576, 640, chunk rules 50/-1 and
     100/2, T = 1600 = 1536 + a 64-frame prompt, T = 4160, D = 128, ragged
     T = 4100, and the short path's other mel buckets 128-2048), with
     CUDA-event times (median of 3 loops, after warming the card) of the
     kernel, the plain version and torch's SDPA as a yardstick; at
     T <= 2048 also device-only times (CUDA graph replay: back to back, these
     launches are bound by the host), printed and put in the kernel line as
     device_ms, plain_device_ms and library_device_ms beside the event
     times, and the wrapper's host cost per call; then at T = 15000 and
     15512 (the top mel bucket) two heads against the plain version and
     kernel 1 and SDPA timed alone beside the bound;
  4. kernel 3 (stock flash, segment ids) against its plain version on every
     row at the long-form shapes (T = 2048, 2560, 4096), at T = 2112
     (T % 128 == 64) with lengths 1, 63, 65, 2111, at D = 128, and at
     batch 16, T = 512 with lengths 512, 508, ..., 452 (padded rows that
     see 8-60 keys), with the
     times of the kernel, the plain version, SDPA with the segment mask,
     and the banded attention the long-form gate takes instead, and the
     host cost per call; then kernel 3 and banded times alone at T = 8192,
     12288, 15360;
  5. kernel 2 (HiFT ResBlock stage, 3xTF32 on wgmma) against its plain
     version on every row at the 512-frame bucket's stages (C=128, T=20480)
     and (C=64, T=61441), batch 1 and 2, at the 15000-bucket request's
     windowed pair (its 8 windows of 2112 frames: batch 8, C=128 at
     T=84480, C=64 at T=253441) and at T no multiple of its tile, each with
     the kernel's and the plain version's times, the 3xTF32 and f32 FFMA
     bounds and the recompute factor;
  6. the main path: a full-width Synthesizer with seeded random weights
     (default JyutVoiceConfig) answers 6 requests: one at the 512-frame mel
     bucket twice (cold, then warm), raw Cantonese text, Mandarin, one
     with a voice-cloning prompt, and one of about 13000 frames in the
     15000-frame bucket (kernel 1 at T = 15000, no kernel 3); one short
     request is checked against the same model run on the CPU through the
     plain versions;
  6b. voice cloning from reference audio: a full-width PromptExtractor
     (seeded random flow-encoder, CAM++ and S3 trees) on the card against
     the same on the CPU, on a 5 s cut of phase 6's Cantonese waveform fed
     at 24 kHz and resampled to 16 and 44.1 kHz (mel energies within 1e-5
     + 1e-3 of the CPU's, spk_embed and prompt_h within 1e-4 of max |ref|,
     the flow encoder on the card's tokens on both sides, every token equal
     apart from values within 1e-4 of an FSQ rounding edge, those counted
     and at most 1 %; the extraction launches no kernel); extract_batch
     with the DSP on the card on 4 rows of different lengths and rates
     against per-row calls, to the same bars; one cloned request at the
     512-frame bucket
     (560 kernel-1 and 2 kernel-2 launches, counted in the kernel line);
     CUDA-event times of the components, cold and warm;
  6c. kernels 1 and 2 at the streaming shapes (chunk 100: seg 134, a
     168-frame vocoder segment): kernel 1 at T=134 and T=84, B=2 (one
     stream) and B=8 (four sessions, with the length-0 rows of a free
     slot, which must come out 0), chunk rules 0 and 50/-1, timed at
     T=134 beside SDPA and its plain version (events, and device time by
     CUDA graph); kernel 2 at C=128 T=6720 and C=64 T=20161, batch 1 and
     4, beside its plain version and bound;
  6d. the streaming path at full width, 10 steps, chunk 100:
     synthesize_streaming on the 512-bucket text unprompted (cold, warm),
     with estimator_chunk_masks=True and with phase 6b's 250-frame prompt
     (capacity 256, "plain" attention), every chunk's launches checked
     (560 kernel-1 and 2 kernel-2 launches unprompted, no kernel 1
     prompted), with the first chunk's and each chunk's ms (host clock
     fenced by torch.cuda.synchronize()) and the RTF; a 3-chunk stream
     against the CPU (mel MAE < 1e-2); MultiStreamSynthesizer with 4
     sessions of different lengths, an unprompted lane and a prompted one
     mixing cloned and plain sessions, against single streams (1e-4 of max
     |ref|), with tick ms and the aggregate RTF;
     PromptExtractor(streaming_encoder=True) and StreamingTokenEncoder on
     phase 6b's tokens against the whole streaming flow encoder (1e-4 of
     max |ref|); cli.infer --stream on its default device;
  6e. kernels 1 and 2 at the serving shapes: kernel 1 at B = 2 b_pad (b_pad
     8 and 4) at T=512 and 1024, a valid length per row, the unconditional
     half repeating the conditional one and a padding row repeating row 0
     (equal to it bit for bit), and a mixed group of cloned and plain rows
     at T = 64 + 512, timed (events and CUDA-graph device time) beside
     SDPA, the plain version and the bound; kernel 2 at the 512 pair at
     batch 4 and 8 and the 1024 pair (C=128 T=40960, C=64 T=122881) at
     batch 8, beside its plain version and bound;
  6f. serving at full width, 10 steps, PCM16: ServingEngine(max_batch=8,
     max_wait_ms=200) groups of 8 (one b_pad-8 dispatch, cold and warm), 3
     (b_pad 4), 3 plain + 1 cloned (phase 6b's 250-frame prompt) and one
     spanning two text partitions (two dispatches), each request against
     direct synthesize (mel frames equal, mel MAE < 1e-2, the waveform gap
     in PCM16 steps), every dispatch's launches checked (560 kernel 1, 2
     kernel 2), the b_pad-8 group's wall time against the 8 requests one
     by one; a long-form request through the engine's long route (exact,
     kernel 3) against synthesize_long; StreamingLane with 4 streams against
     single streams (1e-4 of max |ref|), its dispatch count against the
     chunks of its longest stream and its launches against that count;
     TTSServer (streaming lane, phase
     6b's extractor): /healthz names the card, 4 concurrent /tts coalesce
     into one batch within 1 PCM16 step of the engine, one /tts/stream, one
     ref_audio_b64 request twice (one extraction); `python -m
     jyutvoice_tpu_torch.cli.serve --random-init --streaming --warmup` on
     its default device answers /healthz and /tts and drains on SIGTERM
     with exit code 0;
  6g. kernels 1 and 2 on the very inputs that phase 6f's engine groups
     handed them (the first call at each shape, kept on the device while
     the groups ran, all but the timed warm group): kernel 1 at B = 2 b_pad
     with the batch path's own lengths, padding rows and prompt rows
     (a row that repeats an earlier one must equal it bit for bit), kernel
     2 on the whole-bucket decodes with the vocoder's prepared weights,
     each against its plain version and timed as in phase 6e;
  7. the long-form path: synthesize_long with exact attention at 4096 frames
     (kernel 3), the same in auto mode (banded), exact with a 100-frame
     prompt (2560 frames in all, kernel 3), and synthesize past the
     15000-frame bucket with PCM16 (delegated, banded), with the largest
     |q|, |k| and |v| that reach kernel 3 in the prompted request (it
     rounds them to fp16, whose largest finite value is 65504); then two
     long-form requests (exact with a prompt at 2560 frames, banded at
     2048) against the same model on the CPU;
  8. kernels 4 and 5 (the stock flash backward, dK/dV and dQ, on tf32
     wgmma) against the plain backward on every row, standalone and through
     flash_stock_bwd with one shared preparation, and the preparation of
     their operands against its plain version (tile images bit for bit), at
     T = 2048, 2560, 4096 (D = 64), D = 128, and batch 16 at T = 512 (the
     short training shape), kernel 3's output and residuals against the
     plain forward's at every shape, with the times of the preparation, each kernel,
     the whole backward, the plain backward and SDPA's backward beside the
     TF32 and bf16 bounds, ptxas's registers and spills at D = 128, and
     kernel 3 timed with and without residuals;
  9. the training path: a full-width trainer (default JyutVoiceConfig,
     random weights, seed 0) takes 8 steps at batch 2 in the 2048-frame mel
     bucket (kernels 3, 4 and 5, 56 launches each per step; the largest
     |q|, |k| and |v| that reach kernel 3 in the first), then 3 steps at
     the short shape (batch 16, text 128, mel 512, "plain" attention);
     then one deterministic step of a reduced-depth full-width model, its
     losses and trainable gradients on the card against the CPU;
  10. the fine-tune workflow at full width (default JyutVoiceConfig,
     seeded random trees): reference-shaped flow.pt / hift.pt stand-ins
     through `cli.provision --assemble-pretrain` (every key audited,
     tts_init's decoder and speaker affine bit-equal to the stand-in's);
     `cli.provision --verify` on the card (560 kernel-1 and 2 kernel-2
     launches per request); `prepare_dataset.process_batch` with a
     full-width PromptExtractor on the card over 5 rows of 33-38 s (1650-1900
     mel frames, with decoder_h), two against the CPU at phase 6b's bars;
     `cli.train --pretrain tts_init.npz --tb-dir` on dummy rows at the
     2048-frame bucket (56 launches each of kernels 3, 4, 5 and the
     preparation per step; the validation pass and the validation sample's
     four images; the decoder bit-unchanged, the encoder moved), then two
     library steps on the prepared rows; the trained module exported
     (tree -> save_torch_checkpoint -> provision(tts_ckpt)) and reloaded
     bit-equal; with the seconds of each step, verify's xRT, the rows per
     second prepared, the CLI's median step, the validation pass and the
     sample;
  10f. kernels 1-5 on the inputs phase 10 handed them: kernel 1 and 2 on
     the first call at each shape of `provision --verify`, kernel 3 and its
     backward (4, 5, the preparation) on the first fine-tune step's first
     attention call and the gradient that reached it, each against its
     plain version and timed as in phases 6e and 8.
  11. the last single-device modules at full width (seeded random trees):
     11a, the int8 estimator: the seed-0 tree quantized with the port's
     quantize_estimator in an int8 Synthesizer beside the f32 one, a
     512-bucket and a 15000-bucket request in turns (cold, then 3 and 2 warm
     calls each), 560 kernel-1 and 2 kernel-2 launches per request, mel /
     vocoder / total ms (medians of the warm calls), the int8-vs-f32 mel
     deviation (mean |diff| / mean |f32| < 0.1, the JAX test's bar); one
     full-width QuantLinear on the 512 request's own input against its CPU
     computation (int8 activations and int32 products equal, output rtol
     1e-6), timed beside torch._int_mm and the f32 linear; the int8
     request at 2 steps against the CPU port's (mel MAE < 1e-2);
     synthesize_batch of 3 and a ServingEngine group of 3 on the int8
     synthesizer against its direct requests; kernels 1 and 2 on the inputs
     the int8 path handed them, as in phase 6g;
     11b, Synthesizer.warmup_long (text buckets 1024 and 8192, mel sizes
     2048, 4096 and 12288, 10 steps, PCM16) with exact attention (560
     kernel-3 launches per solve) and auto (banded), and a prompted exact job
     (t_total 2560); each job's launches and synchronised ms; the count
     against the JAX formula; synthesize_long, exact, first and second at
     about 12000 frames (warmed) and 8000 frames (not warmed);
     11c, the host MAS: mas.cpp built with g++ and loaded (the numpy fallback
     must not run), on the MAS inputs of phase 9's steps (B=2 at the 2048
     bucket, B=16 at mel 512) bit-equal to the device maximum_path, both
     timed, the host's with its copies to and from the card;
     11d, the int8 linear's two kernels (csrc/int8_linear.cu) at the
     estimator's four (K, N), q/k/v (256, 512) without a bias and o, ff_in,
     ff_out with one, at 49152 rows (a batch-16 group at the 1536 bucket with
     CFG) and 1024: bit-equal to the plain composition on the card, one
     launch of each kernel a call, the pair's CUDA-event and device (CUDA
     graph) times and each kernel's device time beside the linear's own
     bytes bound (bound_ms) and, apart, the x_q and sx round trip the design
     adds (x_q_ms), the plain composition's times (plain_ms) and
     torch._int_mm's alone (library_ms), and the wrapper's host cost per
     call;
     11e, the DiT's 3xTF32 GEMM (csrc/f32_gemm.cu) through its route
     (nn/f32_gemm.py::linear) at the block's four (K, N) on 28500 rows (a
     DiT call's packed rows in the DiT cell): one launch a call, its
     largest and mean absolute errors against an f64 product within 2x of
     cuBLAS's f32 GEMM's on the same inputs (the signed mean beside them),
     its difference from the plain version within the sum of the two's
     largest errors, and the CUDA-event times of the kernel, the plain
     version and F.linear (library_ms) beside the 3xTF32 and f32 FFMA
     bounds, with TFLOP/s;
     11f, the DiT decoder at its published widths (random trees) in a
     Synthesizer: a group of 16 requests of up to ~900 frames (the DiT
     cell's group; ~22000 packed rows a call) through synthesize_batch_dispatch
     at 10 steps, 88 f32 GEMM launches an estimator call (the kernel line
     counts them), and the same group with the block GEMMs on the plain
     version, the two mels within 1e-4 of the largest magnitude.
  12. the serving export at full width (seeded random trees, 10 steps,
     phase 6's sentence and text bucket): 12a aot_compile at the 512
     bucket, 12b with phase 6's 100-frame prompt in its prompt bucket, 12c
     at the 15000 bucket (about 13000 frames: kernel 1 at T=15000 and the
     windowed vocoder at batch 8 inside the CUDA graph), every program on
     one Synthesizer's shared weights; each with the capture's seconds, its
     peak device memory and the memory it holds after it, 560 kernel-1 and
     2 kernel-2 launches at capture and in one replay (a torch.profiler
     trace of the card), the replay against the eager ServingGraph (max
     |diff| <= 1e-6, lengths equal), call 1's result kept after call 2,
     a wrong shape refused, and Synthesizer.synthesize in the same bucket
     (frames equal, mel MAE < 1e-2); 12d export_program and load_program at
     the 512 bucket, 10 steps (trace seconds, artifact bytes, load
     seconds; the reloaded program against the eager ServingGraph on
     "xla_scores" within 1e-6 and against 12a's program, frames equal, mel
     MAE < 1e-2; the artifact deleted); CUDA-event medians of 5 warm calls
     of the replay, the eager ServingGraph and synthesize at 512 and 15000
     and of the reloaded program and its eager module; 12e kernels 1
     and 2 on the first input of each shape the eager calls of 12a-12c
     handed them (kernel 1 at T=15000 on two heads), as in phase 6g.
  13. multi-device on torch.distributed (dist/), full width, seeded random
     trees: 13a data parallel: `python -m jyutvoice_tpu_torch.cli.train`
     as torchrun-style processes (MASTER_ADDR / WORLD_SIZE / RANK) at world
     1 over NCCL and world 2 over Gloo with both ranks on cuda:0, 2 steps at
     global batch 4 in the 2048 bucket (56 launches each of kernels 3, 4, 5
     and the preparation per rank and step, from each rank's --report),
     the two runs' losses within 1e-3; then a spawned 2-rank Gloo mesh
     (this process rank 0) takes one step on 4 unequal rows against one
     process on the same global batch: losses 1e-3, gradients 2e-2
     relative L2, the decoder bit-unchanged, the ranks' parameters equal;
     13b sequence parallel: synthesize_long(mesh=...) at about 4000 frames
     on 2 Gloo ranks sharing the card (2 steps) and on 1 NCCL rank (10
     steps), each with "scores", "banded" and "ring" (SP_MESHES, printed
     first), against
     the single-device "xla_scores" solve at atol 2e-5 / rtol 1e-4, exact
     attention (kernel 3) at mel MAE < 1e-2 and, for "banded", the
     single-device banded path; per-rank solve ms, the share in
     collectives and peak memory; 13c a long request through
     ServingEngine(sp_mesh=...) against synthesize_long(mesh=...), the
     full-width estimator TP-sharded over 2 Gloo ranks (one call, a
     10-step solve at T=512) against one device, and cli.serve
     --sp-devices 2 refused on a one-card machine.
Launch counts are zeroed before and read after each request of phases 6,
6b and 7, each streamed chunk and multi-session tick of phase 6d, each
engine group, lane run and HTTP block of phase 6f, each training step of
phase 9, the verify call, each training step, the validation pass and the
validation sample of phase 10, and each request, batch, engine group and
warmup_long job of phase 11, and each eager call, capture and synthesize of
phase 12, whose replays add the launches of their program's traced
replay, and each step, request and solve of phase 13 on every rank (the
children's and followers' counts come back in their reports and
gathers). The line
before the last is a JSON
object with one entry per kernel; the last line is {"ok": true, "device":
{...}}. Exits non-zero without printing a result when no CUDA device is
available.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM datasheet peaks (NVIDIA), dense
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
PEAK_INT8_OPS = 1979e12

ATTN_TOL = (5e-3, 2e-2)  # atol, rtol: bf16 products, f32 accumulation
STOCK_TOL = (5e-3, 1e-2)  # the JAX package's bar for the stock flash kernel
STAGE_TOL = (2e-5, 1e-4)  # f32 accuracy (3xTF32 products, f32 sums)
BWD_BAR = 1e-2  # kernels 4 and 5: max |err| / max |ref| per gradient (TF32 products)
TRAIN_LOSS_RTOL = 1e-3  # card against CPU, one deterministic step
TRAIN_GRAD_RTOL = 2e-2  # relative L2 norm of the trainable gradients


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_time_ms(fn, iters, warmup=3, loops=3):
    """Median over `loops` CUDA-event-timed loops of `iters` back-to-back
    calls, after `warmup` calls: ms per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


_CAPTURE_STREAM = []


def graph_time_ms(fn, launches=20, loops=3):
    """Device ms per call without the host: `launches` calls captured in one
    CUDA graph, replayed and timed as in cuda_time_ms. Every capture uses one
    side stream: cuBLAS keeps a workspace allocated for each stream it has
    run on, which a new stream per call would add to the later phases'
    device memory."""
    import torch

    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    ms = cuda_time_ms(graph.replay, 10, loops=loops) / launches
    graph.reset()  # frees the graph's memory pool for the later phases
    return ms


def host_us_per_call(fn, calls=1000):
    """Host microseconds per call: perf_counter over back-to-back calls,
    with no synchronisation inside (the enqueue cost)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def warm_card(seconds=1.0):
    """Bring the card to its load clocks before the first timed case."""
    import torch

    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()


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


def _short_kernel_name(mangled):
    """flash_fwd_sm90's and resblock_stage_sm90's template arguments spelled
    out; other names as they are."""
    import re

    m = re.search(r"resblock_stage_sm90ILi(\d+)E", mangled)
    if m:
        return f"resblock_stage_sm90<C={m.group(1)}>"
    m = re.search(r"int8_gemm_sm90ILi(\d+)E", mangled)
    if m:
        return f"int8_gemm_sm90<BN={m.group(1)}>"
    m = re.search(r"flash_stock_bwd_sm90ILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", mangled)
    if m:
        d, nc, ns, dkv = m.groups()
        return (f"flash_stock_bwd_sm90<D={d}, consumers={nc}, stages={ns}, "
                f"{'dk/dv' if dkv == '1' else 'dq'}>")
    m = re.search(r"flash_stock_bwd_prep_kernelILi(\d+)E", mangled)
    if m:
        return f"flash_stock_bwd_prep<D={m.group(1)}>"
    m = re.search(r"flash_fwd_sm90ILi(\d+)ELi(\d+)ELi(\d+)ELNS0_4RuleE(\d)ELb(\d)ELb(\d)",
                  mangled)
    if not m:
        return mangled
    d, nc, ns, rule, res, f16 = m.groups()
    return (f"flash_fwd_sm90<D={d}, consumers={nc}, stages={ns}, "
            f"{('key band', 'segments')[int(rule)]}{', residuals' if res == '1' else ''}, "
            f"{'fp16' if f16 == '1' else 'bf16'}>")


def phase_build():
    """Build every kernel source (nvcc in parallel) and print, per compiled
    kernel, ptxas's registers and spills and the count of HGMMA (wgmma)
    instructions in its SASS."""
    from jyutvoice_tpu_torch import kernels

    t = time.perf_counter()
    kernels.build_all()
    for name in kernels.KERNEL_SOURCES:
        kernels.load(name)
    log(f"build: {', '.join(kernels.KERNEL_SOURCES)} in {time.perf_counter() - t:.1f} s")
    hgmma = {}
    for name in kernels.KERNEL_SOURCES:
        sass = kernels.sass_opcode_count(name, "HGMMA")
        for func, facts in sorted(kernels.ptxas_facts(name).items()):
            log(f"  {name}: {_short_kernel_name(func)}: {facts}, HGMMA in SASS: {sass.get(func, 0)}")
        hgmma[name] = sass
        for warning in kernels.ptxas_warnings(name):
            log(f"  {name}: ptxas: {warning}")
    for name in ("flash_attention", "flash_stock"):
        if not hgmma[name] or not all(hgmma[name].values()):
            fail(f"csrc/{name}.cu has a kernel without HGMMA in its SASS: {hgmma[name]}")
    # the int8 GEMM: integer wgmma (IGMMA)
    igmma = {_short_kernel_name(f): n for f, n in
             kernels.sass_opcode_count("int8_linear", "IGMMA").items() if "int8_gemm" in f}
    log(f"  int8_linear: IGMMA in SASS: {igmma}")
    if len(igmma) != 1 or not all(igmma.values()):
        fail(f"csrc/int8_linear.cu: an int8 GEMM lacks IGMMA in its SASS: {igmma}")
    if not hgmma["f32_gemm"] or not all(hgmma["f32_gemm"].values()):
        fail(f"csrc/f32_gemm.cu has a kernel without HGMMA in its SASS: {hgmma['f32_gemm']}")
    # kernel 2: the instantiations of the main path's stages (C=128 and 64)
    stage = {_short_kernel_name(f): n for f, n in hgmma["resblock_stage"].items()}
    for c in (128, 64):
        if not stage.get(f"resblock_stage_sm90<C={c}>"):
            fail(f"csrc/resblock_stage.cu has no HGMMA in its C={c} kernel: {stage}")
    # kernels 4 and 5: every instantiation, at D=64 and D=128 (the
    # preparation kernel moves data only)
    bwd = {_short_kernel_name(f): n for f, n in hgmma["flash_stock_bwd"].items()
           if "flash_stock_bwd_sm90" in f}
    for d in (64, 128):
        for which in ("dk/dv", "dq"):
            mine = {f: n for f, n in bwd.items() if f"D={d}," in f and which in f}
            if not mine or not all(mine.values()):
                fail(f"csrc/flash_stock_bwd.cu: a {which} kernel at D={d} lacks HGMMA "
                     f"in its SASS: {bwd}")


def phase_flash():
    """Kernel 1 against its plain version on the valid rows at the short
    path's shapes, ragged T (a 64-frame prompt, T=4100), T=4160 and D=128,
    with steady CUDA-event times beside SDPA with the same mask; device-only
    (CUDA graph) times and the wrapper's host cost at T <= 2048; then in the
    top mel bucket two heads against the plain version, and kernel 1 alone
    beside SDPA and its bound."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn.flash_attention import (
        flash_attention,
        flash_attention_plain,
        key_keep_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    b, h = 2, 8  # the CFG-doubled batch of one request, 8 heads
    cases = [(512, [512, 389], 0, -1, 64), (576, [576, 333], 0, -1, 64),
             (640, [640, 501], 0, -1, 64), (640, [640, 600], 50, -1, 64),
             (512, [400, 512], 100, 2, 64), (1600, [1600, 1100], 0, -1, 64),
             (4160, [4160, 3001], 0, -1, 64), (640, [640, 501], 0, -1, 128),
             # ragged T where the 192-row blocks are picked (4100 % 192 = 68)
             (4100, [4100, 3001], 0, -1, 64)]
    # the other mel buckets of the short path
    cases += [(t, [t, t * 3 // 4], 0, -1, 64) for t in (128, 256, 384, 768, 1024, 1536, 2048)]
    worst, first = 0.0, None
    for t, lens, chunk, left, d in cases:
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
        del ref
        short = t <= 640
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 200 if short else 20)
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, lengths, **kw),
                                20 if short else 3)
        keep = key_keep_mask(lengths, t, chunk, left)  # (B, 1, T, T)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=kw["scale"])
        lib_ms = cuda_time_ms(sdpa, 200 if short else 20)
        pairs = int(keep.expand(-1, -1, t, -1).sum()) * h  # visible (query, key) pairs
        bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
        extra, dev = "", {}
        if t <= 2048 and d == 64:
            # back to back, these launches are bound by the host (the
            # wrapper's cost per call); CUDA-graph replay gives device times
            dev = dict(device_ms=graph_time_ms(lambda: flash_attention(q, k, v, lengths, **kw)),
                       plain_device_ms=graph_time_ms(
                           lambda: flash_attention_plain(q, k, v, lengths, **kw)),
                       library_device_ms=graph_time_ms(sdpa))
            host_us = host_us_per_call(lambda: flash_attention(q, k, v, lengths, **kw))
            extra = (f" device_ms={dev['device_ms']:.4f} "
                     f"plain_device_ms={dev['plain_device_ms']:.4f} "
                     f"sdpa_device_ms={dev['library_device_ms']:.4f} "
                     f"host_us_per_call={host_us:.1f}")
        log(f"flash T={t} lengths={lens} chunk={chunk}/{left} D={d}: max_abs_err={err:.3e} "
            f"ok={ok} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={4 * pairs * d / ms / 1e9:.1f}{extra}")
        if not ok:
            fail(f"flash attention disagrees with its plain version at T={t} chunk={chunk} D={d}")
        if t in (512, 576, 640) and chunk == 0 and lib_ms <= ms:
            fail(f"flash attention is not faster than SDPA at T={t}")
        if first is None:  # T=512, the 512-frame bucket
            first = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, **dev)
        del q, k, v, qt, kt, vt, keep, out
    # the top mel bucket: the plain version's scores of all heads do not fit,
    # so two heads are held to it (ragged T: the last key tile has 24 keys;
    # at 15000 the last 192-row block has 24 rows, one consumer active), and
    # the kernel is timed alone beside SDPA
    for t, lens in ((15000, [15000, 13000]), (15512, [15512, 15000])):
        q, k, v = (torch.randn(b, t, h, 64, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        err, ms, bound_ms, bound_by = _flash_heads_case("", q, k, v, lengths, dict(scale=0.125))
        worst = max(worst, err)
        keep = key_keep_mask(lengths, t, 0, -1)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=0.125), 2,
            warmup=1)
        pairs = t * sum(lens) * h  # every row sees its batch's valid keys
        log(f"flash T={t} lengths={lens} (top bucket, times only): ms={ms:.4f} "
            f"sdpa_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
            f"tflops={4 * pairs * 64 / ms / 1e9:.1f}")
        del q, k, v, qt, kt, vt, keep
    torch.cuda.empty_cache()
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
    h = 8
    worst, main = 0.0, None
    # the long-form shapes, T % 128 == 64 with lengths straddling tile edges,
    # D = 128, and the short training shape (batch 16, T = 512), whose padded
    # rows see 8-60 keys (with bf16 products two of them missed the bar)
    cases = ((2048, [2048, 1700], 64), (2560, [2560, 2148], 64), (4096, [4096, 3001], 64),
             (2112, [1, 63, 65, 2111], 64), (2048, [2048, 1700], 128),
             (512, [512 - 4 * i for i in range(16)], 64))
    for t, lens, d in cases:
        b = len(lens)
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
        banded_ms = float("nan")  # banded attention takes multiples of its 128 chunk
        if t % 128 == 0:
            banded_ms = cuda_time_ms(
                lambda: banded_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    lengths, chunk=128, left=2, right=2), 50
            )
        host_us = host_us_per_call(lambda: flash_stock(q, k, v, lengths, scale=scale), 200)
        pairs = _visible_pairs(lens, t, h)
        bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
        log(f"flash_stock T={t} lengths={lens} D={d}: max_abs_err={err:.3e} ok={ok} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} banded_ms={banded_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={4 * pairs * d / ms / 1e9:.1f} "
            f"host_us_per_call={host_us:.1f}")
        if not ok:
            fail(f"flash_stock disagrees with its plain version at T={t} D={d}")
        if (t, d) == (4096, 64):  # the shape of the long-form request at 4096 frames
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=lib_ms)
    # exact against banded further up the long-form range, for the banded
    # gate's threshold (times only: these lengths are past the plain version's
    # memory, and the kernel is held to it above)
    for t in (8192, 12288, 15360):
        q, k, v = (torch.randn(2, t, h, 64, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor([t, t - 1000], dtype=torch.int32, device="cuda")
        ms = cuda_time_ms(lambda: flash_stock(q, k, v, lengths, scale=64 ** -0.5), 10)
        banded_ms = cuda_time_ms(
            lambda: banded_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                lengths, chunk=128, left=2, right=2), 10
        )
        log(f"flash_stock vs banded T={t} lengths={lengths.tolist()}: ms={ms:.4f} "
            f"banded_ms={banded_ms:.4f}")
    return dict(max_abs_err=worst, **main)


def _visible_pairs(lens, t, h):
    return sum(n * n + (t - n) * (t - n) for n in lens) * h


def _stock_bwd_case(q, k, v, do, lengths, scale, label=""):
    """Kernels 4 and 5 against the plain backward on every row (standalone,
    each preparing its own operands, and through flash_stock_bwd with one
    shared preparation), the preparation against its plain version (tile
    images bit for bit), kernel 3's output and residuals against the plain
    forward's, and times: kernel 3 (with and without residuals), the
    preparation, each kernel on prepared operands, the whole backward, the
    plain backward and SDPA's backward, beside the TF32 and bf16 bounds.
    Fails on a disagreement; returns ({dq, dk, dv, lse2, fwd: max |err|},
    {dkv, dq, prep, fwd: times})."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn import flash_stock as fs

    b, t, h, d = q.shape
    lens = lengths.tolist()
    o, m, l = fs.flash_stock(q, k, v, lengths, scale=scale, residuals=True)
    o_ref, m_ref, l_ref = fs.flash_stock_plain(q, k, v, lengths, scale=scale, residuals=True)
    di = fs.flash_stock_di(o, do)
    prep = fs.flash_stock_bwd_prepare(q, k, v, do, m, l)
    prep_ref = fs.flash_stock_bwd_prepare_plain(q, k, v, do, m, l)
    dk, dv = fs.flash_stock_bwd_dkv(q, k, v, do, m, l, di, lengths, scale=scale)
    dq = fs.flash_stock_bwd_dq(q, k, v, do, m, l, di, lengths, scale=scale)
    shared = fs.flash_stock_bwd(q, k, v, o, do, m, l, lengths, scale=scale)
    dq_ref, dk_ref, dv_ref = fs.flash_stock_bwd_plain(q, k, v, o, do, m, l, lengths,
                                                      scale=scale)
    torch.cuda.synchronize()
    # the residuals: the row max, and the log-sum-exp m + log l (l alone
    # scales with the max, which 16-bit products move)
    res_ok = (within(o, o_ref, STOCK_TOL) and within(m, m_ref, STOCK_TOL)
              and within(m + torch.log(l), m_ref + torch.log(l_ref), STOCK_TOL))
    fwd_err = float((o - o_ref).abs().max())
    # the preparation: tile images bit-equal, lse2 to float rounding
    n_tiles = prep.numel() - b * h * t
    lse_err = float((prep[n_tiles:] - prep_ref[n_tiles:]).abs().max())
    prep_ok = torch.equal(prep[:n_tiles], prep_ref[:n_tiles]) and within(
        prep[n_tiles:], prep_ref[n_tiles:], (1e-6, 1e-6))
    rel, err = {}, {}
    for name, x, xs, y in (("dq", dq, shared[0], dq_ref), ("dk", dk, shared[1], dk_ref),
                           ("dv", dv, shared[2], dv_ref)):
        err[name] = max(float((x - y).abs().max()), float((xs - y).abs().max()))
        rel[name] = err[name] / float(y.abs().max())
    ok = res_ok and prep_ok and all(r <= BWD_BAR for r in rel.values())
    del prep_ref, shared, o_ref

    fwd_ms = cuda_time_ms(lambda: fs.flash_stock(q, k, v, lengths, scale=scale), 30)
    fwd_plain_ms = cuda_time_ms(lambda: fs.flash_stock_plain(q, k, v, lengths, scale=scale), 5,
                                warmup=1)
    res_ms = cuda_time_ms(
        lambda: fs.flash_stock(q, k, v, lengths, scale=scale, residuals=True), 30)
    prep_ms = cuda_time_ms(lambda: fs.flash_stock_bwd_prepare(q, k, v, do, m, l), 30)
    dkv_ms = cuda_time_ms(lambda: fs.flash_stock_bwd_dkv(
        q, k, v, do, m, l, di, lengths, scale=scale, prepared=prep), 30)
    dq_ms = cuda_time_ms(lambda: fs.flash_stock_bwd_dq(
        q, k, v, do, m, l, di, lengths, scale=scale, prepared=prep), 30)
    bwd_ms = cuda_time_ms(
        lambda: fs.flash_stock_bwd(q, k, v, o, do, m, l, lengths, scale=scale), 30)
    plain_ms = cuda_time_ms(
        lambda: fs.flash_stock_bwd_plain(q, k, v, o, do, m, l, lengths, scale=scale), 5,
        warmup=1)
    plain_prep_ms = cuda_time_ms(
        lambda: fs.flash_stock_bwd_prepare_plain(q, k, v, do, m, l), 5, warmup=1)
    # SDPA's forward and backward with the boolean segment mask (the
    # backward timed alone)
    keep = fs.segment_keep_mask(lengths, t)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        fwd_lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, scale=scale), 30)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=scale)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
    del out, qt, kt, vt, keep

    pairs = _visible_pairs(lens, t, h)
    io = b * t * h * d * 4  # one (B, T, H, D) f32 tensor
    rows = b * h * t * 4  # one (B, H, T) f32 tensor
    fwd_bound = bound(4 * io, 4 * pairs * d, PEAK_BF16_FLOPS)
    dkv_bound = bound(4 * io + 3 * rows + 2 * io, 8 * pairs * d, PEAK_TF32_FLOPS)
    dq_bound = bound(4 * io + 3 * rows + io, 6 * pairs * d, PEAK_TF32_FLOPS)
    dkv_bf16 = bound(4 * io + 3 * rows + 2 * io, 8 * pairs * d, PEAK_BF16_FLOPS)[0]
    dq_bf16 = bound(4 * io + 3 * rows + io, 6 * pairs * d, PEAK_BF16_FLOPS)[0]
    prep_bound = bound(4 * io + 2 * rows + 7 * io + rows, 0, PEAK_TF32_FLOPS)
    log(f"flash_stock_bwd{label} T={t} B={b} lengths={lens} D={d}: rel_err dq={rel['dq']:.2e} "
        f"dk={rel['dk']:.2e} dv={rel['dv']:.2e} (max_abs_err dq={err['dq']:.3e} "
        f"dk={err['dk']:.3e} dv={err['dv']:.3e}) "
        f"residuals_ok={res_ok} (fwd max_abs_err {fwd_err:.3e}) "
        f"prep_ok={prep_ok} (lse2 max_abs_err {lse_err:.1e}) ok={ok} "
        f"prep_ms={prep_ms:.4f} (bound {prep_bound[0]:.4f}, plain {plain_prep_ms:.4f}) "
        f"dkv_ms={dkv_ms:.4f} ({8 * pairs * d / dkv_ms / 1e9:.1f} TFLOP/s, bound TF32 "
        f"{dkv_bound[0]:.4f} bf16 {dkv_bf16:.4f}) dq_ms={dq_ms:.4f} "
        f"({6 * pairs * d / dq_ms / 1e9:.1f} TFLOP/s, bound TF32 {dq_bound[0]:.4f} bf16 "
        f"{dq_bf16:.4f}) prep+dkv+dq={prep_ms + dkv_ms + dq_ms:.4f} "
        f"flash_stock_bwd_ms={bwd_ms:.4f} plain_bwd_ms={plain_ms:.4f} "
        f"sdpa_bwd_ms={lib_ms:.4f} fwd_ms={fwd_ms:.4f} (plain {fwd_plain_ms:.4f}, sdpa "
        f"{fwd_lib_ms:.4f}, bound {fwd_bound[0]:.4f}) fwd_residuals_ms={res_ms:.4f}")
    if not ok:
        fail(f"the stock flash backward disagrees with its plain version{label} at T={t} D={d}")
    errs = dict(err, lse2=lse_err, fwd=fwd_err)
    times = {
        "dkv": dict(ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                    bound_bf16_ms=dkv_bf16, library_ms=lib_ms),
        "dq": dict(ms=dq_ms, plain_ms=plain_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1],
                   bound_bf16_ms=dq_bf16, library_ms=lib_ms),
        "prep": dict(ms=prep_ms, plain_ms=plain_prep_ms, bound_ms=prep_bound[0],
                     bound_by=prep_bound[1], library_ms=None),
        "fwd": dict(ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0],
                    bound_by=fwd_bound[1], library_ms=fwd_lib_ms),
    }
    return errs, times


def phase_flash_stock_bwd():
    """Kernels 4 and 5 and their preparation (`_stock_bwd_case`) at the
    long-form training shapes T = 2048, 2560, 4096, at D = 128, and at the
    short training shape (batch 16, T = 512), on random operands."""
    import torch

    from jyutvoice_tpu_torch import kernels

    g = torch.Generator(device="cuda").manual_seed(5)
    h = 8
    spills = {_short_kernel_name(f): facts for f, facts in kernels.ptxas_facts(
        "flash_stock_bwd").items() if "D=128" in _short_kernel_name(f)}
    log(f"flash_stock_bwd at D=128 (ptxas): {spills}")
    worst = {"dkv": 0.0, "dq": 0.0, "prep": 0.0}
    main = None
    cases = ((2048, [2048, 1700], 64), (2560, [2560, 2148], 64), (4096, [4096, 3001], 64),
             (2048, [2048, 1700], 128), (512, [512 - 4 * i for i in range(16)], 64))
    for t, lens, d in cases:
        b = len(lens)
        # strided (B, T, H, D) views of one projection, as in the estimator
        qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        do = torch.randn(b, t, h, d, device="cuda", generator=g)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        err, times = _stock_bwd_case(q, k, v, do, lengths, d ** -0.5)
        worst["dkv"] = max(worst["dkv"], err["dk"], err["dv"])
        worst["dq"] = max(worst["dq"], err["dq"])
        worst["prep"] = max(worst["prep"], err["lse2"])
        if (t, d) == (2048, 64):  # the training step's shape
            main = times
            main["prep"]["spills_d128"] = spills
    return {k: dict(max_abs_err=worst[k], **main[k]) for k in worst}


FP16_MAX = 65504.0  # kernel 3 rounds q, k and v to fp16


@contextlib.contextmanager
def kernel3_input_peaks():
    """The largest |q|, |k| and |v| of the card's calls to kernel 3 through
    the estimator's attention, kept on the device (no sync per call) and
    read as floats on exit. Its reductions add host time to a host-bound
    phase, so it stays out of the runs whose times are compared."""
    import torch

    from jyutvoice_tpu_torch.nn import attention

    real = attention.flash_stock
    peaks = {}

    def probe(q, k, v, *args, **kwargs):
        with torch.no_grad():
            for name, x in (("q", q), ("k", k), ("v", v)):
                m = x.detach().abs().amax()
                peaks[name] = torch.maximum(peaks[name], m) if name in peaks else m
        return real(q, k, v, *args, **kwargs)

    attention.flash_stock = probe
    try:
        yield peaks
    finally:
        attention.flash_stock = real
        peaks.update({name: float(m) for name, m in peaks.items()})


def check_kernel3_peaks(label, peaks):
    log(f"{label}: largest input of kernel 3 |q| {peaks['q']:.4g}, |k| {peaks['k']:.4g}, "
        f"|v| {peaks['v']:.4g} (fp16 max {FP16_MAX:g})")
    if not max(peaks.values()) < FP16_MAX:
        fail(f"{label}: an input of kernel 3 is beyond fp16's range")


def phase_train(mas_inputs=None):
    """The training path at full width: 8 steps at the 2048-frame bucket
    (kernels 3, 4, 5), then 3 steps at the short shape ("plain"). With a
    dict `mas_inputs`, the first MAS call at each shape leaves its inputs
    (log-prior and mask, on the card) there, for phase 11c."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig, TrainConfig
    from jyutvoice_tpu_torch.models import tts as tts_mod
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    cfg = JyutVoiceConfig()
    est = cfg.tts.cfm.estimator
    per_step = (est.num_mid_blocks + 2) * est.n_blocks
    model = load_jax_params(tts_mod.TTS(cfg.tts), random_init.init_tts_tree(cfg.tts, seed=0))
    model = model.cuda()
    trainer = Trainer(model, TrainConfig(batch_size=2), torch.Generator(device="cuda").manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    # MAS time per step, from CUDA events around each call
    real_mas = tts_mod.maximum_path
    mas_events = []

    def timed_mas(*a, **k):
        if mas_inputs is not None and tuple(a[0].shape) not in mas_inputs:
            mas_inputs[tuple(a[0].shape)] = tuple(t.detach().clone() for t in a[:2])
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_mas(*a, **k)
        ev[1].record()
        mas_events.append(ev)
        return out

    tts_mod.maximum_path = timed_mas
    totals = {k: 0 for k in kernels.LAUNCHES}
    try:
        def run(label, rows, steps, want, probe=False):
            dm = TextMelDataModule(rows, DataConfig(batch_size=trainer.train_cfg.batch_size))
            batches = list(dm.train_batches(0))[:steps]
            step_ms, mas_ms = [], []
            torch.cuda.reset_peak_memory_stats()
            for i, batch in enumerate(batches):
                mas_events.clear()
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                # the first step (cold, outside the median) also reads the
                # inputs of kernel 3
                with (kernel3_input_peaks() if probe and i == 0
                      else contextlib.nullcontext()) as peaks:
                    metrics = trainer.step(batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches = dict(kernels.LAUNCHES)
                for k in totals:
                    totals[k] += launches[k]
                mas_ms.append(sum(a.elapsed_time(b) for a, b in mas_events))
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                log(f"train {label} step {i + 1}: y={tuple(batch['y'].shape)} "
                    f"x={tuple(batch['x'].shape)} loss={loss:.4f} grad_norm={gnorm:.3f} "
                    f"lr={metrics['lr']:.3e} step_ms={step_ms[-1]:.1f} mas_ms={mas_ms[-1]:.1f} "
                    f"launches={launches}")
                if launches != want or not (np.isfinite(loss) and np.isfinite(gnorm)):
                    fail(f"training step {i + 1} ({label}) failed its checks (want {want})")
                if probe and i == 0:
                    check_kernel3_peaks(f"train {label} step 1", peaks)
            peak = torch.cuda.max_memory_allocated() / 2**30
            warm = step_ms[2:] if len(step_ms) > 3 else step_ms[1:]
            log(f"train {label}: {len(batches)} steps, median step ms (steps "
                f"{len(step_ms) - len(warm) + 1}-{len(step_ms)}) {float(np.median(warm)):.1f}, "
                f"median MAS ms {float(np.median(mas_ms)):.1f}, "
                f"max_memory_allocated {peak:.2f} GiB")
            return batches

        zero = {k: 0 for k in kernels.LAUNCHES}
        long_rows = dummy_rows(20, seed=0, mel_frames=(1400, 2000))
        batches = run("B=2 mel 2048", long_rows, 8, dict(
            zero, flash_stock=per_step, flash_stock_bwd_dkv=per_step,
            flash_stock_bwd_dq=per_step, flash_stock_bwd_prep=per_step), probe=True)
        if any(b["y"].shape[1] != 2048 for b in batches) or len(batches) != 8:
            fail("the long training batches did not land in the 2048-frame bucket")
        moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
        frozen_ok = not any(n.startswith(("decoder.", "spk_embed_affine_layer.")) for n in moved)
        trained_ok = (any(n.startswith("encoder.") for n in moved)
                      and any(n.startswith("dp.") for n in moved))
        log(f"train: decoder bit-unchanged={frozen_ok}, encoder and duration predictor "
            f"changed={trained_ok} ({len(moved)} tensors moved)")
        if not (frozen_ok and trained_ok):
            fail("the frozen decoder moved or the trainable modules did not")

        trainer.train_cfg = TrainConfig(batch_size=16)
        short_rows = dummy_rows(49, seed=1, mel_frames=(440, 510), phones=(56, 63))
        batches = run("B=16 text 128 mel 512 (plain)", short_rows, 3, zero)
        if any(b["y"].shape[1] != 512 or b["x"].shape[1] != 128 for b in batches):
            fail("the short training batches did not land at text 128 / mel 512")
    finally:
        tts_mod.maximum_path = real_mas
    return totals


def phase_train_reference():
    """One deterministic training step of a full-width, reduced-depth model
    (1 mid stage, 1 block per stage) at the 2048-frame bucket on the card
    (kernels 3, 4, 5) and on the CPU (plain attention): losses and
    trainable gradients."""
    import dataclasses

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.models import tts as tts_mod
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, collate, dummy_rows, row_to_example
    from jyutvoice_tpu_torch.train.step import batch_to_device, freeze
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    base = JyutVoiceConfig().tts
    est = dataclasses.replace(base.cfm.estimator, num_mid_blocks=1, n_blocks=1)
    cfg = dataclasses.replace(base, cfm=dataclasses.replace(base.cfm, estimator=est))
    tree = random_init.init_tts_tree(cfg, seed=2)
    dc = DataConfig(batch_size=2)
    batch = collate([row_to_example(r, dc) for r in dummy_rows(2, seed=3, mel_frames=(1500, 1900))],
                    dc)
    rng = np.random.default_rng(4)
    b, t = batch["y"].shape[:2]
    batch["decoder_h"] = rng.standard_normal(batch["y"].shape).astype(np.float32)
    batch["spk_embed"] = rng.standard_normal(batch["spk_embed"].shape).astype(np.float32)
    ov = dict(t_override=np.array([0.35, 0.8], np.float32),
              z_override=rng.standard_normal((b, t, 80)).astype(np.float32),
              cfg_keep_override=np.array([1.0, 0.0], np.float32))
    keys = ("x", "x_lengths", "y", "y_lengths", "lang", "tone", "word_pos", "syllable_pos",
            "spk_embed", "decoder_h")
    results = {}
    for device in ("cuda", "cpu"):
        model = load_jax_params(tts_mod.TTS(cfg), tree).to(device)
        names = freeze(model, cfg)
        tb = batch_to_device(batch, device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = tts_mod.compute_losses(
            model, None, *(tb[k] for k in keys), cond_prob=1.0, train_dropout=False,
            cfm_overrides={k: torch.from_numpy(v).to(device) for k, v in ov.items()},
        )
        out.total.backward()
        named = dict(model.named_parameters())
        results[device] = dict(
            losses={k: getattr(out, k).item() for k in ("dur_loss", "prior_loss", "diff_loss",
                                                        "total")},
            attn=out.attn.cpu(), grads={n: named[n].grad.cpu() for n in names},
            launches=dict(kernels.LAUNCHES), s=time.perf_counter() - t0,
        )
    card, cpu = results["cuda"], results["cpu"]
    per_call = est.num_mid_blocks + 2
    want = {"flash_stock": per_call, "flash_stock_bwd_dkv": per_call,
            "flash_stock_bwd_dq": per_call, "flash_stock_bwd_prep": per_call,
            "flash_attention": 0, "resblock_stage": 0, "f32_gemm": 0, "int8_quant_rows": 0,
            "int8_gemm": 0}
    loss_gap = {k: abs(card["losses"][k] - v) / abs(v) for k, v in cpu["losses"].items()}
    diff = sum(float(torch.sum((card["grads"][n] - g) ** 2)) for n, g in cpu["grads"].items())
    ref = sum(float(torch.sum(g ** 2)) for g in cpu["grads"].values())
    grad_gap = (diff / ref) ** 0.5
    attn_equal = torch.equal(card["attn"], cpu["attn"])
    log(f"train reference (CPU, plain attention) vs card (kernels 3/4/5): y={tuple(batch['y'].shape)} "
        f"loss rel gaps {json.dumps({k: float(f'{v:.3e}') for k, v in loss_gap.items()})} "
        f"trainable grad rel L2 gap {grad_gap:.3e} attn_equal={attn_equal} "
        f"card launches={card['launches']} (CPU {cpu['s']:.1f} s)")
    if (card["launches"] != want or not attn_equal or max(loss_gap.values()) > TRAIN_LOSS_RTOL
            or not grad_gap <= TRAIN_GRAD_RTOL):
        fail("the card's training step does not agree with the CPU")


def phase_stage(synth):
    """Kernel 2 against its plain version on every row, with the vocoder's
    stage weights: the 512-frame bucket's pair (C=128 at T=20480, C=64 at
    T=61441) at batch 1 and 2, the 15000-bucket request's windowed pair (its
    8 windows of 2112 frames: batch 8, C=128 at T=84480, C=64 at T=253441)
    and ragged T; the kernel's and the plain version's times, the 3xTF32
    tensor-core and the f32 FFMA bounds, and the kernel's recompute
    factor."""
    import torch

    from jyutvoice_tpu_torch.nn import resblock_stage as rs

    cfg = synth.cfg.hift
    ks = tuple(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    n = len(ks)
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    sums = {"512": {}, "windowed": {}}  # the B=1 512 pair and the B=8 windowed pair
    cases = [("512", 1, 20480, 1), ("512", 2, 61441, 1), ("512", 1, 20480, 2),
             ("512", 2, 61441, 2), ("windowed", 1, 84480, 8), ("windowed", 2, 253441, 8),
             # T no multiple of the tile the wrapper picks
             ("ragged", 1, 5001, 1), ("ragged", 2, 15003, 2)]
    for label, stage, t, b in cases:
        w = rs.pack_stage_weights(synth.hift.resblocks[stage * n : (stage + 1) * n], dil)
        c = synth.hift.resblocks[stage * n].convs1[0].weight.shape[0]
        prepared = rs.prepare_stage_weights(w, c, ks, dil)
        x = torch.randn(b, t, c, device="cuda", generator=g) * 0.5
        kw = dict(kernel_sizes=ks, dilations=dil)
        out = rs.resblock_stage_prepared(x, prepared)
        ref = rs.resblock_stage_plain(x, w, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = within(out, ref, STAGE_TOL)
        worst = max(worst, err)
        del out, ref
        big = b == 8
        ms = cuda_time_ms(lambda: rs.resblock_stage_prepared(x, prepared), 3 if big else 10,
                          warmup=1)
        plain_ms = cuda_time_ms(lambda: rs.resblock_stage_plain(x, w, **kw), 2 if big else 5,
                                warmup=1)
        flops = b * t * c * c * 4 * len(dil) * sum(ks)  # 252 C^2 T at (3, 7, 11), (1, 3, 5)
        io_bytes = 2 * x.numel() * 4 + w.numel() * 4
        bound_ms, bound_by = bound(io_bytes, 3 * flops, PEAK_TF32_FLOPS)  # 3 TF32 products
        bound_f32_ms, _ = bound(io_bytes, flops, PEAK_F32_FLOPS)
        tt = rs.launch_tile(t, b, c, ks, dil, x.device)
        log(f"resblock_stage {label} C={c} T={t} B={b}: max_abs_err={err:.3e} ok={ok} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (3xTF32, {bound_by}) "
            f"bound_f32_ms={bound_f32_ms:.4f} tile={tt} (T % tile = {t % tt}) "
            f"recompute={rs.recompute_factor(t, b, tt, ks, dil):.3f} "
            f"tflops={flops / ms / 1e9:.1f}")
        if not ok:
            fail(f"resblock stage disagrees with its plain version at C={c} T={t} B={b}")
        if label in sums and b in (1, 8):
            acc = sums[label]
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                             ("bound_f32_ms", bound_f32_ms)):
                acc[key] = acc.get(key, 0.0) + val
            acc["bound_by"] = bound_by
        del x
        torch.cuda.empty_cache()
    main, win = sums["512"], sums["windowed"]
    return dict(max_abs_err=worst, library_ms=None, **main,
                windowed_ms=win["ms"], windowed_plain_ms=win["plain_ms"],
                windowed_bound_ms=win["bound_ms"])


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
        and launches == {"flash_attention": want_flash, "resblock_stage": 2, "flash_stock": 0,
                         "flash_stock_bwd_dkv": 0, "flash_stock_bwd_dq": 0,
                         "flash_stock_bwd_prep": 0, "f32_gemm": 0, "int8_quant_rows": 0,
                         "int8_gemm": 0}
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
        # about 13000 frames: past 12288, so neither long-form gate applies
        # (15000 is no multiple of 128 or 512) and kernel 1 runs at T = 15000
        ("yue@15000 (top bucket, ~13000 frames)", 15000,
         dict(yue, length_scale=scale_for(synth, 13000, **yue))),
    ]
    results = {}
    for label, bucket, kw in runs:
        res, launches = run_request(synth, label, expect_bucket=bucket, n_timesteps=10, **kw)
        results[label] = res
        for k in counts:
            counts[k] += launches[k]
    return results, counts, scale


# card against CPU, the 24 kHz log-mel compared as mel energies: |mel - ref|
# <= 1e-5 (the log's clamp floor) + 1e-3 ref. A log-mel near the floor
# amplifies the f32 DFT's rounding: at mel 1e-4 a 3e-6 difference is 0.03
# in the log.
CLONE_MEL_ATOL, CLONE_MEL_RTOL = 1e-5, 1e-3
# card against CPU and batch against row: max |err| / max |ref| of spk_embed
# and prompt_h. H100 runs read 4.8e-7 to 1.1e-6 for card against CPU and up
# to 1.6e-5 for the spk_embed of batch (fbank on the card) against row
# (fbank on the host).
CLONE_REL = 1e-4
# speech tokens: every one equal, apart from those with a value within
# FSQ_EDGE of a rounding edge (+-0.5), where two runs may round apart; those
# at most 1 % of the tokens (at least 1)
FSQ_EDGE = 1e-4


def _rel(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-12))


def _mel_err(a, b):
    """(max |log-mel error|, the largest |mel - ref| / (CLONE_MEL_ATOL +
    CLONE_MEL_RTOL ref): at most 1 within the bar) of two log-mels."""
    import numpy as np

    n = min(len(a), len(b))
    a, b = a[:n].astype(np.float64), b[:n].astype(np.float64)
    ratio = np.abs(np.exp(a) - np.exp(b)) / (CLONE_MEL_ATOL + CLONE_MEL_RTOL * np.exp(b))
    return float(np.abs(a - b).max()), float(ratio.max())


def _token_check(ex, audio, sr, got, want):
    """(ok, tokens that differ, tokens at an FSQ edge): got against want,
    the edges from ex's S3 on the host whisper mel of `audio`."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch.audio.resample import resample_sinc
    from jyutvoice_tpu_torch.audio.whisper_mel import whisper_log_mel
    from jyutvoice_tpu_torch.models.s3_tokenizer import _FSQ_TANH_SCALE, apply_s3_encoder

    if got.shape != want.shape:
        return False, -1, -1
    model = ex.tokenizer.model
    mel = whisper_log_mel(resample_sinc(audio, sr, 16000)).T[None]
    with torch.inference_mode():
        h = apply_s3_encoder(model, torch.from_numpy(np.ascontiguousarray(mel)).to(ex.device))
        z = torch.tanh(model.fsq(h)) * _FSQ_TANH_SCALE
    edge = (torch.abs(torch.abs(z) - 0.5) < FSQ_EDGE).any(dim=-1)[0, : len(want)].cpu().numpy()
    differ = got != want
    ok = not (differ & ~edge).any() and differ.sum() <= max(1, int(0.01 * differ.size))
    return ok, int(differ.sum()), int(edge.sum())


def _event_ms(fn, loops=3):
    """(cold ms of the first call, median warm ms of `loops` more), CUDA
    events around each call."""
    import statistics

    import torch

    times = []
    for _ in range(1 + loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times[0], statistics.median(times[1:])


def phase_clone(synth, ref_wav24, scale, smi):
    """Voice cloning from reference audio at full width: a PromptExtractor on
    the card (seeded random flow-encoder, CAM++ and S3 trees) against the
    same on the CPU, at 24, 16 and 44.1 kHz; extract_batch with the DSP on
    the card against per-row calls; one cloned request at the 512-frame
    bucket; the components' CUDA-event times."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.audio.resample import resample_sinc
    from jyutvoice_tpu_torch.models.campplus import apply_campplus
    from jyutvoice_tpu_torch.models.flow_encoder import apply_flow_encoder
    from jyutvoice_tpu_torch.models.s3_tokenizer import apply_s3_tokenizer
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor
    from jyutvoice_tpu_torch.weights import random_init

    t0 = time.perf_counter()
    trees = dict(
        flow_encoder_params=random_init.init_flow_encoder_tree(synth.cfg.flow_encoder, seed=2),
        flow_encoder_cfg=synth.cfg.flow_encoder,
        campplus_params=random_init.init_campplus_tree(seed=3),
        tokenizer_params=random_init.init_s3_tree(seed=4),
    )
    ex = PromptExtractor(device="cuda", **trees)
    cpu = PromptExtractor(device="cpu", **trees)
    log(f"clone: full-width extractors (flow encoder, CAM++, S3; seeds 2/3/4) on cuda and cpu "
        f"in {time.perf_counter() - t0:.1f} s")
    # about 5 s of phase 6's Cantonese waveform, at 24 kHz and resampled
    wav24 = np.ascontiguousarray(ref_wav24[:120000], dtype=np.float32)
    refs = {24000: wav24, 16000: resample_sinc(wav24, 24000, 16000),
            44100: resample_sinc(wav24, 24000, 44100)}
    feats = {}
    for sr, audio in refs.items():
        kernels.reset_launch_counts()
        f = ex(audio, sr)
        if any(kernels.LAUNCHES.values()):
            fail(f"prompt extraction launched kernels: {kernels.LAUNCHES}")
        g = cpu(audio, sr)
        tok_ok, n_differ, n_edge = _token_check(cpu, audio, sr, f.speech_tokens, g.speech_tokens)
        # the flow encoder on identical tokens: the card's, on both sides
        h_cpu = cpu._encode_tokens(f.speech_tokens)[: f.prompt_h.shape[0]]
        log_err, mel_ratio = _mel_err(f.prompt_feat, g.prompt_feat)
        errs = dict(spk_embed=_rel(f.spk_embed, g.spk_embed), prompt_h=_rel(f.prompt_h, h_cpu))
        finite = all(np.isfinite(x).all() for x in (f.prompt_feat, f.prompt_h, f.spk_embed))
        log(f"clone @ {sr} Hz: prompt frames {f.prompt_feat.shape[0]} (cpu "
            f"{g.prompt_feat.shape[0]}), tokens {f.speech_tokens.shape[0]}, card/cpu tokens "
            f"that differ {n_differ} (share equal {1 - n_differ / len(g.speech_tokens):.4f}; "
            f"at an FSQ edge on the cpu: {n_edge}), prompt_feat "
            f"max_abs_err {log_err:.3e} (mel error / bar "
            f"{mel_ratio:.3f}), spk_embed rel_err {errs['spk_embed']:.3e}, prompt_h (same "
            f"tokens) rel_err {errs['prompt_h']:.3e} (bar {CLONE_REL}), finite={finite}")
        if not (finite and f.prompt_h.shape == f.prompt_feat.shape
                and f.prompt_feat.shape == g.prompt_feat.shape
                and f.spk_embed.shape == (192,) and tok_ok
                and mel_ratio <= 1.0 and errs["spk_embed"] <= CLONE_REL
                and errs["prompt_h"] <= CLONE_REL):
            fail(f"the card's prompt extraction at {sr} Hz does not agree with the CPU")
        feats[sr] = f

    # extract_batch with the DSP on the card: 4 rows of different lengths and rates
    rows = [(wav24, 24000), (refs[16000][:52000], 16000), (refs[44100][:180000], 44100),
            (wav24[:41000], 24000)]
    batch = ex.extract_batch([a for a, _ in rows], [sr for _, sr in rows], device_dsp=True)
    for i, ((audio, sr), b) in enumerate(zip(rows, batch)):
        if isinstance(b, Exception):
            fail(f"extract_batch row {i} failed: {b!r}")
        one = ex(audio, sr)
        tok_ok, n_differ, n_edge = _token_check(ex, audio, sr, b.speech_tokens,
                                                one.speech_tokens)
        h_one = ex._encode_tokens(b.speech_tokens)[: b.prompt_h.shape[0]]
        log_err, mel_ratio = _mel_err(b.prompt_feat, one.prompt_feat)
        spk_err, h_err = _rel(b.spk_embed, one.spk_embed), _rel(b.prompt_h, h_one)
        log(f"clone extract_batch(device_dsp=True) row {i} ({len(audio)} samples @ {sr} Hz) vs "
            f"__call__: prompt frames {b.prompt_feat.shape[0]}/{one.prompt_feat.shape[0]}, "
            f"tokens that differ {n_differ} (at an FSQ edge: {n_edge}), prompt_feat "
            f"max_abs_err {log_err:.3e} (mel error / "
            f"bar {mel_ratio:.3f}), spk_embed rel_err {spk_err:.3e}, prompt_h (same tokens) "
            f"rel_err {h_err:.3e}")
        if not (tok_ok and b.prompt_feat.shape == one.prompt_feat.shape
                and mel_ratio <= 1.0
                and spk_err <= CLONE_REL and h_err <= CLONE_REL):
            fail(f"extract_batch row {i} does not agree with __call__")

    # one cloned request at the 512-frame bucket (launches counted by run_request)
    f = feats[24000]
    _, launches = run_request(
        synth, f"yue cloned from {f.prompt_feat.shape[0]} prompt frames @512", expect_bucket=512,
        n_timesteps=10, text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3",
        length_scale=scale, spk_embed=f.spk_embed, prompt_feat=f.prompt_feat,
        prompt_h=f.prompt_h)

    # CUDA-event times of the components, cold (first call) and warm
    with torch.inference_mode():
        dev = torch.device("cuda")
        pad = (ex.mel.n_fft - ex.mel.hop) // 2
        w24 = torch.from_numpy(np.pad(wav24, (pad, pad), mode="reflect")[None]).to(dev)
        w16 = torch.from_numpy(np.pad(refs[16000], (200, 200), mode="reflect")[None]).to(dev)
        len16 = torch.tensor([len(refs[16000])], device=dev)
        tok = torch.from_numpy(f.speech_tokens[None].astype(np.int64)).to(dev)
        n_tok = torch.tensor([tok.shape[1]], device=dev)
        comps = {
            "24 kHz mel": lambda: ex.mel.from_padded(w24),
            "fbank + CAM++": lambda: apply_campplus(
                ex.embedder.model, *ex._batch_dsp(w16, len16, True, False)[:2]),
            "whisper mel + S3": lambda: apply_s3_tokenizer(
                ex.tokenizer.model, *ex._batch_dsp(w16, len16, False, True)[2:]),
            "flow encoder": lambda: apply_flow_encoder(ex.flow_encoder, tok, n_tok,
                                                       exact_pad=True),
        }
        times = {name: _event_ms(fn) for name, fn in comps.items()}
    times["whole extraction (24 kHz input, host work included)"] = _event_ms(
        lambda: ex(wav24, 24000))
    log(f"clone component times ({smi}), {f.prompt_feat.shape[0]} prompt frames, "
        f"{tok.shape[1]} tokens, cold / warm ms: "
        + ", ".join(f"{k} {c:.2f} / {w:.2f}" for k, (c, w) in times.items()))
    return launches, f, trees, wav24


STREAM_REL = 1e-4  # multi against single, token encoder against whole: of max |ref|


def phase_stream_kernels(synth, smi):
    """Kernels 1 and 2 at the streaming shapes (chunk 100: seg 134, vocoder
    segment 168 frames): kernel 1 against its plain version at B=2 (one
    stream) and B=8 (four sessions, a free slot of length 0 in both CFG
    halves), full and 50-frame chunk masks, and at T=84 (chunk 50), timed
    at T=134 beside SDPA and the plain version; kernel 2 at the stream's
    pair (C=128 T=6720, C=64 T=20161) at batch 1 and 4 with the vocoder's
    stage weights, beside its plain version and bound. CUDA-event medians of
    3 loops."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn import resblock_stage as rs
    from jyutvoice_tpu_torch.nn.flash_attention import (
        flash_attention,
        flash_attention_plain,
        key_keep_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    h, d = 8, 64
    free = [134, 100, 0, 57, 134, 100, 0, 57]
    cases = [(134, [134, 134], 0), (134, [100, 100], 0), (134, free, 0), (134, free, 50),
             (84, [84, 40], 50), (84, [84, 0, 40, 84, 84, 0, 40, 84], 50)]
    worst, timed = 0.0, {}
    for t, lens, chunk in cases:
        b = len(lens)
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, chunk_size=chunk, num_left_chunks=-1)
        out = flash_attention(q, k, v, lengths, **kw)
        ref = flash_attention_plain(q, k, v, lengths, **kw)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(out).all())
        err = 0.0
        for i, n in enumerate(lens):
            if n:
                err = max(err, float((out[i, :n] - ref[i, :n]).abs().max()))
                ok &= within(out[i, :n], ref[i, :n], ATTN_TOL)
            else:  # a free slot: every query row sees no key and comes out 0
                ok &= bool(torch.all(out[i] == 0))
        worst = max(worst, err)
        extra = ""
        if t == 134 and chunk == 0 and lens[0] == 134:
            ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 200)
            plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, lengths, **kw), 20)
            keep = key_keep_mask(lengths, t, chunk, -1)
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, scale=kw["scale"]), 200)
            pairs = int(keep.expand(-1, -1, t, -1).sum()) * h
            bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
            dev_ms = graph_time_ms(lambda: flash_attention(q, k, v, lengths, **kw))
            timed[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                            device_ms=dev_ms)
            extra = (f" ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                     f"sdpa_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        log(f"stream flash T={t} B={b} lengths={lens} chunk={chunk}/-1: "
            f"max_abs_err={err:.3e} ok={ok}{extra} ({smi})")
        if not ok:
            fail(f"flash attention disagrees with its plain version at the streaming shape "
                 f"T={t} lengths={lens} chunk={chunk}")
        if t == 134 and chunk == 0 and lens == free:
            # the same lane timed as the multi-session tick runs it
            ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 200)
            keep = key_keep_mask(lengths, t, 0, -1)
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, scale=kw["scale"]), 200)
            dev_ms = graph_time_ms(lambda: flash_attention(q, k, v, lengths, **kw))
            log(f"stream flash T=134 B=8 (multi-session lane, free slot): ms={ms:.4f} "
                f"device_ms={dev_ms:.4f} sdpa_ms={lib_ms:.4f} (SDPA's length-0 rows are NaN: "
                f"timed only) ({smi})")
            timed[8] = dict(ms=ms, library_ms=lib_ms, device_ms=dev_ms)

    cfg = synth.cfg.hift
    ks = tuple(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    n = len(ks)
    pair, stage_worst = {}, 0.0
    for b in (1, 4):
        acc = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for stage, t in ((1, 6720), (2, 20161)):
            w = rs.pack_stage_weights(synth.hift.resblocks[stage * n : (stage + 1) * n], dil)
            c = synth.hift.resblocks[stage * n].convs1[0].weight.shape[0]
            prepared = rs.prepare_stage_weights(w, c, ks, dil)
            x = torch.randn(b, t, c, device="cuda", generator=g) * 0.5
            out = rs.resblock_stage_prepared(x, prepared)
            ref = rs.resblock_stage_plain(x, w, kernel_sizes=ks, dilations=dil)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = within(out, ref, STAGE_TOL)
            stage_worst = max(stage_worst, err)
            ms = cuda_time_ms(lambda: rs.resblock_stage_prepared(x, prepared), 20)
            plain_ms = cuda_time_ms(
                lambda: rs.resblock_stage_plain(x, w, kernel_sizes=ks, dilations=dil), 5)
            flops = b * t * c * c * 4 * len(dil) * sum(ks)
            bound_ms, bound_by = bound(2 * x.numel() * 4 + w.numel() * 4, 3 * flops,
                                       PEAK_TF32_FLOPS)
            log(f"stream resblock_stage C={c} T={t} B={b}: max_abs_err={err:.3e} "
                f"ok={ok} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                f"(3xTF32, {bound_by}) ({smi})")
            if not ok:
                fail(f"resblock stage disagrees with its plain version at the streaming "
                     f"shape C={c} T={t} B={b}")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                acc[key] += val
        pair[b] = acc
        log(f"stream resblock_stage pair B={b}: ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.4f} ({smi})")
    return worst, stage_worst, timed, pair


def _stream_chunks(gen, est):
    """Drive a chunk generator: per chunk its host ms (fenced) and launches;
    fails unless each chunk launched kernel 1 `est` times and kernel 2
    twice. Returns (chunks, per-chunk ms); the first includes everything
    before the first chunk (the text half)."""
    import torch

    from jyutvoice_tpu_torch import kernels

    chunks, ms = [], []
    t = time.perf_counter()
    while True:
        kernels.reset_launch_counts()
        try:
            chunk = next(gen)
        except StopIteration:
            break
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms.append((now - t) * 1e3)
        t = now
        launches = dict(kernels.LAUNCHES)
        if launches["flash_attention"] != est or launches["resblock_stage"] != 2 or any(
                v for k, v in launches.items() if k not in ("flash_attention", "resblock_stage")):
            fail(f"stream chunk {len(chunks)} launched {launches} (want flash_attention {est}, "
                 "resblock_stage 2)")
        chunks.append(chunk)
    return chunks, ms


def phase_stream(synth, scale, clone_feats, trees, wav24, params_tts, params_hift, smi):
    """The streaming path at full width, 10 steps, chunk 100: synthesize_
    streaming on the 512-bucket text (unprompted, cold then warm; with the
    estimator's 50-frame chunk masks; prompted with phase 6b's 250-frame
    prompt, capacity 256, "plain" attention), each chunk's launches checked
    (560 kernel-1 and 2 kernel-2 launches unprompted, no kernel 1
    prompted); a 3-chunk stream against the CPU; MultiStreamSynthesizer
    with 4 sessions of different lengths (unprompted lane, and a prompted
    lane mixing cloned and plain sessions) against single streams;
    PromptExtractor(streaming_encoder=True) and StreamingTokenEncoder on
    phase 6b's tokens against the whole streaming flow encoder; cli.infer
    --stream on its default device. Returns the launches of its main-path
    runs."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.cli import infer
    from jyutvoice_tpu_torch.models.flow_encoder import apply_flow_encoder
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor
    from jyutvoice_tpu_torch.pipeline.streaming import (
        MultiStreamSynthesizer,
        StreamingSynthesizer,
        StreamingTokenEncoder,
    )

    est_cfg = synth.cfg.tts.cfm.estimator
    per_chunk = 10 * (est_cfg.num_mid_blocks + 2) * est_cfg.n_blocks
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    counts = {"flash_attention": 0, "resblock_stage": 0}
    pf, ph, spk_embed = clone_feats.prompt_feat, clone_feats.prompt_h, clone_feats.spk_embed
    runs = [("unprompted (cold)", {}, per_chunk), ("unprompted", {}, per_chunk),
            ("chunk masks", dict(estimator_chunk_masks=True), per_chunk),
            (f"prompted ({pf.shape[0]}-frame prompt, capacity 256)",
             dict(prompt_feat=pf, prompt_h=ph, spk_embed=spk_embed), 0)]
    mu_y, c, y_len = synth.prepare_stream(**yue, length_scale=scale)
    for label, kw, want_k1 in runs:
        t0 = time.perf_counter()
        gen = synth.synthesize_streaming(**yue, length_scale=scale, chunk_frames=100,
                                         n_timesteps=10, **kw)
        chunks, ms = _stream_chunks(gen, want_k1)
        total_s = time.perf_counter() - t0
        wav = np.concatenate(chunks)
        audio_s = len(wav) / 24000
        ok = np.isfinite(wav).all() and wav.shape == (y_len * 480,)
        log(f"stream {label}: {len(chunks)} chunks, {y_len} frames, wav {wav.shape[0]} samples, "
            f"first chunk {ms[0]:.1f} ms, per chunk median {np.median(ms):.1f} ms "
            f"(all: {', '.join(f'{m:.1f}' for m in ms)}), total {total_s * 1e3:.1f} ms, "
            f"rtf {total_s / audio_s:.4f}, launches per chunk flash_attention {want_k1} "
            f"resblock_stage 2, finite={bool(np.isfinite(wav).all())} ({smi})")
        if not ok:
            fail(f"stream {label} failed its checks")
        counts["flash_attention"] += want_k1 * len(chunks)
        counts["resblock_stage"] += 2 * len(chunks)

    # a 3-chunk stream on the card against the same on the CPU (plain versions)
    mu3 = mu_y[:250]
    spk0 = np.asarray(c, np.float32)
    card_ss = synth._streams[(100, 0, 10, False)]
    cpu_ss = StreamingSynthesizer(synth.cfg, params_tts, params_hift, chunk_frames=100,
                                  n_timesteps=10, device="cpu")
    t = time.perf_counter()
    want = list(cpu_ss.stream(mu3, spk0, emit_mel=True))
    cpu_s = time.perf_counter() - t
    kernels.reset_launch_counts()
    got = list(card_ss.stream(mu3, spk0, emit_mel=True))
    if kernels.LAUNCHES["flash_attention"] != 3 * per_chunk:
        fail(f"the 3-chunk card stream launched {kernels.LAUNCHES}")
    maes = [float(np.abs(m - r).mean()) for (_, m), (_, r) in zip(got, want)]
    same = [w.shape for w, _ in got] == [w.shape for w, _ in want] and len(got) == 3
    wav_err = max(float(np.abs(w - r).max()) for (w, _), (r, _) in zip(got, want)) if same else -1
    log(f"stream reference (CPU, plain versions) vs card, 3 chunks of {mu3.shape[0]} frames: "
        f"chunk lengths equal={same}, mel MAE per chunk {', '.join(f'{m:.3e}' for m in maes)}, "
        f"wav max_abs_err {wav_err:.3e} (CPU {cpu_s:.1f} s)")
    if not same or not max(maes) < 1e-2:
        fail("the card's stream does not agree with the CPU")

    # the multi-session lanes: 4 sessions of different lengths, one dispatch a tick
    lens = (y_len, 350, 230, 130)
    rng = np.random.default_rng(3)
    embeds = [rng.standard_normal(192).astype(np.float32) for _ in range(3)]
    spks = [spk0] + [synth.prepare_stream(**yue, length_scale=scale, spk_embed=e)[1]
                     for e in embeds]
    prompted_ss = synth._streams[(100, 256, 10, False)]
    lanes = [("unprompted", 0, [(mu_y[:n], s) for n, s in zip(lens, spks)], card_ss),
             ("prompted (2 cloned, 2 plain)", 256,
              [(mu_y[:n], s, pf, ph) if i % 2 == 0 else (mu_y[:n], s)
               for i, (n, s) in enumerate(zip(lens, spks))], prompted_ss)]
    for label, p_cap, reqs, single_ss in lanes:
        ms_ = MultiStreamSynthesizer(synth.cfg, synth.tts, synth.hift, max_sessions=4,
                                     chunk_frames=100, prompt_frames=p_cap, n_timesteps=10)
        want_k1 = 0 if p_cap else per_chunk
        sid_to_idx = {ms_.open(*req): i for i, req in enumerate(reqs)}
        out = {i: [] for i in range(len(reqs))}
        tick_ms, n_dispatch = [], 0
        torch.cuda.synchronize()
        t0 = t = time.perf_counter()
        while ms_.active or ms_._pending is not None:
            kernels.reset_launch_counts()
            chunks, _ = ms_.tick()
            launches = dict(kernels.LAUNCHES)
            if launches["resblock_stage"]:
                n_dispatch += 1
                if launches["flash_attention"] != want_k1 or launches["resblock_stage"] != 2:
                    fail(f"multi-session tick ({label}) launched {launches}")
            now = time.perf_counter()
            tick_ms.append((now - t) * 1e3)
            t = now
            for sid, w in chunks.items():
                out[sid_to_idx[sid]].append(w)
        wall = time.perf_counter() - t0
        counts["flash_attention"] += want_k1 * n_dispatch
        counts["resblock_stage"] += 2 * n_dispatch
        worst = 0.0
        audio_s = 0.0
        for i, req in enumerate(reqs):
            got_w = np.concatenate(out[i])
            ref_w = np.concatenate(list(single_ss.stream(*req)))
            if got_w.shape != ref_w.shape:
                fail(f"multi-session {label} session {i}: {got_w.shape} vs {ref_w.shape}")
            worst = max(worst, float(np.abs(got_w - ref_w).max() / np.abs(ref_w).max()))
            audio_s += len(got_w) / 24000
        log(f"stream multi-session {label}: 4 sessions of {lens} frames, {n_dispatch} "
            f"dispatches, tick ms median {np.median(tick_ms):.1f} (all: "
            f"{', '.join(f'{m:.1f}' for m in tick_ms)}), wall {wall * 1e3:.1f} ms for "
            f"{audio_s:.2f} s of audio, aggregate rtf {wall / audio_s:.4f}, launches per "
            f"dispatch flash_attention {want_k1} resblock_stage 2; multi vs single max |err| / "
            f"max |ref| {worst:.3e} (bar {STREAM_REL}) ({smi})")
        if not worst <= STREAM_REL:
            fail(f"the multi-session lane ({label}) does not agree with single streams")

    # the KV-cached token encoder: PromptExtractor(streaming_encoder=True) and
    # StreamingTokenEncoder on phase 6b's tokens against the whole streaming forward
    ex = PromptExtractor(device="cuda", streaming_encoder=True, **trees)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    f = ex(wav24, 24000)
    ex_s = time.perf_counter() - t
    if any(kernels.LAUNCHES.values()):
        fail(f"the streaming-encoder extraction launched kernels: {kernels.LAUNCHES}")
    tokens = f.speech_tokens
    with torch.inference_mode():
        whole, _ = apply_flow_encoder(
            ex.flow_encoder, torch.from_numpy(tokens[None].astype(np.int64)).cuda(),
            torch.tensor([len(tokens)], device="cuda"), streaming=True)
    whole = whole[0].cpu().numpy()
    enc = StreamingTokenEncoder(ex.flow_encoder, t_max_tokens=1024)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pieces = [enc.push(tokens[i : i + 7]) for i in range(0, len(tokens), 7)] + [enc.flush()]
    enc_s = time.perf_counter() - t
    h = np.concatenate(pieces)
    err_enc = _rel(h, whole[: len(h)])
    err_ex = _rel(f.prompt_h, whole[: f.prompt_h.shape[0]])
    log(f"stream token encoder: {len(tokens)} tokens in pieces of 7 -> {h.shape[0]} frames "
        f"in {enc_s * 1e3:.1f} ms ({-(-len(tokens) // enc.chunk)} chunks of {enc.chunk}); "
        f"vs the whole streaming forward max |err| / max |ref| {err_enc:.3e}; "
        f"PromptExtractor(streaming_encoder=True) prompt_h {err_ex:.3e} "
        f"(extraction {ex_s * 1e3:.1f} ms) (bar {STREAM_REL}) ({smi})")
    if (h.shape != (2 * len(tokens), 80) or not err_enc <= STREAM_REL
            or not err_ex <= STREAM_REL):
        fail("the streaming token encoder does not agree with the whole streaming forward")

    # the CLI on its default device
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wav = infer.main(["--text", "佢 係 邊 個", "--phone", "keoi5 hai6 bin1 go3", "--stream",
                          "--length-scale", str(scale), "--output",
                          os.path.join(tmp, "stream.wav")], cfg=synth.cfg)
    cli_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n_chunks = launches["resblock_stage"] // 2
    log(f"stream cli.infer --stream (default device): {len(wav)} samples in {n_chunks} chunks, "
        f"{cli_s:.1f} s with the model's set-up, launches {launches}")
    if (not np.isfinite(wav).all() or n_chunks != 5 or wav.shape != (y_len * 480,)
            or launches["flash_attention"] != per_chunk * n_chunks):
        fail("cli.infer --stream failed its checks")
    counts["flash_attention"] += launches["flash_attention"]
    counts["resblock_stage"] += launches["resblock_stage"]
    return counts


def _cfg_rows(lens):
    """A serving batch's rows as the CFG solve has them: the conditional
    half, then the unconditional half repeating it."""
    return list(lens) + list(lens)


def _repeated_rows(lens, *xs):
    """(i, j) for every row i whose length and inputs equal those of an
    earlier row j bit for bit (j the first such row)."""
    pairs = []
    for i in range(1, len(lens)):
        for j in range(i):
            if lens[j] == lens[i] and all(bool((x[i] == x[j]).all()) for x in xs):
                pairs.append((i, j))
                break
    return pairs


def _serve_flash_case(label, q, k, v, lengths, smi, scale=0.125, chunk_size=0,
                      num_left_chunks=-1, want_repeats=0):
    """Kernel 1 on one serving batch against its plain version on the valid
    rows; a row whose inputs repeat an earlier row's must come out equal to
    it bit for bit (at least `want_repeats` such rows). Times by CUDA events
    and CUDA-graph device time beside SDPA, the plain version and the bound.
    Returns (max |err|, times)."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn.flash_attention import (
        flash_attention,
        flash_attention_plain,
        key_keep_mask,
    )

    b, t, h, d = q.shape
    lens = lengths.tolist()
    kw = dict(scale=scale, chunk_size=chunk_size, num_left_chunks=num_left_chunks)
    out = flash_attention(q, k, v, lengths, **kw)
    ref = flash_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for i, n in enumerate(lens):
        err = max(err, float((out[i, :n] - ref[i, :n]).abs().max()) if n else 0.0)
        ok &= within(out[i, :n], ref[i, :n], ATTN_TOL)
    repeats = _repeated_rows(lens, q, k, v)
    same = all(torch.equal(out[i], out[j]) for i, j in repeats)
    del out, ref
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 200)
    dev_ms = graph_time_ms(lambda: flash_attention(q, k, v, lengths, **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, lengths, **kw), 10)
    keep = key_keep_mask(lengths, t, chunk_size, num_left_chunks)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, scale=scale), 200)
    pairs = int(keep.expand(-1, -1, t, -1).sum()) * h
    bound_ms, bound_by = bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS)
    log(f"serve flash {label} B={b} T={t} lengths={lens}: max_abs_err={err:.3e} ok={ok} "
        f"(rows repeating an earlier row {repeats}, outputs equal: {same}) "
        f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) ({smi})")
    if not ok or not same or len(repeats) < want_repeats:
        fail(f"flash attention disagrees with its plain version at the serving shape "
             f"{label} B={b} T={t} lengths={lens} (or a repeated row differs)")
    return err, dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms)


def _stage_weights(synth, c):
    """The plain weights of the vocoder stage with c channels."""
    from jyutvoice_tpu_torch.nn import resblock_stage as rs

    cfg = synth.cfg.hift
    n = len(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    for st in range(len(synth.hift.resblocks) // n):
        if synth.hift.resblocks[st * n].convs1[0].weight.shape[0] == c:
            return rs.pack_stage_weights(synth.hift.resblocks[st * n : (st + 1) * n], dil)
    fail(f"the vocoder has no {c}-channel stage")


def _serve_stage_case(label, x, prepared, w, synth, smi):
    """Kernel 2 on one whole-bucket decode against its plain version on
    every row, beside its plain version's time and the 3xTF32 bound.
    Returns (max |err|, times)."""
    import torch

    from jyutvoice_tpu_torch.nn import resblock_stage as rs

    ks = tuple(synth.cfg.hift.resblock_kernel_sizes)
    dil = tuple(synth.cfg.hift.resblock_dilation_sizes[0])
    b, t, c = x.shape
    out = rs.resblock_stage_prepared(x, prepared)
    ref = rs.resblock_stage_plain(x, w, kernel_sizes=ks, dilations=dil)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = within(out, ref, STAGE_TOL)
    del out, ref
    ms = cuda_time_ms(lambda: rs.resblock_stage_prepared(x, prepared), 5, warmup=1)
    plain_ms = cuda_time_ms(
        lambda: rs.resblock_stage_plain(x, w, kernel_sizes=ks, dilations=dil), 2, warmup=1)
    flops = b * t * c * c * 4 * len(dil) * sum(ks)
    bound_ms, bound_by = bound(2 * x.numel() * 4 + w.numel() * 4, 3 * flops, PEAK_TF32_FLOPS)
    log(f"serve resblock_stage {label} C={c} T={t} B={b}: max_abs_err={err:.3e} ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
        f"(3xTF32, {bound_by}) ({smi})")
    if not ok:
        fail(f"resblock stage disagrees with its plain version at the serving shape "
             f"{label} C={c} T={t} B={b}")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def _add_stage(pairs, key, times):
    """Adds one stage's times to its bucket pair's sums in pairs[key]."""
    acc = pairs.setdefault(key, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0))
    for name in acc:
        acc[name] += times[name]


def _log_pairs(pairs, note, smi):
    for key, acc in pairs.items():
        log(f"serve resblock_stage {key}{note}: ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.4f} ({smi})")


def phase_serve_kernels(synth, smi):
    """Kernels 1 and 2 at the serving shapes. Kernel 1 at B = 2 b_pad (b_pad
    8 and 4), H=8, D=64, T=512 and 1024, a different valid length on every
    request row, the unconditional half repeating the conditional one, and
    the last request row of each half a padding row repeating row 0 (its
    output must equal row 0's); and a mixed group of cloned and plain rows
    at T = 64 + 512 (a 64-frame prompt bucket). Each against its plain
    version on the valid rows, timed by CUDA events and by CUDA-graph device
    time beside SDPA, the plain version and the bound. Kernel 2 at the 512
    pair (C=128 T=20480, C=64 T=61441) at batch 4 and 8 and the 1024 pair
    (C=128 T=40960, C=64 T=122881) at batch 8, whole-bucket decodes, with
    the vocoder's stage weights, against its plain version on every row,
    beside its plain version's time and the 3xTF32 bound. CUDA-event
    medians of 3 loops."""
    import torch

    from jyutvoice_tpu_torch.nn import resblock_stage as rs

    g = torch.Generator(device="cuda").manual_seed(9)
    h, d = 8, 64
    cases = [  # (key, T, per-row lengths)
        ("b16_t512", 512, _cfg_rows([512, 301, 488, 97, 460, 233, 412, 512])),
        ("b16_t1024", 1024, _cfg_rows([1000, 611, 1024, 38, 777, 950, 402, 1000])),
        ("b8_t512", 512, _cfg_rows([480, 129, 350, 480])),
        ("b8_t1024", 1024, _cfg_rows([1024, 700, 222, 1024])),
        # cloned rows 40 + mel, a plain row 0 + mel, in a 64 + 512 segment
        ("b8_t576_mixed", 576, _cfg_rows([40 + 500, 311, 64 + 512, 40 + 500])),
    ]
    worst, flash = 0.0, {}
    for key, t, lens in cases:
        b = len(lens)
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g) for _ in range(3))
        pad = b // 2 - 1
        for a in (q, k, v):
            a[pad], a[b - 1] = a[0], a[b // 2]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        err, flash[key] = _serve_flash_case(key, q, k, v, lengths, smi, want_repeats=2)
        worst = max(worst, err)
        del q, k, v
    torch.cuda.empty_cache()

    cfg = synth.cfg.hift
    ks = tuple(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    stage, stage_worst = {}, 0.0
    for key, t_mel, b in (("pair512_b4", 512, 4), ("pair512_b8", 512, 8),
                          ("pair1024_b8", 1024, 8)):
        for c, t in ((128, 40 * t_mel), (64, 120 * t_mel + 1)):
            w = _stage_weights(synth, c)
            prepared = rs.prepare_stage_weights(w, c, ks, dil)
            x = torch.randn(b, t, c, device="cuda", generator=g) * 0.5
            err, times = _serve_stage_case(key, x, prepared, w, synth, smi)
            stage_worst = max(stage_worst, err)
            _add_stage(stage, key, times)
            del x
            torch.cuda.empty_cache()
    _log_pairs(stage, "", smi)
    return worst, stage_worst, flash, stage


@contextlib.contextmanager
def serving_kernel_inputs(into, label):
    """Keeps, in `into`, a copy on the device of the first input that the
    serving path hands kernel 1 and kernel 2 at each shape not seen yet,
    with `label` and the call's options, for phase 6g to hold the kernels
    to. The copies are enqueued on the calling thread's stream (no sync)."""
    from jyutvoice_tpu_torch.models import hift
    from jyutvoice_tpu_torch.nn import attention

    real_flash, real_stage = attention.flash_attention, hift.resblock_stage_prepared

    def flash_probe(q, k, v, lengths, **kw):
        key = ("flash_attention", tuple(q.shape))
        if key not in into:
            into[key] = dict(label=label, inputs=[a.clone() for a in (q, k, v, lengths)],
                             kw=kw)
        return real_flash(q, k, v, lengths, **kw)

    def stage_probe(x, prepared):
        key = ("resblock_stage", tuple(x.shape))
        if key not in into:
            into[key] = dict(label=label, inputs=[x.clone()], prepared=prepared)
        return real_stage(x, prepared)

    attention.flash_attention, hift.resblock_stage_prepared = flash_probe, stage_probe
    try:
        yield into
    finally:
        attention.flash_attention, hift.resblock_stage_prepared = real_flash, real_stage


def phase_serve_path_kernels(synth, captured, smi, phase="6f"):
    """Kernels 1 and 2 on the inputs that phase 6f's engine groups (or
    another phase's requests) handed them (`serving_kernel_inputs`): the
    first call at each shape, with the lengths, padding rows, prompt rows and
    stage weights the batch path made. Kernel 1 against its plain version on
    the valid rows (a row that repeats an earlier one must equal it bit for
    bit), kernel 2 on every row, timed as in phase 6e. Returns (kernel 1's
    max |err|, kernel 2's, kernel 1's times, kernel 2's pair times), keyed by
    batch and bucket."""
    import torch

    torch.cuda.synchronize()
    flash_keys = sorted(k for k in captured if k[0] == "flash_attention")
    stage_keys = sorted(k for k in captured if k[0] == "resblock_stage")
    if not flash_keys or not stage_keys:
        fail(f"phase {phase} handed no input to kernel 1 or kernel 2: {sorted(captured)}")
    worst, flash = 0.0, {}
    for key in flash_keys:
        case = captured.pop(key)
        b, t = key[1][:2]
        err, flash[f"b{b}_t{t}"] = _serve_flash_case(
            f"({case['label']})", *case["inputs"], smi, **case["kw"])
        worst = max(worst, err)
        del case
    torch.cuda.empty_cache()
    stage_worst, stage = 0.0, {}
    for key in stage_keys:
        case = captured.pop(key)
        b, t, c = key[1]
        name = f"pair{t // 40 if c == 128 else (t - 1) // 120}_b{b}"
        err, times = _serve_stage_case(f"{name} ({case['label']})", case["inputs"][0],
                                       case["prepared"], _stage_weights(synth, c), synth, smi)
        stage_worst = max(stage_worst, err)
        _add_stage(stage, name, times)
        del case
        torch.cuda.empty_cache()
    _log_pairs(stage, f" (phase {phase}'s inputs)", smi)
    return worst, stage_worst, flash, stage


SERVE_ITEMS = [  # 8 short Cantonese requests (one text partition), two with a speaker
    dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3"),
    dict(text="你 好", lang="yue", phone="nei5 hou2"),
    dict(text="我 哋 去", lang="yue", phone="ngo5 dei6 heoi3"),
    dict(text="好", lang="yue", phone="hou2"),
    dict(text="今 日 天 氣 好", lang="yue", phone="gam1 jat6 tin1 hei3 hou2"),
    dict(text="多 謝 晒", lang="yue", phone="do1 ze6 saai3"),
    dict(text="早 晨", lang="yue", phone="zou2 san4"),
    dict(text="食 咗 飯 未", lang="yue", phone="sik6 zo2 faan6 mei6"),
]
# 77 tokens (text bucket 96): past twice the short ones' 32, so a group with
# both dispatches twice. About 1270 frames: the 1536 mel bucket, below the
# 2048 where the estimator turns to banded attention (no kernel 1)
SERVE_LONGER = dict(text="佢 係 邊 個 今 日 天 氣 好 多 謝 晒 食", lang="yue",
                    phone="keoi5 hai6 bin1 go3 gam1 jat6 tin1 hei3 hou2 do1 ze6 saai3 sik6")


def _serve_group(engine, items, direct, label, want_dispatches, smi, capture=None):
    """Submit `items` at once, wait for every result, and hold each against
    the direct request in `direct` (a SynthesisResult of synthesize(...,
    pcm16=True)): mel frames equal, mel MAE < 1e-2; the largest waveform gap
    is printed in PCM16 steps. Fails unless the group was one batch of
    `want_dispatches` dispatches of 560 kernel-1 and 2 kernel-2 launches
    each, and on an int8 decoder a launch of each int8 linear kernel per
    QuantLinear and step. With a dict `capture`, kernels 1 and 2's inputs at shapes not seen
    yet go into it (`serving_kernel_inputs`). Returns (launches, wall s,
    audio s)."""
    import numpy as np

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.nn.quant import QuantLinear

    est = engine.synth.cfg.tts.cfm.estimator
    per_dispatch = engine.n_timesteps * (est.num_mid_blocks + 2) * est.n_blocks
    int8_per_dispatch = engine.n_timesteps * sum(
        isinstance(m, QuantLinear) for m in engine.synth.tts.modules())
    d0, b0 = engine.stats.dispatches, engine.stats.batches
    kernels.reset_launch_counts()
    with (contextlib.nullcontext() if capture is None
          else serving_kernel_inputs(capture, label)):
        t0 = time.perf_counter()
        futs = [engine.submit(**it) for it in items]
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    dispatches, batches = engine.stats.dispatches - d0, engine.stats.batches - b0
    maes, gaps = [], []
    for r, want in zip(res, direct):
        if r.mel_frames != want.mel_frames or r.wav.dtype != np.int16 \
                or r.wav.shape != want.wav.shape:
            fail(f"serve {label}: {r.mel_frames} frames {r.wav.dtype} {r.wav.shape} against "
                 f"{want.mel_frames} frames {want.wav.shape}")
        maes.append(float(np.abs(r.mel - want.mel).mean()))
        gaps.append(float(np.abs(r.wav.astype(np.float64) - want.wav * 32767.0).max()))
    audio_s = sum(r.mel_frames for r in res) * 480 / 24000
    want_launches = {k: 0 for k in launches}
    want_launches.update(flash_attention=per_dispatch * want_dispatches,
                         resblock_stage=2 * want_dispatches,
                         int8_quant_rows=int8_per_dispatch * want_dispatches,
                         int8_gemm=int8_per_dispatch * want_dispatches)
    log(f"serve engine {label}: {len(items)} requests, {batches} batch, {dispatches} dispatches, "
        f"frames {[r.mel_frames for r in res]}, wall {wall * 1e3:.1f} ms for {audio_s:.2f} s "
        f"of audio, aggregate rtf {wall / audio_s:.4f}; vs direct synthesize: mel MAE max "
        f"{max(maes):.3e}, waveform gap max {max(gaps):.0f} PCM16 steps; launches {launches} "
        f"({smi})")
    if (batches != 1 or dispatches != want_dispatches or launches != want_launches
            or not max(maes) < 1e-2):
        fail(f"serve engine {label} failed its checks (want {want_dispatches} dispatches in one "
             f"batch, launches {want_launches}, mel MAE < 1e-2)")
    return launches, wall, audio_s


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(port, path, body=None, timeout=600):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _wav_pcm(data):
    import wave
    from io import BytesIO

    import numpy as np

    with wave.open(BytesIO(data), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


def phase_serve(synth, scale, clone_feats, clone_trees, clone_wav, smi):
    """Serving at full width, 10 steps, PCM16 as TTSServer serves it.
    Engine (max_batch 8, 200 ms window): 8 requests that coalesce into one
    b_pad-8 dispatch (cold, then warm), 3 (b_pad 4), 3 plain and one cloned
    with phase 6b's 250-frame prompt, and a group spanning two text
    partitions (two dispatches); each result against direct synthesize of
    the same item, the group's wall time against the 8 requests one by one;
    a long-form request through the engine's long route (exact attention,
    kernel 3) against synthesize_long. Lane: 4 streams against single
    synthesize_streaming streams (1e-4 of max |ref|). HTTP: TTSServer with a
    streaming lane and phase 6b's extractor: /healthz names the card, 4
    concurrent /tts coalesce and match the engine within 1 PCM16 step, one
    /tts/stream, one ref_audio_b64 request twice (one extraction). CLI:
    `python -m jyutvoice_tpu_torch.cli.serve --random-init --streaming
    --warmup` on its default device answers /healthz and /tts, then drains on
    SIGTERM with exit code 0. Returns the launches of the runs in this
    process."""
    import base64
    import re
    import signal
    import threading

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.pipeline.http_server import TTSServer, wav_bytes
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine, StreamingLane

    counts = {k: 0 for k in kernels.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    def counted(fn, *args, **kw):
        kernels.reset_launch_counts()
        out = fn(*args, **kw)
        add(kernels.LAUNCHES)
        return out

    rng = np.random.default_rng(5)
    items = [dict(it) for it in SERVE_ITEMS]
    for i in (1, 5):
        items[i]["spk_embed"] = rng.standard_normal(192).astype(np.float32)
    cloned = dict(text="早 晨", lang="yue", phone="zou2 san4",
                  spk_embed=clone_feats.spk_embed, prompt_feat=clone_feats.prompt_feat,
                  prompt_h=clone_feats.prompt_h)

    def direct(it):
        return synth.synthesize(**it, n_timesteps=10, length_scale=scale, pcm16=True)

    # the 8 requests one by one (warm b=1 shapes: phase 6 ran them)
    t0 = time.perf_counter()
    singles = counted(lambda: [direct(it) for it in items])
    single_s = time.perf_counter() - t0
    audio_s = sum(r.mel_frames for r in singles) * 480 / 24000
    log(f"serve one by one: 8 synthesize calls in {single_s * 1e3:.1f} ms for {audio_s:.2f} s "
        f"of audio, rtf {single_s / audio_s:.4f}, per request ms "
        f"{[round(r.timings['total'] * 1e3, 1) for r in singles]} ({smi})")

    # kernels 1 and 2's inputs in every group but the timed warm one
    captured = {}
    with ServingEngine(synth, max_batch=8, max_wait_ms=200.0, n_timesteps=10,
                       length_scale=scale, pcm16=True, return_mel=True) as engine:
        for label, capture in (("8 requests, b_pad 8 (cold)", captured),
                               ("8 requests, b_pad 8", None)):
            launches, wall, _ = _serve_group(engine, items, singles, label, 1, smi, capture)
            add(launches)
        log(f"serve b_pad 8 group against one by one: {wall * 1e3:.1f} ms against "
            f"{single_s * 1e3:.1f} ms, {single_s / wall:.2f}x ({smi})")
        add(_serve_group(engine, items[:3], singles[:3], "3 requests, b_pad 4", 1, smi,
                         captured)[0])
        want_cloned, want_longer = counted(lambda: (direct(cloned), direct(SERVE_LONGER)))
        add(_serve_group(engine, items[1:4] + [cloned], singles[1:4] + [want_cloned],
                         "3 plain + 1 cloned (250-frame prompt), b_pad 4", 1, smi,
                         captured)[0])
        add(_serve_group(engine, [items[3], SERVE_LONGER, items[1]],
                         [singles[3], want_longer, singles[1]],
                         "two text partitions (buckets 32 and 96)", 2, smi, captured)[0])

    # the long route: a text past INTERACTIVE_TEXT_CAP through synthesize_long
    long_item = dict(text=" ".join(["佢 係 邊 個"] * 40), lang="yue",
                     phone=" ".join(["keoi5 hai6 bin1 go3"] * 40))
    s_long = scale_for(synth, 4000, **long_item)
    with ServingEngine(synth, n_timesteps=10, length_scale=s_long, pcm16=True,
                       return_mel=True, long_attention="exact") as engine:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = engine.submit(**long_item).result(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    add(launches)
    want = counted(synth.synthesize_long, **long_item, n_timesteps=10, length_scale=s_long,
                   attention="exact", pcm16=True, dequantize=False)
    gap = float(np.abs(got.wav.astype(np.int32) - want.wav.astype(np.int32)).max())
    mae = float(np.abs(got.mel - want.mel).mean())
    log(f"serve engine long route (exact): {got.mel_frames} frames in {wall * 1e3:.1f} ms, "
        f"launches {launches}; vs synthesize_long mel MAE {mae:.3e}, waveform gap {gap:.0f} "
        f"PCM16 steps ({smi})")
    if (got.mel_frames != want.mel_frames or launches["flash_stock"] != 560
            or launches["resblock_stage"] != 2 or launches["flash_attention"]
            or not mae < 1e-2):
        fail("the engine's long route failed its checks")

    # the lane: 4 streams of different lengths and speakers at once
    lane_items = [items[0], items[4], items[5], items[3]]
    refs = counted(lambda: [np.concatenate(list(synth.synthesize_streaming(
        **it, chunk_frames=100, n_timesteps=10, length_scale=scale))) for it in lane_items])
    with StreamingLane(synth, max_streams=4, chunk_frames=100, n_timesteps=10) as lane:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [lane.submit(**it, length_scale=scale) for it in lane_items]
        outs = [np.concatenate(list(h.iter_timeout(600))) for h in handles]
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        ticks = lane.dispatches
    add(launches)
    worst = max(float(np.abs(o - r).max() / np.abs(r).max()) if o.shape == r.shape else np.inf
                for o, r in zip(outs, refs))
    # the four streams are queued before the worker has opened the first
    # (its text half takes far longer than three submits), so all start on
    # the first dispatch and the longest sets the count: one per chunk
    frames = [len(o) // 480 for o in outs]
    want_ticks = -(-max(frames) // 100)
    audio_s = sum(len(o) for o in outs) / 24000
    log(f"serve lane: 4 streams of {frames} frames, {ticks} dispatches (want {want_ticks}), "
        f"wall {wall * 1e3:.1f} ms for {audio_s:.2f} s of audio, aggregate rtf "
        f"{wall / audio_s:.4f}; vs single streams max |err| / max |ref| {worst:.3e} (bar "
        f"{STREAM_REL}); launches {launches} ({smi})")
    est = synth.cfg.tts.cfm.estimator
    per_tick = 10 * (est.num_mid_blocks + 2) * est.n_blocks
    if (not worst <= STREAM_REL or ticks != want_ticks
            or launches["flash_attention"] != per_tick * ticks
            or launches["resblock_stage"] != 2 * ticks):
        fail("the streaming lane failed its checks")

    # HTTP: the same model behind TTSServer
    http_items = [items[0], items[2], items[6], items[7]]
    with ServingEngine(synth, max_batch=8, max_wait_ms=200.0, n_timesteps=10,
                       length_scale=scale, pcm16=True) as engine:
        ref4 = counted(lambda: [f.result(timeout=600)
                                for f in [engine.submit(**it) for it in http_items]])
    ex = PromptExtractor(device="cuda", **clone_trees)
    kernels.reset_launch_counts()
    with TTSServer(synth, port=0, max_batch=8, max_wait_ms=200.0, n_timesteps=10,
                   length_scale=scale, streaming=True, chunk_frames=100,
                   prompt_extractor=ex) as srv:
        health = json.loads(_http(srv.port, "/healthz"))
        before = json.loads(_http(srv.port, "/stats"))
        bodies = {}

        def post(i, it):
            body = dict(text=it["text"], lang=it["lang"], phone=it["phone"])
            if it.get("spk_embed") is not None:
                body["spk_embed"] = it["spk_embed"].tolist()
            bodies[i] = _http(srv.port, "/tts", body)

        threads = [threading.Thread(target=post, args=(i, it)) for i, it in enumerate(http_items)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        http_wall = time.perf_counter() - t0
        after = json.loads(_http(srv.port, "/stats"))
        steps = [int(np.abs(_wav_pcm(bodies[i]).astype(np.int32)
                            - ref4[i].wav.astype(np.int32)).max())
                 if i in bodies and len(_wav_pcm(bodies[i])) == len(ref4[i].wav) else -1
                 for i in range(4)]
        stream = _http(srv.port, "/tts/stream", dict(items[0]))
        stream_pcm = np.frombuffer(stream[44:], np.int16)
        stream_err = (float(np.abs(stream_pcm / 32767.0 - refs[0]).max())
                      if len(stream_pcm) == len(refs[0]) else np.inf)
        b64 = base64.b64encode(wav_bytes(clone_wav, 24000)).decode()
        voice = dict(text="早 晨", lang="yue", phone="zou2 san4", ref_audio_b64=b64)
        t0 = time.perf_counter()
        first = _http(srv.port, "/tts", voice)
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        second = _http(srv.port, "/tts", voice)
        second_ms = (time.perf_counter() - t0) * 1e3
        final = json.loads(_http(srv.port, "/stats"))
    add(kernels.LAUNCHES)
    voice_step = (int(np.abs(_wav_pcm(first).astype(np.int32)
                             - _wav_pcm(second).astype(np.int32)).max())
                  if len(first) == len(second) else -1)
    log(f"serve http: /healthz {health}; 4 concurrent /tts in {http_wall * 1e3:.1f} ms, "
        f"batches {after['batches'] - before['batches']}, requests "
        f"{after['requests'] - before['requests']}, largest gap to the engine's PCM16 "
        f"{steps} steps; /tts/stream {len(stream_pcm)} samples, max |err| to "
        f"synthesize_streaming {stream_err:.3e}; ref_audio_b64 twice: {first_ms:.1f} ms, "
        f"{second_ms:.1f} ms, cached_voices {final['cached_voices']}, gap {voice_step} steps "
        f"({smi})")
    if (health != {"ok": True, "device": torch.cuda.get_device_name(0)}
            or after["batches"] - before["batches"] != 1
            or after["requests"] - before["requests"] != 4
            or not all(0 <= st <= 1 for st in steps)
            or not stream_err <= STREAM_REL * np.abs(refs[0]).max() + 1 / 32767.0
            or final["cached_voices"] != 1 or not 0 <= voice_step <= 1):
        fail("the HTTP server failed its checks")

    # the CLI on its default device, in a process of its own
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jyutvoice_tpu_torch.cli.serve", "--random-init", "--host",
         "127.0.0.1", "--port", str(_free_port()), "--streaming", "--warmup", "--warmup-text",
         "32", "--warmup-mel", "512"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        port = None
        while port is None and time.perf_counter() - t0 < 300 and proc.poll() is None:
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", "".join(lines))
            port = int(m.group(1)) if m else None
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        if port is None:
            fail("cli.serve did not start: " + "".join(lines)[-3000:])
        health = json.loads(_http(port, "/healthz"))
        pcm = _wav_pcm(_http(port, "/tts", dict(items[0])))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    warm = [ln.strip() for ln in lines if "warmup:" in ln]
    log(f"serve cli.serve (default device): ready in {ready_s:.1f} s ({warm}), /healthz "
        f"{health}, /tts {len(pcm)} samples, rc {rc} after SIGTERM")
    if (rc != 0 or health.get("device") != torch.cuda.get_device_name(0) or not len(pcm)
            or not any("drain" in ln for ln in lines)):
        fail("cli.serve failed its checks: " + "".join(lines)[-3000:])
    return counts, captured


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
        # (a)'s mel time is set beside (a')'s: the probe stays out of it
        probe = want_k3 and not label.startswith("(a)")
        with kernel3_input_peaks() if probe else contextlib.nullcontext() as peaks:
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
                             "resblock_stage": 2, "flash_stock_bwd_dkv": 0,
                             "flash_stock_bwd_dq": 0, "flash_stock_bwd_prep": 0,
                             "f32_gemm": 0, "int8_quant_rows": 0, "int8_gemm": 0}
        )
        t = {k: round(v, 6) for k, v in res.timings.items()}
        log(f"long-form {label}: mel_frames={res.mel_frames} t_total={head + t_mel} "
            f"wav_samples={res.wav.shape[0]} launches={launches} "
            f"(want flash_attention {want_k1}, flash_stock {want_k3}, resblock_stage 2) "
            f"timings={json.dumps(t)}")
        if not ok:
            fail(f"long-form request {label} failed its checks")
        if probe:
            check_kernel3_peaks(f"long-form {label}", peaks)
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


# ---------------------------------------------------------------------------
# phase 10: the fine-tune workflow (provision -> verify -> prepare -> train
# -> export)
# ---------------------------------------------------------------------------


def flow_encoder_state(tree):
    """The reference's state_dict names (flow.pt's encoder half) for a
    JAX-layout flow-encoder tree: the inverse of `convert_flow_encoder`."""
    import numpy as np

    sd = {}

    def lin(name, p, conv1x1=False):
        w = np.asarray(p["w"]).T
        sd[f"{name}.weight"] = w[:, :, None] if conv1x1 else w
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["g"]), np.asarray(p["b"])

    def conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(2, 1, 0)
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def layer(name, p):
        a = p["attn"]
        for src, dst in (("q", "linear_q"), ("k", "linear_k"), ("v", "linear_v"),
                         ("o", "linear_out"), ("pos", "linear_pos")):
            lin(f"{name}.self_attn.{dst}", a[src])
        sd[f"{name}.self_attn.pos_bias_u"] = np.asarray(a["pos_bias_u"])
        sd[f"{name}.self_attn.pos_bias_v"] = np.asarray(a["pos_bias_v"])
        ln(f"{name}.norm_mha", p["norm_mha"])
        lin(f"{name}.feed_forward.w_1", p["ff"]["w1"])
        lin(f"{name}.feed_forward.w_2", p["ff"]["w2"])
        ln(f"{name}.norm_ff", p["norm_ff"])
        if "ff_macaron" in p:
            lin(f"{name}.feed_forward_macaron.w_1", p["ff_macaron"]["w1"])
            lin(f"{name}.feed_forward_macaron.w_2", p["ff_macaron"]["w2"])
            ln(f"{name}.norm_ff_macaron", p["norm_ff_macaron"])
        if "conv" in p:
            c = f"{name}.conv_module"
            lin(f"{c}.pointwise_conv1", p["conv"]["pw1"], conv1x1=True)
            sd[f"{c}.depthwise_conv.weight"] = np.asarray(p["conv"]["dw"]["w"]).T[:, None, :]
            sd[f"{c}.depthwise_conv.bias"] = np.asarray(p["conv"]["dw"]["b"])
            n = p["conv"]["norm"]
            if "mean" in n:
                for src, dst in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                                 ("var", "running_var")):
                    sd[f"{c}.norm.{dst}"] = np.asarray(n[src])
                sd[f"{c}.norm.num_batches_tracked"] = np.array(0)
            else:
                ln(f"{c}.norm", n)
            lin(f"{c}.pointwise_conv2", p["conv"]["pw2"], conv1x1=True)
            ln(f"{name}.norm_conv", p["norm_conv"])
            ln(f"{name}.norm_final", p["norm_final"])

    sd["input_embedding.weight"] = np.asarray(tree["input_embedding"]["w"])
    lin("encoder.embed.out.0", tree["embed"]["linear"])
    ln("encoder.embed.out.1", tree["embed"]["norm"])
    conv("encoder.pre_lookahead_layer.conv1", tree["pre_lookahead"]["conv1"])
    conv("encoder.pre_lookahead_layer.conv2", tree["pre_lookahead"]["conv2"])
    for i, p in enumerate(tree["encoders"]):
        layer(f"encoder.encoders.{i}", p)
    conv("encoder.up_layer.conv", tree["up_conv"])
    lin("encoder.up_embed.out.0", tree["up_embed"]["linear"])
    ln("encoder.up_embed.out.1", tree["up_embed"]["norm"])
    for i, p in enumerate(tree["up_encoders"]):
        layer(f"encoder.up_encoders.{i}", p)
    ln("encoder.after_norm", tree["after_norm"])
    lin("encoder_proj", tree["encoder_proj"])
    return sd


def hift_state(tree):
    """The reference's HiFT state_dict names (hift.pt) for a JAX-layout HiFT
    tree: the inverse of `convert_hift`, plain weights in place of weight
    norm."""
    import numpy as np

    sd = {}

    def conv(name, p, transpose=False):
        w = np.asarray(p["w"])
        sd[f"{name}.weight"] = w.transpose(1, 2, 0) if transpose else w.transpose(2, 1, 0)
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def resblock(name, p):
        for j in range(len(p["convs1"])):
            conv(f"{name}.convs1.{j}", p["convs1"][j])
            conv(f"{name}.convs2.{j}", p["convs2"][j])
            sd[f"{name}.activations1.{j}.alpha"] = np.asarray(p["alphas1"][j])
            sd[f"{name}.activations2.{j}.alpha"] = np.asarray(p["alphas2"][j])

    for i, c in enumerate(tree["f0_predictor"]["convs"]):
        conv(f"f0_predictor.condnet.{2 * i}", c)
    for name, p in (("f0_predictor.classifier", tree["f0_predictor"]["classifier"]),
                    ("m_source.l_linear", tree["m_source"]["l_linear"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["w"]).T, np.asarray(p["b"])
    conv("conv_pre", tree["conv_pre"])
    for i, p in enumerate(tree["ups"]):
        conv(f"ups.{i}", p, transpose=True)
    for i, p in enumerate(tree["source_downs"]):
        conv(f"source_downs.{i}", p["conv"])
    for i, p in enumerate(tree["source_resblocks"]):
        resblock(f"source_resblocks.{i}", p)
    for i, p in enumerate(tree["resblocks"]):
        resblock(f"resblocks.{i}", p)
    conv("conv_post", tree["conv_post"])
    return sd


def _save_state(path, sd):
    import numpy as np
    import torch

    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def _same_leaves(a, b, prefixes=None):
    """Whether two trees hold bit-equal leaves under the same paths (only
    those starting with one of `prefixes`, when given)."""
    import numpy as np

    from jyutvoice_tpu_torch.weights.from_jax import _flatten

    fa, fb = _flatten(a), _flatten(b)
    if prefixes:
        fa = {k: v for k, v in fa.items() if k.startswith(prefixes)}
        fb = {k: v for k, v in fb.items() if k.startswith(prefixes)}
    return bool(fa) and set(fa) == set(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)


def _speech(seconds, sr, seed):
    """A voiced, amplitude-modulated signal with a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
    return (0.2 * x / np.abs(x).max() + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


# prepared rows: 33-38 s (1650-1900 mel frames), so their batches land in
# the 2048-frame bucket
FT_ROWS = ((33.0, 24000), (38.0, 16000), (35.5, 44100), (36.5, 24000), (34.0, 16000))
FT_TEXT = ("佢 係 邊 個 今 日 天 氣 好 多 謝 晒", "keoi5 hai6 bin1 go3 gam1 jat6 tin1 hei3 "
           "hou2 do1 ze6 saai3")
FT_SEED = 0  # dummy rows of 1400-2000 frames: every batch of 2 at the 2048 bucket


@contextlib.contextmanager
def finetune_kernel_inputs(into):
    """Keeps, in `into["flash_stock"]`, the first input that kernel 3 gets
    under autograd (q, k, v, lengths and the call's options) and the
    gradient that then reaches its output (the `do` of kernels 4 and 5),
    for phase 10f to hold kernels 3, 4 and 5 to."""
    from jyutvoice_tpu_torch.nn import attention

    real = attention.flash_stock

    def probe(q, k, v, lengths, **kw):
        out = real(q, k, v, lengths, **kw)
        if "flash_stock" not in into and out.requires_grad:
            case = dict(inputs=[a.detach().clone() for a in (q, k, v, lengths)], kw=kw)
            into["flash_stock"] = case
            out.register_hook(lambda g: case.setdefault("do", g.detach().clone()))
        return out

    attention.flash_stock = probe
    try:
        yield into
    finally:
        attention.flash_stock = real


class _RecordingWriter:
    """A SummaryWriter stand-in that keeps the images it is given."""

    def __init__(self):
        self.images = {}

    def add_image(self, tag, img, step, dataformats):
        self.images[tag] = img.shape


def phase_finetune(smi):
    """The fine-tune workflow at full width (default JyutVoiceConfig, seeded
    random trees), through the entry points a user calls:
      (a) reference-shaped flow.pt and hift.pt stand-ins ->
          `cli.provision --assemble-pretrain` (strict audit);
      (b) `cli.provision --verify` on the card (kernels 1 and 2);
      (c) `prepare_dataset.process_batch` with a full-width PromptExtractor
          on the card over 5 rows of 33-38 s, two rows against the CPU;
      (d) `cli.train --pretrain tts_init.npz --tb-dir` on dummy rows at the
          2048-frame bucket (kernels 3, 4, 5), then two library steps on
          the prepared rows;
      (e) the trained module -> tree -> `save_torch_checkpoint` ->
          `provision(tts_ckpt=...)` -> reloaded bit-equal.
    Returns (the launch counts, the kernel inputs kept for phase 10f, the
    HiFT tree, the timings)."""
    import logging
    import re
    import statistics

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.cli import provision as cli_provision
    from jyutvoice_tpu_torch.cli import train as cli_train
    from jyutvoice_tpu_torch.cli.prepare_dataset import process_batch
    from jyutvoice_tpu_torch.config import JyutVoiceConfig, TrainConfig
    from jyutvoice_tpu_torch.models.tts import TTS
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor
    from jyutvoice_tpu_torch.train import checkpoints as ckpt
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.utils.tb_logging import TrainLogger
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import (
        jax_params_from_module,
        load_jax_params,
        load_pytree_npz,
    )
    from jyutvoice_tpu_torch.weights.provision import provision
    from jyutvoice_tpu_torch.weights.torch_export import export_estimator, save_torch_checkpoint

    cfg = JyutVoiceConfig()
    est = cfg.tts.cfm.estimator
    per_step = (est.num_mid_blocks + 2) * est.n_blocks
    zero = {k: 0 for k in kernels.LAUNCHES}
    counts = dict(zero)
    captured, times = {}, {}

    def add(launches):
        for k in counts:
            counts[k] += launches[k]

    with tempfile.TemporaryDirectory() as work:
        # ---- (a) provision
        t = time.perf_counter()
        tts = random_init.init_tts_tree(cfg.tts, seed=20)
        hift = random_init.init_hift_tree(cfg.hift, seed=21)
        fe = random_init.init_flow_encoder_tree(cfg.flow_encoder, seed=22)
        flow = flow_encoder_state(fe)
        flow.update(export_estimator(tts["decoder"], "decoder.estimator."))
        flow["spk_embed_affine_layer.weight"] = tts["spk_embed_affine_layer"]["w"].T
        flow["spk_embed_affine_layer.bias"] = tts["spk_embed_affine_layer"]["b"]
        flow_pt, hift_pt = os.path.join(work, "flow.pt"), os.path.join(work, "hift.pt")
        _save_state(flow_pt, flow)
        _save_state(hift_pt, hift_state(hift))
        log(f"finetune (a): stand-ins flow.pt ({len(flow)} tensors) and hift.pt written in "
            f"{time.perf_counter() - t:.1f} s")
        audits = []

        class _Audits(logging.Handler):
            def emit(self, record):
                audits.extend(re.findall(r"consumed (\d+)/(\d+)", record.getMessage()))

        prov_log = logging.getLogger("jyutvoice_tpu_torch.weights.provision")
        handler = _Audits()
        prov_log.addHandler(handler)
        prov_log.setLevel(logging.INFO)
        out_dir = os.path.join(work, "pretrained")
        try:
            t = time.perf_counter()
            written = cli_provision.main(["--flow-pt", flow_pt, "--hift-pt", hift_pt,
                                          "--assemble-pretrain", "--out-dir", out_dir])
            times["provision_s"] = time.perf_counter() - t
        finally:
            prov_log.removeHandler(handler)
        init = load_pytree_npz(written["tts_init"])
        checks = dict(
            frozen_half=_same_leaves(init, tts, ("decoder/", "spk_embed_affine_layer/")),
            flow_encoder=_same_leaves(load_pytree_npz(written["flow_encoder"]), fe),
            hift=_same_leaves(load_pytree_npz(written["hift"]), hift),
            random_half=_same_leaves(init, random_init.init_tts_tree(cfg.tts, seed=42),
                                     ("encoder/", "dp/")),
        )
        audit_ok = len(audits) == 3 and all(a == b for a, b in audits)
        log(f"finetune (a): cli.provision --assemble-pretrain in {times['provision_s']:.1f} s: "
            f"{sorted(written)}; audits consumed/total {audits}; tts_init decoder and "
            f"speaker affine bit-equal to flow.pt's: {checks['frozen_half']}; encoder and "
            f"duration predictor = init_tts_tree(seed 42): {checks['random_half']}; "
            f"flow_encoder.npz / hift.npz bit-equal to the written trees: "
            f"{checks['flow_encoder']} / {checks['hift']}")
        if not (audit_ok and all(checks.values())):
            fail("provisioning did not reproduce the stand-ins' trees or left keys unread")

        # ---- (b) verify on the card: two requests (a warm-up and a timed one)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        with serving_kernel_inputs(captured, "provision --verify"):
            metrics = cli_provision.main(["--verify", "--flow-pt", flow_pt, "--hift-pt", hift_pt,
                                          "--out-dir", out_dir])
        torch.cuda.synchronize()
        times["verify_s"] = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        add(launches)
        times["verify_xrt"] = metrics["xrt"]
        want = dict(zero, flash_attention=2 * 560, resblock_stage=2 * 2)
        log(f"finetune (b): cli.provision --verify in {times['verify_s']:.1f} s: mel_frames "
            f"{metrics['mel_frames']}, audio {metrics['audio_seconds']} s, xRT {metrics['xrt']}; "
            f"launches {launches} (want 560 kernel 1 and 2 kernel 2 per request, 2 requests) "
            f"({smi})")
        if launches != want or not metrics["xrt"] > 0:
            fail("provision --verify did not run its requests through kernels 1 and 2")

        # ---- (c) prepare rows on the card, two of them against the CPU
        t = time.perf_counter()
        trees = dict(flow_encoder_params=load_pytree_npz(written["flow_encoder"]),
                     flow_encoder_cfg=cfg.flow_encoder,
                     campplus_params=random_init.init_campplus_tree(seed=23),
                     tokenizer_params=random_init.init_s3_tree(seed=24))
        ex = PromptExtractor(device="cuda", **trees)
        cpu_ex = PromptExtractor(device="cpu", **trees)
        rows = {"text": [FT_TEXT[0]] * len(FT_ROWS), "phone": [FT_TEXT[1]] * len(FT_ROWS),
                "lang": ["yue"] * len(FT_ROWS),
                "audio": [{"array": _speech(s, sr, 30 + i), "sampling_rate": sr}
                          for i, (s, sr) in enumerate(FT_ROWS)]}
        log(f"finetune (c): full-width extractors and {len(FT_ROWS)} rows "
            f"({', '.join(f'{s} s @ {sr}' for s, sr in FT_ROWS)}) in "
            f"{time.perf_counter() - t:.1f} s")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        process_batch(rows, ex)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        card = process_batch(rows, ex)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        times["prepare_rows_per_s"] = len(FT_ROWS) / warm_s
        if any(kernels.LAUNCHES.values()):
            fail(f"dataset preparation launched kernels: {kernels.LAUNCHES}")
        frames = [len(m) for m in card["mel"]]
        ok = (all(card["audio_processed"]) and all(1536 < f <= 2048 for f in frames)
              and all(len(h) == len(m) for h, m in zip(card["decoder_h"], card["mel"])))
        try:
            import datasets  # noqa: F401 — only cli.prepare_dataset.main needs it

            has_datasets = True
        except ImportError:
            has_datasets = False
        log(f"finetune (c): process_batch on the card: cold {cold:.1f} ms, warm "
            f"{warm_s * 1e3:.1f} ms ({times['prepare_rows_per_s']:.2f} rows/s), mel frames "
            f"{frames}, all processed with decoder_h: {ok}; `datasets` imports: "
            f"{has_datasets}")
        if not ok:
            fail("the prepared rows are not all processed at 1537-2048 frames with decoder_h")
        t0 = time.perf_counter()
        two = {k: v[:2] for k, v in rows.items()}
        ref = process_batch(two, cpu_ex)
        cpu_s = time.perf_counter() - t0
        for i in range(2):
            audio, sr = rows["audio"][i]["array"], rows["audio"][i]["sampling_rate"]
            got = {k: np.asarray(card[k][i], np.float32)
                   for k in ("mel", "spk_emb", "decoder_h")}
            want_ = {k: np.asarray(ref[k][i], np.float32) for k in ("mel", "spk_emb")}
            tok, tok_ref = (np.asarray(x["speech_tokens"][i]) for x in (card, ref))
            tok_ok, n_differ, n_edge = _token_check(cpu_ex, audio, sr, tok, tok_ref)
            # the flow encoder on identical tokens: the card's, on both sides
            h_cpu = cpu_ex._encode_tokens(tok.astype(np.int32))[: len(got["decoder_h"])]
            log_err, mel_ratio = _mel_err(got["mel"], want_["mel"])
            errs = dict(spk_emb=_rel(got["spk_emb"], want_["spk_emb"]),
                        decoder_h=_rel(got["decoder_h"], h_cpu))
            ids_ok = all(card[k][i] == ref[k][i] for k in
                         ("phone_ids", "tones", "word_pos", "syllable_pos", "lang_ids"))
            log(f"finetune (c): row {i} card vs CPU: mel frames {len(got['mel'])} (cpu "
                f"{len(ref['mel'][i])}), tokens {len(tok)}, tokens that differ {n_differ} (at an "
                f"FSQ edge on the cpu: {n_edge}), mel max_abs_err {log_err:.3e} (mel error / "
                f"bar {mel_ratio:.3f}), spk_emb rel_err {errs['spk_emb']:.3e}, decoder_h (same "
                f"tokens) rel_err {errs['decoder_h']:.3e} (bar {CLONE_REL}), ids equal {ids_ok} "
                f"(CPU {cpu_s:.1f} s for both)")
            if not (ids_ok and tok_ok and len(got["mel"]) == len(ref["mel"][i])
                    and mel_ratio <= 1.0 and max(errs.values()) <= CLONE_REL):
                fail(f"prepared row {i} on the card does not agree with the CPU")
        prepared = [{k: card[k][i] for k in ("phone_ids", "tones", "word_pos", "syllable_pos",
                                             "lang_ids", "mel", "spk_emb", "decoder_h")}
                    for i in range(len(FT_ROWS))]
        del ex, cpu_ex, card, ref

        # ---- (d) train: the CLI from tts_init.npz, then two library steps
        steps = []  # (label, y frames, ms, launches)
        real_step = Trainer.step
        real_val, real_sample = cli_train.validation_pass, cli_train._log_val_sample
        label = ["cli"]

        def timed_step(self, batch):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with finetune_kernel_inputs(captured):
                out = real_step(self, batch)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            add(launches)
            steps.append((label[0], int(batch["y"].shape[1]), (time.perf_counter() - t0) * 1e3,
                          launches))
            return out

        def timed_val(trainer, dm):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = real_val(trainer, dm)
            torch.cuda.synchronize()
            times["validation_ms"] = (time.perf_counter() - t0) * 1e3
            times["validation_launches"] = dict(kernels.LAUNCHES)
            add(kernels.LAUNCHES)
            return out

        def timed_sample(model, dm, tb, step):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with serving_kernel_inputs(captured, "validation sample"):
                out = real_sample(model, dm, tb, step)
            torch.cuda.synchronize()
            times["sample_ms"] = (time.perf_counter() - t0) * 1e3
            times["sample_launches"] = dict(kernels.LAUNCHES)
            times["sample_frames"] = None if out is None else int(out.mel_lengths[0])
            add(kernels.LAUNCHES)
            return out

        ck, tb_dir = os.path.join(work, "ckpt"), os.path.join(work, "tb")
        Trainer.step = timed_step
        cli_train.validation_pass, cli_train._log_val_sample = timed_val, timed_sample
        try:
            t = time.perf_counter()
            res = cli_train.main(["--pretrain", written["tts_init"], "--tb-dir", tb_dir,
                                  "--dummy", "--dummy-rows", "9", "--dummy-mel", "1400,2000",
                                  "--batch-size", "2", "--epochs", "1", "--log-every", "1",
                                  "--seed", str(FT_SEED), "--ckpt-dir", ck])
            times["train_cli_s"] = time.perf_counter() - t
            state = ckpt.restore(ck, map_location="cpu")
            tuned = TTS(cfg.tts)
            tuned.load_state_dict(state["trainer"]["model"])
            start = load_jax_params(TTS(cfg.tts), init)
            frozen_ok, moved = _frozen_and_moved(start, tuned)
            try:
                import torch.utils.tensorboard  # noqa: F401

                tb_ok = True
            except Exception as e:  # noqa: BLE001
                tb_ok = False
                log(f"finetune (d): torch.utils.tensorboard does not import ({e})")
            if tb_ok:
                from tensorboard.backend.event_processing.event_accumulator import (
                    EventAccumulator,
                )

                acc = EventAccumulator(tb_dir, size_guidance={"images": 0, "scalars": 0})
                acc.Reload()
                tags = acc.Tags()
                images = sorted(tags["images"])
                scalars = sorted(tags["scalars"])
            else:
                # the sample on the card all the same, into a recording logger
                dm = TextMelDataModule(dummy_rows(9, seed=FT_SEED, mel_frames=(1400, 2000)),
                                       DataConfig(batch_size=2, seed=FT_SEED))
                rec = TrainLogger()
                rec.writer = _RecordingWriter()
                timed_sample(tuned.cuda(), dm, rec, res["step"])
                tuned.cpu()
                images, scalars = sorted(rec.writer.images), []
            if "sample_ms" not in times or "validation_ms" not in times:
                fail("the fine-tune CLI ran no validation pass or no validation sample")
            cli = [s for s in steps if s[0] == "cli"]
            ms = [s[2] for s in cli]
            times["cli_step_ms"] = statistics.median(ms[1:])
            want_images = ["val/alignment", "val/encoder_mel", "val/generated_mel",
                           "val/ground_truth_mel"]
            for i, (_, y, step_ms, launches) in enumerate(cli):
                log(f"finetune (d): cli step {i + 1}: mel bucket {y}, {step_ms:.1f} ms, "
                    f"launches {launches}")
            log(f"finetune (d): cli.train --pretrain --tb-dir: {res['step']} steps in "
                f"{times['train_cli_s']:.1f} s, median step (steps 2-{len(ms)}) "
                f"{times['cli_step_ms']:.1f} ms, validation pass {times['validation_ms']:.1f} ms "
                f"(launches {times['validation_launches']}), validation sample "
                f"{times['sample_ms']:.1f} ms ({times['sample_frames']} frames, launches "
                f"{times['sample_launches']}); torch.utils.tensorboard imported: {tb_ok}; "
                f"images {images}; scalars {scalars}; decoder and speaker affine "
                f"bit-equal to tts_init: {frozen_ok}; tensors moved {moved} ({smi})")
            want = dict(zero, flash_stock=per_step, flash_stock_bwd_dkv=per_step,
                        flash_stock_bwd_dq=per_step, flash_stock_bwd_prep=per_step)
            if (len(cli) != 4 or any(y != 2048 or l != want for _, y, _, l in cli)
                    or images != want_images or not frozen_ok or not moved
                    or (tb_ok and not {"train/loss", "val/loss"} <= set(scalars))):
                fail("the fine-tune CLI failed its checks")

            # two library steps on (c)'s prepared rows
            label[0] = "library"
            dm = TextMelDataModule(prepared, DataConfig(batch_size=2))
            model = load_jax_params(TTS(cfg.tts), init).cuda()
            trainer = Trainer(model, TrainConfig(batch_size=2),
                              torch.Generator(device="cuda").manual_seed(0))
            losses = [float(trainer.step(batch)["loss"])
                      for batch in list(dm.train_batches(0))[:2]]
            lib = [s for s in steps if s[0] == "library"]
            for i, (_, y, step_ms, launches) in enumerate(lib):
                log(f"finetune (d): library step {i + 1} on prepared rows: mel bucket {y}, "
                    f"{step_ms:.1f} ms, loss {losses[i]:.4f}, launches {launches}")
            frozen_ok, moved = _frozen_and_moved(start, model.cpu())
            if (len(lib) != 2 or any(y != 2048 or l != want for _, y, _, l in lib)
                    or not frozen_ok or not moved or not np.isfinite(losses).all()):
                fail("the library steps on the prepared rows failed their checks")
        finally:
            Trainer.step = real_step
            cli_train.validation_pass, cli_train._log_val_sample = real_val, real_sample

        # ---- (e) export: module -> tree -> reference checkpoint -> provision
        t = time.perf_counter()
        path = os.path.join(work, "finetuned.ckpt")
        save_torch_checkpoint(path, jax_params_from_module(model))
        exported = provision(tts_ckpt=path, out_dir=os.path.join(work, "export"), cfg=cfg)
        back = load_jax_params(TTS(cfg.tts), load_pytree_npz(exported["tts"]))
        times["export_s"] = time.perf_counter() - t
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(model.named_parameters(), back.named_parameters()))
        log(f"finetune (e): module -> tree -> save_torch_checkpoint -> provision(tts_ckpt) "
            f"(strict audit) -> reloaded in {times['export_s']:.1f} s: parameters bit-equal "
            f"to the trained module's: {same}")
        if not same:
            fail("the exported checkpoint does not reload to the trained parameters")
    return counts, captured, hift, times


def _frozen_and_moved(start, tuned):
    """(decoder and speaker affine bit-equal in both, encoder and duration
    predictor moved) between two TTS modules."""
    import torch

    a, b = dict(start.named_parameters()), dict(tuned.named_parameters())
    frozen = all(torch.equal(a[n], b[n].cpu()) for n in a
                 if n.startswith(("decoder.", "spk_embed_affine_layer.")))
    moved = [n for n in a if not torch.equal(a[n], b[n].cpu())]
    trained = (any(n.startswith("encoder.") for n in moved)
               and any(n.startswith("dp.") for n in moved))
    return frozen, len(moved) if trained else 0


def phase_finetune_kernels(captured, hift_tree, smi):
    """Kernels 1-5 on the inputs that phase 10 handed them: kernel 1 and 2 on
    the first call at each shape of `provision --verify` (and of the
    validation sample, where it took kernel 1), kernel 3 with 4 and 5 on the
    first fine-tune step's first attention call and the gradient that
    reached it. Returns (max |err| and times per kernel)."""
    import types

    import torch

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.models.hift import HiFT
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    torch.cuda.synchronize()
    out = {"flash": (0.0, {}), "stage": (0.0, {}), "stock": None}
    flash_keys = sorted(k for k in captured if k[0] == "flash_attention")
    stage_keys = sorted(k for k in captured if k[0] == "resblock_stage")
    if not flash_keys or not stage_keys or "do" not in captured.get("flash_stock", {}):
        fail(f"phase 10 handed no input to kernel 1, 2 or 3 (or no gradient to 4/5): "
             f"{sorted(map(str, captured))}")
    worst, flash = 0.0, {}
    for key in flash_keys:
        case = captured.pop(key)
        b, t = key[1][:2]
        err, flash[f"b{b}_t{t}"] = _serve_flash_case(
            f"({case['label']})", *case["inputs"], smi, **case["kw"])
        worst = max(worst, err)
    out["flash"] = (worst, flash)
    cfg = JyutVoiceConfig()
    vocoder = types.SimpleNamespace(
        cfg=cfg, hift=load_jax_params(HiFT(cfg.hift), hift_tree).cuda().eval())
    stage_worst, stage = 0.0, {}
    for key in stage_keys:
        case = captured.pop(key)
        b, t, c = key[1]
        name = f"pair{t // 40 if c == 128 else (t - 1) // 120}_b{b}"
        err, times = _serve_stage_case(f"{name} ({case['label']})", case["inputs"][0],
                                       case["prepared"], _stage_weights(vocoder, c), vocoder,
                                       smi)
        stage_worst = max(stage_worst, err)
        _add_stage(stage, name, times)
    _log_pairs(stage, " (phase 10's inputs)", smi)
    out["stage"] = (stage_worst, stage)
    case = captured.pop("flash_stock")
    q, k, v, lengths = case["inputs"]
    out["stock"] = _stock_bwd_case(q, k, v, case["do"], lengths, case["kw"]["scale"],
                                   label=" (fine-tune step 1's inputs)")
    del vocoder, case
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: the int8 estimator, warmup_long, the host MAS
# ---------------------------------------------------------------------------

INT8_TO_F32_REL = 0.1  # int8 against f32 mel: mean |diff| / mean |f32| (the JAX test's bar)


def _quant_linear_case(lin, x, smi):
    """One full-width QuantLinear on the card against its plain computation
    on the CPU: the int8 activations and the int32 products equal, the
    output within rtol 1e-6. Times the whole int8 linear, its product alone
    (torch._int_mm) and the f32 linear of the dequantized weight, each a
    median of CUDA-event loops. Returns the times."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn import quant

    x2 = x.reshape(-1, x.shape[-1])
    x_q, sx = quant.quantize_rows(x2)
    acc = quant.int8_matmul(x_q, lin.w_q.t())
    out = lin(x)
    w_q, scale, bias = (t.cpu() for t in (lin.w_q, lin.scale, lin.bias))
    r_q, r_sx = quant.quantize_rows(x2.cpu())
    r_acc = quant.int8_matmul(r_q, w_q.t())
    ref = quant.linear_q({"w_q": w_q.t(), "scale": scale, "b": bias}, x.cpu())
    out_c = out.cpu()
    rel = float(((out_c - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    ok = (torch.equal(x_q.cpu(), r_q) and torch.equal(sx.cpu(), r_sx)
          and torch.equal(acc.cpu(), r_acc) and bool(torch.allclose(out_c, ref, rtol=1e-6, atol=0)))
    m, k = x2.shape
    n = lin.w_q.shape[0]
    w_f32 = (lin.w_q.float() * lin.scale[:, None]).contiguous()
    w_t = lin.w_q.t()
    ms = cuda_time_ms(lambda: lin(x), 50)
    mm_ms = cuda_time_ms(lambda: torch._int_mm(x_q, w_t), 50)
    f32_ms = cuda_time_ms(lambda: F.linear(x, w_f32, lin.bias), 50)
    log(f"int8 QuantLinear {k}->{n} on {m} rows (the 512 request's decoder.mid.0.blocks.0.ff_in "
        f"input): x_q equal {torch.equal(x_q.cpu(), r_q)}, int32 products equal "
        f"{torch.equal(acc.cpu(), r_acc)}, output max rel err {rel:.3e}; linear ms {ms:.4f}, "
        f"torch._int_mm ms {mm_ms:.4f}, f32 linear (TF32 off) ms {f32_ms:.4f} ({smi})")
    if not ok:
        fail("the int8 linear on the card does not match its CPU computation")
    return dict(ms=ms, int_mm_ms=mm_ms, f32_ms=f32_ms)


def phase_int8(params_tts, params_hift, scale, smi):
    """11a, the int8 estimator at full width: the seed-0 tree quantized with
    the port's quantize_estimator in an int8 Synthesizer on the card beside
    the f32 one. A 512-bucket and a 15000-bucket request in turns (f32,
    int8, then warm calls alternating), each with 560 kernel-1 and 2
    kernel-2 launches; mel / vocoder (host clock fenced by synchronize) and
    total (CUDA events) medians of the warm calls; the int8-vs-f32 mel
    deviation against INT8_TO_F32_REL. One full-width QuantLinear on the
    512 request's own input against its CPU computation. The int8 request
    at 2 steps against the CPU port's int8 request (mel MAE < 1e-2).
    synthesize_batch and a ServingEngine group on the int8 synthesizer
    against its direct requests. Kernels 1 and 2 on the inputs the int8
    path handed them. Returns (launches, kernel 1's and 2's errors and
    times)."""
    import statistics

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.nn.quant import QuantLinear, quantize_estimator, quantize_rows
    from jyutvoice_tpu_torch.pipeline import buckets
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    cfg = JyutVoiceConfig()
    est = cfg.tts.cfm.estimator
    per_step = (est.num_mid_blocks + 2) * est.n_blocks
    qtree = {**params_tts, "decoder": quantize_estimator(params_tts["decoder"])}
    synths = {"f32": Synthesizer(cfg, params_tts, params_hift, device="cuda"),
              "int8": Synthesizer(cfg, qtree, params_hift, device="cuda")}
    int8 = synths["int8"]
    n_q = sum(isinstance(m, QuantLinear) for m in int8.tts.modules())
    want_q = 6 * (est.num_mid_blocks + 2) * est.n_blocks
    log(f"int8: {n_q} QuantLinear modules in the int8 decoder (want {want_q}), "
        f"{sum(isinstance(m, QuantLinear) for m in synths['f32'].tts.modules())} in the f32 one")
    if n_q != want_q or any(isinstance(m, QuantLinear) for m in synths["f32"].tts.modules()):
        fail("the int8 tree did not load as QuantLinear modules where the estimator takes them")
    counts = {k: 0 for k in kernels.LAUNCHES}
    zero = {k: 0 for k in kernels.LAUNCHES}
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    captured, lin_in = {}, {}
    lin = int8.tts.decoder.mid[0].blocks[0].ff_in

    def keep_input(mod, args):
        lin_in.setdefault("x", args[0].detach().clone())

    hook = lin.register_forward_pre_hook(keep_input)

    def request(name, label, bucket, capture, **kw):
        kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with (serving_kernel_inputs(captured, label) if capture else contextlib.nullcontext()):
            res = synths[name].synthesize(**kw)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = dict(zero, flash_attention=kw["n_timesteps"] * per_step, resblock_stage=2)
        if name == "int8":  # each int8 linear once a step: two launches
            want.update(int8_quant_rows=kw["n_timesteps"] * want_q,
                        int8_gemm=kw["n_timesteps"] * want_q)
        got_bucket = buckets.pick_bucket(res.mel_frames, buckets.MEL_BUCKETS)
        log(f"int8 phase {name} {label}: mel_frames={res.mel_frames} bucket={got_bucket} "
            f"mel_ms={res.timings['mel'] * 1e3:.1f} vocoder_ms={res.timings['vocoder'] * 1e3:.1f} "
            f"total_event_ms={start.elapsed_time(end):.1f} launches={launches} ({smi})")
        if (launches != want or not np.isfinite(res.mel).all()
                or (bucket is not None and got_bucket != bucket)):
            fail(f"int8 phase {name} {label} failed its checks (want launches {want}, "
                 f"bucket {bucket})")
        if name == "int8":
            for k in counts:
                counts[k] += launches[k]
        return res, start.elapsed_time(end)

    times = {}
    cases = [("512", 512, dict(yue, length_scale=scale), 3),
             ("15000", 15000, dict(yue, length_scale=scale_for(int8, 13000, **yue)), 2)]
    for case, bucket, kw, warm in cases:
        order = ["f32", "int8"] + ["f32", "int8", "int8", "f32", "f32", "int8"][: 2 * warm]
        runs = {"f32": [], "int8": []}
        for i, name in enumerate(order):
            cold = i < 2
            runs[name].append(request(
                name, f"{case} bucket ({'cold' if cold else 'warm'})", bucket,
                capture=(case == "512" and name == "int8" and cold), n_timesteps=10, **kw))
        f_mel, q_mel = runs["f32"][-1][0].mel, runs["int8"][-1][0].mel
        rel = float(np.abs(q_mel - f_mel).mean() / np.abs(f_mel).mean()) \
            if q_mel.shape == f_mel.shape else float("inf")
        for name in runs:
            warm_runs = runs[name][1:]
            times[f"{case}_{name}"] = dict(
                mel_ms=statistics.median(r.timings["mel"] * 1e3 for r, _ in warm_runs),
                vocoder_ms=statistics.median(r.timings["vocoder"] * 1e3 for r, _ in warm_runs),
                total_ms=statistics.median(ms for _, ms in warm_runs),
                cold_total_ms=runs[name][0][1])
        log(f"int8 phase {case} bucket, median of {warm} warm calls: f32 {json.dumps(times[f'{case}_f32'])}"
            f"; int8 {json.dumps(times[f'{case}_int8'])}; int8 vs f32 mel: mean |diff| / mean "
            f"|f32| = {rel:.4e} (bar {INT8_TO_F32_REL}), mel MAE "
            f"{float(np.abs(q_mel - f_mel).mean()):.4e} ({smi})")
        if not rel < INT8_TO_F32_REL:
            fail(f"the int8 mel is too far from the f32 one at the {case} bucket")
    hook.remove()
    lin_times = _quant_linear_case(lin, lin_in.pop("x"), smi)

    # 2 steps against the CPU port's int8 request; every int8 linear of the
    # card's request on its own first input against its CPU computation
    cpu = Synthesizer(cfg, qtree, params_hift, device="cpu")
    kw = dict(text="佢", lang="yue", phone="keoi5", n_timesteps=2)
    t = time.perf_counter()
    ref = cpu.synthesize(**kw)
    cpu_s = time.perf_counter() - t
    firsts = {}

    def keep_first(mod, args):
        firsts.setdefault(mod, args[0].detach().clone())

    hooks = [m.register_forward_pre_hook(keep_first)
             for m in int8.tts.modules() if isinstance(m, QuantLinear)]
    try:
        out, _ = request("int8", "2 steps (against the CPU)", None, False, **kw)
    finally:
        for h in hooks:
            h.remove()
    mae = float(np.abs(out.mel - ref.mel).mean()) if out.mel.shape == ref.mel.shape else float("inf")
    bad, worst = [], 0.0
    for name, mod in int8.tts.named_modules():
        if mod not in firsts:
            continue
        x = firsts.pop(mod)
        cpu_mod = cpu.tts.get_submodule(name)
        with torch.inference_mode():
            got, want = mod(x).cpu(), cpu_mod(x.cpu())
        x_q, _ = quantize_rows(x.reshape(-1, x.shape[-1]))
        r_q, _ = quantize_rows(x.cpu().reshape(-1, x.shape[-1]))
        worst = max(worst, float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
        if not (torch.equal(x_q.cpu(), r_q) and torch.allclose(got, want, rtol=1e-6, atol=0)):
            bad.append(name)
    log(f"int8 reference (CPU, plain versions) vs card at 2 steps: mel_frames "
        f"{out.mel_frames}/{ref.mel_frames} mel_mae={mae:.3e} (CPU {cpu_s:.1f} s); each int8 "
        f"linear on the card's own input against the CPU: {want_q - len(bad)} of {want_q} with "
        f"equal int8 activations and outputs within rtol 1e-6 (max rel err {worst:.3e})")
    if out.mel_frames != ref.mel_frames or not mae < 1e-2 or bad or firsts:
        fail(f"the card's int8 output does not agree with the CPU's int8 output "
             f"(linears off: {bad[:5]})")
    del cpu

    # synthesize_batch and the engine on the int8 synthesizer
    items = [dict(it) for it in SERVE_ITEMS[:3]]
    direct = [int8.synthesize(**it, n_timesteps=10, length_scale=scale, pcm16=True)
              for it in items]
    kernels.reset_launch_counts()
    batch = int8.synthesize_batch(items, n_timesteps=10, length_scale=scale, pcm16=True)
    launches = dict(kernels.LAUNCHES)
    maes = [float(np.abs(b.mel - d.mel).mean()) for b, d in zip(batch, direct)]
    log(f"int8 synthesize_batch of 3 (b_pad 4): frames {[b.mel_frames for b in batch]}, mel MAE "
        f"against direct synthesize max {max(maes):.3e}, launches {launches}")
    if (launches != dict(zero, flash_attention=10 * per_step, resblock_stage=2,
                         int8_quant_rows=10 * want_q, int8_gemm=10 * want_q)
            or [b.mel_frames for b in batch] != [d.mel_frames for d in direct]
            or not max(maes) < 1e-2):
        fail("int8 synthesize_batch failed its checks")
    for k in counts:
        counts[k] += launches[k]
    with ServingEngine(int8, max_batch=8, max_wait_ms=200.0, n_timesteps=10,
                       length_scale=scale, pcm16=True, return_mel=True) as engine:
        launches, _, _ = _serve_group(engine, items, direct, "int8, 3 requests, b_pad 4", 1, smi,
                                      captured)
    for k in counts:
        counts[k] += launches[k]
    del synths, direct, batch
    torch.cuda.empty_cache()
    kernel_cases = phase_serve_path_kernels(int8, captured, smi, phase="11a")
    del int8, captured
    torch.cuda.empty_cache()
    log(f"int8 phase times: {json.dumps(times)}, QuantLinear {json.dumps(lin_times)} ({smi})")
    return counts, kernel_cases


# the estimator's int8 linears: (K, N, bias), q/k/v then o, ff_in, ff_out
INT8_LINEARS = ((256, 512, False), (512, 256, True), (256, 1024, True), (1024, 256, True))
# the DiT's block GEMMs (phase 11e): a call's packed valid rows in the DiT
# cell (two 16-request halves of ~890 frames for guidance), and (name, K, N)
F32_GEMM_ROWS = 28500
F32_GEMM_LINEARS = (("qkv", 1024, 3072), ("o", 1024, 1024), ("ff_in", 1024, 2048),
                    ("ff_out", 2048, 1024))
INT8_ROWS = (49152, 1024)  # a batch-16 group at the 1536 bucket with CFG; a small one


def phase_int8_kernels(smi):
    """11d, the int8 linear's two kernels on seeded inputs at the estimator's
    four (K, N) and INT8_ROWS rows: bit-equal to the plain composition on
    the card (x scaled by 3 and every 7th row zero: the 1e-12 floor), one
    launch of each kernel per call; the pair's CUDA-event and device times,
    each kernel's device time, the bytes bound of the linear (x read once in
    f32, w_q, the scales and the bias read, y written) and, apart, what the
    design's own intermediate adds to it (x_q written and read back, sx),
    the plain composition's times and torch._int_mm's alone, and the
    wrapper's host microseconds per call. Returns the cases by name for the
    kernel line."""
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.nn import quant

    g = torch.Generator(device="cuda").manual_seed(18)
    quant_fn, gemm_fn = quant._entries()
    cases = {}
    for m in INT8_ROWS:
        for k, n, has_bias in INT8_LINEARS:
            x = torch.randn(m, k, device="cuda", generator=g) * 3
            x[::7] = 0
            w_q = torch.randint(-127, 128, (n, k), device="cuda", generator=g,
                                dtype=torch.int8)
            scale = torch.rand(n, device="cuda", generator=g) * 0.01 + 1e-4
            bias = torch.randn(n, device="cuda", generator=g) if has_bias else None
            kernels.reset_launch_counts()
            got = quant.int8_linear(x, w_q, scale, bias)
            launches = dict(kernels.LAUNCHES)
            want = quant.linear_q_plain(x, w_q.t(), scale, bias)
            equal = torch.equal(got, want)
            x_q, sx = quant.quantize_rows(x)
            sx1 = sx.reshape(-1)
            y = torch.empty_like(got)

            def quant_only():  # on the current stream: a capture's own
                kernels.check(quant_fn(x.data_ptr(), k, x_q.data_ptr(), sx1.data_ptr(), m, k,
                                       torch.cuda.current_stream().cuda_stream),
                              "int8_quant_rows")

            def gemm_only():
                kernels.check(gemm_fn(x_q.data_ptr(), w_q.data_ptr(), sx1.data_ptr(),
                                      scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
                                      y.data_ptr(), m, n, k,
                                      torch.cuda.current_stream().cuda_stream), "int8_gemm")

            pair = lambda: quant.int8_linear(x, w_q, scale, bias)  # noqa: E731
            plain = lambda: quant.linear_q_plain(x, w_q.t(), scale, bias)  # noqa: E731
            w_t = w_q.t()
            moved = m * k * 4 + n * k + n * 4 * (2 if has_bias else 1) + m * n * 4
            bound_ms, bound_by = bound(moved, 2 * m * n * k, PEAK_INT8_OPS)
            case = dict(
                ms=cuda_time_ms(pair, 50), device_ms=graph_time_ms(pair),
                quant_device_ms=graph_time_ms(quant_only), gemm_device_ms=graph_time_ms(gemm_only),
                plain_ms=cuda_time_ms(plain, 20), plain_device_ms=graph_time_ms(plain),
                library_ms=cuda_time_ms(lambda: torch._int_mm(x_q, w_t), 50),
                library_device_ms=graph_time_ms(lambda: torch._int_mm(x_q, w_t)),
                bound_ms=bound_ms, x_q_ms=bound(2 * m * k + 2 * m * 4, 0, PEAK_INT8_OPS)[0],
                host_us=host_us_per_call(pair, 300))
            case["roofline_pct"] = 100.0 * bound_ms / case["device_ms"]
            name = f"m{m}_k{k}_n{n}"
            cases[name] = case
            log(f"int8 linear {k}->{n} ({'bias' if has_bias else 'no bias'}) on {m} rows: "
                f"bit-equal to the plain composition {equal}, launches "
                f"{launches['int8_quant_rows']} + {launches['int8_gemm']}; "
                f"{json.dumps({c: round(v, 4) for c, v in case.items()})} (bound by {bound_by}; "
                f"x_q_ms is the x_q and sx round trip at the bytes peak, a cost of the design "
                f"outside bound_ms; {smi})")
            if not equal or launches != dict({c: 0 for c in launches}, int8_quant_rows=1,
                                             int8_gemm=1):
                fail(f"the int8 linear kernels at {name} are not bit-equal to the plain "
                     f"composition or did not launch once each")
            del x, x_q, sx, sx1, y, got, want
    torch.cuda.empty_cache()
    return cases


def _gemm_errors(y, want):
    """Largest, mean absolute and mean signed error of y against an f64 want."""
    d = y.double() - want
    return float(d.abs().max()), float(d.abs().mean()), float(d.mean())


def phase_f32_gemm(smi):
    """11e, the DiT's 3xTF32 GEMM (csrc/f32_gemm.cu) at the block's four
    (K, N) on F32_GEMM_ROWS rows (a DiT call's packed valid rows in the DiT
    cell): against its plain version and an f64 product beside cuBLAS's f32
    GEMM (F.linear, TF32 off) on the same seeded inputs (largest, mean
    absolute and mean signed error), one launch a call through the route
    `f32_gemm.linear`, its difference from the plain version within the
    sum of the two's largest errors against f64; CUDA-event times of
    the kernel, the plain version and F.linear beside the 3xTF32 bound
    (three TF32 products a product at 495 TFLOP/s) and the f32 FFMA bound
    (67 TFLOP/s), and the kernel's and cuBLAS's TFLOP/s of f32 work.
    Returns the cases by name for the kernel line."""
    import torch
    import torch.nn.functional as F

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.nn import f32_gemm

    g = torch.Generator(device="cuda").manual_seed(22)
    m = F32_GEMM_ROWS
    cases = {}
    for name, k, n in F32_GEMM_LINEARS:
        x = torch.randn(m, k, device="cuda", generator=g)
        w = (torch.rand(n, k, device="cuda", generator=g) * 2 - 1) / k ** 0.5
        b = torch.randn(n, device="cuda", generator=g) * 0.1
        images = f32_gemm.prepare_weight(w)
        kernels.reset_launch_counts()
        got = f32_gemm.linear(x, images, b)
        launches = kernels.LAUNCHES["f32_gemm"]
        want = F.linear(x.double(), w.double(), b.double())
        err = _gemm_errors(got, want)
        err_lib = _gemm_errors(F.linear(x, w, b), want)
        plain = f32_gemm.linear_plain(x, images, b)
        err_plain = _gemm_errors(plain, want)
        vs_plain = float((got - plain).abs().max())
        del plain
        flop = 2.0 * m * n * k
        moved = 4 * (m * k + 2 * n * k + n + m * n)
        case = dict(
            ms=cuda_time_ms(lambda: f32_gemm.linear(x, images, b), 20),
            plain_ms=cuda_time_ms(lambda: f32_gemm.linear_plain(x, images, b), 5),
            library_ms=cuda_time_ms(lambda: F.linear(x, w, b), 20),
            bound_ms=bound(moved, 3 * flop, PEAK_TF32_FLOPS)[0],
            bound_f32_ms=bound(moved, flop, PEAK_F32_FLOPS)[0],
            max_err=err[0], mean_abs_err=err[1], mean_err=err[2],
            library_max_err=err_lib[0], library_mean_abs_err=err_lib[1],
            library_mean_err=err_lib[2], plain_max_err=err_plain[0], max_diff_plain=vs_plain)
        case["tflops"] = flop / case["ms"] / 1e9
        case["library_tflops"] = flop / case["library_ms"] / 1e9
        case["roofline_pct"] = 100.0 * case["bound_ms"] / case["ms"]
        cases[name] = case
        log(f"f32 GEMM {name} ({m} x {k} -> {n}): launches {launches}; "
            f"{json.dumps({c: float(f'{v:.4g}') for c, v in case.items()})} ({smi})")
        if launches != 1 or not (err[0] <= 2 * err_lib[0] and err[1] <= 2 * err_lib[1]):
            fail(f"the f32 GEMM at {name} did not launch once or is less accurate than 2x "
                 f"cuBLAS's f32 GEMM against f64")
        if vs_plain > err[0] + err_plain[0]:
            fail(f"the f32 GEMM at {name} differs from its plain version by {vs_plain:.3g}, more "
                 f"than the two's largest errors against f64 ({err[0]:.3g} + {err_plain[0]:.3g})")
        del x, w, b, images, got, want
    torch.cuda.empty_cache()
    return cases


DIT_GROUP = 16  # the DiT cell's group: 16 requests, 2 x 16 rows with guidance
DIT_FRAMES = 890  # the frames a zero speaker gets; seeded speakers spread them


def phase_dit(smi):
    """11f, the DiT decoder at its published widths (random trees, seeds
    0 and 1) in a Synthesizer on the card: a group of DIT_GROUP requests
    (one sentence stretched to DIT_FRAMES frames, a seeded speaker each)
    through `synthesize_batch_dispatch` at 10 steps, the launch counts
    reset just before it: 88 launches of the f32 GEMM per estimator call
    (one call a step; 4 a block). Then the same group with the blocks'
    GEMMs on the plain version (`f32_gemm.linear_plain`, three cuBLAS f32
    products): the two mels within 1e-4 of the largest magnitude (the DiT
    tests' bar). Each group timed on the host clock behind a synchronize.
    Returns the kernel group's launches."""
    import dataclasses

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import config as C
    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.nn import f32_gemm
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    base = C.JyutVoiceConfig()
    cfm = dataclasses.replace(base.tts.cfm, estimator_kind="dit", dit=C.DiTConfig())
    cfg = dataclasses.replace(base, tts=dataclasses.replace(base.tts, cfm=cfm))
    steps, depth = 10, cfg.tts.cfm.dit.depth
    synth = Synthesizer(cfg, random_init.init_tts_tree(cfg.tts, seed=0),
                        random_init.init_hift_tree(cfg.hift, seed=1), device="cuda")
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    scale = scale_for(synth, DIT_FRAMES, **yue)
    rng = np.random.default_rng(11)
    items = [dict(yue, spk_embed=rng.standard_normal(cfg.tts.spk_embed_dim).astype(np.float32))
             for _ in range(DIT_GROUP)]

    def group():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = synth.synthesize_batch_dispatch(items, n_timesteps=steps, length_scale=scale)()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    group()  # warm: the shapes, and the blocks' weight images
    kernels.reset_launch_counts()
    res, ms = group()
    launches = dict(kernels.LAUNCHES)
    route = f32_gemm.linear
    f32_gemm.linear = lambda x, images, bias=None: f32_gemm.linear_plain(x, images, bias)
    try:
        kernels.reset_launch_counts()
        plain, plain_ms = group()
        plain_launches = kernels.LAUNCHES["f32_gemm"]
    finally:
        f32_gemm.linear = route
    frames = [r.mel_frames for r in res]
    gap = max(float(np.abs(a.mel - b.mel).max()) for a, b in zip(res, plain)) \
        / max(float(np.abs(b.mel).max()) for b in plain)
    log(f"DiT group: {DIT_GROUP} requests, frames {min(frames)}-{max(frames)}, "
        f"{2 * sum(frames)} packed rows a call, {steps} steps: launches {launches}; "
        f"{ms:.1f} ms, plain GEMMs {plain_ms:.1f} ms ({plain_launches} f32 GEMM launches); "
        f"mel gap to the plain GEMMs {gap:.3g} of the largest ({smi})")
    if launches["f32_gemm"] != steps * 4 * depth or plain_launches \
            or not all(np.isfinite(r.mel).all() for r in res) or gap > 1e-4:
        fail(f"the DiT group did not launch the f32 GEMM {steps * 4 * depth} times or differs "
             f"from its plain GEMMs by more than 1e-4")
    del synth, res, plain
    torch.cuda.empty_cache()
    return launches


def phase_warmup_long(params_tts, params_hift, smi):
    """11b, `Synthesizer.warmup_long` at full width, 10 steps, PCM16: text
    buckets 1024 and 8192 and mel sizes 2048, 4096 and 12288 with exact
    attention (560 kernel-3 launches per solve) and auto (banded), then a
    prompted exact job at 2048 (t_total 2560); every job's launches read
    and its seconds taken (synchronised) by the log callback; the count
    against the JAX formula. Then synthesize_long, exact, first and second
    at about 12000 frames (12288, warmed) and 8000 frames (8192, not
    warmed). Returns the launches."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    cfg = JyutVoiceConfig()
    est = cfg.tts.cfm.estimator
    per_solve = 10 * (est.num_mid_blocks + 2) * est.n_blocks
    synth = Synthesizer(cfg, params_tts, params_hift, device="cuda")
    counts = {k: 0 for k in kernels.LAUNCHES}
    zero = {k: 0 for k in kernels.LAUNCHES}
    table = dict(mel_sizes=(2048, 4096, 12288), text_buckets=(1024, 8192))
    runs = [
        ("exact", dict(table, attention="exact"),
         [0, 0] + [per_solve] * 3),
        ("auto", dict(table, attention="auto"), [0, 0, 0, 0, 0]),
        ("exact, prompted", dict(mel_sizes=(2048,), text_buckets=(), with_prompt=True,
                                 attention="exact"), [per_solve, per_solve]),
    ]
    for label, kw, want_k3 in runs:
        seen = []
        clock = [time.perf_counter()]

        def log_fn(msg):
            torch.cuda.synchronize()
            now = time.perf_counter()
            seen.append((msg, dict(kernels.LAUNCHES), (now - clock[0]) * 1e3))
            clock[0] = now
            kernels.reset_launch_counts()

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        n = synth.warmup_long(n_timesteps=(10,), pcm16=True, log_fn=log_fn, **kw)
        wall = time.perf_counter() - t0
        want_n = len(kw["text_buckets"]) + len(kw["mel_sizes"]) * (1 + kw.get("with_prompt", 0))
        ok = n == want_n == len(seen)
        for (msg, launches, ms), k3 in zip(seen, want_k3):
            mel_job = msg.startswith("warmup_long: mel")
            want = dict(zero, flash_stock=k3, resblock_stage=2 if mel_job else 0)
            ok &= launches == want
            for k in counts:
                counts[k] += launches[k]
            log(f"warmup_long {label}: {msg} in {ms:.1f} ms, launches {launches}")
        log(f"warmup_long {label}: {n} shapes (JAX count {want_n}) in {wall:.1f} s ({smi})")
        if not ok:
            fail(f"warmup_long {label} failed its checks (count {n}, want {want_n}; "
                 f"kernel 3 per job {want_k3}, kernel 2 twice per mel job)")

    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    for frames, note in ((12000, "warmed"), (8000, "not warmed")):
        kw = dict(yue, attention="exact", length_scale=scale_for(synth, frames, **yue))
        first = []
        for which in ("first", "second"):
            kernels.reset_launch_counts()
            res = synth.synthesize_long(n_timesteps=10, pcm16=True, **kw)
            launches = dict(kernels.LAUNCHES)
            first.append(res.timings["total"] * 1e3)
            t = {k: round(v * 1e3, 1) for k, v in res.timings.items() if k != "audio_seconds"}
            log(f"synthesize_long after warmup_long, exact, {res.mel_frames} frames ({note}), "
                f"{which}: ms {json.dumps(t)}, launches {launches} ({smi})")
            if (launches != dict(zero, flash_stock=per_solve, resblock_stage=2)
                    or not np.isfinite(res.wav).all()):
                fail(f"synthesize_long after warmup_long ({note}, {which}) failed its checks")
            for k in counts:
                counts[k] += launches[k]
        log(f"synthesize_long at {frames} frames ({note}): first {first[0]:.1f} ms, second "
            f"{first[1]:.1f} ms, first - second {first[0] - first[1]:.1f} ms ({smi})")
    del synth
    torch.cuda.empty_cache()
    return counts


def phase_host_mas(mas_inputs, smi):
    """11c, the host MAS: mas.cpp built with g++ into _build/ and loaded (the
    numpy fallback must not run), then on each MAS input phase 9's training
    steps made (B=2 at the 2048 bucket, B=16 at mel 512) the host path
    (device-to-host copy, maximum_path_host, the path back to the card)
    against the device wavefront maximum_path, bit for bit, each timed
    (median of 3 after one warm call; the device's by CUDA events, the
    host's by the host clock around synchronised copies)."""
    import statistics

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import align

    t0 = time.perf_counter()
    lib = align._get_lib()
    log(f"host MAS: native library {align._lib_path()} loaded={lib is not None} "
        f"({time.perf_counter() - t0:.1f} s with the build)")
    if lib is None:
        fail("the native host MAS did not build or load")
    if not mas_inputs:
        fail("phase 9 handed no input to MAS")

    def no_fallback(*a):
        raise RuntimeError("the numpy fallback ran")

    real_numpy = align._maximum_path_numpy
    align._maximum_path_numpy = no_fallback
    try:
        for shape, (value, mask) in sorted(mas_inputs.items()):
            device = align.maximum_path(value, mask)
            host = align.maximum_path_host(value.cpu().numpy(), mask.cpu().numpy())
            same = torch.equal(device.cpu(), torch.from_numpy(host))
            _, dev_ms = _event_ms(lambda: align.maximum_path(value, mask))
            parts = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v, m = value.cpu().numpy(), mask.cpu().numpy()
                t1 = time.perf_counter()
                p = align.maximum_path_host(v, m)
                t2 = time.perf_counter()
                torch.from_numpy(p).to(value.device)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t3 - t0) * 1e3))
            d2h, mas, h2d, total = (statistics.median(p[i] for p in parts[1:]) for i in range(4))
            lens = (mask[:, :, 0].sum(1).int().tolist(), mask[:, 0, :].sum(1).int().tolist())
            log(f"host MAS {shape} (text lengths {lens[0]}, mel lengths {lens[1]}): equal to the "
                f"device MAS {same} ({int(np.asarray(host).sum())} path cells); device "
                f"(maximum_path, CUDA events) {dev_ms:.2f} ms; host {total:.2f} ms = copy to "
                f"the host {d2h:.2f} + mas.cpp {mas:.2f} + copy back {h2d:.2f} ({smi})")
            if not same:
                fail(f"the host MAS differs from the device MAS at {shape}")
    finally:
        align._maximum_path_numpy = real_numpy


SERVE_EXPORT_TOL = 1e-6  # replay / reloaded artifact against the eager module (the JAX test's bar)
SERVE_EXPORT_TOP = (15000, 13000)  # 12c: the top mel bucket, and the frames asked for there


def _flash_heads_case(label, q, k, v, lengths, kw):
    """Kernel 1 at the top mel bucket: all heads through the kernel, heads 0
    and H-1 against the plain version on the valid rows (the plain
    version's scores of all heads do not fit), then the kernel timed alone.
    Returns (max |err|, ms, bound ms, what bounds it)."""
    import torch

    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention, flash_attention_plain

    b, t, h, d = q.shape
    lens = lengths.tolist()
    out = flash_attention(q, k, v, lengths, **kw)
    err, ok = 0.0, True
    for hd in (0, h - 1):
        one = slice(hd, hd + 1)
        ref = flash_attention_plain(q[:, :, one], k[:, :, one], v[:, :, one], lengths, **kw)
        for i, n in enumerate(lens):
            err = max(err, float((out[i, :n, one] - ref[i, :n]).abs().max()))
            ok &= within(out[i, :n, one], ref[i, :n], ATTN_TOL)
        del ref
        torch.cuda.empty_cache()
    del out
    log(f"flash {label}T={t} lengths={lens} heads 0 and {h - 1}: max_abs_err={err:.3e} ok={ok}")
    if not ok:
        fail(f"flash attention disagrees with its plain version at {label}T={t}")
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, lengths, **kw), 5, warmup=1)
    pairs = t * sum(lens) * h  # every row sees its batch's valid keys
    return (err, ms, *bound(4 * b * t * h * d * 4, 4 * pairs * d, PEAK_BF16_FLOPS))


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _replay_kernel(name):
    """Which of the port's kernels a device kernel of a trace is, by its
    name, or None. Kernels 1 and 3 share the template flash_fwd_sm90,
    whose last argument (kF16) is false for kernel 1 and true for 3."""
    if "resblock_stage_sm90" in name:
        return "resblock_stage"
    if "flash_fwd_sm90" in name:
        return "flash_stock" if re.search(r"true>\(|Lb1EEv", name) else "flash_attention"
    return None


def replay_launches(prog, args):
    """The port's kernels that one replay of a bucket program runs, counted
    by name in a torch.profiler trace of the card (the replay is one of the
    program's own). Returns ({kernel: launches}, device kernels in all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {}
    for name in names:
        kernel = _replay_kernel(name)
        if kernel:
            seen[kernel] = seen.get(kernel, 0) + 1
    return seen, len(names)


def phase_serving_export(params_tts, params_hift, scale, smi):
    """12, the serving export at full width (seeded random trees, 10 steps,
    phase 6's sentence and text bucket): 12a aot_compile at the 512 bucket,
    12b the same with phase 6's 100-frame prompt in its prompt bucket, 12c
    at the 15000 bucket (about 13000 frames: kernel 1 at T=15000 and the
    windowed vocoder at batch 8 inside the graph). Every program shares the
    weights of one Synthesizer's modules. Each: the capture's seconds, its
    peak device memory and what it holds after it (the reserved memory's
    growth: its graph's private pool and static buffers), its launches at
    capture (560 of kernel 1 and 2 of kernel 2) and those of one replay,
    counted in a torch.profiler trace of the card, the replay against the
    eager ServingGraph on the same inputs (max |diff| <= SERVE_EXPORT_TOL,
    lengths equal), call 1's result unchanged by call 2 on other inputs,
    wrong shapes refused, and Synthesizer.synthesize on the same text in
    the same bucket (frames equal, mel MAE < 1e-2). 12d export_program /
    load_program at the 512 bucket, 10 steps: trace, artifact bytes, load;
    the reloaded program against the eager ServingGraph on "xla_scores"
    (max |diff| <= SERVE_EXPORT_TOL) and against 12a's program (frames
    equal, mel MAE < 1e-2). CUDA-event medians of 5 warm calls of the
    replay, the eager ServingGraph and synthesize at 512 and 15000, and of
    the reloaded program and the eager module on "xla_scores" at 512. 12e:
    kernels 1 and 2 on the first input of each shape that the eager calls
    of 12a-12c handed them. Returns (launches: the Python-counted ones plus
    each program's replays times the launches of its traced replay; kernel
    1's and 2's max |err|; phase 12's fields; kernel 1's and 2's fields)."""
    import statistics

    import numpy as np
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline import buckets, serving
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    log(f"serving export: torch {torch.__version__}")
    cfg = JyutVoiceConfig()
    est = cfg.tts.cfm.estimator
    per_request = dict(flash_attention=10 * (est.num_mid_blocks + 2) * est.n_blocks,
                       resblock_stage=2)
    synth = Synthesizer(cfg, params_tts, params_hift, device="cuda")
    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    rng = np.random.default_rng(0)  # phase 6's prompted request's draws
    spk = rng.standard_normal(192).astype(np.float32)
    pf = rng.standard_normal((100, 80)).astype(np.float32)
    ph = rng.standard_normal((100, 80)).astype(np.float32)
    arrs, n, t_text = synth.prepare_text(**yue)
    counts = {k: 0 for k in kernels.LAUNCHES}
    programs = []  # (replays, launches of a traced replay) of every BucketProgram built
    captured, fields = {}, {}

    def counted(fn, *a, **kw):
        kernels.reset_launch_counts()
        out = fn(*a, **kw)
        for key in counts:
            counts[key] += kernels.LAUNCHES[key]
        return out

    def eager(graph, args):
        with torch.inference_mode():
            return graph(*args)

    def bucket_case(key, t_mel, length_scale, prompted, timings):
        t_prompt = buckets.pick_prompt_bucket(100, t_mel) if prompted else 0
        prompt = dict(spk_embed=spk, prompt_feat=pf, prompt_h=ph) if prompted else {}
        args = serving.request_args(arrs, n, t_prompt=t_prompt, device="cuda", **prompt)
        graph = serving.build_serving_fn(cfg, synth.tts, synth.hift, t_text=t_text,
                                         t_mel=t_mel, t_prompt=t_prompt, n_timesteps=10,
                                         length_scale=length_scale, device="cuda")
        kernels.reset_launch_counts()
        with serving_kernel_inputs(captured, f"phase 12 {key}"):
            ref = counted(eager, graph, args)
        torch.cuda.synchronize()
        if {k: v for k, v in kernels.LAUNCHES.items() if v} != per_request:
            fail(f"12 {key}: the eager ServingGraph launched {dict(kernels.LAUNCHES)}")
        torch.cuda.empty_cache()
        base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        prog = counted(serving.BucketProgram, graph)
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.empty_cache()
        held_gib = (torch.cuda.memory_reserved() - base_reserved) / 2**30
        out = prog(*args)
        diff = _max_diff(out[:2], ref[:2])
        same_len = torch.equal(out[2], ref[2])
        keep = [o.clone() for o in out]
        other = serving.request_args(arrs, n, spk_embed=np.ones(192, np.float32),
                                     t_prompt=t_prompt, device="cuda", **({} if not prompted
                                     else dict(prompt_feat=pf[:60], prompt_h=ph[:60])))
        out2 = prog(*other)
        fresh = all(torch.equal(o, k) for o, k in zip(out, keep)) and \
            not torch.equal(out[1], out2[1])
        try:
            prog(torch.zeros((1, t_text + 1), dtype=torch.int32, device="cuda"), *args[1:])
            refused = False
        except ValueError:
            refused = True
        replayed, device_kernels = replay_launches(prog, args)
        res = counted(synth.synthesize, **yue, length_scale=length_scale, n_timesteps=10,
                      **prompt)
        frames = int(out[2][0])
        mel = out[1][0, :frames].cpu().numpy()
        mae = float(np.abs(mel - res.mel).mean()) if res.mel_frames == frames else float("inf")
        bucket = buckets.pick_bucket(res.mel_frames, buckets.MEL_BUCKETS)
        log(f"12 {key}: t_text={t_text} t_mel={t_mel} t_prompt={t_prompt} frames={frames} "
            f"capture {prog.capture_s:.2f} s (warm call + capture), peak {peak_gib:.2f} GiB, "
            f"held after capture {held_gib:.2f} GiB (reserved); launches at capture "
            f"{prog.launches}, in a traced replay {replayed} of {device_kernels} device "
            f"kernels; replay vs eager max |diff| {diff:.3e} (bar {SERVE_EXPORT_TOL}), lengths "
            f"equal {same_len}; call 1 kept after call 2 {fresh}; a wrong shape refused "
            f"{refused}; vs synthesize (bucket {bucket}, {res.mel_frames} frames) mel MAE "
            f"{mae:.3e} ({smi})")
        if (prog.launches != per_request or replayed != per_request
                or not diff <= SERVE_EXPORT_TOL or not same_len or not fresh or not refused
                or bucket != t_mel or not mae < 1e-2
                or not np.isfinite(out[0].cpu().numpy()).all()):
            fail(f"12 {key}: the bucket program failed its checks")
        fields.update({f"{key}_capture_s": prog.capture_s, f"{key}_peak_gib": peak_gib,
                       f"{key}_held_gib": held_gib})
        if timings:
            ms = {"replay": _event_ms(lambda: prog(*args), loops=5)[1],
                  "eager": counted(lambda: _event_ms(lambda: eager(graph, args), loops=5)[1])}
            runs = []
            ms["synthesize"] = counted(lambda: _event_ms(
                lambda: runs.append(synth.synthesize(**yue, length_scale=length_scale,
                                                     n_timesteps=10)), loops=5)[1])
            ms["synthesize_mel_vocoder"] = statistics.median(
                (r.timings["mel"] + r.timings["vocoder"]) * 1e3 for r in runs[1:])
            log(f"12 {key} times, CUDA-event medians of 5 warm calls: "
                f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} ({smi})")
            fields.update({f"{key}_{k}_ms": v for k, v in ms.items()})
        programs.append((prog, replayed))
        return prog

    prog512 = bucket_case("512", 512, scale, False, True)
    # the speaker embedding moves the durations: scale them into the 512 bucket again
    spk_t = torch.as_tensor(spk, device="cuda").reshape(1, -1)
    bucket_case("512_prompted", 512, 480.0 / synth.duration_frames(arrs, n, spk_t), True,
                False)
    top, top_frames = SERVE_EXPORT_TOP
    bucket_case(str(top), top, scale_for(synth, top_frames, **yue), False, True)

    # 12d: the exported artifact at the 512 bucket, 10 steps, against 12a's program
    args = serving.request_args(arrs, n, device="cuda")
    bucket = dict(t_text=t_text, t_mel=512, n_timesteps=10, length_scale=scale,
                  device="cuda")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bucket512.pt2")
        t0 = time.perf_counter()
        program = serving.export_program(cfg, params_tts, params_hift, path, **bucket)
        trace_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        ops = sum(1 for nd in program.graph.nodes if nd.target is
                  torch.ops.jyutvoice.resblock_stage.default)
        del program
        t0 = time.perf_counter()
        loaded = serving.load_program(path)
        load_s = time.perf_counter() - t0
    out = counted(loaded, *args)
    scores = serving.build_serving_fn(serving.export_safe_cfg(cfg), params_tts, params_hift,
                                      **bucket)
    ref = counted(eager, scores, args)
    kern = prog512(*args)
    diff = _max_diff(out[:2], ref[:2])
    frames = int(out[2][0])
    mae = float((out[1] - kern[1]).abs().mean())
    log(f"12d export: 10 steps, trace {trace_s:.1f} s, artifact {nbytes} bytes, load "
        f"{load_s:.1f} s, {ops} jyutvoice.resblock_stage nodes; reloaded vs eager "
        f"ServingGraph on xla_scores max |diff| {diff:.3e} (bar {SERVE_EXPORT_TOL}), lengths "
        f"equal {torch.equal(out[2], ref[2])}; vs 12a's program: frames "
        f"{frames}/{int(kern[2][0])}, mel MAE {mae:.3e} ({smi})")
    if (not diff <= SERVE_EXPORT_TOL or not torch.equal(out[2], ref[2]) or ops != 2
            or frames != int(kern[2][0]) or not mae < 1e-2):
        fail("12d: the reloaded artifact failed its checks")
    ms = {"reloaded": counted(lambda: _event_ms(lambda: loaded(*args), loops=5)[1]),
          "eager_scores": counted(lambda: _event_ms(lambda: eager(scores, args), loops=5)[1])}
    log(f"12d times, CUDA-event medians of 5 warm calls: "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} ({smi})")
    fields.update(export_trace_s=trace_s, export_artifact_bytes=nbytes, export_load_s=load_s,
                  **{f"export_{k}_ms": v for k, v in ms.items()})
    del loaded, scores, out, ref, kern, prog512

    replayed = {k: sum(p.replays * per.get(k, 0) for p, per in programs) for k in counts}
    log(f"12 launches: counted in Python {counts}, by replays {replayed} ({len(programs)} "
        f"programs, {sum(p.replays for p, _ in programs)} replays)")
    counts = {k: counts[k] + replayed[k] for k in counts}
    del programs
    torch.cuda.empty_cache()

    # 12e: kernels 1 and 2 on this phase's own inputs
    torch.cuda.synchronize()
    flash_err, top = 0.0, {}
    for key in [k for k in captured if k[0] == "flash_attention" and k[1][1] > 4096]:
        case = captured.pop(key)
        err, ms, bound_ms, bound_by = _flash_heads_case(f"({case['label']}) ", *case["inputs"],
                                                        case["kw"])
        log(f"serve flash ({case['label']}) T={key[1][1]}: ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) ({smi})")
        top[f"b{key[1][0]}_t{key[1][1]}"] = dict(ms=ms, bound_ms=bound_ms)
        flash_err = max(flash_err, err)
        del case
    if not top:
        fail("phase 12 handed kernel 1 no input at the 15000 bucket")
    err, stage_err, flash, stage = phase_serve_path_kernels(synth, captured, smi, phase="12")
    flash.update(top)
    del synth, captured
    torch.cuda.empty_cache()
    return counts, max(flash_err, err), stage_err, fields, flash, stage


PHASE_S = {}  # phase name -> wall seconds, printed before the result


# ---------------------------------------------------------------------------
# Phase 13: multi-device on torch.distributed (dist/)
# ---------------------------------------------------------------------------

SP_TOL = (2e-5, 1e-4)  # the JAX package's SP bar (tests/test_sequence_parallel.py)
# the meshes of phase 13b, the attention modes and the Euler steps each runs,
# stated before the run: two ranks share the card over Gloo (NCCL refuses two
# ranks on one GPU; Gloo's point-to-point fails on CUDA tensors, so the
# ring's exchanges are staged through host memory, dist/mesh.py::
# GLOO_CUDA_OPS), at 2 steps, since Gloo moves every collective through host
# memory and a 10-step solve there takes about 20 s; one rank over NCCL at
# the full 10 steps
SP_MESHES = (("gloo, 2 ranks on cuda:0", 2, "gloo", ("scores", "banded", "ring"), 2),
             ("nccl, 1 rank on cuda:0", 1, "nccl", ("scores", "banded", "ring"), 10))
DDP_ROWS = (1400, 2000)  # dummy mel frames: the 2048 bucket, kernels 3-5


def _free_tcp_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_children(tmp, world, backend, device):
    """`python -m jyutvoice_tpu_torch.cli.train` as `world` torchrun-style
    processes (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK):
    full width, 2 steps at global batch 4 in the 2048 bucket."""
    port = str(_free_tcp_port())
    procs = []
    for r in range(world):
        out = open(os.path.join(tmp, f"rank{r}.log"), "w")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
        argv = [sys.executable, "-m", "jyutvoice_tpu_torch.cli.train", "--dummy",
                "--dummy-rows", "9", "--dummy-mel", ",".join(map(str, DDP_ROWS)),
                "--batch-size", "4", "--max-steps", "2", "--log-every", "1",
                "--ckpt-dir", os.path.join(tmp, "ckpt"),
                "--report", os.path.join(tmp, "rank{rank}.json"), "--device", device]
        if backend:
            argv += ["--dist-backend", backend]
        procs.append((subprocess.Popen(argv, env=env, stdout=out, stderr=subprocess.STDOUT,
                                       cwd=os.path.dirname(os.path.abspath(__file__))), out))
    return procs


def _collect_children(label, tmp, procs, timeout):
    reports = []
    for r, (p, out) in enumerate(procs):
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        out.close()
        text = open(os.path.join(tmp, f"rank{r}.log")).read()
        if p.returncode != 0:
            log(text[-3000:])
            fail(f"cli.train {label} rank {r} exited with {p.returncode}")
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _ddp_batch():
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows

    dm = TextMelDataModule(dummy_rows(9, seed=5, mel_frames=DDP_ROWS), DataConfig(batch_size=4))
    return next(iter(dm.train_batches(0)))


def ddp_rank(mesh, seed, batch):
    """One rank of phase 13a's data-parallel step (run on every rank of a
    spawned mesh): the full-width trainer on this rank's rows of the global
    batch, the all-reduced gradients, then a step. Rank 0 returns the
    metrics, the gradients and every rank's launches and checks."""
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.dist.mesh import make_mesh
    from jyutvoice_tpu_torch.models import tts as tts_mod
    from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    disable_tf32()
    cfg = JyutVoiceConfig()
    model = load_jax_params(tts_mod.TTS(cfg.tts), random_init.init_tts_tree(cfg.tts, seed=seed))
    model = model.to(mesh.device)
    trainer = Trainer(model, cfg.train, torch.Generator(device=mesh.device).manual_seed(seed),
                      mesh=make_mesh())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("decoder.")}
    kernels.reset_launch_counts()
    metrics, grads = trainer.gradients(batch)
    trainer.step(batch)
    torch.cuda.synchronize(mesh.device)
    launches = [kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES]
    unchanged = all(torch.equal(p, frozen[n]) for n, p in model.named_parameters()
                    if n.startswith("decoder."))
    check = float(sum(p.detach().double().sum() for p in trainer.params))
    row = torch.tensor([launches + [float(unchanged), check]], dtype=torch.float64,
                       device=mesh.device)
    rows = torch.cat(mesh.comm().all_gather(row, 0)).cpu()
    return ({k: float(v) for k, v in metrics.items()}, [g.detach().cpu() for g in grads], rows)


def phase_ddp_step(smi):
    """13a (iii): two Gloo ranks on the card take one data-parallel step on a
    global batch of 4 unequal rows; one process takes it on the whole batch."""
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.dist.mesh import Mesh
    from jyutvoice_tpu_torch.models import tts as tts_mod
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    batch = _ddp_batch()
    lens = [int(v) for v in batch["y_lengths"]]
    if batch["y"].shape[1] != 2048 or len(set(lens)) != 4:
        fail(f"the DDP batch is not 4 unequal rows in the 2048 bucket: {lens}")
    t0 = time.perf_counter()
    with Mesh.spawn(("data",), (2,), ["cuda:0", "cuda:0"], backend="gloo") as mesh:
        m2, g2, rows = mesh.run(ddp_rank, 0, batch)
    ddp_s = time.perf_counter() - t0
    cfg = JyutVoiceConfig()
    model = load_jax_params(tts_mod.TTS(cfg.tts), random_init.init_tts_tree(cfg.tts, seed=0))
    one = Trainer(model.cuda(), cfg.train, torch.Generator(device="cuda").manual_seed(0))
    kernels.reset_launch_counts()
    m1, g1 = one.gradients(batch)
    single = [kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES]
    loss_gap = {k: abs(m2[k] - float(v)) / abs(float(v)) for k, v in m1.items()}
    diff = sum(float(torch.sum((a - b.cpu()) ** 2)) for a, b in zip(g2, g1))
    ref = sum(float(torch.sum(b.cpu() ** 2)) for b in g1)
    grad_gap = (diff / ref) ** 0.5
    per_rank = {r: dict(zip(kernels.KERNEL_NAMES, (int(v) for v in rows[r, :-2])))
                for r in range(rows.shape[0])}
    unchanged = bool((rows[:, -2] == 1).all())
    same_params = float(rows[0, -1]) == float(rows[1, -1])
    per_step = 56
    want = {k: (2 * per_step if k.startswith("flash_stock") else 0) for k in kernels.KERNEL_NAMES}
    log(f"13a DDP step, 2 Gloo ranks on one card (global batch 4, y_lengths {lens}) against one "
        f"process: loss rel gaps {json.dumps({k: float(f'{v:.3e}') for k, v in loss_gap.items()})}"
        f" trainable grad rel L2 gap {grad_gap:.3e}, decoder bit-unchanged={unchanged}, ranks' "
        f"parameters equal after the step={same_params}, per-rank launches {per_rank} (want "
        f"{want}), one process {dict(zip(kernels.KERNEL_NAMES, single))}; {ddp_s:.1f} s with "
        f"the follower's start ({smi})")
    if (max(loss_gap.values()) > TRAIN_LOSS_RTOL or not grad_gap <= TRAIN_GRAD_RTOL
            or not unchanged or not same_params or any(per_rank[r] != want for r in per_rank)):
        fail("the data-parallel step does not agree with one process")
    counts = {k: sum(per_rank[r][k] for r in per_rank) + v
              for k, v in zip(kernels.KERNEL_NAMES, single)}
    return counts


def phase_ddp_cli(tmp, procs_one, procs_two):
    """13a (i) and (ii): cli.train at world 1 over NCCL and at world 2 over
    Gloo on the card (children started before 13a (iii)); their reports."""
    from jyutvoice_tpu_torch import kernels

    one = _collect_children("world 1 (nccl)", os.path.join(tmp, "one"), procs_one, 600)
    two = _collect_children("world 2 (gloo)", os.path.join(tmp, "two"), procs_two, 600)
    want = {k: (2 * 56 if k.startswith("flash_stock") else 0) for k in kernels.KERNEL_NAMES}
    gaps = {k: abs(two[0]["metrics"][k] - one[0]["metrics"][k]) / abs(one[0]["metrics"][k])
            for k in ("loss", "dur_loss", "prior_loss", "diff_loss")}
    log(f"13a cli.train, 2 steps at global batch 4 in the 2048 bucket: world 1 over NCCL "
        f"{json.dumps(one[0]['metrics'])}; world 2 over Gloo rank 0 "
        f"{json.dumps(two[0]['metrics'])}, rank 1 {json.dumps(two[1]['metrics'])}; "
        f"step-2 loss rel gaps {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}; "
        f"launches per rank {[r['launches'] for r in one + two]} (want {want} each)")
    ok = (all(r["step"] == 2 for r in one + two) and one[0]["world"] == 1
          and two[0]["world"] == 2 and two[0]["metrics"] == two[1]["metrics"]
          and max(gaps.values()) <= TRAIN_LOSS_RTOL
          and all(r["launches"] == want for r in one + two))
    if not ok:
        fail("cli.train across ranks does not agree with one rank")
    return {k: sum(r["launches"][k] for r in one + two) for k in kernels.KERNEL_NAMES}


def _mel_gap(a, b):
    import numpy as np

    d = np.abs(a - b)
    return float(d.max()), float(d.mean()), bool(np.all(d <= SP_TOL[0] + SP_TOL[1] * np.abs(b)))


def phase_sp(synth, scores, smi):
    """13b: synthesize_long(mesh=...) at about 4000 frames on each mesh of
    SP_MESHES, each of its attention modes at its step count, against one
    device at the same steps: "scores" and "ring" against the "xla_scores"
    synthesizer at the JAX SP bar and against exact attention (kernel 3) at
    mel MAE < 1e-2; "banded" against the single-device banded path at the
    JAX SP bar. Per-rank solve ms, the share in collectives and peak memory
    per rank."""
    import numpy as np

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.dist.sp import make_sp_mesh

    yue = dict(text="佢 係 邊 個", lang="yue", phone="keoi5 hai6 bin1 go3")
    base = dict(yue, length_scale=scale_for(synth, 4000, **yue))
    log("13b meshes, modes and steps: " + "; ".join(
        f"{label}: {', '.join(modes)} at {steps} steps" for label, _, _, modes, steps in SP_MESHES))
    counts = {k: 0 for k in kernels.LAUNCHES}
    for label, n, backend, modes, steps in SP_MESHES:
        kw = dict(base, n_timesteps=steps)
        kernels.reset_launch_counts()
        refs = {"scores": scores.synthesize_long(**kw),
                "exact": synth.synthesize_long(attention="exact", **kw),
                "banded": synth.synthesize_long(attention="banded", **kw)}
        launches = dict(kernels.LAUNCHES)
        counts = {k: counts[k] + launches[k] for k in counts}
        mel_ms = ", ".join(f"{r.timings['mel'] * 1e3:.1f}" for r in refs.values())
        log(f"13b single-device references (xla_scores, exact, banded) at "
            f"{refs['exact'].mel_frames} frames, {steps} steps: mel phases {mel_ms} ms; "
            f"launches {launches} ({smi})")
        mesh = make_sp_mesh(n, devices=["cuda:0"] * n, backend=backend)
        mesh.timing = True
        try:
            for mode in modes:
                kernels.reset_launch_counts()
                res = synth.synthesize_long(mesh=mesh, sp_attention=mode, **kw)
                launches = dict(kernels.LAUNCHES)
                stats = mesh.last_stats.numpy()
                ref = refs["banded" if mode == "banded" else "scores"]
                mx, mean, ok = _mel_gap(res.mel, ref.mel)
                mae_exact = float(np.abs(res.mel - refs["exact"].mel).mean())
                ranks = "; ".join(f"rank {r}: solve {v[0]:.1f} ms, collectives {v[1]:.1f} ms "
                                  f"({100 * v[1] / v[0]:.1f} %), peak {v[2] / 2**30:.2f} GiB"
                                  for r, v in enumerate(stats))
                log(f"13b {label}, {mode}, {steps} steps: mel_frames={res.mel_frames}, against "
                    f"one device ({'banded' if mode == 'banded' else 'xla_scores'}) max |diff| "
                    f"{mx:.3e} mean {mean:.3e} within the SP bar={ok}; mel MAE against exact "
                    f"(kernel 3) {mae_exact:.3e}; mel phase {res.timings['mel'] * 1e3:.1f} ms; "
                    f"{ranks}; launches {launches} ({smi})")
                # the band is approximate: held to the single-device band only
                exact_ok = mode == "banded" or mae_exact < 1e-2
                if (not ok or res.mel_frames != ref.mel_frames or not exact_ok
                        or launches["resblock_stage"] != 2
                        or any(v for k, v in launches.items() if k != "resblock_stage")):
                    fail(f"sequence-parallel {mode} on {label} does not agree with one device")
                for k in counts:
                    counts[k] += launches[k]
            if n == 2:
                engine_counts = phase_sp_engine(synth, mesh, steps, smi)
                counts = {k: counts[k] + engine_counts[k] for k in counts}
        finally:
            mesh.close()
    return counts


def phase_sp_engine(synth, mesh, steps, smi):
    """13c: one long request through ServingEngine(sp_mesh=...) against the
    same request through synthesize_long(mesh=...)."""
    import numpy as np

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine

    text = ("佢係邊個 " * 40).strip()  # past the interactive text cap: the long route
    phone = " ".join(["keoi5 hai6 bin1 go3"] * 40)
    ls = scale_for(synth, 2000, text, "yue", phone)
    want = synth.synthesize_long(text, lang="yue", phone=phone, mesh=mesh, n_timesteps=steps,
                                 length_scale=ls)
    kernels.reset_launch_counts()
    with ServingEngine(synth, max_batch=2, n_timesteps=steps, length_scale=ls, return_mel=True,
                       sp_mesh=mesh) as engine:
        t0 = time.perf_counter()
        res = engine.submit(text, lang="yue", phone=phone).result(timeout=600)
        ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    gap = float(np.abs(res.mel - want.mel).max())
    log(f"13c ServingEngine(sp_mesh=2 Gloo ranks) long request: mel_frames={res.mel_frames} "
        f"(direct {want.mel_frames}), max |mel diff| {gap:.3e}, {ms:.1f} ms, launches "
        f"{launches} ({smi})")
    if res.mel_frames != want.mel_frames or gap > SP_TOL[0] or launches["resblock_stage"] != 2:
        fail("the engine's sequence-parallel long request does not agree with synthesize_long")
    return launches


def phase_tp(synth, smi):
    """13c: the full-width estimator TP-sharded over two Gloo ranks on the
    card (H=8: 4 heads a rank, an all_reduce on CUDA after attn-out and
    ff_out) against one device: one estimator call and a 10-step solve at
    T=512; then cli.serve --sp-devices 2 refused on a one-card machine."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch.cli import serve
    from jyutvoice_tpu_torch.dist import tp
    from jyutvoice_tpu_torch.dist.sp import shard_params
    from jyutvoice_tpu_torch.models.cfm import cfm_forward
    from jyutvoice_tpu_torch.models.estimator import with_attention_backend

    rng = np.random.default_rng(13)
    t = 512
    dev = synth.device
    arr = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa
    x, mu, cond, spks = arr(2, t, 80), arr(2, t, 80), arr(2, t, 80), arr(2, 80)
    mask = torch.ones((2, t, 1), device=dev)
    tt = torch.tensor([0.25, 0.75], device=dev)
    dec = synth.tts.decoder
    plain = with_attention_backend(dec, "xla_scores")
    with torch.inference_mode():
        want = plain(x, mask, mu, tt, spks, cond)
        want_mel = cfm_forward(plain, synth.cfg.tts.cfm, mu[:1], mask[:1], spks[:1], cond[:1],
                               n_timesteps=10, rand_noise=synth.noise)
    with tp.make_tp_mesh(2, devices=["cuda:0", "cuda:0"], backend="gloo") as mesh:
        placed = shard_params(dec, mesh)
        got = tp.tp_estimator(placed, x, mask, mu, tt, spks, cond)
        t0 = time.perf_counter()
        got_mel = tp.tp_cfm_solve(dec, synth.cfg.tts.cfm, mesh, n_timesteps=10)(
            placed, mu[:1], mask[:1], spks[:1], cond[:1], synth.noise[:, :t])
        solve_ms = (time.perf_counter() - t0) * 1e3
        stats = mesh.last_stats.numpy()
        local = mesh.state[placed.key].mid[0].blocks[0].attn.q.weight.shape
    est_ok = within(got, want, SP_TOL)
    mx, mean, mel_ok = _mel_gap(got_mel.cpu().numpy(), want_mel.cpu().numpy())
    log(f"13c TP estimator, 2 Gloo ranks on one card (rank 0's q slice {tuple(local)}): one call "
        f"max |diff| {float((got - want).abs().max()):.3e} within the SP bar={est_ok}; 10-step "
        f"solve at T={t} max |diff| {mx:.3e} mean {mean:.3e} within={mel_ok}, {solve_ms:.1f} ms "
        f"({'; '.join(f'rank {r}: {s[0]:.1f} ms, peak {s[2] / 2**30:.2f} GiB' for r, s in enumerate(stats))}) ({smi})")
    if not (est_ok and mel_ok and local[0] == 256):
        fail("the tensor-parallel estimator does not agree with one device")
    try:
        serve.main(["--random-init", "--sp-devices", "2", "--port", "0"])
    except SystemExit as e:
        msg = str(e)
    else:
        fail("cli.serve --sp-devices 2 was not refused on a one-card machine")
    log(f"13c cli.serve --sp-devices 2 on one card: refused ({msg!r})")
    if msg != "--sp-devices 2 but only 1 device(s) visible":
        fail("cli.serve --sp-devices 2 was refused with another message")


def phase_multi_device(params_tts, params_hift, smi):
    """Phase 13: 13a DDP (cli.train children at world 1 over NCCL and world
    2 over Gloo, started first; the step against one process), 13b SP long
    form, 13c TP and the engine; returns the launches of every rank."""
    import dataclasses

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.dist.tp import tp_cfm_cfg
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    tmp = tempfile.mkdtemp(prefix="phase13-")
    for sub in ("one", "two"):
        os.makedirs(os.path.join(tmp, sub))
    procs_one = _train_children(os.path.join(tmp, "one"), 1, None, "cuda")
    procs_two = _train_children(os.path.join(tmp, "two"), 2, "gloo", "cuda:0")
    try:
        counts = phase_ddp_step(smi)
    except BaseException:
        for p, out in procs_one + procs_two:
            p.kill()
            p.wait()
            out.close()
        raise
    ddp_cli = phase_ddp_cli(tmp, procs_one, procs_two)
    counts = {k: counts[k] + ddp_cli[k] for k in counts}
    cfg = JyutVoiceConfig()
    synth = Synthesizer(cfg, params_tts, params_hift, device="cuda")
    scores_cfg = dataclasses.replace(cfg, tts=dataclasses.replace(cfg.tts, cfm=tp_cfm_cfg(
        cfg.tts.cfm)))
    scores = Synthesizer(scores_cfg, params_tts, params_hift, device="cuda")
    sp_counts = phase_sp(synth, scores, smi)
    del scores
    phase_tp(synth, smi)
    return {k: counts[k] + sp_counts[k] for k in kernels.LAUNCHES}


def timed(name, fn, *args, **kw):
    t = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = round(time.perf_counter() - t, 1)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs only on a GPU")
        return 2
    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    t_start = time.perf_counter()
    smi = phase_device()
    timed("build", phase_build)

    cfg = JyutVoiceConfig()
    t = time.perf_counter()
    params_tts = random_init.init_tts_tree(cfg.tts, seed=0)
    params_hift = random_init.init_hift_tree(cfg.hift, seed=1)
    synth = Synthesizer(cfg, params_tts, params_hift, device="cuda")
    log(f"full-width Synthesizer (random weights, seeds 0/1) ready in {time.perf_counter() - t:.1f} s")

    warm_card()
    flash = timed("3 flash", phase_flash)
    stock = timed("4 flash_stock", phase_flash_stock)
    bwd = timed("8 flash_stock_bwd", phase_flash_stock_bwd)
    stage = timed("5 stage", phase_stage, synth)
    main_results, counts, scale = timed("6 main path", phase_main_path, synth)
    timed("6 reference", phase_reference, synth, params_tts, params_hift)
    clone_counts, clone_feats, clone_trees, clone_wav = timed(
        "6b clone", phase_clone, synth, main_results["yue+phone@512"].wav, scale, smi)
    counts = {k: counts[k] + clone_counts[k] for k in counts}
    stream_err, stream_stage_err, stream_flash, stream_stage = timed(
        "6c stream kernels", phase_stream_kernels, synth, smi)
    stream_counts = timed("6d stream", phase_stream, synth, scale, clone_feats, clone_trees,
                          clone_wav, params_tts, params_hift, smi)
    counts = {k: counts[k] + stream_counts.get(k, 0) for k in counts}
    flash["max_abs_err"] = max(flash["max_abs_err"], stream_err)
    stage["max_abs_err"] = max(stage["max_abs_err"], stream_stage_err)
    flash.update(stream_b2_ms=stream_flash[2]["ms"], stream_b2_device_ms=stream_flash[2]["device_ms"],
                 stream_b2_plain_ms=stream_flash[2]["plain_ms"],
                 stream_b2_library_ms=stream_flash[2]["library_ms"],
                 stream_b2_bound_ms=stream_flash[2]["bound_ms"],
                 stream_b8_ms=stream_flash[8]["ms"], stream_b8_device_ms=stream_flash[8]["device_ms"],
                 stream_b8_library_ms=stream_flash[8]["library_ms"])
    stage.update(stream_pair_b1_ms=stream_stage[1]["ms"],
                 stream_pair_b1_plain_ms=stream_stage[1]["plain_ms"],
                 stream_pair_b1_bound_ms=stream_stage[1]["bound_ms"],
                 stream_pair_b4_ms=stream_stage[4]["ms"],
                 stream_pair_b4_plain_ms=stream_stage[4]["plain_ms"],
                 stream_pair_b4_bound_ms=stream_stage[4]["bound_ms"])
    serve_err, serve_stage_err, serve_flash, serve_stage = timed(
        "6e serve kernels", phase_serve_kernels, synth, smi)
    serve_counts, captured = timed("6f serve", phase_serve, synth, scale, clone_feats,
                                   clone_trees, clone_wav, smi)
    counts = {k: counts[k] + serve_counts.get(k, 0) for k in counts}
    path_err, path_stage_err, path_flash, path_stage = timed(
        "6g serve path kernels", phase_serve_path_kernels, synth, captured, smi)
    del captured
    flash["max_abs_err"] = max(flash["max_abs_err"], serve_err, path_err)
    stage["max_abs_err"] = max(stage["max_abs_err"], serve_stage_err, path_stage_err)
    for kernel, cases in ((flash, serve_flash), (stage, serve_stage),
                          (flash, {f"path_{c}": d for c, d in path_flash.items()}),
                          (stage, {f"path_{c}": d for c, d in path_stage.items()})):
        kernel.update({f"serve_{case}_{k}": v for case, d in cases.items() for k, v in d.items()})
    long_counts = timed("7 long form", phase_long_form, synth)
    timed("7 reference", phase_long_reference, synth, params_tts, params_hift)
    del synth
    torch.cuda.empty_cache()
    mas_inputs = {}
    train_counts = timed("9 train", phase_train, mas_inputs)
    timed("9 reference", phase_train_reference)
    counts = {k: counts.get(k, 0) + long_counts.get(k, 0) + train_counts[k] for k in train_counts}
    torch.cuda.empty_cache()
    ft_counts, ft_captured, ft_hift, ft_times = timed("10 fine-tune", phase_finetune, smi)
    counts = {k: counts[k] + ft_counts[k] for k in counts}
    ft = timed("10f fine-tune kernels", phase_finetune_kernels, ft_captured, ft_hift, smi)
    del ft_captured
    log(f"finetune times: {json.dumps(ft_times)} ({smi})")
    ft_err, ft_kernel = ft["stock"]
    flash["max_abs_err"] = max(flash["max_abs_err"], ft["flash"][0])
    stage["max_abs_err"] = max(stage["max_abs_err"], ft["stage"][0])
    stock["max_abs_err"] = max(stock["max_abs_err"], ft_err["fwd"])
    bwd["dkv"]["max_abs_err"] = max(bwd["dkv"]["max_abs_err"], ft_err["dk"], ft_err["dv"])
    bwd["dq"]["max_abs_err"] = max(bwd["dq"]["max_abs_err"], ft_err["dq"])
    bwd["prep"]["max_abs_err"] = max(bwd["prep"]["max_abs_err"], ft_err["lse2"])
    for kernel, cases in ((flash, ft["flash"][1]), (stage, ft["stage"][1])):
        kernel.update({f"finetune_{case}_{k}": v for case, d in cases.items() for k, v in d.items()})
    for kernel, key in ((stock, "fwd"), (bwd["dkv"], "dkv"), (bwd["dq"], "dq"),
                        (bwd["prep"], "prep")):
        kernel.update({f"finetune_{k}": v for k, v in ft_kernel[key].items()})
    torch.cuda.empty_cache()
    int8_counts, (int8_err, int8_stage_err, int8_flash, int8_stage) = timed(
        "11a int8", phase_int8, params_tts, params_hift, scale, smi)
    wl_counts = timed("11b warmup_long", phase_warmup_long, params_tts, params_hift, smi)
    timed("11c host MAS", phase_host_mas, mas_inputs, smi)
    int8_cases = timed("11d int8 linear kernels", phase_int8_kernels, smi)
    f32_cases = timed("11e f32 GEMM kernel", phase_f32_gemm, smi)
    dit_counts = timed("11f DiT", phase_dit, smi)
    del mas_inputs
    counts = {k: counts[k] + int8_counts[k] + wl_counts[k] + dit_counts[k] for k in counts}
    flash["max_abs_err"] = max(flash["max_abs_err"], int8_err)
    stage["max_abs_err"] = max(stage["max_abs_err"], int8_stage_err)
    for kernel, cases in ((flash, int8_flash), (stage, int8_stage)):
        kernel.update({f"int8_{case}_{k}": v for case, d in cases.items() for k, v in d.items()})

    sx_counts, sx_flash_err, sx_stage_err, sx_fields, sx_flash, sx_stage = timed(
        "12 serving export", phase_serving_export, params_tts, params_hift, scale, smi)
    counts = {k: counts[k] + sx_counts[k] for k in counts}
    torch.cuda.empty_cache()
    md_counts = timed("13 multi-device", phase_multi_device, params_tts, params_hift, smi)
    counts = {k: counts[k] + md_counts[k] for k in counts}
    flash["max_abs_err"] = max(flash["max_abs_err"], sx_flash_err)
    stage["max_abs_err"] = max(stage["max_abs_err"], sx_stage_err)
    for kernel, cases in ((flash, sx_flash), (stage, sx_stage)):
        kernel.update({f"serving_export_{case}_{k}": v for case, d in cases.items()
                       for k, v in d.items()})
        kernel.update({f"serving_export_{k}": v for k, v in sx_fields.items()})

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
        dict(name="flash_stock_bwd_dkv", route="cuda",
             source="jyutvoice_tpu_torch/csrc/flash_stock_bwd.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                      "(pallas_call of _flash_attention_bwd_dkv, the backward of the "
                      "stock flash_attention called at jyutvoice_tpu/models/estimator.py:215-249)",
             launches=counts["flash_stock_bwd_dkv"], **bwd["dkv"]),
        dict(name="flash_stock_bwd_dq", route="cuda",
             source="jyutvoice_tpu_torch/csrc/flash_stock_bwd.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                      "(pallas_call of _flash_attention_bwd_dq)",
             launches=counts["flash_stock_bwd_dq"], **bwd["dq"]),
        dict(name="flash_stock_bwd_prep", route="cuda",
             source="jyutvoice_tpu_torch/csrc/flash_stock_bwd.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1121 and :1456 "
                      "(the operands of both backward pallas_calls, rounded and laid out "
                      "once per backward for kernels 4 and 5)",
             launches=counts["flash_stock_bwd_prep"], **bwd["prep"]),
        dict(name="int8_linear", route="cuda",
             source="jyutvoice_tpu_torch/csrc/int8_linear.cu",
             replaces="none: the JAX package's int8 product is plain XLA "
                      "(jyutvoice_tpu/nn/quant.py::linear_q); the port's plain composition "
                      "is nn/quant.py::linear_q_plain",
             launches={"int8_quant_rows": counts["int8_quant_rows"],
                       "int8_gemm": counts["int8_gemm"]}, **int8_cases),
        dict(name="f32_gemm", route="cuda",
             source="jyutvoice_tpu_torch/csrc/f32_gemm.cu",
             replaces="none: the DiT exists only in the port (its plain reference "
                      "tests/reference_dit.py), so no JAX computation; a kernel of the port for "
                      "the f32 GEMMs' FFMA ceiling, whose plain version is "
                      "nn/f32_gemm.py::linear_plain",
             launches=counts["f32_gemm"], **f32_cases),
    ]}
    log(f"phase seconds: {json.dumps(PHASE_S)}, whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
