"""Serving traffic on the DiT configuration: `serve.py`'s closed backlog
through `ServingEngine.submit`, with the DiT's weights and the DiT
reference's check.

Set-up, window and check follow `serve.py` (its `sized`, `Groups`, `route`,
noise and token ids): the weights come from `layout_dit.py`, whose text
half and vocoder are cell 1's for the same seed; the check recomputes each
sampled request with `reference/dit.py` and judges it with `check.py`'s
numbers and limits. A program whose configuration has no estimator choice
(`CFMConfig.estimator_kind`) cannot run the cell and is refused before any
work.

With `--trace 1` the window also runs the program's span recorder and row
counter, and a device trace that keeps each device operation's correlation
id and each CUDA runtime call's start and thread (`SpanTrace`), so the
device time under each span (`spans.readings`) and the estimator's valid
rows go into the run's output."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import check, layout_dit, program, window
from portbench import trace as tr
from portbench.kinds import serve
from portbench.reference import dit as dit_ref
from portbench.reference import model as ref


def require_dit() -> None:
    from jyutvoice_tpu_torch import config as jvc

    if "estimator_kind" not in {f.name for f in dataclasses.fields(jvc.CFMConfig)}:
        raise RuntimeError("the program has no DiT estimator (no CFMConfig.estimator_kind): "
                           "it cannot run this configuration")


class SpanTrace(tr.Trace):
    """`trace.Trace` that also keeps, for `spans.readings`, each device
    operation as (name, start_ns, end_ns, correlation id) in `device_ops`
    and each CUDA runtime call (host events named cu*) as correlation id ->
    (start_ns, thread) in `launches`."""

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        self.device_ops, self.launches = [], {}
        if self.prof is not None:
            self.prof.__exit__(*exc)
            for e in self.prof.profiler.kineto_results.events():
                rec = (e.name(), e.start_ns(), e.end_ns())
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    self.device.append(rec)
                    self.device_ops.append((*rec, e.correlation_id()))
                else:
                    self.host.append(rec)
                    if e.name().startswith("cu"):
                        self.launches[e.correlation_id()] = (e.start_ns(), e.device_resource_id())
            self.prof = None
        return False


def run(conf: Dict, traffic: Dict, limits: Dict, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", fault=None) -> Dict:
    require_dit()
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine
    from jyutvoice_tpu_torch.utils import observability as obs

    dev = torch.device(device)
    model = conf["model"]
    parts = {"start": time.perf_counter() - t_start}  # set-up's parts, printed to stderr
    mark = time.perf_counter()

    def part(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    tts_t, hift_t, flats = layout_dit.model_trees(model, seed, dev)
    part("weights")
    trees = (tts_t, hift_t)
    reqs, ls = serve.sized(trees, conf, traffic, seed, dev)
    part("sizing")
    synth = program.synthesizer(conf, *layout_dit.to_numpy(tts_t, hift_t, flats), dev)
    part("synthesizer")
    eng_kw = dict(traffic["engine"])
    warm = traffic["warm"]
    synth.warmup(text_buckets=warm["text_buckets"], mel_buckets=warm["mel_buckets"],
                 batch_sizes=(eng_kw["max_batch"],), n_timesteps=(1,),
                 pcm16=eng_kw.get("pcm16", False))
    part("warmup")
    if fault is not None:
        fault(synth)
    groups = serve.Groups(synth)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(synth, length_scale=ls, **eng_kw)

    def submit(i):
        r = reqs[i]
        return engine.submit(r.text, lang="yue", phone=r.phone, spk_embed=r.spk)

    if traced:
        obs.drain()
        obs.ESTIMATOR_ROWS.reset()
        obs.enable()
    t_window = time.perf_counter()
    setup_s = t_window - t_start - parts["sizing"]
    try:
        with groups, SpanTrace(traced) as trc:
            records, t0, t1 = window.closed_loop(
                submit, len(reqs), seconds, traffic["outstanding"],
                group=eng_kw["max_batch"] if traffic["outstanding"] >= eng_kw["max_batch"] else 1,
                cycle=traffic["size_cycle"])
    finally:
        if traced:
            obs.disable()
    engine.close()
    stats = engine.stats
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, synth
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    done = [r for r in records if r.error is None]
    audio_s = sum(r.result.mel_frames for r in done) / model["audio"]["sample_rate"] * \
        model["audio"]["hop_length"]
    out = {
        "attempted": len(records), "failed": len(records) - len(done),
        "window_s": t1 - t0, "setup_s": setup_s, "memory_peak_bytes": int(peak),
        "e2e": {"audio_s_per_s": audio_s / (t1 - t0), "setup_s": setup_s},
        "errors": [repr(r.error) for r in records if r.error is not None][:3],
        "setup_parts": parts,
    }
    if traced:
        from portbench import spans as sp

        out["trace"] = tr.reduce(trc)
        out["spans"] = sp.readings(obs.drain(), trc.device_ops, trc.launches, trc.t0_ns,
                                   trc.t1_ns, audio_s)
        out["spans"]["audio_s"] = audio_s
        out["rows"] = obs.ESTIMATOR_ROWS.read()
        obs.ESTIMATOR_ROWS.reset()
        out["served"] = [(reqs[r.index % len(reqs)].tokens, r.result.mel_frames,
                          serve.route(traffic, model, groups, reqs[r.index % len(reqs)].text,
                                      r.result.mel_frames, dev)["band"] is not None)
                         for r in done]
        out["stats"] = stats
    out["checks"] = judge(conf, traffic, trees, reqs, done, ls, seed, dev, groups)
    return out


def reference_outputs(trees, model: Dict, ids, spk: torch.Tensor, noise: torch.Tensor,
                      length_scale: float, steps: int, got_frames: Optional[int],
                      num: ref.Numerics, band=None, window: Optional[int] = None):
    """`check.reference_outputs` with the DiT's mel: (frames_off, mel (1, T,
    80), PCM16 waveform) of one request in `num`."""
    tts, hift = trees
    w = ref.durations(tts, model, ids, spk)
    if got_frames is None:
        frames, off = torch.ceil(w) * length_scale, 0
    else:
        frames, off = check.frame_counts(w, length_scale, got_frames)
    mel = dit_ref.mel(tts, model, ids, spk, frames, noise, steps, num, band)
    pad = torch.zeros(1, check.TAIL, mel.shape[2], device=mel.device)
    wav = ref.vocode(hift, model["hift"], torch.cat([mel, pad], dim=1), window=window)
    return off, mel, check.pcm16(wav[0])


def judge(conf, traffic, trees, reqs, done, ls, seed, dev, groups) -> Dict:
    """The worst of each number over a seeded sample of the served
    requests, the longest among them (`serve.judge`'s sample)."""
    if not done:
        return {k: float("inf") for k in check.NUMBERS}
    rng = np.random.default_rng(seed + 1)
    longest = max(range(len(done)), key=lambda i: done[i].result.mel_frames)
    k = min(traffic["check_sample"], len(done))
    pick = [longest] + [int(i) for i in rng.permutation(len(done)) if i != longest][: k - 1]
    model = conf["model"]
    readings = []
    noise = serve.noise_buffer(dev)
    with torch.no_grad():
        for i in pick:
            rec = done[i]
            req = reqs[rec.index % len(reqs)]
            res = rec.result
            way = serve.route(traffic, model, groups, req.text, res.mel_frames, dev)
            off, mel, wav = reference_outputs(
                trees, model, serve.ids_of(req, dev), torch.as_tensor(req.spk, device=dev)[None],
                noise, ls, traffic["engine"]["n_timesteps"], res.mel_frames, ref.Numerics(), **way)
            readings.append(check.judge(off, mel, wav, res.mel_frames, res.mel, res.wav,
                                        trees[1], model["hift"], way["window"]))
    return check.worst(readings)
