"""Serving traffic through `ServingEngine.submit`: a closed backlog of
seeded requests, then the reference's check of a seeded sample of what
the window served.

Set-up: the weights from the seed on the device, the traffic and its
sizing (`sized`: the length scale, from the reference's durations of the
traffic's first `calibrate` requests, gives the config's assumed frames
per token; it is rounded to 1/256, which keeps every frame count and
cumulative sum exact in f32; with `size_in_frames` every request's text
is then sized to its target frames, so every seed serves the same audio),
the synthesizer, and a warm-up of the traffic file's shapes only. The
window then keeps `outstanding` requests submitted, in groups of the
engine's batch, and serves whole cycles of the traffic's sizes.
`setup_s` leaves out the sizing's seconds: they are the reference's, not
the program's.

The check follows each request's route: a batch dispatch runs its
group's mel bucket, whose attention the port bands on CUDA at 2048
frames and past (`banded_long_threshold`), so the reference bands a
request that a dispatch served at such a bucket; the long route bands and
windows past the traffic's `banded_past` and `window_past`."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, layout, program, textgen, window
from portbench import trace as tr
from portbench.reference import frontend
from portbench.reference import model as ref

LS_GRAIN = 256  # length scales are multiples of 1/256
# a copy of the port's mel bucket table (`pipeline/buckets.py::MEL_BUCKETS`)
MEL_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 15000)


def noise_buffer(device) -> torch.Tensor:
    """The model's fixed CFM noise (1, 15000, 80): torch.randn(1, 80, 15000)
    from a CPU generator seeded 0, channels last."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(1, 80, 15000, generator=g).transpose(1, 2).contiguous().to(device)


def ids_of(req: textgen.Request, device):
    return [torch.tensor([s], device=device) for s in frontend.token_ids(req.text, req.phone)]


def batch_band(model: Dict, t_mel: int, device) -> Optional[Tuple[int, int, int]]:
    """The attention band of a batch dispatch at mel bucket t_mel with no
    prompt: the config's band on CUDA at a 128-aligned bucket at or past
    its `banded_long_threshold`, else none (kernel 1)."""
    s = model["tts"]["cfm"]["estimator"]
    on = (torch.device(device).type == "cuda" and s["attention_backend"] == "xla"
          and 0 < s["banded_long_threshold"] <= t_mel and t_mel % s["banded_chunk"] == 0)
    return (s["banded_chunk"], s["banded_left"], s["banded_right"]) if on else None


def own_bucket(frames: int) -> int:
    """The mel bucket of a request dispatched alone (`MEL_BUCKETS`)."""
    return next(b for b in MEL_BUCKETS if frames <= b)


class Groups:
    """The mel bucket at which a batch dispatch served each request, by its
    text: a probe around the synthesizer's `synthesize_batch_dispatch` and
    the `synthesize_mel` it calls (its `t_mel_max`)."""

    def __init__(self, synth):
        self.synth = synth
        self.t_mel: Dict[str, int] = {}
        self._seen: List[int] = []

    def __enter__(self):
        from jyutvoice_tpu_torch.models import tts as tts_mod

        self._mel = tts_mod.synthesize_mel
        dispatch = self.synth.synthesize_batch_dispatch

        def synthesize_mel(*a, **kw):
            self._seen.append(int(kw["t_mel_max"]))
            return self._mel(*a, **kw)

        def probe(items, **kw):
            n = len(self._seen)
            fin = dispatch(items, **kw)
            for it in items if len(self._seen) > n else ():
                self.t_mel[it["text"]] = self._seen[-1]
            return fin

        tts_mod.synthesize_mel = synthesize_mel
        self.synth.synthesize_batch_dispatch = probe
        return self

    def __exit__(self, *exc):
        from jyutvoice_tpu_torch.models import tts as tts_mod

        tts_mod.synthesize_mel = self._mel
        return False


def long_route(traffic: Dict, model: Dict, frames: int) -> Dict:
    """The reference's attention band and vocoder window for a request of
    `frames` frames: the long route's attention is banded, and its vocoder
    windowed (2048-frame windows), past the traffic's `banded_past` and
    `window_past` lengths (absent: never)."""
    s = model["tts"]["cfm"]["estimator"]
    past = traffic.get("banded_past"), traffic.get("window_past")
    return {"band": (s["banded_chunk"], s["banded_left"], s["banded_right"])
            if past[0] is not None and frames > past[0] else None,
            "window": 2048 if past[1] is not None and frames > past[1] else None}


def frames_at_one(trees, model: Dict, reqs, device) -> List[float]:
    """The frames each request's text gives at length scale 1, by the
    reference's durations."""
    out = []
    with torch.no_grad():
        for r in reqs:
            w = ref.durations(trees[0], model, ids_of(r, device),
                              torch.as_tensor(r.spk, device=device)[None])
            out.append(float(torch.ceil(w).sum()))
    return out


def sized(trees, conf: Dict, traffic: Dict, seed: int, device):
    """(requests, length scale). The length scale gives the assumed frames
    per token over the first `calibrate` requests; with `size_in_frames`,
    the requests are then sized in frames (`textgen.sized_to_frames`)."""
    model = conf["model"]
    per_token = conf["assumed"]["frames_per_token"]
    reqs = textgen.requests(traffic, seed, model["tts"]["spk_embed_dim"])
    whole = traffic.get("size_in_frames", False)
    frames = frames_at_one(trees, model, reqs if whole else reqs[:traffic["calibrate"]], device)
    n = traffic["calibrate"]
    tok = sum(r.tokens for r in reqs[:n])
    ls = max(round(per_token * tok / sum(frames[:n]) * LS_GRAIN), 1) / LS_GRAIN
    if whole:
        rates = [f * ls / r.tokens for f, r in zip(frames, reqs)]
        reqs = textgen.sized_to_frames(traffic, reqs, rates, per_token, seed)
    return reqs, ls


def run(conf: Dict, traffic: Dict, limits: Dict, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", fault=None) -> Dict:
    dev = torch.device(device)
    model = conf["model"]
    parts = {"start": time.perf_counter() - t_start}  # set-up's parts, printed to stderr
    mark = time.perf_counter()

    def part(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    tts_t, hift_t, flats = layout.model_trees(model, seed, dev)
    part("weights")
    trees = (tts_t, hift_t)
    reqs, ls = sized(trees, conf, traffic, seed, dev)
    part("sizing")
    synth = program.synthesizer(conf, layout.to_numpy(tts_t, flats[0]),
                                layout.to_numpy(hift_t, flats[1]), dev)
    part("synthesizer")
    eng_kw = dict(traffic["engine"])
    warm = traffic["warm"]
    if warm.get("long"):
        synth.warmup_long(mel_sizes=tuple(warm["mel_sizes"]),
                          text_buckets=tuple(warm["text_buckets"]), n_timesteps=(1,),
                          pcm16=eng_kw.get("pcm16", False),
                          attention=eng_kw.get("long_attention", "auto"))
    else:
        synth.warmup(text_buckets=warm["text_buckets"], mel_buckets=warm["mel_buckets"],
                     batch_sizes=(eng_kw["max_batch"],), n_timesteps=(1,),
                     pcm16=eng_kw.get("pcm16", False))
    part("warmup")
    if fault is not None:
        fault(synth)
    groups = Groups(synth)
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(synth, length_scale=ls, **eng_kw)

    def submit(i):
        r = reqs[i]
        return engine.submit(r.text, lang="yue", phone=r.phone, spk_embed=r.spk)

    t_window = time.perf_counter()
    setup_s = t_window - t_start - parts["sizing"]
    with groups, program.Probes(traced) as probes, tr.Trace(traced) as trc:
        records, t0, t1 = window.closed_loop(
            submit, len(reqs), seconds, traffic["outstanding"],
            group=eng_kw["max_batch"] if traffic["outstanding"] >= eng_kw["max_batch"] else 1,
            cycle=traffic["size_cycle"])
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
        out["trace"] = tr.reduce(trc)
        out["probes"] = {"k1": probes.k1_calls(), "k2": probes.k2}
        out["served"] = [(reqs[r.index % len(reqs)].tokens, r.result.mel_frames,
                          route(traffic, model, groups, reqs[r.index % len(reqs)].text,
                                r.result.mel_frames, dev)["band"] is not None)
                         for r in done]
        out["stats"] = stats
    out["checks"] = judge(conf, traffic, trees, reqs, done, ls, seed, dev, groups)
    return out


def alone_route(traffic: Dict, model: Dict, frames: int, device) -> Dict:
    """The route of a request served on its own: the long route for
    long-form traffic, else a batch dispatch at its own bucket."""
    if traffic.get("long_form"):
        return long_route(traffic, model, frames)
    return {"band": batch_band(model, own_bucket(frames), device), "window": None}


def route(traffic: Dict, model: Dict, groups: Groups, text: str, frames: int, device) -> Dict:
    """The band and vocoder window of a served request: its dispatch's
    bucket's where a batch dispatch served it, else the long route's."""
    if text in groups.t_mel:
        return {"band": batch_band(model, groups.t_mel[text], device), "window": None}
    return long_route(traffic, model, frames)


def judge(conf, traffic, trees, reqs, done, ls, seed, dev, groups) -> Dict:
    """The worst of each number over a seeded sample of the served
    requests, the longest among them."""
    if not done:
        return {k: float("inf") for k in check.NUMBERS}
    rng = np.random.default_rng(seed + 1)
    longest = max(range(len(done)), key=lambda i: done[i].result.mel_frames)
    k = min(traffic["check_sample"], len(done))
    pick = [longest] + [int(i) for i in rng.permutation(len(done)) if i != longest][: k - 1]
    model = conf["model"]
    eng = traffic["engine"]
    num = ref.Numerics(quant_bits=8 if conf["int8"] else 0)
    readings = []
    noise = noise_buffer(dev)
    with torch.no_grad():
        for i in pick:
            rec = done[i]
            req = reqs[rec.index % len(reqs)]
            res = rec.result
            way = route(traffic, model, groups, req.text, res.mel_frames, dev)
            off, mel, wav = check.reference_outputs(
                trees, model, ids_of(req, dev), torch.as_tensor(req.spk, device=dev)[None],
                noise, ls, eng["n_timesteps"], res.mel_frames, num, **way)
            readings.append(check.judge(off, mel, wav, res.mel_frames, res.mel, res.wav,
                                        trees[1], model["hift"], way["window"]))
    return check.worst(readings)
