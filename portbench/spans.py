"""The program's spans (`jyutvoice_tpu_torch/utils/observability.py`) laid
over the device trace of a window.

Spans and Kineto's host and device events share one clock
(`time.time_ns()`), so a device operation belongs to the innermost span
that was open on the thread that launched it when its launch call began:
the device event carries the correlation id of its launch, the launch its
start and thread. Kineto gives a host operation's thread as its native id
(a span's `tid`) and a CUDA runtime call's as the low 32 bits of its
pthread id, signed (a span's `ident`, `launch_thread`). Each span's device
time counts inclusively up the span tree: an operation under `int8.linear`
inside `mel.solve` counts for both. Device time is clipped to the window,
as `trace.reduce` clips it.

A span here is anything with `id`, `name`, `parent`, `tid`, `ident`,
`start_ns` and `end_ns` (the recorder's `Span`)."""

from __future__ import annotations

import ctypes
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from portbench.trace import _union

NONE = "none"  # no span open
ENGINE_HOST = ("engine.validate", "engine.dispatch", "engine.finalize")
WAIT = "wait."


def _breakpoints(spans: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """One thread's spans as breakpoints (times, span ids): from each time
    on, the innermost open span is that id (-1: none) until the next
    breakpoint. A thread's spans nest, so one pass with a stack gives
    them."""
    times: List[int] = []
    ids: List[int] = []
    stack: List = []

    def close_until(t):
        while stack and stack[-1].end_ns <= t:
            top = stack.pop()
            times.append(top.end_ns)
            ids.append(stack[-1].id if stack else -1)

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close_until(s.start_ns)
        stack.append(s)
        times.append(s.start_ns)
        ids.append(s.id)
    close_until(float("inf"))
    return np.asarray(times, np.int64), np.asarray(ids, np.int64)


def launch_thread(span) -> int:
    """A span's thread as CUPTI stamps the runtime calls made on it."""
    return ctypes.c_int32(span.ident).value


def innermost(spans: Iterable, times: np.ndarray, tids: np.ndarray,
              thread=lambda s: s.tid) -> np.ndarray:
    """Per (time, thread): the id of the innermost span open on that thread
    at that time (a span is open from its start to just before its end),
    -1 where none. `thread(span)` gives a span's thread as `tids` do."""
    times = np.asarray(times, np.int64)
    tids = np.asarray(tids, np.int64)
    out = np.full(len(times), -1, np.int64)
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[thread(s)].append(s)
    for tid, ss in by_tid.items():
        sel = np.nonzero(tids == tid)[0]
        if not len(sel):
            continue
        bt, bid = _breakpoints(ss)
        k = np.searchsorted(bt, times[sel], side="right") - 1
        out[sel] = np.where(k >= 0, bid[np.maximum(k, 0)], -1)
    return out


def owners(spans: Iterable, device: Sequence[Tuple[str, int, int, int]],
           launches: Dict[int, Tuple[int, int]]) -> np.ndarray:
    """The innermost span id of each device operation (name, start_ns,
    end_ns, correlation id), by its launch (correlation id -> (start_ns,
    thread) of the host runtime call, the thread as Kineto gives it:
    `launch_thread`); -1 where no span was open or no launch was found."""
    t = np.zeros(len(device), np.int64)
    tid = np.full(len(device), -1, np.int64)
    for i, (_, _, _, corr) in enumerate(device):
        hit = launches.get(corr)
        if hit is not None:
            t[i], tid[i] = hit
    return innermost(spans, t, tid, thread=launch_thread)


def chains(spans: Iterable) -> Dict[int, Tuple[str, ...]]:
    """Per span id, the names of the span and its ancestors, innermost
    first (an ancestor not among `spans` ends the chain)."""
    by_id = {s.id: s for s in spans}
    out: Dict[int, Tuple[str, ...]] = {}
    for sid in by_id:
        names, cur = [], by_id[sid]
        while cur is not None:
            names.append(cur.name)
            cur = by_id.get(cur.parent)
        out[sid] = tuple(names)
    return out


def _clipped(start: np.ndarray, end: np.ndarray, t0: int, t1: int) -> np.ndarray:
    return np.maximum(np.minimum(end, t1) - np.maximum(start, t0), 0)


def device_seconds(spans: Sequence, device: Sequence[Tuple[str, int, int, int]],
                   owner: np.ndarray, t0: int, t1: int) -> Dict[str, float]:
    """Device seconds inside [t0, t1] under each span name, inclusive (an
    operation counts once for every distinct name on its chain), and under
    `NONE` for operations launched outside any span."""
    if not len(device):
        return {}
    dur = _clipped(np.asarray([d[1] for d in device], np.int64),
                   np.asarray([d[2] for d in device], np.int64), t0, t1)
    ids, inv = np.unique(owner, return_inverse=True)
    per = np.bincount(inv, weights=dur.astype(np.float64))
    chain = chains(spans)
    out: Dict[str, float] = defaultdict(float)
    for sid, ns in zip(ids, per):
        for name in set(chain.get(int(sid), (NONE,))):
            out[name] += ns * 1e-9
    return dict(out)


def _idle(device: Sequence[Tuple[str, int, int, int]], t0: int, t1: int):
    """The window's idle intervals (a, b): [t0, t1] less the union of the
    device operations."""
    iv = np.asarray([(max(s, t0), min(e, t1)) for _, s, e, _ in device if e > t0 and s < t1],
                    np.int64).reshape(-1, 2)
    busy = _union(iv)
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return gaps[:, 0], gaps[:, 1]


def idle_by_owner(spans: Sequence, device: Sequence[Tuple[str, int, int, int]],
                  tid: int, t0: int, t1: int) -> Dict[int, float]:
    """The window's idle seconds by the innermost span open on thread `tid`
    meanwhile (-1: none)."""
    a, b = _idle(device, t0, t1)
    if not len(a):
        return {}
    cum = np.concatenate([[0], np.cumsum(b - a)])

    def idle_before(t):  # idle ns in [t0, t)
        t = np.clip(t, t0, t1)
        k = np.searchsorted(a, t, side="right") - 1
        part = np.where(k >= 0, np.minimum(t, b[np.maximum(k, 0)]) - a[np.maximum(k, 0)], 0)
        return cum[np.maximum(k, 0)] * (k >= 0) + part

    bt, bid = _breakpoints([s for s in spans if s.tid == tid])
    cuts = np.concatenate([[t0], np.clip(bt, t0, t1), [t1]])
    owner = np.concatenate([[-1], bid])
    per = np.diff(idle_before(cuts))
    out: Dict[int, float] = defaultdict(float)
    for sid, ns in zip(owner, per):
        if ns:
            out[int(sid)] += ns * 1e-9
    return dict(out)


def idle_by_span(spans: Sequence, idle: Dict[int, float]) -> Dict[str, float]:
    """`idle_by_owner` by span name (`NONE` where no span was open)."""
    names = {s.id: s.name for s in spans}
    out: Dict[str, float] = defaultdict(float)
    for sid, s in idle.items():
        out[names.get(sid, NONE)] += s
    return dict(out)


def idle_in_host_work(spans: Sequence, idle: Dict[int, float]) -> float:
    """Idle seconds while the thread was in the engine's host work: inside
    `engine.validate`, `engine.dispatch` or `engine.finalize` and not in a
    `wait.*` span."""
    chain = chains(spans)
    total = 0.0
    for sid, s in idle.items():
        names = chain.get(sid, ())
        if names and not names[0].startswith(WAIT) and any(n in ENGINE_HOST for n in names):
            total += s
    return total


def engine_host_s(spans: Sequence, t0: int, t1: int) -> Tuple[float, int]:
    """(seconds, groups): the worker's time inside [t0, t1] in
    `engine.validate`, `engine.dispatch` and `engine.finalize`, less the
    `wait.*` spans inside them, and the number of `engine.finalize` spans
    that started in the window."""
    chain = chains(spans)

    def inside(ss):
        return float(sum(_clipped(np.int64(s.start_ns), np.int64(s.end_ns), t0, t1)
                         for s in ss)) * 1e-9

    host = [s for s in spans if s.name in ENGINE_HOST]
    waits = [s for s in spans if s.name.startswith(WAIT)
             and any(n in ENGINE_HOST for n in chain[s.id][1:])]
    groups = sum(1 for s in spans if s.name == "engine.finalize" and t0 <= s.start_ns < t1)
    return inside(host) - inside(waits), groups


def worker_tid(spans: Sequence):
    """The native id of the thread that ran the engine's spans, or None."""
    return next((s.tid for s in spans if s.name.startswith("engine.")), None)


def readings(spans: Sequence, device: Sequence[Tuple[str, int, int, int]],
             launches: Dict[int, Tuple[int, int]], t0: int, t1: int,
             audio_s: float) -> Dict:
    """The span metrics of a window: device seconds and launches by span,
    idle seconds by the worker's innermost span, and the per-layer
    numbers (None where the run has nothing for them)."""
    owner = owners(spans, device, launches)
    dev_s = device_seconds(spans, device, owner, t0, t1)
    tid = worker_tid(spans)
    idle = idle_by_owner(spans, device, tid, t0, t1) if tid is not None else {}
    host_s, groups = engine_host_s(spans, t0, t1)
    window_s = (t1 - t0) * 1e-9

    def per_audio(name):
        return 1e3 * dev_s[name] / audio_s if name in dev_s and audio_s > 0 else None

    return {
        "device_s": dev_s,
        "owner": owner,
        "idle_by_span": idle_by_span(spans, idle),
        "engine_host_ms_per_group": 1e3 * host_s / groups if groups else None,
        "device_idle_host_pct": 100.0 * idle_in_host_work(spans, idle) / window_s
        if tid is not None else None,
        "text_half_ms_per_audio_s": per_audio("text_half"),
        "mel_solve_ms_per_audio_s": per_audio("mel.solve"),
        "vocoder_ms_per_audio_s": per_audio("vocoder"),
        "int8_linear_ms_per_audio_s": per_audio("int8.linear"),
    }
