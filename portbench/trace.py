"""The device trace of a window: `torch.profiler` with CUDA activity,
reduced to the device's busy time, kernel time by name and the breakdown
(the device operations that took most time, and the longest idle gaps by
what the host was doing in them).

Kineto stamps host and device events on one wall clock (ns), so the
window's `time.time_ns()` bounds clip both."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


class Trace:
    """Profile the enclosed block; `.events` afterwards, `.t0_ns`,
    `.t1_ns` its bounds on the trace's clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.device = []  # (name, start_ns, end_ns)
        self.host = []

    def __enter__(self):
        if self.enabled:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)
            for e in self.prof.profiler.kineto_results.events():
                rec = (e.name(), e.start_ns(), e.end_ns())
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    self.device.append(rec)
                else:
                    self.host.append(rec)
            self.prof = None
        return False


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted (n, 2) intervals."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def reduce(tr: Trace) -> Dict:
    """busy_s, window_s, kernel seconds by name, and the breakdown."""
    t0, t1 = tr.t0_ns, tr.t1_ns
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in tr.device if e > t0 and s < t1]
    by_name: Dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    busy = _union(np.asarray([(s, e) for _, s, e in dev], dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:10]
    hs = np.asarray([s for _, s, _ in tr.host], dtype=np.int64)
    he = np.asarray([e for _, _, e in tr.host], dtype=np.int64)
    names = [n for n, _, _ in tr.host]
    api = np.asarray([n.startswith("cu") for n in names], dtype=bool)
    idle: List[Tuple[str, float]] = []
    for gs, ge in gaps:
        over = np.minimum(he, ge) - np.maximum(hs, gs)
        label = "no_CUDA_call_or_traced_op_on_the_host"
        for pick in (api, ~api):
            cand = np.where(pick & (over > 0))[0]
            if len(cand):
                label = names[cand[np.argmax(over[cand])]]
                break
        idle.append((label[:64], (ge - gs) * 1e-9))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (t1 - t0) * 1e-9,
        "kernel_s": by_name,
        "breakdown": {"device_ops": [[n[:64], s] for n, s in top],
                      "idle_gaps": [[n, s] for n, s in idle]},
    }


def kernel_seconds(reduced: Dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds `fragment`."""
    return sum(s for n, s in reduced["kernel_s"].items() if fragment in n)
