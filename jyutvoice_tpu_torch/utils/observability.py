"""Traces, stage timers, parameter counts and the NaN guard: the counterpart
of the JAX package's `utils/observability.py` (the reference's thin
observability layer; the synthesis pipeline reports RTF itself).

`trace` records a `torch.profiler` trace (host and, on the GPU, device
activity) as a Chrome-trace JSON that Perfetto and TensorBoard's profiler
plugin open. `debug_nans` is the reference's detect_anomaly flag
(configs/base.yaml:139) over `torch.autograd.set_detect_anomaly`."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

_log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a torch.profiler trace of the block into log_dir
    (`<host>_<pid>.<time>.pt.trace.json`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode for the block, restored after.

    It catches something else than the JAX package's `jax_debug_nans`: that
    checks the output of every forward operation and raises
    FloatingPointError at the first NaN; anomaly mode raises RuntimeError
    when a backward function returns NaN gradients, naming the forward
    operation (with its traceback) that made it. A NaN in a forward pass
    without a backward (inference) goes unreported."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


class StageTimer:
    """Accumulating wall-clock stage timer; reports xRT per stage. Times
    GPU work only where the block synchronizes."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, audio_seconds: Optional[float] = None) -> Dict[str, dict]:
        out = {}
        for name, total in self.totals.items():
            entry = {"total_s": total, "count": self.counts[name]}
            if audio_seconds:
                entry["xrt"] = audio_seconds / total if total else float("inf")
            out[name] = entry
        return out


def _tensors(node):
    if isinstance(node, nn.Module):
        # this package's batch norms keep their running statistics as
        # (frozen) parameters, so a module counts as its tree does
        yield from node.parameters()
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    else:
        yield node


def param_count(params) -> int:
    """Values in a parameter tree (nested dicts / lists of arrays) or module."""
    return sum(int(np.prod(np.shape(x))) for x in _tensors(params))


def log_param_counts(params) -> Dict[str, int]:
    """Parameter counts per top-level entry and in total, logged (the
    reference's utils/logging_utils.py:12-55). `params` is a tree (its
    top-level keys) or a module (its children, and parameters of its own),
    which count as its tree from `weights/from_jax.py` would."""
    if isinstance(params, nn.Module):
        parts = dict(params.named_children())
        parts.update(params.named_parameters(recurse=False))
    else:
        parts = params
    counts = {k: param_count(v) for k, v in parts.items()}
    counts["total"] = sum(counts.values())
    for k, v in counts.items():
        _log.info("params/%s: %s", k, f"{v:,}")
    return counts
