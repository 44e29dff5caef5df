"""Spans, traces, stage timers, parameter counts and the NaN guard: the
counterpart of the JAX package's `utils/observability.py` (the reference's
thin observability layer; the synthesis pipeline reports RTF itself), with
the port's span recorder.

`span(name)` marks a layer boundary of the program. The recorder is off
unless `enable()` turned it on: a span is then one shared object that does
nothing, at the cost of a flag check. On, each span is kept in memory
(`Span`: name, start and end on `time.time_ns()`, the thread, the enclosing
span of that thread) until `drain()` hands the records over.
`time.time_ns()` is the clock on which Kineto stamps host and device events,
so spans lie over a `torch.profiler` trace of the same process; they are
kept by the recorder itself, and not as `record_function` ranges, because
those exist only while a profiler runs and the engine's host time is read
without one. Nothing is recorded while torch.export or dynamo traces
(`kernels.tracing()`). Names starting with `wait.` mark the host blocked on
the device. `ESTIMATOR_ROWS` counts the frame rows the DiT estimator's blocks
computed and the valid frame rows, while the recorder is on.

`trace` records a `torch.profiler` trace (host and, on the GPU, device
activity) as a Chrome-trace JSON that Perfetto and TensorBoard's profiler
plugin open. `StageTimer` is a recorder that adds up its spans by name.
`debug_nans` is the reference's detect_anomaly flag (configs/base.yaml:139)
over `torch.autograd.set_detect_anomaly`."""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from jyutvoice_tpu_torch import kernels

_log = logging.getLogger(__name__)


class Span:
    """One recorded span. `parent` is the id of the span that was open on
    the same thread when this one opened (None at the top). The thread is
    given twice: `tid`, its native id (Kineto's thread of a host
    operation), and `ident`, its pthread id (`threading.get_ident()`; CUPTI
    stamps a runtime call with its low 32 bits)."""

    __slots__ = ("id", "name", "parent", "tid", "ident", "start_ns", "end_ns", "_rec")

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self.name = rec, name
        self.id = next(rec._ids)

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self.parent = stack[-1].id if stack else None
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._rec._stack().pop()
        self._rec._close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, tid={self.tid}, "
                f"{self.start_ns}..{self.end_ns})")


class _NoSpan:
    """The span of a recorder that is off: records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """Spans in memory, in the order they closed; one stack of open spans
    per thread. Spans may open and close on any thread."""

    def __init__(self, on: bool = False):
        self.on = on
        self._records: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, s: Span) -> None:
        with self._lock:
            self._records.append(s)

    def span(self, name: str):
        """A context manager: a `Span` recorded on exit, or `NO_SPAN` while
        the recorder is off or torch.export / dynamo traces."""
        if not self.on or kernels.tracing():
            return NO_SPAN
        return Span(self, name)

    def drain(self) -> List[Span]:
        """The records so far, which the recorder then forgets."""
        with self._lock:
            out, self._records = self._records, []
        return out


RECORDER = Recorder()
span = RECORDER.span


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def drain() -> List[Span]:
    return RECORDER.drain()


class RowCounter:
    """The frame rows an estimator's blocks computed and the valid frame
    rows of its calls, counted while the recorder is on: computed rows as
    the caller gives them on the host (the DiT's: the N valid rows it
    packs where a call's mask holds padding, B T otherwise), valid rows
    summed from the mask into a device tensor (one per device) that only
    `read` brings back, so counting waits for nothing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def add(self, rows: int, mask: torch.Tensor) -> None:
        """One call whose blocks computed `rows` frame rows, over frames
        whose validity is `mask`."""
        if not RECORDER.on or kernels.tracing():
            return
        valid = mask.sum(dtype=torch.float64)
        with self._lock:
            self.rows += rows
            acc = self._valid.get(mask.device)
            if acc is None:
                self._valid[mask.device] = valid
            else:
                acc.add_(valid)

    def read(self) -> Tuple[int, float]:
        """(rows, valid rows) so far; reads the device sums back."""
        with self._lock:
            return self.rows, sum(float(v) for v in self._valid.values())

    def reset(self) -> None:
        with self._lock:
            self.rows = 0
            self._valid: Dict[torch.device, torch.Tensor] = {}


# the DiT estimator's rows (`models/dit.py`)
ESTIMATOR_ROWS = RowCounter()


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


class StageTimer(Recorder):
    """Accumulating stage timer; reports xRT per stage. A stage is a span
    of the timer, which is always on and adds the span's time to its stage
    as it closes, keeping nothing else: the timer has no clock of its own.
    Times GPU work only where the block synchronizes."""

    def __init__(self) -> None:
        super().__init__(on=True)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    stage = Recorder.span

    def _close(self, s: Span) -> None:
        self.totals[s.name] = self.totals.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
        self.counts[s.name] = self.counts.get(s.name, 0) + 1

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
