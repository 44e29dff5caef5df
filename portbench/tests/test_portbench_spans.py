"""Spans laid over a device trace (`portbench/spans.py`) and the
`pinned_allocs.serve` reader, on a hand-built window: the engine's worker
with a collect span that straddles the window's start, a finalize span
that straddles its end, device operations launched inside nested spans,
one launched before any span and one launched by another thread. Then the
program's own spans over a CPU Kineto trace of two threads."""

import importlib.util
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jyutvoice_tpu_torch.utils import observability as obs
from portbench import spans as sp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0, T1 = 100, 1000  # the window, ns
WORKER, OTHER = 7, 8  # native ids; the pthread ids below are 1000 + these


def _span(sid, name, start, end, parent=None, tid=WORKER):
    return SimpleNamespace(id=sid, name=name, start_ns=start, end_ns=end, parent=parent,
                           tid=tid, ident=1000 + tid)


SPANS = [
    _span(0, "engine.collect", 50, 150),
    _span(1, "engine.validate", 150, 200),
    _span(2, "engine.dispatch", 200, 700),
    _span(3, "text_half", 210, 260, parent=2),
    _span(4, "wait.durations", 260, 320, parent=2),
    _span(5, "mel.solve", 330, 600, parent=2),
    _span(6, "int8.linear", 400, 450, parent=5),
    _span(7, "vocoder", 600, 650, parent=2),
    _span(8, "engine.finalize", 900, 1100),
    _span(9, "wait.readback", 950, 1050, parent=8),
]
# (name, start, end, correlation id); launches: correlation id -> (start, thread)
DEVICE = [
    ("k_text", 300, 340, 11),
    ("k_int8", 500, 560, 12),
    ("k_solve", 560, 620, 13),
    ("k_voc", 620, 700, 14),
    ("k_early", 80, 120, 15),  # launched before any span; half of it before the window
    ("k_other", 980, 1020, 16),  # another thread's; half of it past the window
]
LAUNCHES = {11: (215, 1007), 12: (410, 1007), 13: (500, 1007), 14: (610, 1007),
            15: (40, 1007), 16: (955, 1008)}


def test_owners_follow_the_launching_thread_and_time():
    owner = sp.owners(SPANS, DEVICE, LAUNCHES)
    assert owner.tolist() == [3, 6, 5, 7, -1, -1]
    # a launch at a span's start belongs to it, at its end to the parent
    assert sp.innermost(SPANS, np.array([330, 600, 700]), np.array([WORKER] * 3)).tolist() \
        == [5, 7, -1]
    # the same times on a thread with no spans
    assert sp.innermost(SPANS, np.array([330]), np.array([OTHER])).tolist() == [-1]
    assert sp.launch_thread(SimpleNamespace(ident=0x7F12E7402640)) == -415226304


def test_device_seconds_inclusive_and_clipped():
    owner = sp.owners(SPANS, DEVICE, LAUNCHES)
    got = sp.device_seconds(SPANS, DEVICE, owner, T0, T1)
    want = {"text_half": 40, "int8.linear": 60, "mel.solve": 120, "vocoder": 80,
            "engine.dispatch": 240, "none": 40}
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()})


def test_idle_by_the_workers_innermost_span():
    idle = sp.idle_by_owner(SPANS, DEVICE, WORKER, T0, T1)
    want = {"engine.collect": 30, "engine.validate": 50, "engine.dispatch": 10,
            "text_half": 50, "wait.durations": 40, "mel.solve": 110, "int8.linear": 50,
            "none": 200, "engine.finalize": 50, "wait.readback": 30}
    assert sp.idle_by_span(SPANS, idle) == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(idle.values()) == pytest.approx(620e-9)  # the window less the device's union
    # in validate, dispatch and finalize and not waiting
    assert sp.idle_in_host_work(SPANS, idle) == pytest.approx(320e-9)


def test_engine_host_time_per_group():
    # validate 50 + dispatch 500 + finalize 100 inside the window, less the
    # waits inside them (60 + 50); one finalize started in the window
    host, groups = sp.engine_host_s(SPANS, T0, T1)
    assert host == pytest.approx(540e-9) and groups == 1


def test_readings():
    got = sp.readings(SPANS, DEVICE, LAUNCHES, T0, T1, audio_s=2.0)
    assert got["engine_host_ms_per_group"] == pytest.approx(540e-9 * 1e3)
    assert got["device_idle_host_pct"] == pytest.approx(100 * 320 / 900)
    assert got["device_idle_host_pct"] <= 100 * 620 / 900  # a part of the idle share
    for key, ns in (("text_half", 40), ("mel_solve", 120), ("vocoder", 80), ("int8_linear", 60)):
        assert got[f"{key}_ms_per_audio_s"] == pytest.approx(1e3 * ns * 1e-9 / 2.0)
    none = sp.readings(SPANS[:5], DEVICE, LAUNCHES, T0, T1, audio_s=2.0)
    assert none["int8_linear_ms_per_audio_s"] is None and none["vocoder_ms_per_audio_s"] is None
    empty = sp.readings([], DEVICE, LAUNCHES, T0, T1, audio_s=2.0)
    assert empty["engine_host_ms_per_group"] is None and empty["device_idle_host_pct"] is None


def test_pinned_allocs_reader():
    path = os.path.join(HERE, "metrics", "pinned_allocs.serve.py")
    spec = importlib.util.spec_from_file_location("pinned_allocs_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"out": {"stats": SimpleNamespace(pinned_allocs=7, batches=2)}}) == 3.5
    # no group finalized, or a program without the counter: nothing to read
    assert mod.read({"out": {"stats": SimpleNamespace(pinned_allocs=0, batches=0)}}) is None
    assert mod.read({"out": {"stats": SimpleNamespace(batch_sizes=[16], batches=1)}}) is None


@pytest.fixture
def recording():
    """The process's recorder on, and empty, for one test."""
    obs.drain()
    obs.enable()
    yield
    obs.disable()
    obs.drain()


def test_attribution_on_a_cpu_kineto_trace(recording):
    """Two threads run ops at the same time, one inside a span: the span
    claims its own thread's aten ops and none of the other thread's."""
    go = threading.Barrier(2)
    tids = {}

    def work(name, in_span):
        tids[name] = threading.get_native_id()
        go.wait(120)
        x = torch.ones(64, 64)
        for _ in range(20):
            if in_span:
                with obs.span("mine"):
                    x = torch.mm(x, x).clamp(-1, 1)
            else:
                x = torch.mm(x, x).clamp(-1, 1)
                time.sleep(0.0001)

    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        threads = [threading.Thread(target=work, args=(n, n == "a")) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not any(t.is_alive() for t in threads)
    spans = obs.drain()
    assert len(spans) == 20 and {s.tid for s in spans} == {tids["a"]}
    ops = [(e.name(), e.start_ns(), e.device_resource_id())
           for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    owner = sp.innermost(spans, np.array([o[1] for o in ops]), np.array([o[2] for o in ops]))
    on_a = np.array([o[2] == tids["a"] for o in ops])
    on_b = np.array([o[2] == tids["b"] for o in ops])
    assert on_a.sum() == on_b.sum() == 20
    assert (owner[on_a] >= 0).all() and len(set(owner[on_a])) == 20
    assert (owner[on_b] == -1).all()
    # thread b's ops ran while thread a's spans were open
    a0, a1 = min(s.start_ns for s in spans), max(s.end_ns for s in spans)
    assert any(a0 < o[1] < a1 for o, b in zip(ops, on_b) if b)
