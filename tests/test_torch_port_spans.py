"""The port's span recorder (`utils/observability.py`) and the spans the
serving path records, on the CPU with the small configuration:

  * off, `span` hands back one shared object and records nothing; on, spans
    nest per thread with the right parents, threads keep separate stacks,
    and nothing is recorded while torch.export traces;
  * `StageTimer` adds up its own spans, and only its own;
  * one `ServingEngine` group gives the span tree of the engine's steps,
    the pinned-allocation counter reads 0;
  * a quantized decoder gives one `int8.linear` span per `QuantLinear` call,
    each inside the solve.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from jyutvoice_tpu_torch.nn import quant
from jyutvoice_tpu_torch.pipeline import ServingEngine, serving
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.utils import observability as obs
from torch_port_setup import PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

T = 120  # seconds: the bound of every wait below


@pytest.fixture
def recording():
    """The process's recorder on, and empty, for one test."""
    obs.drain()
    obs.enable()
    yield
    obs.disable()
    obs.drain()


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_returns_the_shared_no_op_and_records_nothing():
    obs.drain()
    assert not obs.RECORDER.on
    a, b = obs.span("engine.dispatch"), obs.span("int8.linear")
    assert a is b is obs.NO_SPAN
    with a:
        with b:
            pass
    assert obs.drain() == []


def test_spans_nest_with_parents(recording):
    t0 = time.time_ns()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
        with obs.span("wait.x"):
            pass
    t1 = time.time_ns()
    got = obs.drain()
    assert [s.name for s in got] == ["inner", "wait.x", "outer"]  # in the order they closed
    by = {s.name: s for s in got}
    assert by["outer"].parent is None
    assert by["inner"].parent == by["wait.x"].parent == by["outer"].id
    assert t0 <= by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns \
        <= by["wait.x"].start_ns <= by["wait.x"].end_ns <= by["outer"].end_ns <= t1
    assert {s.tid for s in got} == {threading.get_native_id()}
    assert {s.ident for s in got} == {threading.get_ident()}
    assert obs.drain() == []
    assert obs.RECORDER._stack() == []  # every span closed


def test_threads_keep_separate_stacks(recording):
    """More threads than cores open nested spans at once under a shortened
    switch interval: every child's parent is its own thread's span, and no
    record is lost."""
    n_threads, rounds = 12, 300
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(T)
        for i in range(rounds):
            with obs.span(f"parent.{k}.{i}"):
                with obs.span(f"child.{k}.{i}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = obs.drain()
    assert len(got) == 2 * n_threads * rounds
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        if s.name.startswith("child."):
            p = by_id[s.parent]
            assert p.name == "parent." + s.name[len("child."):] and p.tid == s.tid
        else:
            assert s.parent is None
    assert len({s.tid for s in got}) == n_threads


def test_nothing_recorded_while_export_traces(trees, recording):
    """The same small ServingGraph records its spans when called eagerly
    and none while torch.export traces it."""
    graph = serving.build_serving_fn(serving.export_safe_cfg(PORT_CFG), *trees, t_text=32,
                                     t_mel=128, n_timesteps=2, device="cpu")
    args = serving.example_args(32, 0)
    with torch.no_grad():
        graph(*args)
    eager = {s.name for s in obs.drain()}
    assert {"text_half", "mel.solve", "vocoder"} <= eager
    with torch.no_grad():
        torch.export.export(graph, args)
    assert obs.drain() == []


def test_stage_timer_sums_its_own_spans():
    """A StageTimer times whether the process's recorder is on or off, adds
    each stage's span to its totals as it closes, and keeps no spans."""
    obs.drain()
    timer = obs.StageTimer()
    spans = []
    for on in (False, True):
        obs.RECORDER.on = on
        with timer.stage("mel") as s:
            time.sleep(0.002)
        spans.append(s)
    obs.disable()
    assert obs.drain() == [] and timer.drain() == []
    assert timer.counts == {"mel": 2}
    total = sum(s.end_ns - s.start_ns for s in spans) * 1e-9
    assert timer.totals["mel"] == pytest.approx(total, rel=1e-12) and total >= 0.004
    assert timer.report(1.0)["mel"]["xrt"] == 1.0 / timer.totals["mel"]


def test_engine_group_span_tree(trees, recording):
    """One group of three through the engine: collect, validate, dispatch
    (text half twice, the duration wait, the staging, the solve, the
    vocoder) and finalize, on the engine's worker."""
    synth = Synthesizer(PORT_CFG, *trees, device="cpu")
    text, phone = "佢 係邊 個", "keoi5 hai6 bin1 go3"
    with ServingEngine(synth, max_batch=3, max_wait_ms=2000.0, n_timesteps=1,
                       return_mel=True) as engine:
        futs = [engine.submit(text, lang="yue", phone=phone) for _ in range(3)]
        for f in futs:
            assert f.result(T).mel_frames > 0
    assert engine.stats.pinned_allocs == 0
    got = obs.drain()
    by = _by_name(got)
    (dispatch,) = by["engine.dispatch"]
    (validate,) = by["engine.validate"]
    (finalize,) = by["engine.finalize"]
    collect = by["engine.collect"]
    assert len(collect) == 2  # the group's, then the wait for the next one
    assert collect[0].end_ns <= validate.start_ns < validate.end_ns <= dispatch.start_ns \
        < dispatch.end_ns <= finalize.start_ns
    for s in [validate, dispatch, finalize] + collect:
        assert s.parent is None
    children = sorted(s.name for s in got if s.parent == dispatch.id)
    assert children == ["batch.stage", "batch.stage", "mel.solve", "text_half", "text_half",
                        "vocoder", "wait.durations"]
    assert "wait.readback" not in by  # a CPU read-back has no event to wait on
    assert len({s.tid for s in got}) == 1  # the engine's worker
    assert "int8.linear" not in by


def test_one_int8_span_per_quant_linear_call(trees, recording):
    tt, th = trees
    tq = {**tt, "decoder": quant.quantize_estimator(jax.tree_util.tree_map(np.asarray,
                                                                            tt["decoder"]))}
    synth = Synthesizer(PORT_CFG, tq, th, device="cpu")
    calls = []
    linears = [m for m in synth.tts.modules() if isinstance(m, quant.QuantLinear)]
    assert linears
    hooks = [m.register_forward_hook(lambda *a: calls.append(1)) for m in linears]
    try:
        obs.drain()
        synth.synthesize("佢 係邊 個", lang="yue", phone="keoi5 hai6 bin1 go3", n_timesteps=2)
    finally:
        for h in hooks:
            h.remove()
    got = obs.drain()
    by = _by_name(got)
    assert len(by["int8.linear"]) == len(calls) == 2 * len(linears)  # one estimator call a step
    (solve,) = by["mel.solve"]
    by_id = {s.id: s for s in got}

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s

    assert all(solve in ancestors(s) for s in by["int8.linear"])
