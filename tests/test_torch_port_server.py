"""The port's serving engine and streaming lane (`pipeline/server.py`) on the
CPU: the cases of the JAX package's tests/test_server.py and
tests/test_server_soak.py::test_engine_close_rejects_unresolved, on the small
configuration with the JAX package's random trees, 1-2 Euler steps. Left
out: test_engine_long_request_sequence_parallel (the port has no
sequence-parallel long solve), and test_batch_dispatch_overlong_culprit_indices,
which test_torch_port_batch.py holds.

Bars: batched against direct synthesis atol 5e-4 / rtol 1e-3 (split
dispatch 1e-5), as the JAX tests; the lane's streams against
`Synthesizer.synthesize_streaming` within 1e-4 of max |ref|. Every wait is
bounded.
"""

import concurrent.futures
import sys
import threading

import numpy as np
import pytest
import torch

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
from jyutvoice_tpu_torch.pipeline import ServingEngine
from jyutvoice_tpu_torch.pipeline.server import StreamingLane, _StreamHandle
from jyutvoice_tpu_torch.pipeline.synthesize import (
    NoiseBufferExceeded,
    OverLongBatchItems,
    Synthesizer,
)
from torch_port_setup import PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

T = 120  # seconds: the bound of every wait below

UTTS = [
    ("佢 係邊 個", "keoi5 hai6 bin1 go3"),
    ("你好", "nei5 hou2"),
    ("我 哋 去", "ngo5 dei6 heoi3"),
]
LONG_PH = " ".join(["keoi5 hai6 bin1 go3"] * 40)  # > 512 tokens: long-form
LONG_TX = ("佢係邊個 " * 40).strip()
STREAM_REL = 1e-4


@pytest.fixture(scope="module")
def synth():
    return Synthesizer(PORT_CFG, *jax_trees(), device="cpu")


def _stream_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= STREAM_REL * np.abs(want).max()


def test_launch_counts_exact_across_threads():
    """count_launch from several threads loses no update (a shortened
    switch interval provokes the interleavings), and the plain path of a
    wrapper counts nothing."""
    kernels.reset_launch_counts()
    n_threads, per_thread = 8, 4000
    q = torch.zeros((1, 4, 1, 64))
    lengths = torch.tensor([4], dtype=torch.int32)

    def work():
        for i in range(per_thread):
            kernels.count_launch("resblock_stage")
            if i % 400 == 0:
                flash_attention(q, q, q, lengths, scale=0.125)  # CPU: the plain version

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.LAUNCHES["resblock_stage"] == n_threads * per_thread
    assert kernels.LAUNCHES["flash_attention"] == 0
    kernels.reset_launch_counts()
    assert not any(kernels.LAUNCHES.values())


def test_engine_batches_and_matches_direct(synth, monkeypatch):
    direct = {t: synth.synthesize(t, lang="yue", phone=p, n_timesteps=2) for t, p in UTTS}
    modes = []
    real_prepare = synth.prepare_text

    def spy(*a, **kw):  # runs in the engine's worker thread
        modes.append(torch.is_inference_mode_enabled())
        return real_prepare(*a, **kw)

    monkeypatch.setattr(synth, "prepare_text", spy)
    with ServingEngine(synth, max_batch=4, max_wait_ms=200.0, n_timesteps=2) as engine:
        futs = [(t, engine.submit(t, lang="yue", phone=p)) for t, p in UTTS]
        results = [(t, f.result(timeout=T)) for t, f in futs]
        stats = engine.stats
    assert modes and all(modes)
    assert stats.requests == len(UTTS)
    assert stats.batches >= 1 and max(stats.batch_sizes) >= 2
    for text, res in results:
        ref = direct[text]
        assert res.mel_frames == ref.mel_frames
        assert res.wav.shape == ref.wav.shape
        np.testing.assert_allclose(res.wav, ref.wav, atol=5e-4, rtol=1e-3)


def test_engine_error_propagates(synth):
    with ServingEngine(synth, max_batch=2, max_wait_ms=5.0) as engine:
        fut = engine.submit("abc", lang="nope-such-lang")
        with pytest.raises(Exception):
            fut.result(timeout=T)
        assert engine.stats.errors >= 1
    with pytest.raises(RuntimeError):
        engine.submit("after close", lang="yue", phone="aa1")


def test_engine_overlong_prompt_fails_only_that_request(synth):
    with ServingEngine(synth, max_batch=4, max_wait_ms=200.0, n_timesteps=2) as engine:
        bad = engine.submit("佢", lang="yue", phone="keoi5",
                            prompt_feat=np.zeros((600, 80), np.float32),
                            prompt_h=np.zeros((600, 80), np.float32))
        good = engine.submit("你好", lang="yue", phone="nei5 hou2")
        with pytest.raises(ValueError, match="prompt"):
            bad.result(timeout=T)
        assert good.result(timeout=T).mel_frames > 0


def test_engine_survives_cancelled_future(synth):
    with ServingEngine(synth, max_batch=2, max_wait_ms=5.0, n_timesteps=2) as engine:
        fut = engine.submit("佢", lang="yue", phone="keoi5")
        fut.cancel()  # may race the worker; the engine survives either way
        res = engine.submit("你好", lang="yue", phone="nei5 hou2").result(timeout=T)
        assert res.mel_frames > 0


def test_engine_split_dispatch(synth):
    texts = [("佢", "keoi5"), ("好", "hou2"), ("係", "hai6"), ("個", "go3"), ("邊", "bin1")]
    want = {t: synth.synthesize(t, lang="yue", phone=p, n_timesteps=2).wav for t, p in texts}
    with ServingEngine(synth, max_batch=8, max_wait_ms=300, n_timesteps=2,
                       split_dispatch_at=2) as eng:
        futs = [(t, eng.submit(t, lang="yue", phone=p)) for t, p in texts]
        for t, f in futs:
            np.testing.assert_allclose(f.result(timeout=T).wav, want[t], atol=1e-5)
    assert eng.stats.requests == len(texts)
    assert eng.stats.dispatches >= 3  # at most 2 requests a dispatch


def test_engine_partitions_mixed_lengths(synth):
    """A long text must not drag the short ones up to its mel bucket."""
    long_ph = " ".join(["keoi5 hai6 bin1 go3"] * 10)
    long_tx = ("佢係邊個 " * 10).strip()
    with ServingEngine(synth, max_batch=4, max_wait_ms=300.0, n_timesteps=1) as engine:
        fs = [engine.submit("佢", lang="yue", phone="keoi5"),
              engine.submit(long_tx, lang="yue", phone=long_ph),
              engine.submit("佢", lang="yue", phone="keoi5")]
        res = [f.result(timeout=T) for f in fs]
        stats = engine.stats
    assert all(r.mel_frames > 0 for r in res)
    assert stats.dispatches >= 2


def test_engine_overlong_item_reroutes_incl_cloning(synth, monkeypatch):
    """Items past the batch mel table go through synthesize_long, cloning
    ones with their prompt; the innocent rest is dispatched again."""
    real = synth.synthesize_batch_dispatch

    def fake(items, **kw):
        idx = [i for i, it in enumerate(items) if it["text"] in ("佢", "我")]
        if idx:
            raise OverLongBatchItems("items need 99999 mel frames, past the batch table", idx)
        return real(items, **kw)

    long_called = []
    real_long = type(synth).synthesize_long

    def spy(self, text, **kw):
        long_called.append((text, kw.get("prompt_feat") is not None))
        return real_long(self, text, **kw)

    monkeypatch.setattr(synth, "synthesize_batch_dispatch", fake)
    monkeypatch.setattr(type(synth), "synthesize_long", spy)
    with ServingEngine(synth, max_batch=4, max_wait_ms=300.0, n_timesteps=2) as engine:
        rerouted = engine.submit("佢", lang="yue", phone="keoi5")
        cloned = engine.submit("我", lang="yue", phone="ngo5",
                               prompt_feat=np.zeros((8, 80), np.float32),
                               prompt_h=np.zeros((8, 80), np.float32))
        good = engine.submit("你好", lang="yue", phone="nei5 hou2")
        assert rerouted.result(timeout=T).mel_frames > 0
        assert cloned.result(timeout=T).mel_frames > 0
        assert good.result(timeout=T).mel_frames > 0
    assert sorted(long_called) == [("佢", False), ("我", True)]
    assert engine.stats.errors == 0


@pytest.mark.parametrize("prompted", [False, True])
def test_engine_routes_long_requests_via_synthesize_long(synth, monkeypatch, prompted):
    """A text past the interactive buckets goes through synthesize_long with
    the engine's long_attention, and with its prompt pair when cloning."""
    calls = {}
    orig = type(synth).synthesize_long

    def spy(self, text, **kw):
        calls.update(kw, text=text)
        return orig(self, text, **kw)

    monkeypatch.setattr(type(synth), "synthesize_long", spy)
    rng = np.random.default_rng(9)
    pf = rng.standard_normal((16, 80)).astype(np.float32) if prompted else None
    ph = rng.standard_normal((16, 80)).astype(np.float32) if prompted else None
    with ServingEngine(synth, max_batch=4, n_timesteps=1, long_attention="exact") as engine:
        res = engine.submit(LONG_TX, lang="yue", phone=LONG_PH, prompt_feat=pf,
                            prompt_h=ph).result(timeout=T)
    assert calls["text"] == LONG_TX and res.mel_frames > 0
    assert calls["attention"] == "exact"
    assert calls["prompt_feat"] is pf and calls["prompt_h"] is ph


@pytest.mark.parametrize("case,match", [
    (dict(spk_embed=np.zeros((2,), np.float32)), "spk_embed"),
    (dict(prompt_feat=np.zeros((8, 80), np.float32)), "BOTH"),
    (dict(prompt_feat=np.zeros((8, 79), np.float32),
          prompt_h=np.zeros((8, 79), np.float32)), r"\(T, 80\)"),
])
def test_engine_bad_item_fails_only_culprit(synth, case, match):
    """A malformed spk_embed, a half prompt pair or a prompt of the wrong
    shape fails its own request at validation, not the batch it joins."""
    with ServingEngine(synth, max_batch=4, max_wait_ms=200.0, n_timesteps=2) as engine:
        bad = engine.submit("佢", lang="yue", phone="keoi5", **case)
        good = engine.submit("你好", lang="yue", phone="nei5 hou2")
        with pytest.raises(ValueError, match=match):
            bad.result(timeout=T)
        assert good.result(timeout=T).mel_frames > 0
    assert engine.stats.errors == 1


@pytest.mark.parametrize("intrinsic", [False, True])
def test_engine_noise_cap(synth, monkeypatch, intrinsic):
    """Past the noise buffer a mixed group splits into its prompted and
    plain halves; only a prompted group past it on its own fails."""
    real = synth.synthesize_batch_dispatch

    def fake(items, **kw):
        has_prompt = any(it.get("prompt_feat") is not None for it in items)
        has_free = any(it.get("prompt_feat") is None for it in items)
        if has_prompt and (has_free or intrinsic):
            raise NoiseBufferExceeded("prompt + mel frames exceed the noise buffer")
        return real(items, **kw)

    monkeypatch.setattr(synth, "synthesize_batch_dispatch", fake)
    with ServingEngine(synth, max_batch=4, max_wait_ms=300.0, n_timesteps=2) as engine:
        pf = np.zeros((8, 80), np.float32)
        cloned = engine.submit("佢", lang="yue", phone="keoi5", prompt_feat=pf, prompt_h=pf)
        free = engine.submit("你好", lang="yue", phone="nei5 hou2")
        if intrinsic:
            with pytest.raises(NoiseBufferExceeded):
                cloned.result(timeout=T)
        else:
            assert cloned.result(timeout=T).mel_frames > 0
        assert free.result(timeout=T).mel_frames > 0
    assert engine.stats.errors == (1 if intrinsic else 0)
    if not intrinsic:
        assert engine.stats.dispatches >= 2


def test_engine_close_rejects_unresolved(synth):
    """Futures still queued at close() resolve (a result or a refusal)."""
    engine = ServingEngine(synth, max_batch=4, max_wait_ms=5000.0, n_timesteps=1)
    futs = [engine.submit(t, lang="yue", phone=p) for t, p in UTTS]
    engine.close()
    assert not engine._worker.is_alive()
    for f in futs:
        try:
            assert f.result(timeout=60).mel_frames > 0
        except (RuntimeError, concurrent.futures.CancelledError):
            pass  # refused at shutdown is acceptable; hanging is not


def test_streaming_lane(synth):
    """Concurrent streams share one dispatch a tick; each stream equals
    synthesize_streaming's."""
    reqs = [("佢", "keoi5"), ("好", "hou2"), ("係", "hai6")]
    want = [np.concatenate(list(synth.synthesize_streaming(
        t, lang="yue", phone=p, chunk_frames=50, n_timesteps=2))) for t, p in reqs]
    with StreamingLane(synth, max_streams=4, chunk_frames=50, n_timesteps=2) as lane:
        handles = [lane.submit(t, lang="yue", phone=p) for t, p in reqs]
        got = [np.concatenate(list(h.iter_timeout(T))) for h in handles]
    for g, w in zip(got, want):
        _stream_close(g, w)
    assert not lane._worker.is_alive()


def test_streaming_lane_counts_its_dispatches(synth):
    """One stream takes one dispatch per chunk of its frames."""
    spf = synth.cfg.hift.total_upsample
    with StreamingLane(synth, max_streams=2, chunk_frames=50, n_timesteps=2) as lane:
        assert lane.dispatches == 0
        wav = np.concatenate(list(lane.submit("佢係邊個", lang="yue",
                                              phone="keoi5 hai6 bin1 go3").iter_timeout(T)))
        assert len(wav) % spf == 0
        assert lane.dispatches == -(-(len(wav) // spf) // 50)


def test_streaming_lane_bad_request_isolated(synth):
    with StreamingLane(synth, max_streams=2, chunk_frames=50, n_timesteps=2) as lane:
        bad = lane.submit("hello", lang="no-such-lang")
        good = lane.submit("佢", lang="yue", phone="keoi5")
        with pytest.raises(ValueError):
            list(bad.iter_timeout(T))
        wav = np.concatenate(list(good.iter_timeout(T)))
        assert np.isfinite(wav).all() and len(wav) > 0


def test_streaming_lane_survives_tick_failure(synth):
    with StreamingLane(synth, max_streams=2, chunk_frames=50, n_timesteps=2) as lane:
        real_tick = lane._ms.tick
        armed = {"on": True}

        def flaky_tick():
            if armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected device failure")
            return real_tick()

        lane._ms.tick = flaky_tick
        doomed = lane.submit("佢", lang="yue", phone="keoi5")
        with pytest.raises(RuntimeError, match="injected"):
            list(doomed.iter_timeout(T))
        good = lane.submit("好", lang="yue", phone="hou2")
        wav = np.concatenate(list(good.iter_timeout(T)))
        assert np.isfinite(wav).all() and len(wav) > 0


def test_streaming_lane_cloning_prompt(synth):
    """A prompt-capable lane streams a cloning request as synthesize_streaming
    does, beside a plain stream; a prompt past the capacity, or on a lane
    without one, fails at submit."""
    rng = np.random.default_rng(3)
    pf = rng.standard_normal((24, 80)).astype(np.float32)
    ph = rng.standard_normal((24, 80)).astype(np.float32)
    want = np.concatenate(list(synth.synthesize_streaming(
        "佢", lang="yue", phone="keoi5", chunk_frames=50, n_timesteps=2,
        prompt_feat=pf, prompt_h=ph)))
    with StreamingLane(synth, max_streams=2, chunk_frames=50, n_timesteps=2,
                       prompt_frames=64) as lane:
        h = lane.submit("佢", lang="yue", phone="keoi5", prompt_feat=pf, prompt_h=ph)
        h2 = lane.submit("好", lang="yue", phone="hou2")
        got = np.concatenate(list(h.iter_timeout(T)))
        free = np.concatenate(list(h2.iter_timeout(T)))
        with pytest.raises(ValueError, match="capacity"):
            lane.submit("佢", lang="yue", phone="keoi5",
                        prompt_feat=np.zeros((65, 80), np.float32),
                        prompt_h=np.zeros((65, 80), np.float32))
    _stream_close(got, want)
    assert np.isfinite(free).all() and len(free) > 0
    with StreamingLane(synth, max_streams=1, chunk_frames=50, n_timesteps=2) as plain:
        with pytest.raises(ValueError, match="prompt capacity"):
            plain.submit("佢", lang="yue", phone="keoi5", prompt_feat=pf, prompt_h=ph)


def test_streaming_lane_cancel_frees_slot(synth):
    long_ph = " ".join(["keoi5 hai6 bin1 go3"] * 20)
    with StreamingLane(synth, max_streams=1, chunk_frames=50, n_timesteps=2) as lane:
        doomed = lane.submit("佢係邊個 " * 20, lang="yue", phone=long_ph)
        it = doomed.iter_timeout(T)
        next(it)  # admitted and producing
        doomed.cancel()
        good = lane.submit("佢", lang="yue", phone="keoi5")
        wav = np.concatenate(list(good.iter_timeout(T)))
        assert np.isfinite(wav).all() and len(wav) > 0
        list(it)  # the cancelled handle ends (buffered chunks, then done)


def test_stream_handle_iter_timeout():
    h = _StreamHandle()
    with pytest.raises(TimeoutError, match="chunk"):
        next(h.iter_timeout(0.05))
    h2 = _StreamHandle()
    h2._q.put(np.zeros(4, np.float32))
    h2._q.put(_StreamHandle._DONE)
    out = list(h2.iter_timeout(1.0))
    assert len(out) == 1 and out[0].shape == (4,)


def test_streaming_lane_sample_budget_units(synth):
    lane = StreamingLane(synth, max_streams=1, chunk_frames=50, n_timesteps=1)
    try:
        assert lane._spf == synth.cfg.hift.total_upsample == 480
        assert lane._ms._ss.tts is synth.tts and lane._ms._ss.hift is synth.hift
    finally:
        lane.close()
    assert not lane._worker.is_alive()
