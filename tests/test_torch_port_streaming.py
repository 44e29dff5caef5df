"""The port's streaming synthesis against the JAX package on the CPU: the
"xla_scores" estimator route, `StreamingSynthesizer.stream`,
`MultiStreamSynthesizer`, `Synthesizer.synthesize_streaming` and
`cli.infer --stream`, on the small configuration's JAX random trees, 2
Euler steps, numpy-seeded inputs; the JAX streaming graphs are jitted.

Bars: the same chunk count and lengths; an unprompted chunk's mel MAE
< 1e-2 (PARITY.md section 2.2: the port's CPU kernel-1 route rounds the
attention products to bf16 as the kernel does, JAX's CPU path stays f32)
and its waveform atol 1e-4 (tests/test_torch_port_e2e.py); a prompted
chunk, f32 scores on both sides, mel and waveform atol 1e-4; PCM16 within
1 LSB; the "xla_scores" estimator atol 1e-5; the multi-session lane against
the port's single stream atol 1e-5 (the JAX package's own bar,
tests/test_streaming.py::test_multistream_matches_single).
"""

import dataclasses
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jyutvoice_tpu.models import estimator as jest
from jyutvoice_tpu.pipeline import streaming as jstream
from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu_torch.cli import infer
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.nn import attention as pattn
from jyutvoice_tpu_torch.pipeline import streaming
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.weights import random_init
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CHUNK = 50


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


def _utterance(seed, t, prompt=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pair = (f(prompt, 80), f(prompt, 80)) if prompt else (None, None)
    return f(t, 80), f(80), *pair


def _no_kernel_1(monkeypatch):
    """Fail if anything reaches kernel 1's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a front-padded mask reached kernel 1")

    monkeypatch.setattr(pattn, "flash_attention", refuse)


def test_xla_scores_route_on_a_front_padded_mask(monkeypatch):
    """A prompted segment's mask (rows [p_start, n_valid)) through the
    "xla_scores" route against the JAX package's; kernel 1, which reads a
    length per row, would mask it as the prefix [0, n_valid - p_start)."""
    from jyutvoice_tpu.models.tts import init_tts
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
    import jax

    assert pest.attention_route(PORT_CFG.tts.cfm.estimator, 134, 0) == "flash"
    jc = dataclasses.replace(JAX_CFG.tts.cfm.estimator, attention_backend="xla_scores")
    tree = init_tts(jax.random.PRNGKey(0), JAX_CFG.tts)["decoder"]
    est = load_jax_params(pest.Estimator(PORT_CFG.tts.cfm.estimator), tree).eval()
    view = pest.with_attention_backend(est, "xla_scores")
    assert pest.attention_route(view.cfg, 134, 50) == "plain"
    assert est.cfg.attention_backend == "xla" and view.down is est.down
    rng = np.random.default_rng(5)
    t = 134
    mask = np.zeros((2, t, 1), np.float32)
    mask[0, 20:120] = 1.0  # front-padded
    mask[1, 0:90] = 1.0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ins = (f(2, t, 80), mask, f(2, t, 80), np.array([0.3, 0.7], np.float32), f(2, 80),
           f(2, t, 80))
    for streaming_masks in (False, True):
        ref = np.asarray(jest.apply_estimator(tree, jc, *(jnp.asarray(a) for a in ins),
                                              streaming=streaming_masks))
        with torch.no_grad():
            with monkeypatch.context() as mp:
                _no_kernel_1(mp)
                out = view(*(torch.from_numpy(a) for a in ins), streaming_masks).numpy()
            flash = est(*(torch.from_numpy(a) for a in ins), streaming_masks).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
        # the length route mis-masks the front-padded row, not the other one
        assert np.abs(flash[0] - ref[0]).max() > 1e-2
        np.testing.assert_allclose(flash[1], ref[1], atol=5e-3, rtol=2e-2)


STREAM_CASES = {
    "unprompted": (dict(), 0),
    "chunk_masks": (dict(estimator_chunk_masks=True), 0),
    "prompted": (dict(prompt_frames=64), 32),
    "pcm16": (dict(pcm16=True), 0),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_matches_jax(trees, monkeypatch, case):
    kw, prompt = STREAM_CASES[case]
    tt, th = trees
    mu, spk, pf, ph = _utterance(1, 130, prompt)
    jss = jstream.StreamingSynthesizer(JAX_CFG, tt, th, chunk_frames=CHUNK, n_timesteps=2, **kw)
    pss = streaming.StreamingSynthesizer(PORT_CFG, tt, th, chunk_frames=CHUNK, n_timesteps=2,
                                         device="cpu", **kw)
    want = list(jss.stream(mu, spk, pf, ph, emit_mel=True))
    if prompt:
        _no_kernel_1(monkeypatch)  # the prompted graph runs "plain" attention
    got = list(pss.stream(mu, spk, pf, ph, emit_mel=True))
    assert [w.shape for w, _ in got] == [w.shape for w, _ in want]
    assert [m.shape for _, m in got] == [m.shape for _, m in want]
    assert len(got) == 3 and sum(len(w) for w, _ in got) == 130 * 480
    for (w, m), (w_ref, m_ref) in zip(got, want):
        w_ref, m_ref = np.asarray(w_ref), np.asarray(m_ref)
        assert np.abs(m - m_ref).mean() < 1e-2
        if prompt:
            np.testing.assert_allclose(m, m_ref, atol=1e-4)
        if kw.get("pcm16"):
            assert w.dtype == np.int16
            assert np.abs(w.astype(np.int32) - w_ref.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(w, w_ref, atol=1e-4)


def test_stream_guards(trees):
    tt, th = trees
    mu, spk, pf, ph = _utterance(2, 60, 80)
    with pytest.raises(ValueError, match="must exceed the crossfade"):
        streaming.StreamingSynthesizer(PORT_CFG, tt, th, chunk_frames=streaming.OVERLAP,
                                       device="cpu")
    plain = streaming.StreamingSynthesizer(PORT_CFG, tt, th, chunk_frames=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="without prompt capacity"):
        next(plain.stream(mu, spk, pf, ph))
    small = streaming.StreamingSynthesizer(PORT_CFG, tt, th, chunk_frames=CHUNK,
                                           prompt_frames=64, device="cpu")
    with pytest.raises(ValueError, match="prompt capacity 64"):
        next(small.stream(mu, spk, pf, ph))
    ms = streaming.MultiStreamSynthesizer(PORT_CFG, tt, th, max_sessions=1, chunk_frames=CHUNK,
                                          device="cpu")
    with pytest.raises(ValueError, match="mu_y is empty"):
        ms.open(mu[:0], spk)
    with pytest.raises(ValueError, match="prompt_frames=0"):
        ms.open(mu, spk, pf, ph)
    ms.open(mu, spk)
    with pytest.raises(RuntimeError, match="slots busy"):
        ms.open(mu, spk)


def _single(ss, mu, spk, pf=None, ph=None):
    return np.concatenate(list(ss.stream(mu, spk, pf, ph)))


def test_multi_stream_matches_single(trees):
    """Three sessions of 130, 80 and 50 frames finish on different ticks;
    the fourth slot rides along free and its carries stay zero."""
    tt, th = trees
    kw = dict(chunk_frames=CHUNK, n_timesteps=2, device="cpu")
    ss = streaming.StreamingSynthesizer(PORT_CFG, tt, th, **kw)
    reqs = [_utterance(10 + i, t)[:2] for i, t in enumerate((130, 80, 50))]
    ms = streaming.MultiStreamSynthesizer(PORT_CFG, tt, th, max_sessions=4, **kw)
    got = ms.run_all(reqs)
    for i, (mu, spk) in enumerate(reqs):
        assert got[i].shape == (mu.shape[0] * 480,)
        np.testing.assert_allclose(got[i], _single(ss, mu, spk), atol=1e-5)
    for carry in (ms._held, ms._voc_tail, ms._src):
        assert not carry[3].any()
    assert ms.active == 0 and ms._pending is None


def test_multi_stream_mixed_prompt_sessions_match_jax(trees, monkeypatch):
    """A prompt-capable lane: a cloning session (a 24-frame prompt in a
    64-frame capacity) and a plain one in one dispatch, against the JAX
    package's lane; no kernel-1 route."""
    tt, th = trees
    mu1, s1, pf, ph = _utterance(20, 130, 24)
    mu2, s2, _, _ = _utterance(21, 80)
    kw = dict(max_sessions=2, chunk_frames=CHUNK, prompt_frames=64, n_timesteps=2)
    want = jstream.MultiStreamSynthesizer(JAX_CFG, tt, th, **kw).run_all(
        [(mu1, s1, pf, ph), (mu2, s2)])
    _no_kernel_1(monkeypatch)
    got = streaming.MultiStreamSynthesizer(PORT_CFG, tt, th, device="cpu", **kw).run_all(
        [(mu1, s1, pf, ph), (mu2, s2)])
    for i in (0, 1):
        assert got[i].shape == want[i].shape
        np.testing.assert_allclose(got[i], np.asarray(want[i]), atol=1e-4)


def test_multi_stream_close_reopen_and_reset(trees):
    """tick() delivers the previous dispatch; close() drops a session's share
    of the dispatch in flight, so a session reopened in its slot receives
    only its own audio; reset() frees everything."""
    tt, th = trees
    kw = dict(chunk_frames=CHUNK, n_timesteps=2, device="cpu")
    ss = streaming.StreamingSynthesizer(PORT_CFG, tt, th, **kw)
    ms = streaming.MultiStreamSynthesizer(PORT_CFG, tt, th, max_sessions=2, **kw)
    (mu_a, s_a), (mu_b, s_b), (mu_c, s_c) = (_utterance(30 + i, t)[:2]
                                              for i, t in enumerate((130, 90, 70)))
    a, b = ms.open(mu_a, s_a), ms.open(mu_b, s_b)
    assert ms.tick() == ({}, set())  # the first dispatch is still in flight
    ms.close(a)
    c = ms.open(mu_c, s_c)
    assert c == a
    out = {b: [], c: []}
    done = set()
    while ms.active or ms._pending is not None:
        chunks, fin = ms.tick()
        for sid, w in chunks.items():
            out[sid].append(w)
        done |= fin
    assert done == {b, c}
    np.testing.assert_allclose(np.concatenate(out[b]), _single(ss, mu_b, s_b), atol=1e-5)
    np.testing.assert_allclose(np.concatenate(out[c]), _single(ss, mu_c, s_c), atol=1e-5)
    ms.open(mu_a, s_a)
    ms.tick()
    ms.reset()
    assert ms.active == 0 and ms._pending is None and not ms._held.any()


@pytest.fixture(scope="module")
def synths(trees):
    tt, th = trees
    return JaxSynthesizer(JAX_CFG, tt, th), Synthesizer(PORT_CFG, tt, th, device="cpu")


@pytest.mark.parametrize("prompted", [False, True])
def test_synthesize_streaming_matches_jax(synths, prompted):
    jax_s, port_s = synths
    _, _, pf, ph = _utterance(40, 0, 40 if prompted else 0)
    kw = dict(lang="yue", phone="keoi5 hai6 bin1 go3", chunk_frames=CHUNK, n_timesteps=2,
              length_scale=3.0, prompt_feat=pf, prompt_h=ph)
    want = [np.asarray(w) for w in jax_s.synthesize_streaming("佢係邊個", **kw)]
    got = list(port_s.synthesize_streaming("佢係邊個", **kw))
    mu_y, _, y_len = port_s.prepare_stream("佢係邊個", "yue", "keoi5 hai6 bin1 go3",
                                           length_scale=3.0)
    assert len(got) >= 2 and [len(w) for w in got] == [len(w) for w in want]
    assert sum(len(w) for w in got) == y_len * 480
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=1e-4)
    if prompted:  # the 40-frame prompt took the 64 bucket
        assert (CHUNK, 64, 2, False) in port_s._streams
    with pytest.raises(ValueError, match="BOTH"):
        next(port_s.synthesize_streaming("佢", phone="keoi5", prompt_feat=pf if prompted
                                         else np.zeros((8, 80), np.float32)))


def test_infer_cli_stream_on_the_cpu(tmp_path):
    out = str(tmp_path / "out.wav")
    argv = ["--text", "佢係邊個", "--lang", "yue", "--phone", "keoi5 hai6 bin1 go3",
            "--n-timesteps", "2", "--device", "cpu", "--stream", "--chunk-frames", "50",
            "--length-scale", "3", "--output", out]
    wav = infer.main(argv, cfg=PORT_CFG)
    with wave.open(out, "rb") as f:
        assert f.getframerate() == 24000 and f.getnframes() == len(wav)
    synth = Synthesizer(PORT_CFG, random_init.init_tts_tree(PORT_CFG.tts, seed=0),
                        random_init.init_hift_tree(PORT_CFG.hift, seed=1), device="cpu")
    want = np.concatenate(list(synth.synthesize_streaming(
        "佢係邊個", phone="keoi5 hai6 bin1 go3", chunk_frames=50, n_timesteps=2,
        length_scale=3.0)))
    np.testing.assert_array_equal(wav, want)
