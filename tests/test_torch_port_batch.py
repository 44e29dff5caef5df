"""The port's batched synthesis (`Synthesizer.synthesize_batch_dispatch` /
`synthesize_batch` / `warmup`) against the JAX package's, and against its own
single-request path, on the CPU with the small configuration and the JAX
package's random trees, 2 Euler steps; and the one request check at every
request entry.

Bars: against the JAX package as in test_torch_port_e2e.py (mel frames equal,
mel MAE < 1e-2, waveform atol 1e-4); batched against single as the JAX
package holds its own engine (tests/test_server.py: atol 5e-4 / rtol 1e-3).
"""

import wave

import numpy as np
import pytest
import torch

from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu.weights import provision
from jyutvoice_tpu_torch.cli import infer
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.pipeline import buckets as bkt
from jyutvoice_tpu_torch.pipeline.server import ServingEngine, StreamingLane
from jyutvoice_tpu_torch.pipeline.synthesize import (
    NoiseBufferExceeded,
    OverLongBatchItems,
    Synthesizer,
)
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WAV_ATOL = 1e-4


def _items():
    """3 items (a batch of 4 after padding): mixed text lengths, one with a
    speaker embedding, one cloned with a 40-frame prompt."""
    rng = np.random.default_rng(0)
    pf = rng.standard_normal((40, 80)).astype(np.float32)
    ph = rng.standard_normal((40, 80)).astype(np.float32)
    return [
        dict(text="佢 係邊 個", lang="yue", phone="keoi5 hai6 bin1 go3"),
        dict(text="你好", lang="yue", phone="nei5 hou2",
             spk_embed=rng.standard_normal(192).astype(np.float32)),
        dict(text="好", lang="yue", phone="hou2", prompt_feat=pf, prompt_h=ph,
             spk_embed=rng.standard_normal(192).astype(np.float32)),
    ]


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


@pytest.fixture(scope="module")
def port(trees):
    return Synthesizer(PORT_CFG, *trees, device="cpu")


def test_batch_matches_jax_batch(trees, port):
    jax_s = JaxSynthesizer(JAX_CFG, *trees)
    want = jax_s.synthesize_batch(_items(), n_timesteps=2)
    got = port.synthesize_batch(_items(), n_timesteps=2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.mel_frames == w.mel_frames
        assert g.wav.shape == (g.mel_frames * 480,) and g.wav.dtype == np.float32
        assert np.abs(g.mel - np.asarray(w.mel)).mean() < 1e-2
        np.testing.assert_allclose(g.wav, np.asarray(w.wav), atol=WAV_ATOL)
        assert np.isnan(g.rtf) and g.timings == {}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_batch_matches_single(port, monkeypatch):
    """A padded batch of mixed items agrees with single requests; a batch of
    one and `synthesize` run one short path: the same `synthesize_mel` call,
    bit-equal waveform and mel."""
    got = port.synthesize_batch(_items(), n_timesteps=2)
    for it, g in zip(_items(), got):
        ref = port.synthesize(n_timesteps=2, **it)
        assert g.mel_frames == ref.mel_frames
        np.testing.assert_allclose(g.wav, ref.wav, atol=5e-4, rtol=1e-3)

    calls = []
    real = tts_mod.synthesize_mel

    def spy(model, *args, **kw):
        calls.append((args, kw))
        return real(model, *args, **kw)

    monkeypatch.setattr(tts_mod, "synthesize_mel", spy)
    for it in _items():
        ref = port.synthesize(n_timesteps=2, **it)
        (one,) = port.synthesize_batch_dispatch([it], n_timesteps=2)()
        (ref_args, ref_kw), (one_args, one_kw) = calls[-2:]
        assert len(calls) % 2 == 0 and ref_kw.keys() == one_kw.keys()
        assert all(_same(a, b) for a, b in zip(ref_args, one_args))
        assert all(_same(ref_kw[k], one_kw[k]) for k in ref_kw)
        assert one.mel_frames == ref.mel_frames
        np.testing.assert_array_equal(one.wav, ref.wav)
        np.testing.assert_array_equal(one.mel, ref.mel)


def test_batch_options(port):
    """pcm16 returns the device-rounded int16 waveform; return_mel=False
    reads no mel back."""
    items = _items()[:2]
    flt = port.synthesize_batch(items, n_timesteps=2)
    pcm = port.synthesize_batch(items, n_timesteps=2, pcm16=True, return_mel=False)
    for f, p in zip(flt, pcm):
        assert p.mel is None and p.mel_frames == f.mel_frames
        assert p.wav.dtype == np.int16
        np.testing.assert_array_equal(
            p.wav, np.round(np.clip(f.wav, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_batch_error_paths(port, monkeypatch):
    assert port.synthesize_batch([]) == []
    pf = np.zeros((8, 80), np.float32)
    with pytest.raises(ValueError, match="mismatched cloning prompt"):
        port.synthesize_batch_dispatch([dict(text="佢", phone="keoi5", prompt_feat=pf)])
    with pytest.raises(ValueError, match="mismatched cloning prompt"):
        port.synthesize_batch_dispatch(
            [dict(text="佢", phone="keoi5", prompt_feat=pf, prompt_h=pf[:5])])

    cap = bkt.MEL_BUCKETS[-1]

    def fake_frames(arrs, n, spk):
        out = np.full((len(n),), 10.0, np.float32)
        out[1] = cap + 7  # item 1 is the over-long one
        return out

    monkeypatch.setattr(port, "duration_frames_batch", fake_frames)
    items = [dict(text="佢", lang="yue", phone="keoi5"),
             dict(text="好", lang="yue", phone="hou2"),
             dict(text="你好", lang="yue", phone="nei5 hou2")]
    with pytest.raises(OverLongBatchItems) as ei:
        port.synthesize_batch_dispatch(items, n_timesteps=2)
    assert ei.value.indices == (1,)

    # a prompt bucket on top of the 15000 bucket passes the noise buffer
    monkeypatch.setattr(port, "duration_frames_batch",
                        lambda arrs, n, spk: np.full((len(n),), float(cap), np.float32))
    with pytest.raises(NoiseBufferExceeded):
        port.synthesize_batch_dispatch(
            [dict(text="佢", phone="keoi5", prompt_feat=pf, prompt_h=pf)], n_timesteps=2)


_PF = np.zeros((8, 80), np.float32)
BAD_REQUESTS = {
    "half_pair": (dict(prompt_feat=_PF), "BOTH"),
    "wrong_width": (dict(prompt_feat=np.zeros((8, 79), np.float32),
                         prompt_h=np.zeros((8, 79), np.float32)), r"\(T, 80\)"),
    "unequal_lengths": (dict(prompt_feat=_PF, prompt_h=np.zeros((9, 80), np.float32)),
                        "mismatched cloning prompt"),
    "prompt_past_512": (dict(prompt_feat=np.zeros((600, 80), np.float32),
                             prompt_h=np.zeros((600, 80), np.float32)),
                        "past the largest prompt bucket"),
    "spk_embed_2": (dict(spk_embed=np.zeros((2,), np.float32)), r"spk_embed must have shape"),
}


def _engine_submit(synth, **kw):
    with ServingEngine(synth, max_batch=1, max_wait_ms=1.0, n_timesteps=1) as engine:
        engine.submit("佢", phone="keoi5", **kw).result(timeout=120)


def _lane_submit(synth, **kw):
    with StreamingLane(synth, max_streams=1, chunk_frames=50, n_timesteps=1,
                       prompt_frames=64) as lane:
        lane.submit("佢", phone="keoi5", **kw)


ENTRIES = {
    "synthesize": lambda s, **kw: s.synthesize("佢", phone="keoi5", n_timesteps=1, **kw),
    "synthesize_long": lambda s, **kw: s.synthesize_long("佢", phone="keoi5", n_timesteps=1,
                                                         **kw),
    "synthesize_batch_dispatch": lambda s, **kw: s.synthesize_batch_dispatch(
        [dict(text="好", phone="hou2"), dict(text="佢", phone="keoi5", **kw)], n_timesteps=1),
    "synthesize_streaming": lambda s, **kw: next(s.synthesize_streaming(
        "佢", phone="keoi5", n_timesteps=1, **kw)),
    "engine_submit": _engine_submit,
    "lane_submit": _lane_submit,
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_malformed_request_fails_at_every_entry(port, monkeypatch, entry, case):
    """Every request entry rejects a malformed request with the same
    ValueError before any work: no g2p, no device call."""
    def no_work(*a, **k):
        raise AssertionError("request work started before the request check")

    monkeypatch.setattr(port, "prepare_text", no_work)
    monkeypatch.setattr(tts_mod, "synthesize_mel", no_work)
    kw, match = BAD_REQUESTS[case]
    with pytest.raises(ValueError, match=match) as ei:
        ENTRIES[entry](port, **kw)
    if entry == "synthesize_batch_dispatch":
        assert str(ei.value).startswith("item 1: ")


def test_warmup_drives_each_shape(port, monkeypatch):
    seen = []
    real = tts_mod.synthesize_mel

    def spy(model, x, *args, **kw):
        seen.append((x.shape[0], x.shape[1], kw["t_mel_max"], args[7].shape[1],
                     kw["n_timesteps"]))
        return real(model, x, *args, **kw)

    monkeypatch.setattr(tts_mod, "synthesize_mel", spy)
    n = port.warmup(text_buckets=(32,), mel_buckets=(128,), prompt_buckets=(0, 64),
                    n_timesteps=(2,), batch_sizes=(2, 1), pcm16=True)
    # the JAX package's count: per batch size 1 duration graph, then per
    # (mel, prompt, steps) 2 (mel + vocoder), and 1 more at batch 1
    assert n == (1 + 2 * 3) + (1 + 2 * 2)
    assert seen == [(1, 32, 128, 0, 2), (1, 32, 128, 64, 2),
                    (2, 32, 128, 0, 2), (2, 32, 128, 64, 2)]


def test_infer_cli_text_file(tmp_path, trees):
    tt, th = trees
    ckpt, hift = str(tmp_path / "tts.npz"), str(tmp_path / "hift.npz")
    provision.save_pytree_npz(ckpt, tt)
    provision.save_pytree_npz(hift, th)
    lines = tmp_path / "lines.txt"
    lines.write_text("佢|keoi5\n\n好|hou2\n你好|nei5 hou2\n", encoding="utf-8")
    out = str(tmp_path / "out.wav")
    res = infer.main(
        ["--text-file", str(lines), "--batch-size", "2", "--ckpt", ckpt, "--hift", hift,
         "--output", out, "--n-timesteps", "2", "--device", "cpu"],
        cfg=PORT_CFG,
    )
    assert len(res) == 3
    for i, r in enumerate(res):
        with wave.open(str(tmp_path / f"out_{i:04d}.wav"), "rb") as f:
            assert f.getframerate() == 24000
            assert f.getnframes() == r.mel_frames * 480
    with pytest.raises(SystemExit):
        infer.main(["--text", "佢", "--text-file", str(lines), "--device", "cpu"],
                   cfg=PORT_CFG)
    with pytest.raises(SystemExit):
        infer.main(["--device", "cpu"], cfg=PORT_CFG)
