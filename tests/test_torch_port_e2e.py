"""The port's Synthesizer against the JAX package's, end to end on the CPU:
same weights (the JAX package's random trees), same text, 2 Euler steps.

Durations and mel frames must be identical; mel MAE < 1e-2 (PARITY.md
section 2.2). Waveforms: atol 1e-4 per sample (the random-weight vocoder's
output is a few hundredths in amplitude). The mel differs only through the estimator's attention (the port rounds its
products' inputs to bf16 as the flash kernel does, the JAX CPU path stays
f32), and the vocoder itself agrees to 1e-5 (test_torch_port_modules.py).
"""

import wave

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu.weights import provision
from jyutvoice_tpu_torch.cli import infer
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees

WAV_ATOL = 1e-4


@pytest.fixture(scope="module")
def synths():
    tt, th = jax_trees()
    return JaxSynthesizer(JAX_CFG, tt, th), Synthesizer(PORT_CFG, tt, th, device="cpu")


@pytest.mark.parametrize(
    "text,lang,phone",
    [("佢", "yue", "keoi5"), ("佢係邊個", "yue", None)],
)
def test_synthesizer_matches_jax(synths, text, lang, phone):
    jax_s, port_s = synths
    arrs, n, t_text = port_s.prepare_text(text, lang, phone)
    (jx, jtone, jwp, jsp, jlang), jn, jt_text = jax_s.prepare_text(text, lang, phone)
    assert t_text == jt_text and int(n[0]) == int(jn[0])
    for a, b in zip(arrs, (jx, jtone, jwp, jsp, jlang)):
        np.testing.assert_array_equal(a, b)
    spk = torch.zeros((1, 192))
    jax_frames = int(jax_s._dur_fn(t_text)(
        jax_s.params_tts, jx, jnp.asarray(jn), jlang, jtone, jwp, jsp,
        jnp.zeros((1, 192), jnp.float32),
    )[0])
    assert port_s.duration_frames(arrs, n, spk) == jax_frames

    ref = jax_s.synthesize(text, lang=lang, phone=phone, n_timesteps=2)
    out = port_s.synthesize(text, lang=lang, phone=phone, n_timesteps=2)
    assert out.mel_frames == ref.mel_frames
    assert out.wav.shape == (out.mel_frames * 480,)
    assert set(out.timings) == set(ref.timings)
    assert np.abs(out.mel - ref.mel).mean() < 1e-2
    np.testing.assert_allclose(out.wav, ref.wav, atol=WAV_ATOL)


def test_prompted_synthesis_and_validation(synths):
    _, port_s = synths
    rng = np.random.default_rng(0)
    pf = rng.standard_normal((40, 80)).astype(np.float32)
    res = port_s.synthesize(
        "好", lang="yue", phone="hou2", spk_embed=rng.standard_normal(192).astype(np.float32),
        prompt_feat=pf, prompt_h=pf, n_timesteps=2,
    )
    assert res.wav.shape == (res.mel_frames * 480,) and np.isfinite(res.wav).all()
    with pytest.raises(ValueError, match="BOTH"):
        port_s.synthesize("好", lang="yue", phone="hou2", prompt_feat=pf, n_timesteps=2)


def test_past_the_bucket_table_raises(synths, monkeypatch):
    """Past the 15000-frame bucket, synthesize raises only on a half-given
    prompt pair (checked before the hand-over) and otherwise delegates to
    synthesize_long with this call's g2p output and its PCM16 choice, as
    tests/test_pipeline.py holds the JAX package to."""
    _, port_s = synths
    monkeypatch.setattr(port_s, "duration_frames_batch",
                        lambda *a: np.array([20000.0], np.float32))
    called = {}

    def spy(text, **kw):
        called.update(kw, text=text)
        return "SENTINEL"

    monkeypatch.setattr(port_s, "synthesize_long", spy)
    pf = np.zeros((8, 80), np.float32)
    with pytest.raises(ValueError, match="BOTH"):
        port_s.synthesize("佢", lang="yue", phone="keoi5", prompt_h=pf, n_timesteps=2)
    assert not called
    out = port_s.synthesize("佢", lang="yue", phone="keoi5", prompt_feat=pf, prompt_h=pf,
                            n_timesteps=2, pcm16=True)
    assert out == "SENTINEL" and called["text"] == "佢"
    assert called["prompt_feat"] is pf and called["prompt_h"] is pf
    assert called["pcm16"] is True and called["n_timesteps"] == 2
    arrs, n, t_text = called["prepped"]
    want_arrs, want_n, want_t = port_s.prepare_text("佢", "yue", "keoi5")
    assert t_text == want_t and int(n[0]) == int(want_n[0])
    for a, b in zip(arrs, want_arrs):
        np.testing.assert_array_equal(a, b)


def test_infer_cli_with_npz_trees(tmp_path):
    tt, th = jax_trees()
    ckpt, hift = str(tmp_path / "tts.npz"), str(tmp_path / "hift.npz")
    provision.save_pytree_npz(ckpt, tt)
    provision.save_pytree_npz(hift, th)
    out = str(tmp_path / "out.wav")
    res = infer.main(
        ["--text", "佢", "--lang", "yue", "--phone", "keoi5", "--ckpt", ckpt,
         "--hift", hift, "--output", out, "--n-timesteps", "2", "--device", "cpu"],
        cfg=PORT_CFG,
    )
    with wave.open(out, "rb") as f:
        assert f.getframerate() == 24000
        assert f.getnframes() == res.mel_frames * 480
