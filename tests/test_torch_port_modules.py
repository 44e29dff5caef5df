"""The port's modules against the JAX package on the CPU, on the same weights
(the JAX package's random trees, loaded through the port's weights bridge)
and the same numpy inputs.

Tolerances:
  * f32 modules (core ops, text encoder, duration predictor, HiFT pieces):
    atol 1e-5 / rtol 1e-5, float32 summation order only;
  * anything through the estimator: its attention is the flash kernel's
    plain version (bf16 products, f32 accumulation) against the JAX
    package's f32 SDPA, so atol 5e-3 / rtol 2e-2 (the Pallas test's bar),
    and mel MAE < 1e-2 (PARITY.md section 2.2).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu.models import cfm as jcfm
from jyutvoice_tpu.models import duration as jdur
from jyutvoice_tpu.models import estimator as jest
from jyutvoice_tpu.models import hift as jhift
from jyutvoice_tpu.models import text_encoder as jte
from jyutvoice_tpu.models import tts as jtts
from jyutvoice_tpu.nn import core as jcore
from jyutvoice_tpu.pipeline import buckets as jbuckets
from jyutvoice_tpu.weights import provision
from jyutvoice_tpu.weights.noise import rand_noise as jax_noise
from jyutvoice_tpu_torch import config as port_config
from jyutvoice_tpu_torch.models import cfm as pcfm
from jyutvoice_tpu_torch.models import hift as phift
from jyutvoice_tpu_torch.models import tts as ptts
from jyutvoice_tpu_torch.nn import core as pcore
from jyutvoice_tpu_torch.pipeline import buckets as pbuckets
from jyutvoice_tpu_torch.weights import from_jax, random_init
from jyutvoice_tpu_torch.weights.noise import rand_noise as port_noise
from jyutvoice_tpu_torch.weights.noise import rand_noise_extended
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=5e-3, rtol=2e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    tt, th = jax_trees()
    port_tts = from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), tt).eval()
    port_hift = from_jax.load_jax_params(phift.HiFT(PORT_CFG.hift), th).eval()
    return tt, th, port_tts, port_hift


def _text_inputs(seed=0, b=2, t=32, lengths=(32, 20)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (b, t))
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return (
        ids, np.array(lengths), rng.integers(0, 3, (b, t)), rng.integers(0, 7, (b, t)),
        rng.integers(0, 4, (b, t)), rng.integers(0, 4, (b, t)),
        rng.standard_normal((b, 192)).astype(np.float32),
    )


def _mel_inputs(seed=1, b=2, t=96, lengths=(96, 70)):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = (np.arange(t)[None] < np.array(lengths)[:, None]).astype(np.float32)[..., None]
    return f(b, t, 80), mask, f(b, t, 80), np.array([0.3, 0.7], np.float32)[:b], f(b, 80), f(b, t, 80)


def test_configs_match():
    """Field for field, but for the port's estimator choice (the DiT, which
    the JAX package lacks): its two fields, at the U-Net by default."""
    port = dataclasses.asdict(port_config.JyutVoiceConfig())
    cfm = port["tts"]["cfm"]
    assert cfm.pop("estimator_kind") == "unet"
    assert cfm.pop("dit") == dataclasses.asdict(port_config.DiTConfig())
    assert port == dataclasses.asdict(jax_config.JyutVoiceConfig())


@pytest.mark.parametrize(
    "text,lang,phone",
    [("佢 係 邊 個", "yue", "keoi5 hai6 bin1 go3"), ("佢係邊個", "yue", None),
     ("我们是朋友", "zh", None), ("hello nabokov, walked!", "en", None),
     ("我今日去公園", "multilingual", None)],
)
def test_text_frontend_matches(text, lang, phone):
    from jyutvoice_tpu.text import text_to_sequence as jax_seq
    from jyutvoice_tpu_torch.text import text_to_sequence as port_seq

    assert port_seq(text, lang, phone) == jax_seq(text, lang, phone)


def test_buckets_match():
    assert pbuckets.TEXT_BUCKETS == jbuckets.TEXT_BUCKETS
    assert pbuckets.MEL_BUCKETS == jbuckets.MEL_BUCKETS
    assert pbuckets.PROMPT_BUCKETS == jbuckets.PROMPT_BUCKETS
    for p_len in (0, 1, 64, 65, 300, 512):
        for t_mel in (128, 512, 2048, 3072, 15000):
            assert pbuckets.pick_prompt_bucket(p_len, t_mel) == jbuckets.pick_prompt_bucket(
                p_len, t_mel
            )


@pytest.mark.parametrize(
    "padding,dilation,stride",
    [("same_torch", 1, 1), ("causal", 1, 1), ("valid", 1, 1), ((4, 4), 2, 1), ((7, 7), 1, 15)],
)
def test_conv1d_matches(padding, dilation, stride):
    rng = np.random.default_rng(0)
    k = 3 if stride == 1 else 30
    x = rng.standard_normal((2, 61, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jcore.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                       stride=stride, padding=padding, dilation=dilation)
    out = pcore.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), stride=stride,
                       padding=padding, dilation=dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("k,s", [(16, 8), (11, 5), (7, 3)])
def test_conv_transpose1d_matches(k, s):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 9, 4)).astype(np.float32)
    w = rng.standard_normal((k, 4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    ref = jcore.conv_transpose1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                 stride=s, padding=(k - s) // 2)
    out = pcore.conv_transpose1d(_t(x), _t(w.transpose(1, 2, 0)), _t(b), stride=s,
                                 padding=(k - s) // 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_masks_and_path_match():
    lengths = np.array([7, 3, 10])
    pad = jcore.sequence_mask(jnp.asarray(lengths), 10)
    assert np.array_equal(pcore.sequence_mask(_t(lengths), 10).numpy(), np.asarray(pad))
    for chunk, left in ((0, -1), (4, -1), (3, 1)):
        ref = jcore.chunk_attn_mask(pad, chunk, left)
        out = pcore.chunk_attn_mask(pcore.sequence_mask(_t(lengths), 10), chunk, left)
        assert np.array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            pcore.mask_to_bias(out).numpy(), np.asarray(jcore.mask_to_bias(ref))
        )
    dur = np.array([[1.0, 2.5, 0.0, 3.0]], np.float32)
    am = np.ones((1, 4, 9), np.float32)
    np.testing.assert_array_equal(
        pcore.generate_path(_t(dur), _t(am)).numpy(),
        np.asarray(jcore.generate_path(jnp.asarray(dur), jnp.asarray(am))),
    )
    x = np.random.default_rng(2).standard_normal((2, 40)).astype(np.float32)
    a = np.random.default_rng(3).uniform(0.5, 1.5, 5).astype(np.float32)
    y = np.random.default_rng(4).standard_normal((2, 3, 5)).astype(np.float32)
    from jyutvoice_tpu.audio.mel import frame_signal

    np.testing.assert_array_equal(
        pcore.frame_signal(_t(x), 16, 4).numpy(), np.asarray(frame_signal(jnp.asarray(x), 16, 4))
    )
    for pf, jf in ((pcore.mish, jcore.mish), (pcore.gelu_torch, jcore.gelu_torch),
                   (pcore.silu, jcore.silu), (pcore.elu, jcore.elu)):
        np.testing.assert_allclose(pf(_t(y)).numpy(), np.asarray(jf(jnp.asarray(y))), **F32)
    np.testing.assert_allclose(pcore.snake(_t(y), _t(a)).numpy(),
                               np.asarray(jcore.snake(jnp.asarray(y), jnp.asarray(a))), **F32)


def test_text_encoder_and_duration_match(models):
    tt, _, port_tts, _ = models
    inputs = _text_inputs()
    ref = jte.apply_text_encoder(tt["encoder"], JAX_CFG.tts.encoder,
                                 *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        out = port_tts.encoder(*(_t(a) for a in inputs))
        logw = port_tts.dp(_t(ref.x), _t(ref.x_mask), _t(inputs[-1]))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), **F32)
    np.testing.assert_allclose(out.mu.numpy(), np.asarray(ref.mu), **F32)
    np.testing.assert_array_equal(out.x_mask.numpy(), np.asarray(ref.x_mask))
    ref_logw = jdur.apply_duration_predictor(tt["dp"], JAX_CFG.tts.dp, ref.x, ref.x_mask,
                                             jnp.asarray(inputs[-1]))
    np.testing.assert_allclose(logw.numpy(), np.asarray(ref_logw), **F32)


def test_estimator_matches(models):
    tt, _, port_tts, _ = models
    x, mask, mu, t, spks, cond = _mel_inputs()
    ref = jest.apply_estimator(tt["decoder"], JAX_CFG.tts.cfm.estimator,
                               *(jnp.asarray(a) for a in (x, mask, mu, t, spks, cond)))
    with torch.no_grad():
        out = port_tts.decoder(*(_t(a) for a in (x, mask, mu, t, spks, cond)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BF16)


def test_cfm_forward_matches(models):
    tt, _, port_tts, _ = models
    _, mask, mu, _, spks, cond = _mel_inputs(seed=2)
    ref = np.asarray(jcfm.cfm_forward(
        tt["decoder"], JAX_CFG.tts.cfm, *(jnp.asarray(a) for a in (mu, mask, spks, cond)),
        n_timesteps=2, rand_noise=jnp.asarray(jax_noise()),
    ))
    with torch.no_grad():
        out = pcfm.cfm_forward(
            port_tts.decoder, PORT_CFG.tts.cfm, *(_t(a) for a in (mu, mask, spks, cond)),
            n_timesteps=2, rand_noise=port_noise(),
        ).numpy()
    np.testing.assert_allclose(out, ref, **BF16)
    assert np.abs(out - ref).mean() < 1e-2
    np.testing.assert_allclose(pcfm.cosine_t_span(10).numpy(),
                               np.asarray(jcfm.cosine_t_span(10)), atol=1e-7)


@pytest.mark.parametrize("plen", [0, 40])
def test_synthesize_mel_matches(models, plen):
    tt, _, port_tts, _ = models
    ids, n, lang, tone, wp, sp, spk = _text_inputs(seed=3, b=1, t=32, lengths=(17,))
    rng = np.random.default_rng(5)
    t_prompt = 64 if plen else 0
    pf = np.zeros((1, t_prompt, 80), np.float32)
    ph = np.zeros((1, t_prompt, 80), np.float32)
    pf[0, :plen] = rng.standard_normal((plen, 80))
    ph[0, :plen] = rng.standard_normal((plen, 80))
    args = (ids, n, lang, tone, wp, sp, spk, pf, ph, np.array([plen], np.int32))
    kw = dict(t_mel_max=128, n_timesteps=2, length_scale=0.9)
    ref = jtts.synthesize_mel(tt, JAX_CFG.tts, *(jnp.asarray(a) for a in args),
                              rand_noise=jnp.asarray(jax_noise()), **kw)
    with torch.no_grad():
        out = ptts.synthesize_mel(port_tts, *(_t(a) for a in args), rand_noise=port_noise(), **kw)
    np.testing.assert_array_equal(out.durations.numpy(), np.asarray(ref.durations))
    np.testing.assert_array_equal(out.mel_lengths.numpy(), np.asarray(ref.mel_lengths))
    np.testing.assert_array_equal(out.attn.numpy(), np.asarray(ref.attn))
    np.testing.assert_allclose(out.encoder_mel.numpy(), np.asarray(ref.encoder_mel), **F32)
    n_mel = int(ref.mel_lengths[0])
    diff = np.abs(out.mel.numpy() - np.asarray(ref.mel))[0, :n_mel]
    assert diff.mean() < 1e-2, diff.mean()
    np.testing.assert_allclose(out.mel.numpy(), np.asarray(ref.mel), **BF16)


def test_hift_inference_matches(models):
    _, th, _, port_hift = models
    mel = np.random.default_rng(6).standard_normal((2, 40, 80)).astype(np.float32)
    wav, src = jhift.hift_inference(th, JAX_CFG.hift, jnp.asarray(mel))
    with torch.no_grad():
        pwav, psrc = phift.hift_inference(port_hift, _t(mel))
    assert pwav.shape == (2, 40 * 480)
    np.testing.assert_allclose(psrc.numpy(), np.asarray(src), **F32)
    np.testing.assert_allclose(pwav.numpy(), np.asarray(wav), **F32)


def test_phase_and_small_stft_match():
    rng = np.random.default_rng(7)
    f0 = (rng.uniform(80, 300, (2, 40000)) / 24000).astype(np.float32)
    mult = np.arange(1, 10, dtype=np.float32)
    ref = np.asarray(jhift._harmonic_phase_frac(jnp.asarray(f0), jnp.asarray(mult)))
    out = phift._harmonic_phase_frac(_t(f0), _t(mult)).numpy()
    # compare on the circle: 0.9999 and 0.0001 are 2e-4 cycles apart
    d = np.abs(out - ref)
    assert np.minimum(d, 1.0 - d).max() < 1e-3
    x = rng.standard_normal((2, 480)).astype(np.float32)
    re, im = jhift.small_stft(jnp.asarray(x), 16, 4)
    pre, pim = phift.small_stft(_t(x), 16, 4)
    np.testing.assert_allclose(pre.numpy(), np.asarray(re), **F32)
    np.testing.assert_allclose(pim.numpy(), np.asarray(im), **F32)
    np.testing.assert_allclose(
        phift.small_istft(pre, pim, 16, 4).numpy(),
        np.asarray(jhift.small_istft(re, im, 16, 4)), **F32,
    )


def test_noise_is_the_committed_buffer():
    np.testing.assert_array_equal(port_noise().numpy(), jax_noise())
    from jyutvoice_tpu.weights.noise import rand_noise_extended as jax_ext

    np.testing.assert_array_equal(rand_noise_extended(15100).numpy(), jax_ext(15100))


def test_bridge_is_strict_both_ways(models):
    tt, _, _, _ = models
    import copy

    extra = copy.deepcopy(tt)
    extra["encoder"]["proj"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="proj"):
        from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), extra)
    missing = copy.deepcopy(tt)
    del missing["dp"]["norm2"]
    with pytest.raises(ValueError, match="norm2"):
        from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), missing)
    bad = copy.deepcopy(tt)
    bad["spk_embed_affine_layer"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), bad)
    short = copy.deepcopy(tt)
    short["decoder"]["mid"] = []
    with pytest.raises(ValueError, match="mid"):
        from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), short)


def test_bridge_loads_npz_and_random_trees_fit(models, tmp_path):
    tt, th, port_tts, _ = models
    path = str(tmp_path / "tts.npz")
    provision.save_pytree_npz(path, tt)
    loaded = from_jax.load_jax_params(ptts.TTS(PORT_CFG.tts), from_jax.load_pytree_npz(path))
    for (name, a), (_, b) in zip(loaded.state_dict().items(), port_tts.state_dict().items()):
        assert torch.equal(a, b), name
    # the port's numpy initialisers build trees of the JAX package's shapes
    rt = random_init.init_tts_tree(PORT_CFG.tts, seed=0)
    rh = random_init.init_hift_tree(PORT_CFG.hift, seed=1)
    shapes = lambda tree: sorted(  # noqa: E731
        (k, np.shape(v)) for k, v in provision._flatten(tree).items()
    )
    assert shapes(rt) == shapes(tt) and shapes(rh) == shapes(th)
