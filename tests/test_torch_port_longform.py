"""The port's long-form path against the JAX package on the CPU: kernel 3's
plain version, banded attention, the long-form gates and shape rule, the
text half (`prepare_stream`), the estimator's long-form routes and
`synthesize_long` end to end, on the same weights and numpy inputs.

Tolerances:
  * kernel 3's plain version against JAX's `mha_reference` (the stock
    flash kernel's own reference): atol 5e-3 / rtol 1e-2, the JAX package's
    bar for that kernel (tests/test_estimator_flash_gate.py);
  * banded_sdpa: atol 2e-5 / rtol 1e-5 (tests/test_banded_attention.py);
  * the text half: atol 1e-5 (f32 summation order);
  * the estimator: atol 5e-3 / rtol 2e-2, and synthesize_long: the same mel
    frames, mel MAE < 1e-2 (PARITY.md section 2.2) and wav atol 1e-4, as
    in tests/test_torch_port_e2e.py (PCM16: within 1 LSB).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as jflash
import torch

from jyutvoice_tpu.models import estimator as jest
from jyutvoice_tpu.nn import attention as jattn
from jyutvoice_tpu.pipeline import synthesize as jsyn
from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.nn import attention as pattn
from jyutvoice_tpu_torch.nn.flash_stock import flash_stock, flash_stock_plain
from jyutvoice_tpu_torch.pipeline import buckets as pbuckets
from jyutvoice_tpu_torch.pipeline import synthesize as psyn
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EST = dict(atol=5e-3, rtol=2e-2)
WAV_ATOL = 1e-4
LSB = 1.0 / 32767.0


@pytest.fixture(scope="module")
def synths():
    tt, th = jax_trees()
    return JaxSynthesizer(JAX_CFG, tt, th), Synthesizer(PORT_CFG, tt, th, device="cpu")


def _qkv(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "t,lengths", [(256, [256, 200]), (256, [1, 129]), (512, [300, 512]), (512, [0, 448])]
)
def test_flash_stock_plain_matches_mha_reference(t, lengths):
    b, h, d = len(lengths), 4, 64
    q, k, v = _qkv(0, b, h, t, d)
    seg = (np.arange(t)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    ref = np.asarray(jflash.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        segment_ids=jflash.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
        causal=False, sm_scale=d ** -0.5,
    ))
    to_port = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731 (B, T, H, D) view
    out = flash_stock(to_port(q), to_port(k), to_port(v),
                      torch.tensor(lengths, dtype=torch.int32), scale=d ** -0.5)
    # every row, padded queries included
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize(
    "t,chunk,left,right",
    [(256, 64, 1, 0), (384, 128, 2, 0), (512, 128, 0, 0),
     (256, 64, 1, 1), (384, 128, 2, 1), (512, 128, 2, 2), (512, 128, 3, 3)],
)
def test_banded_sdpa_matches_jax(t, chunk, left, right):
    b, h, d = 2, 3, 32
    q, k, v = _qkv(1, b, h, t, d)
    lengths = [t, t - 37 - chunk]
    ref = np.asarray(jattn.banded_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths, jnp.int32),
        chunk=chunk, left=left, right=right,
    ))
    out = pattn.banded_sdpa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(lengths, dtype=torch.int32), chunk=chunk, left=left, right=right,
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_gates_and_granule_match_jax():
    from jyutvoice_tpu import config as jcfg
    from jyutvoice_tpu_torch import config as pcfg

    variants = [dict(), dict(banded_long_threshold=0), dict(banded_long_threshold=8192),
                dict(banded_chunk=256)]
    ts = sorted(set(range(0, 20481, 64)) | {1, 127, 1535, 1536, 2047, 2049, 2112,
                                            2176, 2304, 15000, 15360, 15872, 16384})
    for kw in variants:
        jc = dataclasses.replace(jcfg.EstimatorConfig(), **kw)
        pc = dataclasses.replace(pcfg.EstimatorConfig(), **kw)
        for t in ts:
            for chunk in (0, 50):
                assert pest.use_banded(t, chunk, pc) == jest.use_banded(t, chunk, jc), (kw, t, chunk)
                assert pest.use_stock_flash(t, chunk) == jest.use_stock_flash(t, chunk), (t, chunk)
    for t in ts:
        assert pest._flash_block(t) == jest._flash_block(t)
    for n_seq in range(1, 17):
        assert psyn.long_frame_granule(n_seq) == jsyn.long_frame_granule(n_seq)


def test_attention_route_order():
    from jyutvoice_tpu_torch.config import EstimatorConfig

    cfg = EstimatorConfig()
    route = pest.attention_route
    # the banded gate first, then the stock-flash gate, then kernel 1
    assert route(cfg, 2048, 0) == "banded"
    assert route(cfg, 2048, 0, "exact") == "flash_stock"
    assert route(cfg, 4096, 0, "exact") == "flash_stock"
    assert route(cfg, 2176, 0, "exact") == "flash"  # not 512-aligned
    assert route(cfg, 2112, 0) == "flash"  # not 128-aligned either
    assert route(cfg, 1536, 0) == "flash"
    assert route(cfg, 4096, 50) == "flash"  # the streaming chunk rule
    assert route(dataclasses.replace(cfg, banded_long_threshold=8192), 4096, 0) == "flash_stock"
    # "xla_scores" builds its bias from the mask itself: no length-based
    # kernel may take it (a prompted stream's mask is front-padded)
    assert route(dataclasses.replace(cfg, attention_backend="xla_scores"), 4096, 0) == "plain"
    assert route(dataclasses.replace(cfg, attention_backend="xla_scores"), 134, 50,
                 on_cuda=False) == "plain"
    # the gates are taken on CUDA only; an explicit banded backend everywhere
    assert route(cfg, 4096, 0, on_cuda=False) == "flash"
    assert route(cfg, 4096, 0, "exact", on_cuda=False) == "flash"
    assert route(cfg, 256, 0, "banded", on_cuda=False) == "banded"
    assert route(dataclasses.replace(cfg, attention_backend="banded"), 256, 0,
                 on_cuda=False) == "banded"
    with pytest.raises(ValueError, match="T % 128"):
        route(cfg, 200, 0, "banded")
    with pytest.raises(ValueError, match="unknown long-form attention"):
        route(cfg, 2048, 0, "dense")


def _long_ys():
    ys = set(range(1, 80, 7))
    for bkt in pbuckets.MEL_BUCKETS:
        ys |= {bkt - 33, bkt - 1, bkt, bkt + 1, bkt + 31}
    ys |= {m * 512 + o for m in range(1, 40) for o in (-1, 0, 1)}
    ys |= set(np.random.default_rng(0).integers(1, 20001, 120).tolist())
    return sorted(y for y in ys if 1 <= y <= 20000)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("attention", ["auto", "banded"])
@pytest.mark.parametrize("prompted", [False, True])
def test_long_form_shapes_match_jax(synths, monkeypatch, attention, prompted):
    jax_s, _ = synths
    seen = {}

    def spy_solve(t_total, n_timesteps, attention="auto"):
        seen["t_total"] = t_total
        raise _Stop

    monkeypatch.setattr(jax_s, "_long_solve_fn", spy_solve)
    monkeypatch.setattr("jyutvoice_tpu.weights.noise.rand_noise_extended",
                        lambda t: np.zeros((1, 1, 80), np.float32))
    pf = np.zeros((40, 80), np.float32) if prompted else None
    bc = PORT_CFG.tts.cfm.estimator.banded_chunk
    for y_len in _long_ys():
        monkeypatch.setattr(
            jax_s, "prepare_stream",
            lambda *a, y=y_len, **k: (np.zeros((y, 80), np.float32), np.zeros(80, np.float32), y),
        )
        with pytest.raises(_Stop):
            jax_s.synthesize_long("佢", prompt_feat=pf, prompt_h=pf, attention=attention)
        head, t_mel = psyn.long_form_shapes(y_len, prompted, attention, bc)
        assert head + t_mel == seen["t_total"], (y_len, head, t_mel)


def test_prepare_stream_matches_jax(synths):
    jax_s, port_s = synths
    spk = np.random.default_rng(3).standard_normal(192).astype(np.float32)
    kw = dict(lang="yue", spk_embed=spk, length_scale=1.37)
    mu_j, c_j, y_j = jax_s.prepare_stream("佢係邊個呀", **kw)
    mu_p, c_p, y_p = port_s.prepare_stream("佢係邊個呀", **kw)
    assert y_p == y_j and mu_p.shape == (y_j, 80)
    np.testing.assert_allclose(mu_p, np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(c_p, np.asarray(c_j), atol=1e-5)


def _estimator_inputs(t, lengths, seed=5):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = (np.arange(t)[None] < np.array(lengths)[:, None]).astype(np.float32)[..., None]
    return f(b, t, 80), mask, f(b, t, 80), np.array([0.3, 0.7], np.float32)[:b], f(b, 80), f(b, t, 80)


def _estimator_pair(est_kw):
    from jyutvoice_tpu import config as jcfg
    from jyutvoice_tpu.models.tts import init_tts
    from jyutvoice_tpu_torch.weights import from_jax
    import jax

    jc = dataclasses.replace(JAX_CFG.tts.cfm.estimator, **est_kw)
    pc = dataclasses.replace(PORT_CFG.tts.cfm.estimator, **est_kw)
    tree = init_tts(jax.random.PRNGKey(0), JAX_CFG.tts)["decoder"]
    port = from_jax.load_jax_params(pest.Estimator(pc), tree).eval()
    return jc, tree, port


def test_estimator_banded_backend_matches_jax():
    jc, tree, port = _estimator_pair(
        dict(attention_backend="banded", banded_chunk=64, banded_left=1, banded_right=1)
    )
    ins = _estimator_inputs(256, [256, 170])
    ref = np.asarray(jest.apply_estimator(tree, jc, *(jnp.asarray(a) for a in ins)))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in ins)).numpy()
    np.testing.assert_allclose(out, ref, **EST)


def test_estimator_stock_flash_route_matches_jax(monkeypatch):
    """The kernel 3 route, taken on CPU tensors by pretending they lie on the
    card (so its plain version runs), against the JAX package's exact
    attention on the CPU."""
    jc, tree, port = _estimator_pair(dict(banded_long_threshold=0))
    routes, calls = [], []
    real_route = pest.attention_route
    monkeypatch.setattr(
        pest, "attention_route",
        lambda cfg, t, chunk, attention="auto", on_cuda=True, training=False:
            routes.append(real_route(cfg, t, chunk, attention, True, training)) or routes[-1],
    )
    monkeypatch.setattr(pattn, "flash_stock", lambda *a, **k: calls.append(1) or flash_stock(*a, **k))
    ins = _estimator_inputs(2048, [2048, 1700])
    ref = np.asarray(jest.apply_estimator(tree, jc, *(jnp.asarray(a) for a in ins)))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in ins)).numpy()
    assert routes == ["flash_stock"] and len(calls) == 3  # down, 1 mid, up
    np.testing.assert_allclose(out, ref, **EST)


@pytest.mark.parametrize("pcm16", [False, True])
@pytest.mark.parametrize("prompted", [False, True])
@pytest.mark.parametrize("attention", ["auto", "banded"])
def test_synthesize_long_matches_jax(synths, attention, prompted, pcm16):
    jax_s, port_s = synths
    rng = np.random.default_rng(7)
    kw = dict(lang="yue", phone="keoi5 hai6 bin1 go3", n_timesteps=2, attention=attention,
              pcm16=pcm16)
    if prompted:
        pf = rng.standard_normal((40, 80)).astype(np.float32)
        kw.update(prompt_feat=pf, prompt_h=pf * 0.5,
                  spk_embed=rng.standard_normal(192).astype(np.float32))
    ref = jax_s.synthesize_long("佢 係 邊 個", **kw)
    out = port_s.synthesize_long("佢 係 邊 個", **kw)
    assert out.mel_frames == ref.mel_frames
    assert out.mel.shape == (out.mel_frames, 80)
    assert out.wav.shape == ref.wav.shape == (out.mel_frames * 480,)
    assert out.wav.dtype == np.float32
    assert set(out.timings) == set(ref.timings)
    assert np.abs(out.mel - np.asarray(ref.mel)).mean() < 1e-2
    atol = LSB * 1.01 if pcm16 else WAV_ATOL
    np.testing.assert_allclose(out.wav, np.asarray(ref.wav), atol=atol, rtol=0)
    if pcm16:
        raw = port_s.synthesize_long("佢 係 邊 個", dequantize=False, return_mel=False, **kw)
        assert raw.wav.dtype == np.int16 and raw.mel is None
        np.testing.assert_array_equal(raw.wav.astype(np.float32) / 32767.0, out.wav)


def test_synthesize_long_validates_like_jax(synths):
    _, port_s = synths
    pf = np.zeros((8, 80), np.float32)
    for kw, msg in [
        (dict(attention="dense"), "unknown long-form attention"),
        (dict(prompt_feat=pf), "BOTH"),
        (dict(prompt_feat=np.zeros((8, 81), np.float32), prompt_h=pf), r"must be \(T_p, 80\)"),
        (dict(prompt_feat=pf, prompt_h=np.zeros((9, 80), np.float32)), "lengths differ"),
        (dict(prompt_feat=np.zeros((600, 80), np.float32),
              prompt_h=np.zeros((600, 80), np.float32)), "past the largest prompt bucket"),
    ]:
        with pytest.raises(ValueError, match=msg):
            port_s.synthesize_long("佢", lang="yue", phone="keoi5", n_timesteps=1, **kw)
