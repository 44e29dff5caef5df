"""The port's int8 estimator (`jyutvoice_tpu_torch/nn/quant.py`) against the
JAX package's `nn/quant.py` on the CPU, on the same numpy-seeded weights and
inputs.

Bars:
  * `quantize_linear` / `quantize_estimator`: w_q and scale bit-equal, every
    other leaf untouched;
  * `linear_q`: the int8 activations equal, the output within rtol 1e-6;
  * the quantized estimator, linear by linear: each of its int8 linears fed
    the very input the JAX package's estimator handed the same linear
    (recorded by a spy on the JAX `linear_q`) gives equal int8 activations
    and an output within rtol 1e-6;
  * the quantized estimator whole (`n_blocks=1, num_mid_blocks=1`, as the
    JAX test uses): mean |port - JAX| / mean |JAX| <= 1e-2 on each route the
    CPU takes (kernel 1's plain version, "plain", banded, the streaming
    chunk rule), and the JAX test's own bar, < 0.1 against f32. The int8
    rounding makes the estimator chaotic at the 1e-3 level: the JAX package
    itself moves by up to 3.8e-3 when its input moves by one ulp, so a
    closer whole-estimator bar would hold no implementation that does not
    repeat XLA's f32 arithmetic bit for bit (ROADMAP.md section 3);
  * end to end: a tiny `Synthesizer.synthesize` with an int8 decoder
    against the JAX `Synthesizer` on the same tree, mel MAE < 1e-2
    (PARITY.md section 2.2), and `synthesize_batch` against it;
  * the bridge: strict both ways on w_q / scale, the round trip bit-equal,
    the reference export refusing an int8 tree.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu.models import estimator as jest
from jyutvoice_tpu.nn import quant as jq
from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu_torch import config as port_config
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.nn import core as pcore
from jyutvoice_tpu_torch.nn import quant as pq
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.weights import from_jax, torch_export
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EST_REL = 1e-2  # whole quantized estimator, port against JAX (see the docstring)
TO_F32_REL = 0.1  # tests/test_pallas_attention.py::test_int8_quantized_estimator_close_to_f32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.fixture(scope="module")
def trees():
    """(f32 estimator tree, its int8 tree from the JAX package), numpy."""
    cfg = jax_config.EstimatorConfig(n_blocks=1, num_mid_blocks=1)
    params = jest.init_estimator(jax.random.PRNGKey(0), cfg)
    return _np_tree(params), _np_tree(jq.quantize_estimator(params))


def _est(tree, **cfg):
    est = pest.Estimator(port_config.EstimatorConfig(n_blocks=1, num_mid_blocks=1, **cfg))
    return from_jax.load_jax_params(est, tree).eval()


def _inputs(seed, b=2, t=128, lengths=(128, 90)):
    rng = np.random.default_rng(seed)
    mask = (np.arange(t)[None, :] < np.array(lengths)[:, None]).astype(np.float32)[..., None]
    return [
        rng.standard_normal((b, t, 80)).astype(np.float32), mask,
        rng.standard_normal((b, t, 80)).astype(np.float32),
        rng.uniform(0.1, 0.9, b).astype(np.float32),
        rng.standard_normal((b, 80)).astype(np.float32),
        rng.standard_normal((b, t, 80)).astype(np.float32),
    ]


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.mark.parametrize("shape,bias,zero_col", [((64, 32), True, False),
                                                 ((256, 512), False, False),
                                                 ((1024, 256), True, True)])
def test_quantize_linear_bit_equal(shape, bias, zero_col):
    rng = np.random.default_rng(shape[0])
    p = {"w": rng.standard_normal(shape).astype(np.float32)}
    if zero_col:
        p["w"][:, 3] = 0.0  # the 1e-12 scale floor
    if bias:
        p["b"] = rng.standard_normal(shape[1]).astype(np.float32)
    want = _np_tree(jq.quantize_linear({k: jnp.asarray(v) for k, v in p.items()}))
    got = pq.quantize_linear(p)
    assert set(got) == set(want)
    assert got["w_q"].dtype == np.int8 and got["scale"].dtype == np.float32
    _same_tree(got, want)


def test_quantize_estimator_bit_equal(trees):
    f32, q = trees
    _same_tree(pq.quantize_estimator(f32), q)


@pytest.mark.parametrize("shape,scale", [((5, 64), 1.0), ((2, 150, 256), 4.0), ((300, 1024), 0.01)])
def test_linear_q_matches_jax(shape, scale):
    rng = np.random.default_rng(len(shape) + shape[-1])
    k = shape[-1]
    p = {"w": rng.standard_normal((k, 96)).astype(np.float32),
         "b": rng.standard_normal(96).astype(np.float32)}
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jp = jq.quantize_linear({n: jnp.asarray(v) for n, v in p.items()})
    want = np.asarray(jq.linear_q(jp, jnp.asarray(x)))
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    got = pq.linear_q(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1], 96)
    xf = jnp.asarray(x.reshape(-1, k))
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    jx_q = np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8))
    px_q, psx = pq.quantize_rows(torch.from_numpy(x.reshape(-1, k)))
    np.testing.assert_array_equal(px_q.numpy(), jx_q)
    np.testing.assert_array_equal(psx.numpy(), np.asarray(sx))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the module holds the transposed leaf and computes the same
    mod = pq.QuantLinear(k, 96)
    from_jax.load_jax_params(mod, _np_tree(jp))
    np.testing.assert_array_equal(mod(torch.from_numpy(x)).numpy(), got)


def test_quantized_estimator_linear_by_linear(trees, monkeypatch):
    """Teacher-forced: every int8 linear of the port's estimator, in call
    order, on the input the JAX estimator handed its own."""
    _, q = trees
    seen = []
    jax_linear_q = jq.linear_q

    def spy(p, x):
        y = jax_linear_q(p, x)
        seen.append((np.asarray(x), np.asarray(y)))
        return y

    monkeypatch.setattr(jq, "linear_q", spy)
    cfg = jax_config.EstimatorConfig(n_blocks=1, num_mid_blocks=1)
    jest.apply_estimator(jax.tree_util.tree_map(jnp.asarray, q), cfg,
                         *map(jnp.asarray, _inputs(3)))
    est = _est(q)
    linears = [m for m in est.modules() if isinstance(m, pq.QuantLinear)]
    assert len(linears) == len(seen) == 3 * 6  # 3 stages x (q, k, v, o, ff_in, ff_out)
    for i, (lin, (x, y)) in enumerate(zip(linears, seen)):
        xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
        x_q, _ = pq.quantize_rows(xt)
        xf = jnp.asarray(xt.numpy())
        sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
        np.testing.assert_array_equal(
            x_q.numpy(), np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127)).astype(np.int8),
            err_msg=f"linear {i}")
        with torch.no_grad():
            got = lin(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, y, rtol=1e-6, atol=0,
                                   err_msg=f"linear {i}")


def test_quantized_estimator_types(trees):
    f32, q = trees
    est = _est(q)
    for blk in [est.down.blocks[0], est.mid[0].blocks[0], est.up.blocks[0]]:
        for lin in (blk.ff_in, blk.ff_out, blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.o):
            assert type(lin) is pq.QuantLinear and lin.w_q.dtype == torch.int8
    assert type(est.time_mlp.linear1) is pcore.Linear
    assert type(est.down.resnet.mlp) is pcore.Linear
    # an int8 module takes no f32 tree (the bridge is strict)
    with pytest.raises(ValueError, match="do not match"):
        from_jax.load_jax_params(est, f32)
    assert not any(isinstance(m, pq.QuantLinear) for m in _est(f32).modules())


@pytest.mark.parametrize("route", ["flash", "plain", "banded", "streaming"])
def test_quantized_estimator_close_to_jax(trees, route):
    """Each route the CPU takes: kernel 1's plain version ("flash"), the f32
    "plain" scores, banded attention and kernel 1's streaming chunk rule."""
    f32, q = trees
    args = _inputs(4)
    jcfg = jax_config.EstimatorConfig(n_blocks=1, num_mid_blocks=1)
    kw, pkw = {}, {}
    if route == "banded":
        jcfg = dataclasses.replace(jcfg, attention_backend="banded")
        pkw["attention"] = "banded"
    if route == "streaming":
        kw["streaming"] = pkw["streaming"] = True
    want = np.asarray(jest.apply_estimator(jax.tree_util.tree_map(jnp.asarray, q), jcfg,
                                           *map(jnp.asarray, args), **kw))
    want32 = np.asarray(jest.apply_estimator(jax.tree_util.tree_map(jnp.asarray, f32), jcfg,
                                             *map(jnp.asarray, args), **kw))
    est, est32 = _est(q), _est(f32)
    if route == "plain":
        est = pest.with_attention_backend(est, "xla_scores")
        est32 = pest.with_attention_backend(est32, "xla_scores")
    with torch.no_grad():
        got = est(*map(torch.from_numpy, args), **pkw).numpy()
        got32 = est32(*map(torch.from_numpy, args), **pkw).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= EST_REL, _rel(got, want)
    assert _rel(got, got32) < TO_F32_REL
    assert _rel(want, want32) < TO_F32_REL


def test_quantized_linear_refuses_autograd():
    mod = pq.QuantLinear(16, 8)
    from_jax.load_jax_params(mod, pq.quantize_linear(
        {"w": np.ones((16, 8), np.float32), "b": np.zeros(8, np.float32)}))
    x = torch.ones(3, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        mod(x)
    with torch.no_grad():
        assert mod(x).shape == (3, 8)


def test_bridge_is_strict_on_int8_leaves(trees):
    _, q = trees
    est = _est(q)
    back = from_jax.jax_params_from_module(est)
    _same_tree(back, q)  # w_q stays int8, every leaf bit-equal

    def broken(fn):
        tree = jax.tree_util.tree_map(lambda a: a, q)
        fn(tree["mid"][0]["blocks"][0]["attn"]["q"])
        return tree

    fresh = pest.Estimator(port_config.EstimatorConfig(n_blocks=1, num_mid_blocks=1))
    with pytest.raises(ValueError, match="do not match"):
        from_jax.load_jax_params(fresh, broken(lambda leaf: leaf.pop("scale")))
    with pytest.raises(ValueError, match="does not fit"):
        from_jax.load_jax_params(fresh, broken(lambda leaf: leaf.update(scale=leaf["scale"][:-1])))
    with pytest.raises(ValueError, match="int8 leaf"):
        from_jax.load_jax_params(
            fresh, broken(lambda leaf: leaf.update(w_q=leaf["w_q"].astype(np.float32))))
    # w_q where the JAX package takes no int8 linear
    tree = jax.tree_util.tree_map(lambda a: a, q)
    tree["time_mlp"]["linear1"] = pq.quantize_linear(tree["time_mlp"]["linear1"])
    with pytest.raises(ValueError, match="do not match"):
        from_jax.load_jax_params(fresh, tree)
    # a leaf buffer the tree does not fill is named
    mod = pq.QuantLinear(16, 8, bias=False)
    with pytest.raises(ValueError, match="do not match"):
        from_jax.load_jax_params(mod, {"w_q": np.zeros((16, 8), np.int8)})


def test_reference_export_refuses_int8(trees):
    f32, q = trees
    assert torch_export.export_estimator(f32)
    with pytest.raises(ValueError, match="no int8 format"):
        torch_export.export_estimator(q)


@pytest.fixture(scope="module")
def int8_synths():
    tt, th = jax_trees()
    tq = {**tt, "decoder": jq.quantize_estimator(tt["decoder"])}
    port_tq = {**tt, "decoder": pq.quantize_estimator(_np_tree(tt["decoder"]))}
    return (JaxSynthesizer(JAX_CFG, tq, th), Synthesizer(PORT_CFG, port_tq, th, device="cpu"),
            Synthesizer(PORT_CFG, tt, th, device="cpu"))


def test_int8_synthesize_matches_jax(int8_synths):
    jax_s, port_s, port_f32 = int8_synths
    assert isinstance(port_s.tts.decoder.mid[0].blocks[0].ff_in, pq.QuantLinear)
    ref = jax_s.synthesize("佢係邊個", lang="yue", phone="keoi5 hai6 bin1 go3", n_timesteps=2)
    out = port_s.synthesize("佢係邊個", lang="yue", phone="keoi5 hai6 bin1 go3", n_timesteps=2)
    f32 = port_f32.synthesize("佢係邊個", lang="yue", phone="keoi5 hai6 bin1 go3",
                              n_timesteps=2)
    assert out.mel_frames == ref.mel_frames == f32.mel_frames
    assert np.abs(out.mel - ref.mel).mean() < 1e-2
    assert np.abs(out.mel - f32.mel).mean() / np.abs(f32.mel).mean() < TO_F32_REL
    batch = port_s.synthesize_batch(
        [{"text": "佢係邊個", "lang": "yue", "phone": "keoi5 hai6 bin1 go3"},
         {"text": "佢", "lang": "yue", "phone": "keoi5"}], n_timesteps=2)
    assert batch[0].mel_frames == ref.mel_frames
    assert np.abs(batch[0].mel - ref.mel).mean() < 1e-2
