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


# ---------------------------------------------------------------------------
# the int8 linear's kernels (csrc/int8_linear.cu): what the CPU can check
# ---------------------------------------------------------------------------


def _fake_cuda(k, n, *, x_dtype=torch.float32, w_dtype=torch.int8, rows=4, bias=True):
    """Fake CUDA tensors (no device needed) for the kernel entry's checks."""
    x = torch.empty(rows, k, dtype=x_dtype, device="cuda")
    w_q = torch.empty(n, k, dtype=w_dtype, device="cuda")
    scale = torch.empty(n, device="cuda")
    return x, w_q, scale, torch.empty(n, device="cuda") if bias else None


@pytest.mark.parametrize("case,match", [
    (dict(k=24, n=64), "inner size a multiple of 16"),
    (dict(k=1040, n=64), "inner size a multiple of 16 up to 1024"),
    (dict(k=256, n=12), "outer size a multiple of 8"),
    (dict(k=256, n=64, x_dtype=torch.float64), "must be float32"),
    (dict(k=256, n=64, x_dtype=torch.bfloat16), "must be float32"),
    (dict(k=256, n=64, w_dtype=torch.uint8), "w_q int8"),
])
def test_int8_kernel_entry_refuses_what_it_does_not_take(case, match):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from jyutvoice_tpu_torch import kernels

    kernels.reset_launch_counts()
    with FakeTensorMode():
        args = _fake_cuda(**case)
        with pytest.raises(ValueError, match=match):
            pq.int8_linear(*args)
    assert not any(kernels.LAUNCHES.values())


def test_int8_kernel_entry_refuses_layouts_and_cpu_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x, w_q, scale, bias = _fake_cuda(256, 512)
        with pytest.raises(ValueError, match="contiguous"):  # the JAX (in, out) leaf
            pq.int8_linear(x, torch.empty(256, 512, dtype=torch.int8, device="cuda").t(),
                           scale, bias)
        with pytest.raises(ValueError, match=r"\(512,\)"):
            pq.int8_linear(x, w_q, torch.empty(256, device="cuda"), bias)
        with pytest.raises(ValueError, match="one CUDA device"):
            pq.int8_linear(x, w_q, scale, torch.empty(512))
    with pytest.raises(ValueError, match="one CUDA device"):
        pq.int8_linear(torch.ones(4, 256), torch.ones(512, 256, dtype=torch.int8),
                       torch.ones(512), None)


def test_gemm_entry_takes_no_tile_argument():
    """No knob: one tile shape serves every (M, N), so the GEMM's C entry
    takes the operands, M, N, K and the stream, and the wrapper the tensors
    alone."""
    import ctypes
    import inspect
    import os
    import re

    from jyutvoice_tpu_torch import kernels

    assert list(inspect.signature(pq.int8_linear).parameters) == ["x", "w_q", "scale", "bias"]
    assert pq._GEMM_ARGTYPES == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with open(os.path.join(kernels.CSRC, "int8_linear.cu")) as f:
        src = f.read()
    sig = re.search(r'extern "C" int jv_int8_gemm\(([^)]*)\)', src).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params == ["xq", "w", "sx", "scale", "bias", "y", "M", "N", "K", "stream"]


def test_linear_q_hands_on_the_module_layout(monkeypatch):
    """`linear_q` gives `_linear_q` the contiguous (out, in) buffer a
    QuantLinear holds, whatever the layout of the JAX (in, out) leaf."""
    seen = []
    monkeypatch.setattr(pq, "_linear_q", lambda x, w_q, scale, bias: seen.append(w_q))
    leaf = torch.arange(256 * 96, dtype=torch.int32).remainder(255).sub(127).to(
        torch.int8).reshape(256, 96)
    for w in (leaf, leaf.t().contiguous().t()):
        pq.linear_q({"w_q": w, "scale": torch.ones(96)}, torch.zeros(3, 256))
    for w in seen:
        assert w.shape == (96, 256) and w.is_contiguous() and torch.equal(w, leaf.t())


def test_cuda_tensor_outside_a_trace_takes_the_kernels(monkeypatch):
    """The route is the device and the trace alone: a CUDA tensor (here a
    fake one used outside its mode, so no trace is active) goes to the
    kernels' wrapper, whatever its Python type; the same call inside the
    mode traces the plain composition."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []
    monkeypatch.setattr(pq, "int8_linear", lambda *a: calls.append(a) or "kernels")
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(2, 20, 256, device="cuda")
        w_q = torch.empty(512, 256, dtype=torch.int8, device="cuda")
        scale = torch.empty(512, device="cuda")
        assert pq._linear_q(x, w_q, scale, None).shape == (2, 20, 512)
    assert not calls
    assert type(x) is not torch.Tensor and x.is_cuda
    assert pq._linear_q(x, w_q, scale, None) == "kernels"
    assert len(calls) == 1 and calls[0][0] is x


def test_cpu_int8_linear_is_the_plain_composition_bit_for_bit(monkeypatch):
    """A CPU tensor takes torch._int_mm once a call and gives the parent's
    composition (quantize_rows, the int32 product, then acc * sx * scale +
    b in f32) bit for bit, on a (B, T, C) view whose rows are strided."""
    calls = []
    int_mm = torch._int_mm

    def spy(a, b):
        calls.append(a.shape)
        return int_mm(a, b)

    rng = np.random.default_rng(18)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in pq.quantize_linear(
        {"w": rng.standard_normal((256, 96)).astype(np.float32),
         "b": rng.standard_normal(96).astype(np.float32)}).items()}
    big = torch.from_numpy(rng.standard_normal((2, 37, 320)).astype(np.float32) * 3)
    x = big[:, :, :256]  # rows at a stride of 320
    x_q, sx = pq.quantize_rows(x.reshape(-1, 256))
    want = (int_mm(x_q, tp["w_q"]).float() * sx * tp["scale"] + tp["b"]).reshape(2, 37, 96)
    monkeypatch.setattr(torch, "_int_mm", spy)
    got = pq.linear_q(tp, x)
    mod = pq.QuantLinear(256, 96)
    from_jax.load_jax_params(mod, {k: v.numpy() for k, v in tp.items()})
    got_mod = mod(x)
    assert calls == [(74, 256), (74, 256)]
    assert torch.equal(got, want) and torch.equal(got_mod, want)


def test_rows_reads_strided_rows_in_place_and_copies_the_rest():
    big = torch.zeros(2, 5, 320)
    x2 = pq._rows(big[:, :, :256], 256)
    assert x2.shape == (10, 256) and x2.stride() == (320, 1)
    assert x2.data_ptr() == big.data_ptr()
    t = torch.zeros(2, 256, 5).transpose(1, 2)  # (B, T, C) of a (B, C, T): no row stride
    x2 = pq._rows(t, 256)
    assert x2.is_contiguous() and x2.data_ptr() != t.data_ptr()
    odd = torch.zeros(6, 258)[:, :256]  # a row stride off 4 floats (16 bytes)
    assert pq._rows(odd, 256).is_contiguous()


def test_traced_int8_linear_takes_the_plain_composition():
    """Fake CUDA tensors (a torch.export trace's) never reach the kernel
    library: `_linear_q` traces the plain composition."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from jyutvoice_tpu_torch import kernels

    kernels.reset_launch_counts()
    libs = dict(kernels._LIBS)
    with FakeTensorMode():
        x = torch.empty(2, 40, 256, device="cuda")
        w_q = torch.empty(512, 256, dtype=torch.int8, device="cuda")
        y = pq._linear_q(x, w_q, torch.empty(512, device="cuda"), None)
    assert y.shape == (2, 40, 512) and y.dtype == torch.float32 and y.is_cuda
    assert not any(kernels.LAUNCHES.values()) and kernels._LIBS == libs


def test_int8_kernel_source_is_listed():
    import os

    from jyutvoice_tpu_torch import kernels

    assert "int8_linear" in kernels.KERNEL_SOURCES
    assert kernels.KERNEL_NAMES[-2:] == ("int8_quant_rows", "int8_gemm")
    assert {"int8_quant_rows", "int8_gemm"} <= set(kernels.LAUNCHES)
    with open(os.path.join(kernels.CSRC, "int8_linear.cu")) as f:
        src = f.read()
    for entry in ("jv_int8_quant_rows", "jv_int8_gemm"):
        assert f'extern "C" int {entry}(' in src
