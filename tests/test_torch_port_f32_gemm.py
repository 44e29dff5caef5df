"""The DiT's 3xTF32 linear (`jyutvoice_tpu_torch/nn/f32_gemm.py`) on the
CPU: the split of an f32 into tf32 hi and lo parts, the plain version's
accuracy against f64 at the DiT's widths, the prepared weight images (the
q/k/v concatenation, rebuilt when the weights change, dropped when the DiT
moves), and the kernel entry's refusals and routing. The kernel itself
runs on the card (`tests/test_torch_port_cuda.py`).

Bars: hi is the nearest tf32 to a (ties away from zero; a magnitude past
the largest finite tf32's rounding range takes that value) and lo the
nearest to a - hi, both keep 13 low mantissa bits zero, and |a - hi - lo|
<= 2^-22 |a| wherever lo is a normal number (|a| >= 2^-103), else at most
half tf32's subnormal spacing, 2^-137. The plain linear's largest and mean absolute errors against an f64
product are within 2x of the CPU's own f32 `F.linear` on the same inputs."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn import f32_gemm as fg
from torch_port_setup import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the DiT block's four GEMMs at the published widths: (K, N)
SHAPES = {"qkv": (1024, 3072), "o": (1024, 1024), "ff_in": (1024, 2048), "ff_out": (2048, 1024)}


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(22)
    if kind == "random":
        mag = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 4096))
        return (mag * rng.choice([-1, 1], 4096)).astype(np.float32)
    if kind == "ties":  # exactly halfway between two tf32 values
        bits = (rng.integers(0x00800000, 0x7F7F0000, 2048) & ~0x1FFF) | 0x1000
        v = _f32(bits)
        return np.concatenate([v, -v])
    if kind == "subnormal":
        bits = np.concatenate([[1, 2, 0x1000, 0x1FFF, 0x2000, 0x7FFFFF],
                               rng.integers(1, 0x800000, 1024)])
        v = _f32(bits)
        return np.concatenate([v, -v])
    # edges: zeros, powers of two over the whole range, the smallest normal,
    # the largest finite f32 and tf32, the split's clamp and its neighbours
    bits = [0x80000000, 0x00800000, 0x7F7FFFFF, 0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000, 0x7F7FDFFF]
    v = np.concatenate([[0.0], _f32(bits), np.ldexp(np.float32(1), np.arange(-149, 128))])
    v = v.astype(np.float32)
    return np.concatenate([v, -v])


def _nearest_tf32(a: np.ndarray) -> np.ndarray:
    """The oracle: the finite tf32 nearest to each finite a, ties away from
    zero, by comparing its two tf32 neighbours in f64."""
    mag = np.abs(a).astype(np.float32)
    low = _f32(mag.view(np.uint32) & np.uint32(0xFFFFE000))
    up_bits = (low.view(np.uint32) + np.uint32(0x2000)).astype(np.uint32)
    up = _f32(np.minimum(up_bits, 0x7F7FE000))  # no finite tf32 above the largest
    d_low = mag.astype(np.float64) - low.astype(np.float64)
    d_up = up.astype(np.float64) - mag.astype(np.float64)
    pick = np.where((d_up <= d_low) & (d_up >= 0), up, low)
    return np.copysign(pick, a).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "subnormal", "edges"])
def test_split_rounds_to_the_nearest_tf32(kind):
    a = _values(kind)
    hi, lo = (t.numpy() for t in fg.split_tf32(torch.from_numpy(a)))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _nearest_tf32(a))
    np.testing.assert_array_equal(lo, _nearest_tf32(a - hi))  # exact in f32
    assert np.isfinite(hi).all() and np.isfinite(lo).all()
    err = np.abs(a.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    big = np.abs(a) >= 2.0 ** -103
    assert (err[big] <= 2.0 ** -22 * np.abs(a[big].astype(np.float64))).all()
    assert (err[~big] <= 2.0 ** -137).all()
    if kind == "random":  # products of tf32 parts are exact in f32: at K = 1 the plain
        # linear is (lo hi_w + hi lo_w) + hi hi_w with one rounding at each sum
        w = torch.tensor([[1.0 + 2.0 ** -9 + 2.0 ** -20]])  # hi_w and lo_w both nonzero
        hw, lw = (float(v) for v in fg.prepare_weight(w)[:, 0, 0])
        h, lo64 = hi.astype(np.float64), lo.astype(np.float64)
        want = ((lo64 * hw + h * lw).astype(np.float32).astype(np.float64) + h * hw)
        got = fg.linear_plain(torch.from_numpy(a)[:, None], fg.prepare_weight(w))[:, 0]
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_split_of_infinities_and_nan():
    a = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = fg.split_tf32(a)
    assert torch.equal(hi[:2] + lo[:2], a[:2]) and torch.isnan(hi[2] + lo[2])


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_linear_is_f32_accurate(name):
    k, n = SHAPES[name]
    g = torch.Generator().manual_seed(len(name))
    x = torch.randn(64, k, generator=g)
    w = (torch.rand(n, k, generator=g) * 2 - 1) / k ** 0.5
    b = torch.randn(n, generator=g) * 0.1
    want = F.linear(x.double(), w.double(), b.double())
    got = fg.linear(x, fg.prepare_weight(w), b)
    lib = F.linear(x, w, b)
    err, err_lib = (got.double() - want).abs(), (lib.double() - want).abs()
    assert got.dtype == torch.float32 and got.shape == (64, n)
    assert float(err.max()) <= 2 * float(err_lib.max()), (float(err.max()), float(err_lib.max()))
    assert float(err.mean()) <= 2 * float(err_lib.mean())


def _linears(g, k, ns, bias=True):
    mods = []
    for n in ns:
        m = core.Linear(k, n, bias=bias)
        with torch.no_grad():
            m.weight.copy_(torch.randn(n, k, generator=g) / k ** 0.5)
            if bias:
                m.bias.copy_(torch.randn(n, generator=g))
        mods.append(m)
    return mods


def test_operands_concatenate_side_by_side_linears():
    g = torch.Generator().manual_seed(1)
    q, k, v = _linears(g, 64, (128, 128, 256))
    qkv = fg.Operands(q, k, v)
    images, bias = qkv.operands()
    w = torch.cat([q.weight, k.weight, v.weight])
    assert images.shape == (2, 512, 64) and images.is_contiguous()
    assert torch.equal(images, torch.stack(fg.split_tf32(w)))
    assert torch.equal(bias, torch.cat([q.bias, k.bias, v.bias]))
    x = torch.randn(3, 7, 64, generator=g)
    got = qkv(x)
    apart = torch.cat([fg.Operands(m)(x) for m in (q, k, v)], dim=-1)
    assert got.shape == (3, 7, 512)
    torch.testing.assert_close(got, apart, atol=1e-6, rtol=0)
    torch.testing.assert_close(got, F.linear(x, w, bias), atol=1e-5, rtol=0)
    (m,) = _linears(g, 64, (128,), bias=False)
    images, bias = fg.Operands(m).operands()
    assert bias is None
    assert ((images[0].double() + images[1].double() - m.weight.double()).abs()
            <= 2.0 ** -22 * m.weight.double().abs()).all()
    with pytest.raises(ValueError, match="every linear has a bias"):
        fg.Operands(q, m)


def test_operands_rebuild_only_when_a_weight_changes():
    g = torch.Generator().manual_seed(2)
    (m,) = _linears(g, 64, (128,))
    ops = fg.Operands(m)
    images, _ = ops.operands()
    assert ops.operands()[0] is images  # unchanged weights: the same images
    with torch.no_grad():
        m.weight.mul_(2.0)  # in place: the version counter moves
    again, _ = ops.operands()
    assert again is not images and torch.equal(again, fg.prepare_weight(m.weight))
    with torch.no_grad():
        m.bias.add_(1.0)
    assert torch.equal(ops.operands()[1], m.bias)
    m.weight.data = torch.randn(128, 64, generator=g)  # a new storage
    assert torch.equal(ops.operands()[0], fg.prepare_weight(m.weight))


def test_operands_drop_the_old_images_before_building_new_ones(monkeypatch):
    """A stale key frees the old images before the new ones are built (a
    reload never holds both), and `drop` forgets them until the next call."""
    g = torch.Generator().manual_seed(4)
    (m,) = _linears(g, 64, (128,))
    ops = fg.Operands(m)
    ops.operands()
    held = []
    prepare = fg.prepare_weight
    monkeypatch.setattr(fg, "prepare_weight", lambda w: held.append(ops.images) or prepare(w))
    with torch.no_grad():
        m.weight.add_(1.0)
    images, bias = ops.operands()
    assert held == [None] and torch.equal(images, prepare(m.weight))
    ops.drop()
    assert ops.images is None and ops.bias is None
    assert torch.equal(ops.operands()[1], m.bias) and len(held) == 2


def test_dit_builds_its_images_once_and_again_for_new_weights(monkeypatch):
    from jyutvoice_tpu_torch import config as C
    from jyutvoice_tpu_torch.models.dit import DiT
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    cfg = C.DiTConfig(dim=64, depth=2, heads=4, dim_head=16, conv_groups=4)
    route = C.EstimatorConfig()
    tree = random_init._dit(random_init._Init(0), cfg)
    dit = load_jax_params(DiT(cfg, route), tree).eval()
    built = []
    prepare = fg.prepare_weight
    monkeypatch.setattr(fg, "prepare_weight", lambda w: built.append(w.shape) or prepare(w))
    g = torch.Generator().manual_seed(3)
    b, t = 2, 24
    x, mu, cond = (torch.randn(b, t, 80, generator=g) for _ in range(3))
    args = (x, torch.ones(b, t, 1), mu, torch.rand(b, generator=g),
            torch.randn(b, 80, generator=g), cond)
    with torch.no_grad():
        first = dit(*args)
        assert built == [(3 * 64, 64), (64, 64), (128, 64), (64, 128)] * cfg.depth
        assert torch.equal(dit(*args), first) and len(built) == 4 * cfg.depth
        other = random_init._dit(random_init._Init(1), cfg)
        load_jax_params(dit, other)
        got = dit(*args)
        assert len(built) == 8 * cfg.depth
        want = load_jax_params(DiT(cfg, route), other).eval()(*args)
    assert torch.equal(got, want)


def test_moving_or_casting_the_dit_drops_its_images():
    """`to`, `float` and `cpu` free every block's weight images at once, so
    a module moved off the card leaves none behind; the next call builds
    them again where the weights are, with the same output."""
    from jyutvoice_tpu_torch import config as C
    from jyutvoice_tpu_torch.models.dit import DiT
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    cfg = C.DiTConfig(dim=64, depth=2, heads=4, dim_head=16, conv_groups=4)
    dit = load_jax_params(DiT(cfg, C.EstimatorConfig()),
                          random_init._dit(random_init._Init(0), cfg)).eval()
    gemms = [gm for blk in dit.blocks
             for gm in (blk.attn.qkv_gemm, blk.attn.o_gemm, blk.ff_in_gemm, blk.ff_out_gemm)]
    g = torch.Generator().manual_seed(5)
    b, t = 2, 16
    x, mu, cond = (torch.randn(b, t, 80, generator=g) for _ in range(3))
    args = (x, torch.ones(b, t, 1), mu, torch.rand(b, generator=g),
            torch.randn(b, 80, generator=g), cond)
    with torch.no_grad():
        first = dit(*args)
        assert len(gemms) == 4 * cfg.depth and all(gm.images is not None for gm in gemms)
        for move in (lambda d: d.to("cpu"), lambda d: d.float(), lambda d: d.cpu()):
            assert move(dit) is dit
            assert all(gm.images is None and gm.bias is None for gm in gemms)
            assert torch.equal(dit(*args), first)
            assert all(gm.images is not None for gm in gemms)


def _fake_cuda(k=64, n=128, *, rows=4, dtype=torch.float32, bias=True):
    x = torch.empty(rows, k, device="cuda", dtype=dtype)
    images = torch.empty(2, n, k, device="cuda")
    return x, images, torch.empty(n, device="cuda") if bias else None


@pytest.mark.parametrize("case,match", [
    (dict(k=48), "multiple of 32"),
    (dict(n=96), "multiple of 32 and N of 128"),
    (dict(dtype=torch.float64), "float32"),
], ids=["k", "n", "dtype"])
def test_kernel_entry_refuses_what_it_does_not_take(case, match):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x, images, bias = _fake_cuda(**case)
        with pytest.raises(ValueError, match=match):
            fg.f32_gemm(x, images, bias)


def test_kernel_entry_refuses_layouts_and_cpu_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with pytest.raises(ValueError, match="CUDA device"):
        fg.f32_gemm(torch.zeros(4, 64), torch.zeros(2, 128, 64))
    with FakeTensorMode():
        x, images, bias = _fake_cuda()
        with pytest.raises(ValueError, match="contiguous"):
            fg.f32_gemm(torch.empty(64, 4, device="cuda").t(), images, bias)
        with pytest.raises(ValueError, match=r"the bias must be \(128,\)"):
            fg.f32_gemm(x, images, torch.empty(64, device="cuda"))
        with pytest.raises(ValueError, match="images"):
            fg.f32_gemm(x, torch.empty(128, 64, device="cuda"), bias)


def test_linear_refuses_autograd():
    x = torch.zeros(2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fg.linear(x, torch.zeros(2, 128, 64))


def test_cuda_tensor_outside_a_trace_takes_the_kernel(monkeypatch):
    """The route is the device and the trace alone: a (fake) CUDA tensor
    used outside its mode goes to the kernel's entry; inside the mode the
    plain version is traced and no kernel library is loaded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernels.reset_launch_counts()
    libs = dict(kernels._LIBS)
    calls = []
    monkeypatch.setattr(fg, "f32_gemm", lambda *a: calls.append(a) or "kernel")
    mode = FakeTensorMode()
    with mode:
        x, images, bias = _fake_cuda(rows=6)
        y = fg.linear(x, images, bias)
        assert y.shape == (6, 128) and y.is_cuda
    assert not calls and kernels._LIBS == libs and not any(kernels.LAUNCHES.values())
    assert fg.linear(x, images, bias) == "kernel" and calls[0][0] is x
