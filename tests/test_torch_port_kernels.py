"""The port's two kernels, through their plain versions on the CPU, against
the JAX package: the Pallas kernels in interpret mode and the XLA default
path each replaces.

Tolerances are the Pallas tests' own:
  * flash attention: atol 5e-3 / rtol 2e-2 on valid query rows (bf16 inputs
    to both products, f32 accumulation);
  * ResBlock stage: atol 2e-5 / rtol 1e-4 (f32 throughout).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jyutvoice_tpu.models.hift import apply_resblock, init_resblock
from jyutvoice_tpu.nn import core as jcore
from jyutvoice_tpu.nn.attention import sdpa
from jyutvoice_tpu.nn.pallas.attention import flash_attention as pallas_flash
from jyutvoice_tpu.nn.pallas.resblock import (
    fused_resblock_stage,
    pack_stage_weights as jax_pack,
)
from jyutvoice_tpu_torch.models.hift import ResBlock
from jyutvoice_tpu_torch.nn import f32_gemm
from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
from jyutvoice_tpu_torch.nn.flash_stock import flash_stock, flash_stock_bwd_prepare
from jyutvoice_tpu_torch.nn.quant import QuantLinear
from jyutvoice_tpu_torch.nn.resblock_stage import (
    chain_halo,
    pack_stage_weights,
    resblock_stage,
)
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

ATTN_TOL = dict(atol=5e-3, rtol=2e-2)
STAGE_TOL = dict(atol=2e-5, rtol=1e-4)
KS = (3, 7, 11)
DIL = (1, 3, 5)


def _qkv(bh, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, d)).astype(np.float32) for _ in range(3)]


def _jax_sdpa(q, k, v, lengths, scale, chunk, left):
    t = q.shape[1]
    pad = jcore.sequence_mask(jnp.asarray(lengths, jnp.int32), t)
    bias = jcore.mask_to_bias(jcore.chunk_attn_mask(pad, chunk, left))[:, None]
    out = sdpa(
        jnp.asarray(q)[:, None], jnp.asarray(k)[:, None], jnp.asarray(v)[:, None],
        bias, scale=scale,
    )
    return np.asarray(out[:, 0])


def _port_flash(q, k, v, lengths, scale, chunk, left):
    # (BH, T, D) -> the port's (B, T, H, D) with one head per row
    out = flash_attention(
        *(torch.from_numpy(a)[:, :, None, :] for a in (q, k, v)),
        torch.tensor(lengths, dtype=torch.int32),
        scale=scale, chunk_size=chunk, num_left_chunks=left,
    )
    return out[:, :, 0, :].numpy()


def _assert_valid_rows(out, ref, lengths, tol):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], **tol)


@pytest.mark.parametrize(
    "t,lengths,chunk,left",
    [
        (256, [256, 200], 0, -1),
        (256, [130, 256], 0, -1),
        (256, [256, 256], 50, -1),
        (512, [400, 512], 100, 2),
    ],
)
def test_flash_plain_matches_pallas_and_sdpa(t, lengths, chunk, left):
    d = 64
    q, k, v = _qkv(len(lengths), t, d)
    scale = 1.0 / np.sqrt(d)
    out = _port_flash(q, k, v, lengths, scale, chunk, left)
    pallas = np.asarray(pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32), scale=scale, chunk_size=chunk,
        num_left_chunks=left, interpret=True,
    ))
    _assert_valid_rows(out, pallas, lengths, ATTN_TOL)
    _assert_valid_rows(out, _jax_sdpa(q, k, v, lengths, scale, chunk, left),
                       lengths, ATTN_TOL)


@pytest.mark.parametrize("t,lengths,chunk", [(576, [576, 333], 0), (640, [600, 640], 50)])
def test_flash_plain_ragged_t_matches_sdpa(t, lengths, chunk):
    """Totals the Pallas kernel cannot take (T not a block multiple)."""
    d = 64
    q, k, v = _qkv(len(lengths), t, d, seed=1)
    scale = 1.0 / np.sqrt(d)
    out = _port_flash(q, k, v, lengths, scale, chunk, -1)
    _assert_valid_rows(out, _jax_sdpa(q, k, v, lengths, scale, chunk, -1),
                       lengths, ATTN_TOL)


def test_flash_plain_multihead_layout():
    """(B, T, H, D) with strided views equals the per-head (BH, T, D) form."""
    b, t, h, d = 2, 96, 4, 64
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d)).astype(np.float32))
    q, k, v = (qkv[..., i * h * d : (i + 1) * h * d].view(b, t, h, d) for i in range(3))
    lengths = [96, 50]
    out = flash_attention(q, k, v, torch.tensor(lengths, dtype=torch.int32), scale=0.125)
    assert out.is_contiguous() and out.shape == (b, t, h, d)
    for hh in range(h):
        ref = _jax_sdpa(*(a[:, :, hh].numpy() for a in (q, k, v)), lengths, 0.125, 0, -1)
        _assert_valid_rows(out[:, :, hh].numpy(), ref, lengths, ATTN_TOL)


def _branches(c, seed=0):
    key = jax.random.PRNGKey(seed)
    jax_br = [init_resblock(jax.random.fold_in(key, i), c, KS[i], DIL) for i in range(3)]
    # non-unit snake alphas so the alpha path is exercised
    rng = np.random.default_rng(seed)
    for br in jax_br:
        for name in ("alphas1", "alphas2"):
            br[name] = [jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32) for _ in DIL]
    port_br = [
        load_jax_params(ResBlock(c, KS[i], DIL), jax_br[i]) for i in range(3)
    ]
    return jax_br, port_br


@pytest.mark.parametrize("c,t", [(64, 700), (128, 512)])
def test_resblock_stage_plain_matches_pallas_and_xla(c, t):
    jax_br, port_br = _branches(c)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, t, c)) * 0.5).astype(np.float32)

    out = resblock_stage(
        torch.from_numpy(x), pack_stage_weights(port_br, DIL),
        kernel_sizes=KS, dilations=DIL,
    ).numpy()
    xla = sum(
        apply_resblock(jax_br[i], jnp.asarray(x), KS[i], DIL) for i in range(3)
    ) / 3.0
    np.testing.assert_allclose(out, np.asarray(xla), **STAGE_TOL)
    pallas = fused_resblock_stage(
        jnp.asarray(x[0]), jax_pack(jax_br, DIL), kernel_sizes=KS, dilations=DIL,
        block_t=256, interpret=True,
    )
    np.testing.assert_allclose(out[0], np.asarray(pallas), **STAGE_TOL)


def test_pack_matches_jax_layout():
    jax_br, port_br = _branches(16, seed=3)
    flat = np.concatenate([np.asarray(w).reshape(-1) for w in jax_pack(jax_br, DIL)])
    np.testing.assert_array_equal(pack_stage_weights(port_br, DIL).numpy(), flat)
    assert chain_halo(11, DIL) == 60 and chain_halo(3, DIL) == 12


def test_wrappers_take_plain_path_only_on_cpu():
    """A CPU tensor never touches the kernel library or the launch counts."""
    from jyutvoice_tpu_torch import kernels

    kernels.reset_launch_counts()
    q = torch.zeros(1, 8, 1, 64)
    flash_attention(q, q, q, torch.tensor([8], dtype=torch.int32), scale=0.125)
    _, port_br = _branches(16, seed=4)
    resblock_stage(torch.zeros(1, 10, 16), pack_stage_weights(port_br, DIL),
                   kernel_sizes=KS, dilations=DIL)
    flash_stock(q, q, q, torch.tensor([8], dtype=torch.int32), scale=0.125)
    qg = q.clone().requires_grad_()
    flash_stock(qg, q, q, torch.tensor([8], dtype=torch.int32), scale=0.125).sum().backward()
    q64 = torch.zeros(1, 64, 1, 64)  # the kernels' tile: T a multiple of 64
    flash_stock_bwd_prepare(q64, q64, q64, q64, torch.ones(1, 1, 64), torch.ones(1, 1, 64))
    QuantLinear(16, 8)(torch.ones(3, 16))  # the int8 linear's plain composition
    f32_gemm.linear(torch.ones(3, 32), torch.ones(2, 128, 32))  # the 3xTF32 linear's plain version
    assert kernels.LAUNCHES == {"flash_attention": 0, "resblock_stage": 0, "flash_stock": 0,
                                "flash_stock_bwd_dkv": 0, "flash_stock_bwd_dq": 0,
                                "flash_stock_bwd_prep": 0, "f32_gemm": 0, "int8_quant_rows": 0,
                                "int8_gemm": 0}
    assert not kernels._LIBS


# ---------------------------------------------------------------------------
# Kernel 2's weight layout and 3xTF32 arithmetic (plain PyTorch on the CPU)
# ---------------------------------------------------------------------------


def _unswizzle(prepared, c, kernel_sizes, n_steps):
    """Prepared tiles -> per conv, hi + lo in the JAX layout (k, Cin, Cout)."""
    from jyutvoice_tpu_torch.nn.resblock_stage import CHUNK_CHANNELS, pass_channels, swizzle_index

    nb, kp = pass_channels(c), max(c, CHUNK_CHANNELS)
    chunks = prepared.tiles.view(-1, 2, nb * CHUNK_CHANNELS)
    hi_lo = chunks[:, :, swizzle_index(nb)]  # the swizzle is its own inverse
    convs, off = [], 0
    for k in kernel_sizes:
        for _ in range(2 * n_steps):
            n = (c // nb) * k * (kp // CHUNK_CHANNELS)
            part = hi_lo[off : off + n].view(c // nb, k, kp // CHUNK_CHANNELS, 2, nb,
                                             CHUNK_CHANNELS)
            # (pass, tap, in group, hi/lo, out, in) -> (hi/lo, tap, in, out)
            w = part.permute(3, 1, 2, 5, 0, 4).reshape(2, k, kp, c)[:, :, :c]
            convs.append(w)
            off += n
    assert off == chunks.shape[0]
    return convs


@pytest.mark.parametrize("c", [128, 64, 16])
def test_prepared_stage_weights_round_trip_jax_layout(c):
    """hi + lo of every prepared weight is the JAX-layout weight within 2^-21
    relative; hi and lo are tf32 (low 13 bits zero); biases, alphas and the
    snake reciprocals are in the kernel's order."""
    from jyutvoice_tpu_torch.nn.resblock_stage import prepare_stage_weights, tiles_numel

    jax_br, _ = _branches(c, seed=5)
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(w).reshape(-1) for w in jax_pack(jax_br, DIL)]))
    prepared = prepare_stage_weights(flat, c, KS, DIL)
    assert prepared.tiles.numel() == tiles_numel(c, KS, len(DIL))
    bits = prepared.tiles.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    convs = _unswizzle(prepared, c, KS, len(DIL))
    params = prepared.params.view(-1, 6, c)
    i = 0
    for b, br in enumerate(jax_br):
        for j in range(len(DIL)):
            for half, (w, bias, alpha) in enumerate(
                    ((br["convs1"][j]["w"], br["convs1"][j]["b"], br["alphas1"][j]),
                     (br["convs2"][j]["w"], br["convs2"][j]["b"], br["alphas2"][j]))):
                hi, lo = convs[i]
                w = torch.from_numpy(np.array(w))
                assert hi.shape == w.shape
                rel = ((hi + lo) - w).abs() / w.abs().clamp_min(1e-30)
                assert float(rel.max()) <= 2.0 ** -21
                assert float((lo.abs() - (w - hi).abs()).abs().max()) <= float(
                    (w.abs() * 2.0 ** -21).max())
                row = params[b * len(DIL) + j, 3 * half : 3 * half + 3]
                alpha = torch.from_numpy(np.array(alpha))
                np.testing.assert_array_equal(row[0].numpy(), np.asarray(bias))
                np.testing.assert_array_equal(row[1].numpy(), alpha.numpy())
                np.testing.assert_array_equal(row[2].numpy(), (1.0 / (alpha + 1e-9)).numpy())
                i += 1


def _tf32_split_like_the_kernel(x):
    """The kernel's A-side split by bit arithmetic: hi rounded to the nearest
    tf32 (ties away from zero), lo = x - hi cut to tf32."""
    from jyutvoice_tpu_torch.nn.resblock_stage import tf32_round

    hi = tf32_round(x)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def test_tf32_round_is_round_to_nearest_ties_away():
    from jyutvoice_tpu_torch.nn.resblock_stage import tf32_round

    ulp = 2.0 ** -10  # tf32's spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + ulp * 0.75,
                      -(1.0 + ulp / 2), 3.0e-3, -7.5e4], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp)], dtype=torch.float32)
    np.testing.assert_array_equal(tf32_round(x)[:5].numpy(), want.numpy())
    rel = ((tf32_round(x) - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -11


def test_3xtf32_dilated_conv_emulation_meets_the_f32_bar():
    """One k=11, d=5 conv at C=128 in the kernel's arithmetic, emulated on
    the CPU: A split by bit arithmetic, the prepared weights' hi and lo, the
    three products lo.hi + hi.lo + hi.hi, against the f32 conv at the stage's
    bar (atol 2e-5 / rtol 1e-4); 1xTF32 (hi.hi alone) misses it."""
    import torch.nn.functional as F

    from jyutvoice_tpu_torch.nn.resblock_stage import tf32_round

    c, k, d, t = 128, 11, 5, 400
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(k * c)).astype(np.float32))
    conv = lambda a, b: F.conv1d(a, b, padding=(k * d - d) // 2, dilation=d)  # noqa: E731
    x_hi, x_lo = _tf32_split_like_the_kernel(x)
    w_hi = tf32_round(w)
    w_lo = tf32_round(w - w_hi)
    out = (conv(x_lo, w_hi) + conv(x_hi, w_lo)) + conv(x_hi, w_hi)
    ref = conv(x, w)
    exact = F.conv1d(x.double(), w.double(), padding=(k * d - d) // 2, dilation=d)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **STAGE_TOL)
    assert float((out.double() - exact).abs().max()) < 4 * float((ref.double() - exact).abs().max())
    one = conv(x_hi, w_hi)
    assert not np.allclose(one.numpy(), ref.numpy(), **STAGE_TOL)


def test_pick_tile_and_recompute_factor():
    """The longest tile on long grids; a shorter one where it fills the last
    wave of blocks; the recompute factor counts 64-row tiles and halos."""
    from jyutvoice_tpu_torch.nn.resblock_stage import (
        block_tile_rows,
        conv_rows,
        pick_tile,
        recompute_factor,
    )

    assert conv_rows(128, 11, DIL)[0] == (238, 1) and conv_rows(128, 11, DIL)[-1] == (128, 1)
    # k=3 at tile 128: convs of 150/148/142/140/130/128 rows -> 3,3,3,3,3,2 tiles of 64
    assert block_tile_rows(128, (3,), DIL) == 3 * 64 * 17
    assert pick_tile(84480, 7, KS, DIL, 248, 132) == 128  # 35 full waves: the longest
    tt = pick_tile(20480, 1, KS, DIL, 248, 132)  # 160 blocks of 128 would leave 104 SMs idle
    assert tt < 128 and -(-20480 // tt) <= 2 * 132
    with pytest.raises(ValueError, match="halo"):
        pick_tile(1000, 1, KS, (1, 3, 5, 7, 9), 248, 132)
    f = recompute_factor(84480, 7, 128, KS, DIL)
    assert 1.5 < f < 1.65
    assert recompute_factor(84480, 7, 64, KS, DIL) > f


def test_hift_stage_resblocks_prepares_once_and_matches():
    """HiFT's kernel-2 stages on the CPU give what the separate ResBlocks
    give (and exactly what the flat-weight call gave before), build their
    prepared weights once, and again only after a weight changes."""
    from jyutvoice_tpu_torch import config as port_config
    from jyutvoice_tpu_torch.models import hift as phift
    from jyutvoice_tpu_torch.weights import random_init

    cfg = port_config.HiFTConfig(base_channels=64)
    model = load_jax_params(phift.HiFT(cfg), random_init.init_hift_tree(cfg, seed=3)).eval()
    calls = []
    real = phift.prepare_stage_weights

    def counting(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)

    n = len(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    rng = np.random.default_rng(8)
    phift.prepare_stage_weights = counting
    try:
        for rep in range(2):
            for i in range(len(cfg.upsample_rates)):
                c = 64 // 2 ** (i + 1)
                x = torch.from_numpy(rng.standard_normal((2, 90, c)).astype(np.float32))
                branches = model.resblocks[i * n : (i + 1) * n]
                with torch.no_grad():
                    out = model.stage_resblocks(i, x)
                    flat = resblock_stage(x, pack_stage_weights(branches, dil),
                                          kernel_sizes=tuple(cfg.resblock_kernel_sizes),
                                          dilations=dil)
                    sep = sum(br(x) for br in branches) / n
                np.testing.assert_array_equal(out.numpy(), flat.numpy())
                np.testing.assert_allclose(out.numpy(), sep.numpy(), **STAGE_TOL)
        assert calls == [32, 16, 8]  # once per stage over both rounds
        with torch.no_grad():
            model.resblocks[0].convs1[0].bias.add_(1.0)
            again = model.stage_resblocks(0, x.new_ones(1, 50, 32))
        assert calls == [32, 16, 8, 32]
        with torch.no_grad():
            assert torch.equal(model.stage_resblocks(0, x.new_ones(1, 50, 32)), again)
        assert calls == [32, 16, 8, 32]
    finally:
        phift.prepare_stage_weights = real
