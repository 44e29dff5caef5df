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
from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
from jyutvoice_tpu_torch.nn.flash_stock import flash_stock
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
    assert kernels.LAUNCHES == {"flash_attention": 0, "resblock_stage": 0, "flash_stock": 0,
                                "flash_stock_bwd_dkv": 0, "flash_stock_bwd_dq": 0}
    assert not kernels._LIBS
