"""Attention: masked SDPA, partial-RoPE self-attention (text encoder), the
interleaved-pair RoPE of the DiT estimator, the plain diffusers-style
attention of the CFM estimator and its core by backend (`attention_core`,
which the DiT shares), the banded (chunk-local) attention of the long-form
gate and the ESPnet relative-position attention of the flow encoder, whole
or one chunk at a time over a KV cache (`rel_mha_chunk`).

The counterpart of the JAX package's `nn/attention.py`. The modules take and
return channels-last (B, T, C); heads are split internally.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
from jyutvoice_tpu_torch.nn.flash_stock import flash_stock

Tensor = torch.Tensor


def sdpa(
    q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None,
    scale: Optional[float] = None, prob_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """f32 scaled dot-product attention. q/k/v (B, H, T, D); bias additive,
    broadcastable to (B, H, Tq, Tk); `prob_dropout` drops attention
    probabilities with draws from `generator`. Returns (B, H, Tq, D)."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    probs = core.dropout(probs, prob_dropout, generator, False)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def split_heads(x: Tensor, n_heads: int) -> Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, n_heads, c // n_heads).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------------------
# Partial RoPE (text encoder)
# ---------------------------------------------------------------------------


def rope_cos_sin(t: int, d: int, base: float = 10_000.0, device=None):
    """cos/sin tables (T, d) for partial RoPE of even width d; rotation pairs
    are (i, i + d/2), theta_i = base^(-2i/d)."""
    theta = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    idx = torch.arange(t, dtype=torch.float32, device=device)[:, None] * theta[None, :]
    idx2 = torch.cat([idx, idx], dim=-1)
    return torch.cos(idx2), torch.sin(idx2)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor, d: int) -> Tensor:
    """Rotate the first d features of each head. x: (B, H, T, Dh)."""
    x_rope, x_pass = x[..., :d], x[..., d:]
    half = d // 2
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    x_rope = x_rope * cos + neg_half * sin
    return torch.cat([x_rope, x_pass], dim=-1)


def rope_pairs_cos_sin(t: int, d: int, base: float = 10_000.0, device=None):
    """cos/sin tables (T, d) of x-transformers' rotary layout (F5-TTS's and
    CosyVoice 3's DiT): interleaved pairs (2i, 2i + 1) turn by
    t * base^(-2i/d)."""
    theta = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * theta[None, :]
    ang = torch.repeat_interleave(ang, 2, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_pairs(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Turn the interleaved pairs of x's last dim, d = cos.shape[-1] wide:
    (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin). cos and sin broadcast
    against x."""
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).flatten(-2)
    return x * cos + rot * sin


class RopeMHA(nn.Module):
    """glow-TTS self-attention with partial RoPE on q and k (rotary width
    head_dim // 2); q/k/v/o are biased linears."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.q = core.Linear(channels, channels)
        self.k = core.Linear(channels, channels)
        self.v = core.Linear(channels, channels)
        self.o = core.Linear(channels, out_channels)

    def forward(
        self, x: Tensor, attn_bias: Optional[Tensor], n_heads: int,
        prob_dropout: float = 0.0, generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        b, t, c = x.shape
        head_dim = c // n_heads
        d_rope = int(head_dim * 0.5)
        if d_rope % 2:
            d_rope -= 1
        q = split_heads(self.q(x), n_heads)
        k = split_heads(self.k(x), n_heads)
        v = split_heads(self.v(x), n_heads)
        cos, sin = rope_cos_sin(t, d_rope, device=x.device)
        q = apply_rope(q, cos, sin, d_rope)
        k = apply_rope(k, cos, sin, d_rope)
        out = sdpa(q, k, v, attn_bias, scale=1.0 / math.sqrt(head_dim),
                   prob_dropout=prob_dropout, generator=generator)
        return self.o(merge_heads(out))


# ---------------------------------------------------------------------------
# Plain attention (CFM estimator)
# ---------------------------------------------------------------------------


def banded_sdpa(
    q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, *, chunk: int, left: int,
    right: int = 0, halo: bool = False, q_offset: int = 0,
) -> Tensor:
    """Banded (chunk-local) attention, linear in T. q/k/v (B, H, T, D);
    lengths (B,) valid key lengths. Returns (B, H, T, D).

    Query chunk c attends to key chunks [c - left, c + right], a window of
    w = (left + 1 + right) * chunk keys. The band is computed slab-wise from
    shifted views of the padded K/V, as in the JAX package: scores are
    (B, H, nc, chunk, w), never (B, H, T, T), and no banded K/V copy is
    made. Key validity comes from positions (window slots before the
    sequence or at/after the length get -1e10). A query chunk with no valid
    key comes out as a uniform average; the caller's mask zeroes it. Scores
    stay f32 on every device.

    Sequence parallel: q holds the frames from global position q_offset
    (a multiple of chunk) and halo=True means k and v already carry the
    left * chunk frames before them and right * chunk after (zeros outside
    the sequence) in place of the zero padding."""
    b, h, t, d = q.shape
    if t % chunk:
        raise ValueError(f"banded_sdpa: T={t} is not a multiple of chunk {chunk}")
    nc = t // chunk
    n_slabs = left + 1 + right
    w = n_slabs * chunk
    scale = 1.0 / math.sqrt(d)
    if halo:
        kp, vp = k, v
    else:
        pad = (0, 0, left * chunk, right * chunk)
        kp = torch.nn.functional.pad(k, pad)
        vp = torch.nn.functional.pad(v, pad)
    qc = q.reshape(b, h, nc, chunk, d)

    def slab(x: Tensor, j: int) -> Tensor:
        return x[:, :, j * chunk : j * chunk + t].reshape(b, h, nc, chunk, d)

    scores = torch.cat(
        [torch.matmul(qc, slab(kp, j).transpose(-1, -2)) for j in range(n_slabs)],
        dim=-1,
    ) * scale
    # absolute key position of window slot (c, wi) = c*chunk - left*chunk + wi
    pos = (
        torch.arange(nc, device=q.device)[:, None] * chunk + (q_offset - left * chunk)
        + torch.arange(w, device=q.device)[None, :]
    )
    keep = (pos >= 0)[None] & (pos[None] < lengths.to(pos.dtype)[:, None, None])
    scores = torch.where(keep[:, None, :, None, :], scores, -1e10)
    probs = torch.softmax(scores, dim=-1)
    out = sum(
        torch.matmul(probs[..., j * chunk : (j + 1) * chunk], slab(vp, j))
        for j in range(n_slabs)
    )
    return out.reshape(b, h, t, d)


def banded_core(
    q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, *, chunk: int, left: int,
    right: int = 0, shard=None,
) -> Tensor:
    """`banded_sdpa` on (B, T, H, D) projections -> (B, T, H*D). shard: this
    rank's `dist/sp.py::SeqShard` inside a sequence-parallel solve, whose
    neighbours supply the band's keys past the shard's edges."""
    offset = 0
    if shard is not None:
        kv = torch.stack([k, v])
        kv = torch.cat([shard.left_halo(kv, left * chunk, dim=2), kv,
                        shard.right_halo(kv, right * chunk, dim=2)], dim=2)
        k, v, offset = kv[0], kv[1], shard.offset
    out = banded_sdpa(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths,
        chunk=chunk, left=left, right=right, halo=shard is not None, q_offset=offset,
    )
    return merge_heads(out)


def attention_core(
    q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, backend: str = "flash",
    chunk_size: int = 0, num_left_chunks: int = -1, band=None,
    bias: Optional[Tensor] = None, shard=None, gather_kv=None, ring=None,
) -> Tensor:
    """The attention of (B, T, H, D) projections by `backend` (the
    arguments of `PlainMHA.forward`) -> (B, T, H*D) merged heads."""
    if backend == "banded":
        chunk, left, right = band
        return banded_core(q, k, v, lengths, chunk=chunk, left=left, right=right, shard=shard)
    b, t = q.shape[:2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if backend == "ring":
        from jyutvoice_tpu_torch.dist.ring import ring_attention_local

        comm, kv_valid = ring
        out = ring_attention_local(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), kv_valid, comm, scale)
        return merge_heads(out)
    if backend == "plain":
        if gather_kv is not None:
            k, v = gather_kv(k, v)
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias,
                   scale=scale)
        return merge_heads(out)
    if backend == "flash_stock":
        out = flash_stock(q, k, v, lengths, scale=scale)
    elif backend == "flash":
        out = flash_attention(
            q, k, v, lengths, scale=scale, chunk_size=chunk_size,
            num_left_chunks=num_left_chunks,
        )
    else:
        raise ValueError(f"unknown attention backend {backend!r}")
    return out.view(b, t, -1)


class PlainMHA(nn.Module):
    """diffusers Attention: bias-free q/k/v, biased output projection.

    The core is chosen by `backend`, as the estimator's dispatch decides:
    "flash" is kernel 1 (`flash_attention`, key padding and the streaming
    chunk rule), "flash_stock" is kernel 3 (`flash_stock`, segment ids from
    the lengths; differentiable through kernels 4 and 5), "banded" is
    `banded_core` and "plain" is `sdpa` with an additive mask bias, the
    counterpart of the JAX package's XLA `plain_mha`, which training takes
    where the stock-flash gate does not fire. The kernels run on CUDA
    tensors and their plain versions on CPU tensors.

    A tree that holds `w_q` for q, k, v or o (`nn/quant.py::
    quantize_estimator`) loads that projection as a `QuantLinear`."""

    QUANTIZABLE = ("q", "k", "v", "o")

    def __init__(self, query_dim: int, n_heads: int, head_dim: int):
        super().__init__()
        inner = n_heads * head_dim
        self.q = core.Linear(query_dim, inner, bias=False)
        self.k = core.Linear(query_dim, inner, bias=False)
        self.v = core.Linear(query_dim, inner, bias=False)
        self.o = core.Linear(inner, query_dim)

    def project(self, x: Tensor, n_heads: int):
        """(B, T, H*D) projections viewed as (B, T, H, D): no head split copy."""
        b, t, _ = x.shape
        return tuple(lin(x).view(b, t, n_heads, -1) for lin in (self.q, self.k, self.v))

    def forward(
        self, x: Tensor, lengths: Tensor, n_heads: int, backend: str = "flash",
        chunk_size: int = 0, num_left_chunks: int = -1, band=None,
        bias: Optional[Tensor] = None, shard=None, gather_kv=None, ring=None,
    ) -> Tensor:
        """x (B, T, C); lengths (B,) int32 valid key lengths; chunk_size and
        num_left_chunks are kernel 1's streaming rule, band the banded
        backend's (chunk, left, right), bias the plain backend's additive
        (B, 1, T, T) mask bias. Inside a sequence-parallel solve
        (`models/estimator.py::attention_ctx`): shard feeds the band its
        neighbours' keys, gather_kv gathers K and V along T for the plain
        route (bias (B, 1, T/n, T)), and ring is the "ring" backend's
        (collectives, (B, T/n) key mask)."""
        q, k, v = self.project(x, n_heads)
        return self.o(attention_core(
            q, k, v, lengths, backend, chunk_size=chunk_size, num_left_chunks=num_left_chunks,
            band=band, bias=bias, shard=shard, gather_kv=gather_kv, ring=ring))


# ---------------------------------------------------------------------------
# ESPnet relative-position attention (flow encoder)
# ---------------------------------------------------------------------------


def espnet_rel_pos_emb(t: int, d_model: int, device=None) -> Tensor:
    """(2T - 1, d_model) f32 relative positional encodings: row k encodes
    the relative distance T - 1 - k (sin on even features, cos on odd)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / d_model)
    )
    pe_pos = torch.zeros(t, d_model, device=device)
    pe_pos[:, 0::2] = torch.sin(pos * div)
    pe_pos[:, 1::2] = torch.cos(pos * div)
    pe_neg = torch.zeros(t, d_model, device=device)
    pe_neg[:, 0::2] = torch.sin(-pos * div)
    pe_neg[:, 1::2] = torch.cos(-pos * div)
    return torch.cat([torch.flip(pe_pos, dims=(0,)), pe_neg[1:]], dim=0)


def rel_shift_gather(matrix_bd: Tensor, t_q: int, t_k: int) -> Tensor:
    """(B, H, Tq, W) -> (B, H, Tq, Tk) relative-position shift,
    out[..., i, j] = in[..., i, Tq - 1 - i + j]: a flat reshape and one
    slice (row i's outputs are the contiguous run flat[i (W - 1) + Tq - 1 + j])
    while every row's band stays inside its own input row (Tk <= W - Tq + 1
    and Tk <= W - 1), else a gather."""
    b, h, tq, w = matrix_bd.shape
    assert tq == t_q
    if t_k > w - tq + 1 or t_k > w - 1:
        i = torch.arange(t_q, device=matrix_bd.device)[:, None]
        j = torch.arange(t_k, device=matrix_bd.device)[None, :]
        idx = ((t_q - 1) - i + j).expand(b, h, t_q, t_k)
        return torch.gather(matrix_bd, -1, idx)
    flat = matrix_bd.reshape(b, h, tq * w)[..., t_q - 1 : t_q - 1 + tq * (w - 1)]
    return flat.reshape(b, h, tq, w - 1)[..., :t_k]


class RelMHA(nn.Module):
    """Transformer-XL style relative-position self-attention (ESPnet
    RelPositionMultiHeadedAttention): biased q/k/v/o, a bias-free position
    projection `pos`, and the learned (H, D) biases pos_bias_u / pos_bias_v."""

    def __init__(self, n_feat: int, n_heads: int):
        super().__init__()
        d_k = n_feat // n_heads
        self.q = core.Linear(n_feat, n_feat)
        self.k = core.Linear(n_feat, n_feat)
        self.v = core.Linear(n_feat, n_feat)
        self.o = core.Linear(n_feat, n_feat)
        self.pos = core.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_heads, d_k), requires_grad=False)
        self.pos_bias_v = nn.Parameter(torch.empty(n_heads, d_k), requires_grad=False)

    def forward(self, x: Tensor, pos_emb: Tensor, attn_bias: Optional[Tensor],
                n_heads: int) -> Tensor:
        return rel_mha(self, x, pos_emb, attn_bias, n_heads)


def rel_mha(
    attn: RelMHA, x: Tensor, pos_emb: Tensor, attn_bias: Optional[Tensor], n_heads: int
) -> Tensor:
    """x (B, T, C), pos_emb (2T - 1, C), attn_bias additive, broadcastable to
    (B, H, T, T) -> (B, T, C)."""
    _, t, c = x.shape
    d_k = c // n_heads
    q = split_heads(attn.q(x), n_heads)  # (B, H, T, D)
    k = split_heads(attn.k(x), n_heads)
    v = split_heads(attn.v(x), n_heads)
    pm = split_heads(attn.pos(pos_emb[None]), n_heads)[0]  # (H, 2T - 1, D)
    q_u = q + attn.pos_bias_u[None, :, None, :]
    q_v = q + attn.pos_bias_v[None, :, None, :]
    matrix_ac = torch.einsum("bhqd,bhkd->bhqk", q_u, k)
    matrix_bd = torch.einsum("bhqd,hkd->bhqk", q_v, pm)  # (B, H, T, 2T - 1)
    matrix_bd = rel_shift_gather(matrix_bd, t, t)
    scores = (matrix_ac + matrix_bd) / math.sqrt(d_k)
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1)
    return attn.o(merge_heads(torch.einsum("bhqk,bhkd->bhqd", probs, v)))


def rel_mha_chunk(
    attn: RelMHA, x: Tensor, pos_band: Tensor, kv_cache: dict, offset: int,
    attn_bias: Optional[Tensor], n_heads: int,
) -> Tuple[Tensor, dict]:
    """Relative-position self-attention of one chunk over a fixed-capacity
    KV cache, the counterpart of the JAX package's `rel_mha_chunk`.

    x (B, c, C) is the chunk at absolute positions [offset, offset + c);
    pos_band (2 T_max - 1, C) = espnet_rel_pos_emb(T_max); kv_cache
    {"k", "v"}: (B, H, T_max, D), written in place at `offset` (a host int:
    the caller guarantees offset + c <= T_max, where the JAX package's
    dynamic_update_slice would clamp); attn_bias broadcastable to
    (B, H, c, T_max), masking keys at j >= offset + c. Returns
    (out (B, c, C), the cache).

    Query i sits at offset + i, so its distance to key j is offset + i - j;
    band column l encodes the distance T_max - 1 - l, so the (c, T_max)
    block starts at column T_max - c - offset, then the usual shift
    out[i, j] = band[i, (c - 1) - i + j]."""
    _, c_len, ch = x.shape
    d_k = ch // n_heads
    t_max = kv_cache["k"].shape[2]
    if not 0 <= offset <= t_max - c_len:
        raise ValueError(f"rel_mha_chunk: chunk [{offset}, {offset + c_len}) is past the "
                         f"cache capacity {t_max}")
    q = split_heads(attn.q(x), n_heads)  # (B, H, c, D)
    kv_cache["k"][:, :, offset : offset + c_len] = split_heads(attn.k(x), n_heads)
    kv_cache["v"][:, :, offset : offset + c_len] = split_heads(attn.v(x), n_heads)
    start = t_max - c_len - offset
    # only the band's columns are projected: the rest of bd is never read
    pm = split_heads(attn.pos(pos_band[None, start : start + t_max + c_len - 1]), n_heads)[0]
    q_u = q + attn.pos_bias_u[None, :, None, :]
    q_v = q + attn.pos_bias_v[None, :, None, :]
    matrix_ac = torch.einsum("bhqd,bhkd->bhqk", q_u, kv_cache["k"])  # (B, H, c, T_max)
    band = torch.einsum("bhqd,hkd->bhqk", q_v, pm)  # (B, H, c, T_max + c - 1)
    matrix_bd = rel_shift_gather(band, c_len, t_max)
    scores = (matrix_ac + matrix_bd) / math.sqrt(d_k)
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, kv_cache["v"])
    return attn.o(merge_heads(out)), kv_cache
