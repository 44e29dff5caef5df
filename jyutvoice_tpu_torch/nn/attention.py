"""Attention: masked SDPA, partial-RoPE self-attention (text encoder) and the
plain diffusers-style attention of the CFM estimator.

The counterpart of the JAX package's `nn/attention.py`. All public functions
take and return channels-last (B, T, C); heads are split internally.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.flash_attention import flash_attention

Tensor = torch.Tensor


def sdpa(
    q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None,
    scale: Optional[float] = None,
) -> Tensor:
    """f32 scaled dot-product attention. q/k/v (B, H, T, D); bias additive,
    broadcastable to (B, H, Tq, Tk). Returns (B, H, Tq, D)."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
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


class RopeMHA(nn.Module):
    """glow-TTS self-attention with partial RoPE on q and k (rotary width
    head_dim // 2); q/k/v/o are biased linears."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.q = core.Linear(channels, channels)
        self.k = core.Linear(channels, channels)
        self.v = core.Linear(channels, channels)
        self.o = core.Linear(channels, out_channels)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor], n_heads: int) -> Tensor:
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
        out = sdpa(q, k, v, attn_bias, scale=1.0 / math.sqrt(head_dim))
        return self.o(merge_heads(out))


# ---------------------------------------------------------------------------
# Plain attention (CFM estimator)
# ---------------------------------------------------------------------------


class PlainMHA(nn.Module):
    """diffusers Attention: bias-free q/k/v, biased output projection. The
    core is kernel 1 (`flash_attention`) on CUDA, its plain version on CPU."""

    def __init__(self, query_dim: int, n_heads: int, head_dim: int):
        super().__init__()
        inner = n_heads * head_dim
        self.q = core.Linear(query_dim, inner, bias=False)
        self.k = core.Linear(query_dim, inner, bias=False)
        self.v = core.Linear(query_dim, inner, bias=False)
        self.o = core.Linear(inner, query_dim)

    def forward(
        self, x: Tensor, lengths: Tensor, n_heads: int, chunk_size: int = 0,
        num_left_chunks: int = -1,
    ) -> Tensor:
        """x (B, T, C); lengths (B,) int32 valid key lengths."""
        b, t, _ = x.shape
        # (B, T, H*D) projections viewed as (B, T, H, D): no head split copy
        q = self.q(x).view(b, t, n_heads, -1)
        k = self.k(x).view(b, t, n_heads, -1)
        v = self.v(x).view(b, t, n_heads, -1)
        out = flash_attention(
            q, k, v, lengths, scale=1.0 / math.sqrt(q.shape[-1]),
            chunk_size=chunk_size, num_left_chunks=num_left_chunks,
        )
        return self.o(out.view(b, t, -1))
