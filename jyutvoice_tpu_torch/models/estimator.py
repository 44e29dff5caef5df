"""Causal CFM estimator U-Net: the velocity field of the flow-matching decoder.

The counterpart of the JAX package's `models/estimator.py`, default path. With
one channel level the network never changes temporal resolution, so it is a
flat pipeline over (B, T, C):

  pack [x, mu, spks, cond] -> 320 channels
  down:  resnet -> 4 transformer blocks -> causal conv
  mid:   12 x (resnet -> 4 transformer blocks)
  up:    skip-concat -> resnet -> 4 transformer blocks -> causal conv
  final: causal block -> 1x1 proj -> 80 channels

Each transformer block: LN -> attention (8 heads x 64) -> LN -> GELU FF (x4).

Attention is chosen once per call, in the JAX package's order
(`attention_route`): an explicit "banded" backend (the config's, or the
per-call mode) on any device; the "xla_scores" backend, f32 scores with an
additive bias built from the mask itself ("plain"), which a front-padded
mask needs (a prompted streaming segment masks rows [0, p_start)); then,
for CUDA tensors only, the long-form banded gate (`use_banded`) and the
stock-flash gate (`use_stock_flash`, kernel 3); otherwise exact attention
through kernel 1, which takes each row's valid keys as a length (a prefix
mask). The JAX package takes the two gates only on its accelerator, so on
the CPU both packages compute exact attention and the parity tests compare
like with like.

Training (`training=True`, from `cfm_loss`) applies the JAX package's
rewrite for the loss: no banded attention of either kind, the stock-flash
gate kept. So a training call takes kernel 3 with its backward (kernels 4
and 5) on CUDA tensors at 512-aligned T >= 2048, and otherwise "plain"
attention (`sdpa` with the key-padding bias, f32), the counterpart of the
JAX package's XLA `plain_mha`, which it trains with at those lengths.

Sequence parallel (`dist/sp.py`): inside a sharded solve the call sees this
rank's T/n frames and `current_shard()` names its place; the causal
convolutions take the frames before the shard from the left neighbours
(`causal_conv`), the lengths and key mask are the whole sequence's, and the
"plain", "banded" and "ring" routes read the other shards' keys as each
needs them (`attention_ctx`).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from jyutvoice_tpu_torch.config import EstimatorConfig
from jyutvoice_tpu_torch.dist.ring import get_ring_context
from jyutvoice_tpu_torch.dist.sp import current_shard
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.attention import PlainMHA

Tensor = torch.Tensor


def sinusoidal_pos_emb(t: Tensor, dim: int, scale: float = 1000.0) -> Tensor:
    """(B,) -> (B, dim)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def use_banded(t: int, chunk: int, cfg: EstimatorConfig) -> bool:
    """Long-form banded gate: full attention, 128-aligned T at or past
    `banded_long_threshold` (0 disables it)."""
    return (
        chunk == 0
        and cfg.banded_long_threshold > 0
        and t >= cfg.banded_long_threshold
        and t % cfg.banded_chunk == 0
    )


def use_stock_flash(t: int, chunk: int) -> bool:
    """Long-form stock-flash gate: full attention, T >= 2048 and a multiple
    of the 512 block."""
    return chunk == 0 and t >= 2048 and _flash_block(t) > 0


def _flash_block(t: int) -> int:
    """The stock-flash block for T: 512, or 0 when T is not a multiple."""
    return 512 if t % 512 == 0 else 0


ATTENTION_MODES = ("auto", "banded", "exact")


def attention_route(
    cfg: EstimatorConfig, t: int, chunk: int, attention: str = "auto",
    on_cuda: bool = True, training: bool = False,
) -> str:
    """The attention backend of one estimator call: "banded", "flash_stock"
    (kernel 3), "flash" (kernel 1), "ring" (the config's
    attention_backend="ring", set by `dist/sp.py::sp_cfm_solve`) or "plain"
    (in training, and for attention_backend="xla_scores" at inference).

    `attention` is the per-call long-form mode: "banded" acts as the
    config's attention_backend="banded", "exact" as banded_long_threshold=0
    (the stock-flash gate stays), "auto" keeps the config. `training` is
    the loss's rewrite (`cfm.py::cfm_loss` in the JAX package): an explicit
    banded backend becomes "xla" and the banded gate is off, so only the
    stock-flash gate remains (on CUDA, for "xla"); every other case is
    "plain", since kernel 1 has no backward."""
    if attention not in ATTENTION_MODES:
        raise ValueError(
            f"unknown long-form attention {attention!r} "
            "(use 'auto', 'banded' or 'exact')"
        )
    if training:
        backend = cfg.attention_backend
        if on_cuda and backend in ("xla", "banded") and use_stock_flash(t, chunk):
            return "flash_stock"
        return "plain"
    if attention == "exact":
        cfg = dataclasses.replace(cfg, banded_long_threshold=0)
    if cfg.attention_backend == "ring":
        if chunk != 0:
            raise ValueError(
                "attention='ring' does not support streaming chunk masks; "
                "use attention='scores' for the chunk-masked solve"
            )
        return "ring"
    if attention == "banded" or cfg.attention_backend == "banded":
        if chunk != 0:
            raise ValueError("the banded backend is for full (non-streaming) attention")
        if t % cfg.banded_chunk:
            raise ValueError(f"banded attention needs T % {cfg.banded_chunk} == 0, got T={t}")
        return "banded"
    if cfg.attention_backend == "xla_scores":
        return "plain"
    if on_cuda and cfg.attention_backend == "xla":
        if use_banded(t, chunk, cfg):
            return "banded"
        if use_stock_flash(t, chunk):
            return "flash_stock"
    return "flash"


def with_config(est: "Estimator", cfg: EstimatorConfig) -> "Estimator":
    """A view of `est` that runs with another config of the same shapes (an
    attention backend, a band geometry): it shares every parameter and
    buffer with `est`."""
    view = copy.copy(est)
    view.cfg = cfg
    return view


def with_attention_backend(est: "Estimator", backend: str) -> "Estimator":
    """A view of `est` whose config names another attention backend."""
    return with_config(est, dataclasses.replace(est.cfg, attention_backend=backend))


def causal_conv(conv, x: Tensor) -> Tensor:
    """A causal convolution of (B, T, C) frames: zeros before the first
    frame on one device, the frames of the ranks to the left inside a
    sequence-parallel solve."""
    shard = current_shard()
    if shard is None:
        return conv(x, padding="causal")
    k = conv.weight.shape[-1]
    return conv(torch.cat([shard.left_halo(x, k - 1), x], dim=1), padding="valid")


def attention_ctx(cfg: EstimatorConfig, backend: str, mask: Tensor, chunk: int) -> dict:
    """The per-call attention arguments of `PlainMHA.forward` for `backend`,
    from the (B, T, 1) mask: lengths, kernel 1's chunk rule, the band, the
    plain route's bias; inside a sequence-parallel solve also the gathers
    that reach the other shards' keys."""
    shard = current_shard()
    lengths = mask[:, :, 0].sum(dim=1)
    if shard is not None:
        lengths = shard.sum(lengths)
    ctx = {"lengths": lengths.to(torch.int32), "n_heads": cfg.num_heads, "backend": backend}
    if backend == "flash":
        ctx.update(chunk_size=chunk, num_left_chunks=cfg.num_decoding_left_chunks)
    elif backend == "banded":
        ctx["band"] = (cfg.banded_chunk, cfg.banded_left, cfg.banded_right)
        ctx["shard"] = shard
    elif backend == "plain":
        if shard is None:
            keep = core.chunk_attn_mask(mask[:, :, 0] > 0, chunk, cfg.num_decoding_left_chunks)
        else:
            keep = shard.query_rows(core.chunk_attn_mask(
                shard.key_mask(mask[:, :, 0]), chunk, cfg.num_decoding_left_chunks))
            ctx["gather_kv"] = shard.gather_kv
        ctx["bias"] = core.mask_to_bias(keep)[:, None]
    elif backend == "ring":
        ring_mesh, ring_axis = get_ring_context()
        ctx["ring"] = (ring_mesh.comm(ring_axis), mask[:, :, 0])
    return ctx


class TimeMLP(nn.Module):
    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear1 = core.Linear(in_dim, embed_dim)
        self.linear2 = core.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: Tensor) -> Tensor:
        return self.linear2(core.silu(self.linear1(t_emb)))


class CausalBlock(nn.Module):
    """CausalConv1d(k=3) -> LayerNorm -> Mish, masked."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = core.Conv1d(dim, dim_out, 3)
        self.norm = core.LayerNorm(dim_out)

    def forward(self, x: Tensor, mask: Tensor) -> Tensor:
        h = causal_conv(self.conv, x * mask)
        return core.mish(self.norm(h)) * mask


class CausalResnet(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int):
        super().__init__()
        self.mlp = core.Linear(time_emb_dim, dim_out)
        self.block1 = CausalBlock(dim, dim_out)
        self.block2 = CausalBlock(dim_out, dim_out)
        self.res_conv = core.Conv1d(dim, dim_out, 1)

    def forward(self, x: Tensor, mask: Tensor, t: Tensor) -> Tensor:
        h = self.block1(x, mask)
        h = h + self.mlp(core.mish(t))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask, padding="valid")


class TransformerBlock(nn.Module):
    QUANTIZABLE = ("ff_in", "ff_out")  # int8 where the tree holds w_q (nn/quant.py)

    def __init__(self, dim: int, n_heads: int, head_dim: int, ff_mult: int = 4):
        super().__init__()
        self.norm1 = core.LayerNorm(dim)
        self.attn = PlainMHA(dim, n_heads, head_dim)
        self.norm3 = core.LayerNorm(dim)
        self.ff_in = core.Linear(dim, dim * ff_mult)
        self.ff_out = core.Linear(dim * ff_mult, dim)

    def forward(self, x: Tensor, attn_ctx: dict) -> Tensor:
        x = x + self.attn(self.norm1(x), **attn_ctx)
        h = core.gelu_torch(self.ff_in(self.norm3(x)))
        return x + self.ff_out(h)


class Stage(nn.Module):
    def __init__(self, in_dim: int, cfg: EstimatorConfig):
        super().__init__()
        ch = cfg.channels[0]
        self.resnet = CausalResnet(in_dim, ch, cfg.time_embed_dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(ch, cfg.num_heads, cfg.attention_head_dim)
            for _ in range(cfg.n_blocks)
        )

    def forward(self, x: Tensor, mask: Tensor, t: Tensor, attn_ctx: dict) -> Tensor:
        x = self.resnet(x, mask, t)
        for blk in self.blocks:
            x = blk(x, attn_ctx)
        return x


class Estimator(nn.Module):
    def __init__(self, cfg: EstimatorConfig):
        super().__init__()
        if len(cfg.channels) != 1:
            raise ValueError("the estimator is a flat U-Net with one channel level")
        self.cfg = cfg
        ch = cfg.channels[0]
        self.time_mlp = TimeMLP(cfg.in_channels, cfg.time_embed_dim)
        self.down = Stage(cfg.in_channels, cfg)
        self.down_conv = core.Conv1d(ch, ch, 3)
        self.mid = nn.ModuleList(Stage(ch, cfg) for _ in range(cfg.num_mid_blocks))
        self.up = Stage(ch * 2, cfg)
        self.up_conv = core.Conv1d(ch, ch, 3)
        self.final_block = CausalBlock(ch, ch)
        self.final_proj = core.Conv1d(ch, cfg.out_channels, 1)

    def forward(
        self, x: Tensor, mask: Tensor, mu: Tensor, t: Tensor, spks: Tensor,
        cond: Tensor, streaming: bool = False, attention: str = "auto",
        training: bool = False,
    ) -> Tensor:
        """x, mu, cond (B, T, 80); mask (B, T, 1) prefix mask; t (B,);
        spks (B, 80); attention the long-form mode of `attention_route`,
        training its loss rewrite. Returns the velocity (B, T, 80)."""
        cfg = self.cfg
        b, seq, _ = x.shape
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, cfg.in_channels).to(x.dtype))
        spks_t = spks[:, None, :].to(x.dtype).expand(b, seq, spks.shape[-1])
        h = torch.cat([x, mu, spks_t, cond], dim=-1)
        chunk = cfg.static_chunk_size if streaming else 0
        shard = current_shard()
        t_all = seq if shard is None else shard.t
        backend = attention_route(cfg, t_all, chunk, attention, x.is_cuda, training)
        attn_ctx = attention_ctx(cfg, backend, mask, chunk)
        h = self.down(h, mask, t_emb, attn_ctx)
        skip = h
        h = causal_conv(self.down_conv, h * mask)
        for mid in self.mid:
            h = mid(h, mask, t_emb, attn_ctx)
        h = torch.cat([h, skip], dim=-1)
        h = self.up(h, mask, t_emb, attn_ctx)
        h = causal_conv(self.up_conv, h * mask)
        h = self.final_block(h, mask)
        out = self.final_proj(h * mask, padding="valid")
        return out * mask
