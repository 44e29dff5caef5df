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
Attention is exact at every T: kernel 1 on CUDA, its plain version on CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from jyutvoice_tpu_torch.config import EstimatorConfig
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
        h = self.conv(x * mask, padding="causal")
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
        cond: Tensor, streaming: bool = False,
    ) -> Tensor:
        """x, mu, cond (B, T, 80); mask (B, T, 1) prefix mask; t (B,);
        spks (B, 80). Returns the velocity (B, T, 80)."""
        cfg = self.cfg
        b, seq, _ = x.shape
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, cfg.in_channels).to(x.dtype))
        spks_t = spks[:, None, :].to(x.dtype).expand(b, seq, spks.shape[-1])
        h = torch.cat([x, mu, spks_t, cond], dim=-1)
        attn_ctx = {
            "lengths": mask[:, :, 0].sum(dim=1).to(torch.int32),
            "n_heads": cfg.num_heads,
            "chunk_size": cfg.static_chunk_size if streaming else 0,
            "num_left_chunks": cfg.num_decoding_left_chunks,
        }
        h = self.down(h, mask, t_emb, attn_ctx)
        skip = h
        h = self.down_conv(h * mask, padding="causal")
        for mid in self.mid:
            h = mid(h, mask, t_emb, attn_ctx)
        h = torch.cat([h, skip], dim=-1)
        h = self.up(h, mask, t_emb, attn_ctx)
        h = self.up_conv(h * mask, padding="causal")
        h = self.final_block(h, mask)
        out = self.final_proj(h * mask, padding="valid")
        return out * mask
