"""CosyVoice 3's DiT flow-matching estimator, behind JyutVoice's text half.

FunAudioLLM/CosyVoice `cosyvoice/flow/DiT/dit.py` and `modules.py` (adapted
from F5-TTS's DiT), at the widths of `config.DiTConfig`. It has the U-Net's
call, `(x, mask, mu, t, spks, cond) -> velocity`, all (B, T, 80), so
`models/cfm.py` solves with either. Over (B, T, D) frames:

  time:   temb = W2 SiLU(W1 [sin(1000 t f), cos(1000 t f)]), 256 features
  input:  h = Linear(cat[x, cond, mu, spks tiled over T]), 320 -> D
  conv position embedding (causal): h = h + P(h), P two grouped
          Conv1d(D, D, 31, groups=16), each left-padded 30 frames and
          followed by Mish; padded frames zeroed before and after P
  depth x block: (s1, c1, g1, s2, c2, g2) = chunk6(Linear(SiLU(temb)))
          h = h + g1 Attn(LN(h) (1 + c1) + s1)
          h = h + g2 FF(LN(h) (1 + c2) + s2)
  out:    (c, s) = chunk2(Linear(SiLU(temb))); v = Linear(LN(h) (1 + c) + s)

LN has no affine and eps 1e-6; FF is Linear(D, 2D), tanh GELU, Linear(2D,
D); Attn has biased q, k, v and out projections, x-transformers' RoPE
(interleaved pairs, base 1e4, dim_head wide) on the first `rope_heads`
heads of q and k, and softmax over each row's valid keys. The attention
core is the U-Net's (`nn/attention.py::attention_core`), routed by
`models/estimator.py::attention_route` on the U-Net's config (its backend
and band settings), so both estimators take kernel 1 and the same routes at
every length. All 22 blocks' modulations depend on temb alone and are made
before the first block.

The conv position embedding is the only operation outside attention that
mixes frames; it runs on the padded (B, T) frames. Where the mask holds
padding, the blocks then run on the valid frame rows alone, packed end to
end (`PackedRows`: one device-to-host read a call, the row index from the
mask): every block's norms, modulations, GEMMs, GELU and gated residuals
see N rows, not B T. Attention scatters the packed q/k/v rows into a
padded buffer zeroed once a call (padded rows stay 0), runs RoPE and
`attention_core` on it as the unpacked path does, and gathers the valid
rows of its output back; the velocity's padded frames are 0. Where the
mask holds no padding the blocks run on (B, T, D) as they are.

The blocks' four GEMMs (q/k/v as one, out, ff_in, ff_out) run in 3xTF32
on the tensor cores at f32 accuracy (`nn/f32_gemm.py`, a hand-written
kernel on CUDA, its plain version on the CPU), from hi and lo images of the
weights that each block builds at its first call (the q/k/v weights
concatenated there once) and again only after its weights change; moving
or casting the module (`to`, `cuda`, `cpu`) drops them at once. The adaLN,
input, time and output linears stay on `F.linear`.

Spans (`utils/observability.py`): `dit.embed` (time embedding, the
modulations, the input projection, the conv position embedding and the
packing), `dit.attn` and `dit.ff` (each block's two halves, norm to gated
residual). `ESTIMATOR_ROWS` counts the rows each call's blocks computed (N
when packed, B T otherwise) and its valid frame rows.

Inference only, on one device and without chunk masks: the streaming
chunk masks, training, the int8 path, the serving export and `dist/` run
the U-Net alone and refuse the DiT (here, and `config.require_unet` on
their entry points).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch.config import DiTConfig, EstimatorConfig
from jyutvoice_tpu_torch.models.estimator import (
    TimeMLP,
    attention_ctx,
    attention_route,
    sinusoidal_pos_emb,
)
from jyutvoice_tpu_torch.nn import core, f32_gemm
from jyutvoice_tpu_torch.nn.attention import apply_rope_pairs, attention_core, rope_pairs_cos_sin
from jyutvoice_tpu_torch.utils.observability import ESTIMATOR_ROWS, span

Tensor = torch.Tensor

LN_EPS = 1e-6


def modulate(x: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    """LN(x) (1 + scale) + shift; scale and shift broadcast against x's
    rows: (B, 1, D) against (B, T, D), (1, D) or (N, D) against packed
    (N, D)."""
    y = F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)
    return torch.addcmul(shift, y, 1.0 + scale)


class PackedRows:
    """The valid frame rows of one call, packed end to end: packed row i is
    frame `idx[i]` of the call's flattened (B T) frames, each request's
    frames contiguous and in order. `shared`: every row has the same t, so
    every request's modulation is row 0's and the rows take it by
    broadcast; else each row gathers its request's."""

    def __init__(self, valid: Tensor, n: int, b: int, t: int, shared: bool):
        """valid: the (B T,) validity of the frames, n how many are valid,
        known on the host: the index is built on the device."""
        slot = torch.where(valid, valid.cumsum(0) - 1, n)  # n: a padded frame's dump slot
        frames = torch.arange(valid.numel(), device=valid.device)
        self.idx = frames.new_zeros(n + 1).scatter_(0, slot, frames)[:n]
        self.b, self.t = b, t
        self.req = None if shared else self.idx // t
        self.qkv_buf = None

    def pack(self, y: Tensor) -> Tensor:
        """(B, T, C) -> the valid rows (N, C)."""
        return y.reshape(self.b * self.t, -1).index_select(0, self.idx)

    def unpack(self, y: Tensor, out: Tensor) -> Tensor:
        """(N, C) rows written into their frames of out (B T, C), the rest
        of out left as it is; viewed as (B, T, C)."""
        return out.index_copy_(0, self.idx, y).view(self.b, self.t, -1)

    def qkv(self, y: Tensor) -> Tensor:
        """The q/k/v GEMM's (N, 3 inner) rows as padded (B, T, 3 inner)
        frames, in one buffer zeroed once a call and reused by every block:
        no block writes a padded row, so they stay 0 (and finite)."""
        if self.qkv_buf is None:
            self.qkv_buf = y.new_zeros(self.b * self.t, y.shape[-1])
        return self.unpack(y, self.qkv_buf)

    def modulation(self, m: Tensor) -> Tensor:
        """A (B, C) per-request modulation for the packed rows: (1, C) or
        (N, C)."""
        return m[:1] if self.req is None else m.index_select(0, self.req)


class ConvPositionEmbedding(nn.Module):
    """CosyVoice's CausalConvPositionEmbedding: two grouped causal convs,
    each followed by Mish."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.groups = cfg.conv_groups
        cin = cfg.dim // cfg.conv_groups
        self.conv1 = core.Conv1d(cin, cfg.dim, cfg.conv_kernel)
        self.conv2 = core.Conv1d(cin, cfg.dim, cfg.conv_kernel)

    def causal(self, conv: core.Conv1d, x: Tensor) -> Tensor:
        """The causal grouped conv of (B, T, C) x, run as a 2-D conv whose
        input is x's own channels-last layout: cuDNN's grouped conv then
        takes it without the transposes of the (B, C, T) form (half the
        time at the DiT cell's shapes on the H100), with the same sums."""
        k = conv.weight.shape[-1]
        xp = F.pad(x, (0, 0, k - 1, 0)).permute(0, 2, 1).unsqueeze(2)  # (B, C, 1, T + k - 1)
        w = conv.weight.unsqueeze(2).contiguous(memory_format=torch.channels_last)
        return F.conv2d(xp, w, conv.bias, groups=self.groups).squeeze(2).permute(0, 2, 1)

    def forward(self, h: Tensor, mask: Tensor) -> Tensor:
        p = core.mish(self.causal(self.conv1, h * mask))
        return core.mish(self.causal(self.conv2, p)) * mask


class DiTAttention(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads, self.rope_heads = cfg.heads, cfg.rope_heads
        self.q = core.Linear(cfg.dim, inner)
        self.k = core.Linear(cfg.dim, inner)
        self.v = core.Linear(cfg.dim, inner)
        self.o = core.Linear(inner, cfg.dim)
        self.qkv_gemm = f32_gemm.Operands(self.q, self.k, self.v)
        self.o_gemm = f32_gemm.Operands(self.o)

    def rotate(self, x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        """RoPE on the first `rope_heads` heads of (B, T, H, D) x, in place."""
        n = self.rope_heads
        x[:, :, :n] = apply_rope_pairs(x[:, :, :n], cos, sin)
        return x

    def forward(self, x: Tensor, rope, ctx: dict, rows: PackedRows | None = None) -> Tensor:
        """x (B, T, D), or packed (N, D) rows of `rows`. q, k and v come
        from one GEMM over the three weights side by side (3.5 % faster than
        three at the DiT cell's shapes on the H100), as (B, T, H, D) views
        that kernel 1 takes as they are; packed rows reach them through the
        padded buffer of `PackedRows.qkv`, and only the valid rows of the
        attention reach the out GEMM."""
        qkv = self.qkv_gemm(x)
        if rows is not None:
            qkv = rows.qkv(qkv)
        b, t, _ = qkv.shape
        q, k, v = qkv.view(b, t, 3, self.heads, -1).unbind(2)
        q, k = self.rotate(q, *rope), self.rotate(k, *rope)
        o = attention_core(q, k, v, **ctx)
        return self.o_gemm(o if rows is None else rows.pack(o))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.ada = core.Linear(cfg.dim, 6 * cfg.dim)
        self.attn = DiTAttention(cfg)
        self.ff_in = core.Linear(cfg.dim, cfg.ff_mult * cfg.dim)
        self.ff_out = core.Linear(cfg.ff_mult * cfg.dim, cfg.dim)
        self.ff_in_gemm = f32_gemm.Operands(self.ff_in)
        self.ff_out_gemm = f32_gemm.Operands(self.ff_out)

    def _apply(self, fn, *args, **kwargs):
        """A move or cast of the block frees its GEMMs' weight images."""
        out = super()._apply(fn, *args, **kwargs)
        for gemm in (self.attn.qkv_gemm, self.attn.o_gemm, self.ff_in_gemm, self.ff_out_gemm):
            gemm.drop()
        return out

    def forward(self, h: Tensor, mod: Tensor, rope, ctx: dict,
                rows: PackedRows | None = None) -> Tensor:
        """h (B, T, D) with this block's (B, 1, 6 D) modulation, or the
        packed (N, D) rows of `rows` with a (1, 6 D) or (N, 6 D) one."""
        s1, c1, g1, s2, c2, g2 = mod.chunk(6, dim=-1)
        with span("dit.attn"):
            h = torch.addcmul(h, g1, self.attn(modulate(h, c1, s1), rope, ctx, rows))
        with span("dit.ff"):
            y = F.gelu(self.ff_in_gemm(modulate(h, c2, s2)), approximate="tanh")
            return torch.addcmul(h, g2, self.ff_out_gemm(y))


class DiT(nn.Module):
    """The estimator. `route` is the U-Net's config, whose attention
    backend and band settings route the attention."""

    def __init__(self, cfg: DiTConfig, route: EstimatorConfig):
        super().__init__()
        if cfg.dim % cfg.conv_groups or not 0 <= cfg.rope_heads <= cfg.heads:
            raise ValueError(f"a DiT of {cfg}: conv_groups must divide dim, and "
                             "rope_heads lie in [0, heads]")
        self.cfg, self.route = cfg, route
        self.time_mlp = TimeMLP(cfg.freq_embed_dim, cfg.dim)
        self.proj = core.Linear(cfg.in_dim, cfg.dim)
        self.conv_pos = ConvPositionEmbedding(cfg)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.ada_out = core.Linear(cfg.dim, 2 * cfg.dim)
        self.proj_out = core.Linear(cfg.dim, cfg.out_channels)

    def inputs(self, x: Tensor, mu: Tensor, spks: Tensor, cond: Tensor) -> Tensor:
        """cat[x, cond, mu, spks tiled over T]: CosyVoice's order, not the
        U-Net's [x, mu, spks, cond]."""
        b, t, _ = x.shape
        return torch.cat([x, cond, mu, spks[:, None, :].to(x.dtype).expand(b, t, -1)], dim=-1)

    def forward(
        self, x: Tensor, mask: Tensor, mu: Tensor, t: Tensor, spks: Tensor,
        cond: Tensor, streaming: bool = False, attention: str = "auto",
        training: bool = False,
    ) -> Tensor:
        """`Estimator.forward`'s call: x, mu, cond (B, T, 80); mask (B, T, 1)
        prefix mask of 0 and 1; t (B,); spks (B, 80); attention the
        long-form mode of `attention_route`. Returns the velocity (B, T,
        80), 0 on padded frames.

        The count of the mask's valid frames is the call's one read back
        to the host: copied out before the embedding is queued and waited
        for after, so the device runs the embedding while the host waits
        and never drains (a `nonzero` there, which drains the queue, left
        the H100 0.3-0.5 points more idle on the DiT cell). A mask with
        padding packs the blocks' rows (`PackedRows`); a t expanded from one
        value (`solve_euler_cfg`'s) shares one modulation among them."""
        if streaming or training:
            what = "training" if training else "streaming chunk masks"
            raise NotImplementedError(f"{what}: the U-Net estimator only; the DiT runs "
                                      "inference with full attention")
        cfg = self.cfg
        b, seq, _ = x.shape
        valid = mask.reshape(-1) != 0
        n_valid = valid.sum().to("cpu", non_blocking=True)
        counted = torch.cuda.Event() if valid.is_cuda else None
        if counted is not None:
            counted.record()
        with span("dit.embed"):
            temb = self.time_mlp(sinusoidal_pos_emb(t, cfg.freq_embed_dim).to(x.dtype))
            st = F.silu(temb)
            mods = [blk.ada(st) for blk in self.blocks]
            out_mod = self.ada_out(st)
            backend = attention_route(self.route, seq, 0, attention, x.is_cuda)
            ctx = attention_ctx(self.route, backend, mask, 0)
            del ctx["n_heads"]
            cos, sin = rope_pairs_cos_sin(seq, cfg.dim_head, device=x.device)
            rope = (cos[:, None], sin[:, None])  # against (B, T, H, D)
            h = self.proj(self.inputs(x, mu, spks, cond))
            h = h + self.conv_pos(h, mask)
            if counted is not None:
                counted.synchronize()
            n = int(n_valid)
            rows = None
            if n < b * seq:
                rows = PackedRows(valid, n, b, seq, shared=t.numel() == 1 or t.stride(0) == 0)
                h = rows.pack(h)
        ESTIMATOR_ROWS.add(n, mask)
        per_row = (lambda m: m[:, None, :]) if rows is None else rows.modulation
        for blk, mod in zip(self.blocks, mods):
            h = blk(h, per_row(mod), rope, ctx, rows)
        c, s = per_row(out_mod).chunk(2, dim=-1)
        v = self.proj_out(modulate(h, c, s))
        if rows is None:  # every frame valid
            return v
        return rows.unpack(v, v.new_zeros(b * seq, v.shape[-1]))
