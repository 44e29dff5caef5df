"""CosyVoice 3's DiT estimator and its CFG Euler solve in plain PyTorch:
float32, one request (batch 1, no padding), no kernel. The port's DiT
(`jyutvoice_tpu_torch/models/dit.py`) is tested against it; it imports
neither package.

The published description: FunAudioLLM/CosyVoice `cosyvoice/flow/DiT/dit.py`
and `modules.py` (adapted from F5-TTS's DiT), at the widths of
Fun-CosyVoice3-0.5B's `cosyvoice3.yaml` (flow.decoder.estimator):

  temb = W2 SiLU(W1 [sin(1000 t f), cos(1000 t f)]), f_i = exp(-i ln 1e4 / (n - 1))
  h = Linear(cat[x, cond, mu, spks tiled over T])
  h = h + Mish(conv2(pad(Mish(conv1(pad(h)))))), grouped convs left-padded
      K - 1 frames (CausalConvPositionEmbedding)
  per block: (s1, c1, g1, s2, c2, g2) = chunk6(Linear(SiLU(temb)))
      h = h + g1 Attn(LN(h) (1 + c1) + s1)
      h = h + g2 FF(LN(h) (1 + c2) + s2)
  v = Linear(LN(h) (1 + c) + s), (c, s) = chunk2(Linear(SiLU(temb)))

with LN without affine at eps 1e-6, FF = Linear, tanh GELU, Linear, biased
q, k, v and out projections, and x-transformers' RoPE (interleaved pairs,
base 1e4, dim_head wide) on q and k.

Departures from it:
  * RoPE heads: CosyVoice's AttnProcessor rotates the projection before the
    heads are split, so only the first dim_head channels (head 0) turn.
    `rope_heads` of the widths says how many heads turn (1: that reading).
  * Initialisation: the published one zeroes the adaLN linears and
    proj_out, so a random model's velocity is zero; the tests draw them
    from torch's default Linear bounds.
  * Attention rounds where the port's configuration states it (kernel 1):
    q scaled in f32 then bf16, k and v bf16, the probabilities bf16 before
    P.V, f32 sums. Everything else is f32, with TF32 off.

Weights are trees in the port's JAX layout (`weights/random_init.py`): a
linear's "w" is (in, out), a grouped convolution's (K, in / groups, out);
numpy or torch leaves. `s` holds the widths as `DiTConfig` names them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Tensor = torch.Tensor


def tensors(tree, device="cpu"):
    """The same tree with float32 torch leaves on `device`."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def lin(p: Dict, x: Tensor) -> Tensor:
    return x @ p["w"] + p["b"]


def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


def layer_norm(x: Tensor) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-6)


def causal_grouped_conv(p: Dict, x: Tensor, groups: int) -> Tensor:
    """(B, T, C) -> (B, T, C'), left-padded K - 1 frames."""
    k = p["w"].shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), p["w"].permute(2, 1, 0), p["b"],
                 groups=groups)
    return y.transpose(1, 2)


def rope(x: Tensor, base: float = 10000.0) -> Tensor:
    """(..., T, d): pair (2i, 2i + 1) of frame p turned by p base^(-2i/d)."""
    t, d = x.shape[-2:]
    pos = torch.arange(t, dtype=torch.float32, device=x.device)
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    even, odd = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = odd * cos + even * sin
    return out


def attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """(B, H, T, D), every key valid, at kernel 1's rounding points."""
    bf = torch.bfloat16
    q = (q * (1.0 / math.sqrt(q.shape[-1]))).to(bf).float()
    scores = q @ k.to(bf).float().transpose(-1, -2)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return (p.to(bf).float() @ v.to(bf).float()) / p.sum(dim=-1, keepdim=True)


def time_embedding(p: Dict, t: Tensor, n: int) -> Tensor:
    half = n // 2
    f = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                  * -(math.log(10000.0) / (half - 1)))
    a = 1000.0 * t[:, None] * f[None, :]
    e = torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    return lin(p["linear2"], F.silu(lin(p["linear1"], e)))


def block(p: Dict, s: Dict, h: Tensor, st: Tensor) -> Tensor:
    """One DiT block over (B, T, D); st = SiLU(temb) (B, 1, D)."""
    b, t, _ = h.shape
    s1, c1, g1, s2, c2, g2 = lin(p["ada"], st).chunk(6, dim=-1)
    y = layer_norm(h) * (1.0 + c1) + s1
    a = p["attn"]
    q, k, v = (lin(a[n], y).reshape(b, t, s["heads"], s["dim_head"]).transpose(1, 2)
               for n in ("q", "k", "v"))
    n = s["rope_heads"]
    q = torch.cat([rope(q[:, :n]), q[:, n:]], dim=1)
    k = torch.cat([rope(k[:, :n]), k[:, n:]], dim=1)
    o = attention(q, k, v).transpose(1, 2).reshape(b, t, -1)
    h = h + g1 * lin(a["o"], o)
    y = layer_norm(h) * (1.0 + c2) + s2
    return h + g2 * lin(p["ff_out"], F.gelu(lin(p["ff_in"], y), approximate="tanh"))


def estimator(p: Dict, s: Dict, x: Tensor, mu: Tensor, t: Tensor, spks: Tensor,
              cond: Tensor) -> Tensor:
    """Velocity (B, T, 80) of (B, T, 80) inputs whose frames are all
    valid; t (B,), spks (B, 80)."""
    b, seq, _ = x.shape
    st = F.silu(time_embedding(p["time_mlp"], t, s["freq_embed_dim"]))[:, None, :]
    h = lin(p["proj"], torch.cat([x, cond, mu, spks[:, None, :].expand(b, seq, -1)], dim=-1))
    g = s["conv_groups"]
    cp = p["conv_pos"]
    h = h + mish(causal_grouped_conv(cp["conv2"], mish(causal_grouped_conv(cp["conv1"], h, g)), g))
    for bp in p["blocks"]:
        h = block(bp, s, h, st)
    c, sh = lin(p["ada_out"], st).chunk(2, dim=-1)
    return lin(p["proj_out"], layer_norm(h) * (1.0 + c) + sh)


def cfm_solve(p: Dict, s: Dict, mu: Tensor, c: Tensor, noise: Tensor, steps: int,
              cfg_rate: float = 0.7) -> Tensor:
    """The CFG Euler solve of one request on the cosine schedule: mu (1, T,
    80), c (1, 80), noise (1, >= T, 80); the unconditioned row has mu, the
    speaker and the condition at zero."""
    t_span = 1.0 - torch.cos(torch.linspace(0.0, 1.0, steps + 1, device=mu.device) * 0.5 * math.pi)
    x = noise[:, : mu.shape[1]].clone()
    zero = torch.zeros_like(mu)
    for i in range(steps):
        v = estimator(p, s, torch.cat([x, x]), torch.cat([mu, zero]),
                      t_span[i].reshape(1).expand(2), torch.cat([c, torch.zeros_like(c)]),
                      torch.cat([zero, zero]))
        x = x + (t_span[i + 1] - t_span[i]) * ((1.0 + cfg_rate) * v[:1] - cfg_rate * v[1:])
    return x
