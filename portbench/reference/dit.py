"""CosyVoice 3's DiT estimator in plain float32 PyTorch, one request at a
time, behind the reference's own text half and vocoder (`model.py`).

The published description: FunAudioLLM/CosyVoice `cosyvoice/flow/DiT/dit.py`
and `modules.py` (adapted from F5-TTS), at the widths of Fun-CosyVoice3-0.5B's
`cosyvoice3.yaml` (flow.decoder.estimator), inside the CFM that JyutVoice's
U-Net sits in. Over (B, T, D) frames, every frame valid:

  temb = W2 SiLU(W1 [sin(1000 t f), cos(1000 t f)]), f_i = exp(-i ln 1e4 / 127)
  h = Linear(cat[x, cond, mu, spks tiled over T])
  h = h + P(h), P = Mish(conv2(pad(Mish(conv1(pad(h)))))), grouped convs
      left-padded K - 1 frames (CosyVoice's CausalConvPositionEmbedding)
  per block: (s1, c1, g1, s2, c2, g2) = chunk6(Linear(SiLU(temb)))
      h = h + g1 Attn(LN(h) (1 + c1) + s1)
      h = h + g2 FF(LN(h) (1 + c2) + s2)
  v = Linear(LN(h) (1 + c) + s), (c, s) = chunk2(Linear(SiLU(temb)))

LN without affine, eps 1e-6; FF Linear, tanh GELU, Linear; q, k, v and out
biased; x-transformers' RoPE (interleaved pairs, base 1e4, dim_head wide)
on q and k.

Departures from the published description, and readings it leaves open:
  * RoPE heads: CosyVoice's AttnProcessor rotates the (B, T, heads x
    dim_head) projection before the heads are split, so only the first
    dim_head channels (head 0) turn. The configuration names its reading
    as `rope_heads` (1 is that one; `heads` turns every head) and lists
    the other under `assumed`.
  * Initialisation: the published one zeroes the adaLN linears and
    proj_out, which makes a random model's velocity zero; the trees here
    draw them from torch's default Linear bounds (`layout_dit.py`).
  * Precision: the configuration's own. The attention rounds as kernel 1
    does (`model.exact_attention`); everything else is f32 with TF32 off.
    `model.Numerics(tf32=True)` is the control one precision down.
  * Attention past the port's band threshold is the chunk band
    (`model.banded_attention`), as the port routes it; inference only,
    without chunk masks.

Trees are in the layout of `portbench/layout_dit.py`: a linear's "w" is
(in, out), a grouped convolution's (K, in / groups, out).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import model as ref

Tensor = torch.Tensor
LN_EPS = 1e-6


def rope_pairs(x: Tensor, base: float = 10000.0) -> Tensor:
    """x (..., T, d): turn the interleaved pairs (2i, 2i + 1) of frame p by
    p base^(-2i/d)."""
    t, d = x.shape[-2], x.shape[-1]
    theta = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * theta[None, :]
    ang = torch.repeat_interleave(ang, 2, dim=-1)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-x1, x0], dim=-1).flatten(-2)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def modulate(h: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    return F.layer_norm(h, (h.shape[-1],), eps=LN_EPS) * (1.0 + scale) + shift


def conv_pos(p: Dict, h: Tensor, groups: int) -> Tensor:
    """P(h): two grouped convs over (B, T, D), each left-padded K - 1
    frames and followed by Mish."""
    def cv(q, z):
        k = q["w"].shape[0]
        y = F.conv1d(F.pad(z.transpose(1, 2), (k - 1, 0)), q["w"].permute(2, 1, 0), q["b"],
                     groups=groups)
        return ref.mish(y.transpose(1, 2))

    return cv(p["conv2"], cv(p["conv1"], h))


def estimator(p: Dict, s: Dict, x, mu, t, spks, cond, num: ref.Numerics, band=None) -> Tensor:
    """The velocity over (B, T, 80) inputs whose T frames are all valid; t
    (B,), spks (B, 80); s the DiT's widths (the config's `tts.cfm.dit`).
    band: (chunk, left, right) for the banded attention, else exact."""
    if num.quant_bits:
        raise ValueError("the DiT has no int8 configuration")
    b, seq, _ = x.shape
    half = s["freq_embed_dim"] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = 1000.0 * t[:, None] * freqs[None, :]
    tm = p["time_mlp"]
    temb = ref.lin(tm["linear2"], F.silu(ref.lin(tm["linear1"],
                                                 torch.cat([ang.sin(), ang.cos()], -1))))
    st = F.silu(temb)[:, None, :]
    heads, rh = s["heads"], s["rope_heads"]
    h = ref.lin(p["proj"], torch.cat([x, cond, mu, spks[:, None, :].expand(b, seq, -1)], -1))
    h = h + conv_pos(p["conv_pos"], h, s["conv_groups"])
    for bp in p["blocks"]:
        s1, c1, g1, s2, c2, g2 = ref.lin(bp["ada"], st).chunk(6, dim=-1)
        a = bp["attn"]
        y = modulate(h, c1, s1)
        q, k, v = (ref.lin(a[n], y).reshape(b, seq, heads, -1).transpose(1, 2) for n in "qkv")
        q = torch.cat([rope_pairs(q[:, :rh]), q[:, rh:]], dim=1)
        k = torch.cat([rope_pairs(k[:, :rh]), k[:, rh:]], dim=1)
        o = ref.banded_attention(q, k, v, *band) if band else ref.exact_attention(q, k, v)
        h = h + g1 * ref.lin(a["o"], o.transpose(1, 2).reshape(b, seq, -1))
        y = F.gelu(ref.lin(bp["ff_in"], modulate(h, c2, s2)), approximate="tanh")
        h = h + g2 * ref.lin(bp["ff_out"], y)
    c, sh = ref.lin(p["ada_out"], st).chunk(2, dim=-1)
    return ref.lin(p["proj_out"], modulate(h, c, sh))


def cfm_solve(p: Dict, cfm: Dict, mu: Tensor, c: Tensor, noise: Tensor, steps: int,
              num: ref.Numerics, band=None) -> Tensor:
    """Euler steps on the cosine schedule with classifier-free guidance, as
    `model.cfm_solve`, over the DiT. mu (1, T, 80); c (1, 80); noise
    (1, >= T, 80)."""
    rate = cfm["inference_cfg_rate"]
    t_span = 1.0 - torch.cos(torch.linspace(0.0, 1.0, steps + 1, device=mu.device) * 0.5 * math.pi)
    x = noise[:, : mu.shape[1]].clone()
    zero = torch.zeros_like(mu)
    for i in range(steps):
        t = t_span[i].reshape(1).expand(2)
        v = estimator(p, cfm["dit"], torch.cat([x, x]), torch.cat([mu, zero]), t,
                      torch.cat([c, torch.zeros_like(c)]), torch.cat([zero, zero]), num, band)
        x = x + (t_span[i + 1] - t_span[i]) * ((1.0 + rate) * v[:1] - rate * v[1:])
    return x


def mel(tts: Dict, m: Dict, ids, spk: Tensor, frames: Tensor, noise: Tensor, steps: int,
        num: ref.Numerics, band=None) -> Tensor:
    """(1, sum(frames), 80) mel of one request, as `model.mel` with the DiT."""
    _, mu = ref.text_encoder(tts["encoder"], m["tts"]["encoder"], ids, spk)
    cum = torch.cumsum(frames.double(), 0)
    y_len = int(torch.clamp(cum[-1], min=1.0))
    tok = torch.searchsorted(cum, torch.arange(y_len, dtype=torch.float64, device=cum.device),
                             right=True)
    mu_y = mu[0, tok.clamp(max=mu.shape[1] - 1)][None]
    spk_n = spk / torch.clamp(spk.norm(dim=1, keepdim=True), min=1e-12)
    c = ref.lin(tts["spk_embed_affine_layer"], spk_n)
    return cfm_solve(tts["decoder"], m["tts"]["cfm"], mu_y, c, noise, steps, num, band)
