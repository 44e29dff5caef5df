"""The model in plain float32 PyTorch, one request at a time.

Trees are in the layout of `portbench/layout.py`: a linear's "w" is
(in, out), a convolution's (K, in, out). Activations are (B, T, C). The
reference follows the model's published equations and the rounding points
that its configuration states: kernel 1's attention rounds q (scaled), k, v
and the probabilities to bf16 and sums in f32; everything else is f32 with
TF32 off. `Numerics` selects the int8 linears of the int8 configuration
and the controls of a lower precision (TF32, int4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Numerics:
    quant_bits: int = 0  # 0: f32 estimator linears; 8: the int8 configuration
    tf32: bool = False  # the control of a float32 configuration


# ---------------------------------------------------------------------------
# primitives


def lin(p: Dict, x: Tensor) -> Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def conv(p: Dict, x: Tensor, pad=None, dilation: int = 1, stride: int = 1) -> Tensor:
    """(B, T, Cin) -> (B, T', Cout); pad (left, right), default K//2 both."""
    w = p["w"]
    k = w.shape[0]
    if pad is None:
        pad = ((k // 2) * dilation,) * 2
    xc = F.pad(x.transpose(1, 2), tuple(pad))
    y = F.conv1d(xc, w.permute(2, 1, 0), p.get("b"), stride=stride, dilation=dilation)
    return y.transpose(1, 2)


def causal(p: Dict, x: Tensor) -> Tensor:
    return conv(p, x, pad=(p["w"].shape[0] - 1, 0))


def ln(p: Dict, x: Tensor, eps: float) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


def quantize_weight(w: Tensor, bits: int):
    """Per-output-column symmetric quantization of an (in, out) weight:
    (integers as float64, scale (out,) f32)."""
    q = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(w.abs().amax(dim=0) / torch.tensor(q, device=w.device), min=1e-12)
    return torch.clamp(torch.round(w / scale), -q, q).double(), scale


def qlin(p: Dict, x: Tensor, bits: int) -> Tensor:
    """The int8 linear: per-row symmetric activations, an exact integer
    product (float64 holds every sum), then the two scales and the bias."""
    if "_q" not in p:
        p["_q"] = quantize_weight(p["w"], bits)
    wq, scale = p["_q"]
    q = float(2 ** (bits - 1) - 1)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    amax = x2.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax / torch.full_like(amax, q), min=1e-12)
    xq = torch.clamp(torch.round(x2 / sx), -q, q).double()
    y = (xq @ wq).float() * sx * scale
    if "b" in p:
        y = y + p["b"]
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# text encoder and duration predictor


def _rope(x: Tensor, d: int) -> Tensor:
    t = x.shape[2]
    theta = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * theta[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    xr, xp = x[..., :d], x[..., d:]
    rot = torch.cat([-xr[..., d // 2:], xr[..., : d // 2]], dim=-1)
    return torch.cat([xr * torch.cos(ang) + rot * torch.sin(ang), xp], dim=-1)


def text_encoder(p: Dict, e: Dict, ids, spk: Tensor):
    """ids: five (1, T) int64 tensors (phones, tones, word positions,
    syllable positions, languages) of one request. Returns (h, mu)."""
    x, tone, wpos, spos, lang = ids
    c = e["n_channels"]
    h = (p["emb"]["w"][x] + p["tone_emb"]["w"][tone] + p["word_pos_emb"]["w"][wpos]
         + p["syllable_pos_emb"]["w"][spos]) * math.sqrt(c)
    pre = p["prenet"]
    y = h
    for cv, nm in zip(pre["convs"], pre["norms"]):
        y = F.relu(ln(nm, conv(cv, y), 1e-4))
    h = h + conv(pre["proj"], y)
    t = h.shape[1]
    h = torch.cat([h, spk[:, None, :].expand(1, t, -1), p["lang_emb"]["w"][lang]], dim=-1)
    heads = e["n_heads"]
    hd = h.shape[-1] // heads
    d_rope = int(hd * 0.5) - int(hd * 0.5) % 2
    for layer in p["layers"]:
        a = layer["attn"]

        def split(z):
            return z.reshape(1, t, heads, hd).transpose(1, 2)

        q = _rope(split(lin(a["q"], h)), d_rope)
        k = _rope(split(lin(a["k"], h)), d_rope)
        v = split(lin(a["v"], h))
        pr = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        y = lin(a["o"], (pr @ v).transpose(1, 2).reshape(1, t, -1))
        h = ln(layer["norm1"], h + y, 1e-4)
        f = layer["ffn"]
        y = conv(f["conv2"], F.relu(conv(f["conv1"], h)))
        h = ln(layer["norm2"], h + y, 1e-4)
    return h, conv(p["proj"], h)


def log_durations(p: Dict, h: Tensor, spk: Tensor) -> Tensor:
    """(1, T) log-durations."""
    x = h + conv(p["cond"], spk[:, None, :])
    x = ln(p["norm1"], F.relu(conv(p["conv1"], x)), 1e-4)
    x = ln(p["norm2"], F.relu(conv(p["conv2"], x)), 1e-4)
    return conv(p["proj"], x)[..., 0]


# ---------------------------------------------------------------------------
# flow-matching decoder


def exact_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """(B, H, T, D) each, every key valid: kernel 1's rounding points (q
    scaled in f32 then bf16, k and v bf16, probabilities bf16 before P.V,
    f32 sums and normaliser)."""
    bf = torch.bfloat16
    q = (q * (1.0 / math.sqrt(q.shape[-1]))).to(bf).float()
    s = q @ k.to(bf).float().transpose(-1, -2)
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (pr.to(bf).float() @ v.to(bf).float()) / pr.sum(dim=-1, keepdim=True)


def banded_attention(q: Tensor, k: Tensor, v: Tensor, chunk: int, left: int,
                     right: int) -> Tensor:
    """(B, H, T, D), every key valid: query chunk c (frames [c chunk,
    (c + 1) chunk), the last one cut at T) attends the keys of chunks
    [c - left, c + right] below T, f32 throughout."""
    t, d = q.shape[2], q.shape[3]
    nc = -(-t // chunk)
    out = torch.empty_like(q)
    for c in range(nc):
        lo, hi = max(c - left, 0) * chunk, min((c + right + 1) * chunk, t)
        rows = slice(c * chunk, min((c + 1) * chunk, t))
        s = q[:, :, rows] @ k[:, :, lo:hi].transpose(-1, -2)
        out[:, :, rows] = torch.softmax(s / math.sqrt(d), -1) @ v[:, :, lo:hi]
    return out


def estimator(p: Dict, s: Dict, x, mu, t, spks, cond, num: Numerics, band=None) -> Tensor:
    """The velocity field over (B, T, 80) inputs whose T frames are all
    valid; t (B,), spks (B, 80). band: (chunk, left, right) for the banded
    long-form attention, else exact attention."""
    b, seq, _ = x.shape
    half = s["in_channels"] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = 1000.0 * t[:, None] * freqs[None, :]
    tm = p["time_mlp"]
    temb = lin(tm["linear2"], F.silu(lin(tm["linear1"], torch.cat([ang.sin(), ang.cos()], -1))))
    heads = s["num_heads"]

    def linear(q, z):
        return qlin(q, z, num.quant_bits) if num.quant_bits else lin(q, z)

    def block(bp, z):
        a = bp["attn"]
        y = F.layer_norm(z, (z.shape[-1],), bp["norm1"]["g"], bp["norm1"]["b"], 1e-5)
        q, k, v = (linear(a[n], y).reshape(b, seq, heads, -1).transpose(1, 2) for n in "qkv")
        o = banded_attention(q, k, v, *band) if band else exact_attention(q, k, v)
        z = z + linear(a["o"], o.transpose(1, 2).reshape(b, seq, -1))
        y = F.layer_norm(z, (z.shape[-1],), bp["norm3"]["g"], bp["norm3"]["b"], 1e-5)
        return z + linear(bp["ff_out"], F.gelu(linear(bp["ff_in"], y)))

    def cblock(cp, z):
        return mish(ln(cp["norm"], causal(cp["conv"], z), 1e-5))

    def stage(sp, z):
        r = sp["resnet"]
        y = cblock(r["block1"], z) + lin(r["mlp"], mish(temb))[:, None, :]
        z = cblock(r["block2"], y) + conv(r["res_conv"], z)
        for bp in sp["blocks"]:
            z = block(bp, z)
        return z

    h = torch.cat([x, mu, spks[:, None, :].expand(b, seq, -1), cond], dim=-1)
    h = stage(p["down"], h)
    skip = h
    h = causal(p["down_conv"], h)
    for sp in p["mid"]:
        h = stage(sp, h)
    h = stage(p["up"], torch.cat([h, skip], dim=-1))
    h = cblock(p["final_block"], causal(p["up_conv"], h))
    return conv(p["final_proj"], h)


def cfm_solve(p: Dict, cfm: Dict, mu: Tensor, c: Tensor, noise: Tensor, steps: int,
              num: Numerics, band=None) -> Tensor:
    """Euler steps on the cosine schedule with classifier-free guidance
    (the unconditioned velocity has mu, the speaker and the condition at
    zero). mu (1, T, 80); c (1, 80); noise (1, >= T, 80)."""
    s = cfm["estimator"]
    rate = cfm["inference_cfg_rate"]
    t_span = 1.0 - torch.cos(torch.linspace(0.0, 1.0, steps + 1, device=mu.device) * 0.5 * math.pi)
    x = noise[:, : mu.shape[1]].clone()
    zero = torch.zeros_like(mu)
    for i in range(steps):
        t = t_span[i].reshape(1).expand(2)
        v = estimator(p, s, torch.cat([x, x]), torch.cat([mu, zero]), t,
                      torch.cat([c, torch.zeros_like(c)]), torch.cat([zero, zero]), num, band)
        x = x + (t_span[i + 1] - t_span[i]) * ((1.0 + rate) * v[:1] - rate * v[1:])
    return x


# ---------------------------------------------------------------------------
# HiFT vocoder


def _hann(n: int, device) -> Tensor:
    i = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n))


def _snake(x: Tensor, a: Tensor) -> Tensor:
    return x + (1.0 / (a + 1e-9)) * torch.square(torch.sin(x * a))


def _resblock(p: Dict, x: Tensor, k: int, dils) -> Tensor:
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alphas1"], p["alphas2"], dils):
        y = conv(c1, _snake(x, a1), pad=((k * d - d) // 2,) * 2, dilation=d)
        x = x + conv(c2, _snake(y, a2), pad=((k - 1) // 2,) * 2)
    return x


def source(p: Dict, h: Dict, mel: Tensor) -> Tensor:
    """The harmonic source (1, 480 T) of a mel (1, T, 80): f0 from the
    predictor, its phase summed per 16384-sample block with only the
    fractional block totals carried (the model's f32 phase accumulation),
    9 harmonics gated by voicing, one linear and tanh."""
    z = mel
    for cv in p["f0_predictor"]["convs"]:
        z = F.elu(conv(cv, z))
    f0 = lin(p["f0_predictor"]["classifier"], z)[..., 0].abs()
    up = math.prod(h["upsample_rates"]) * h["istft_hop_len"]
    f0 = torch.repeat_interleave(f0, up, dim=1)
    n = f0.shape[1]
    blk = 16384
    nb = -(-n // blk)
    f = F.pad(f0 / h["sampling_rate"], (0, nb * blk - n)).view(1, nb, blk)
    tot = torch.remainder(f.sum(dim=2), 1.0)
    carry = torch.remainder(torch.cumsum(tot, dim=1) - tot, 1.0)
    mult = torch.arange(1, h["nb_harmonics"] + 2, dtype=torch.float32, device=mel.device)
    frac = torch.remainder(torch.cumsum(f, dim=2)[..., None] * mult
                           + torch.remainder(carry[:, :, None, None] * mult, 1.0), 1.0)
    frac = frac.reshape(1, nb * blk, -1)[:, :n]
    sine = h["nsf_alpha"] * torch.sin(2.0 * math.pi * frac)
    uv = (f0 > h["nsf_voiced_threshold"]).float()[..., None]
    return torch.tanh(lin(p["m_source"]["l_linear"], sine * uv))[..., 0]


def decode(p: Dict, h: Dict, mel: Tensor, src: Tensor) -> Tensor:
    """(B, T, 80) mel and (B, 480 T) source -> (B, 480 T) waveform."""
    n_fft, hop = h["istft_n_fft"], h["istft_hop_len"]
    dev = mel.device
    win = _hann(n_fft, dev)
    kk = torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=dev)
    nn_ = torch.arange(n_fft, dtype=torch.float64, device=dev)
    ang = 2.0 * math.pi * nn_[:, None] * kk[None, :] / n_fft
    xs = F.pad(src[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xs.unfold(1, n_fft, hop)
    s_stft = torch.cat([frames @ (torch.cos(ang) * win[:, None]).float(),
                        frames @ (-torch.sin(ang) * win[:, None]).float()], dim=-1)
    x = conv(p["conv_pre"], mel)
    strides = [int(v) for v in torch.tensor([1] + list(h["upsample_rates"][::-1][:-1])).cumprod(0).flip(0)]
    nk = len(h["resblock_kernel_sizes"])
    nup = len(h["upsample_rates"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, h["lrelu_slope"])
        up = p["ups"][i]
        x = F.conv_transpose1d(x.transpose(1, 2), up["w"].permute(1, 2, 0), up["b"], u,
                               (k - u) // 2).transpose(1, 2)
        if i == nup - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)
        sd = p["source_downs"][i]["conv"]
        si = conv(sd, s_stft, pad=(0, 0)) if strides[i] == 1 else conv(
            sd, s_stft, pad=(strides[i] // 2,) * 2, stride=strides[i])
        x = x + _resblock(p["source_resblocks"][i], si, h["source_resblock_kernel_sizes"][i],
                          h["source_resblock_dilation_sizes"][i])
        x = sum(_resblock(p["resblocks"][i * nk + j], x, h["resblock_kernel_sizes"][j],
                          h["resblock_dilation_sizes"][j]) for j in range(nk)) / nk
    x = conv(p["conv_post"], F.leaky_relu(x, 0.01))
    nbin = n_fft // 2 + 1
    mag = torch.clamp(torch.exp(x[..., :nbin]), max=1e2)
    ph = torch.sin(x[..., nbin:])
    re, im = mag * torch.cos(ph), mag * torch.sin(ph)
    scale = torch.full((nbin, 1), 2.0 / n_fft, dtype=torch.float64, device=dev)
    scale[0] = scale[-1] = 1.0 / n_fft
    iang = ang.T
    fr = (re @ (torch.cos(iang) * scale).float() + im @ (-torch.sin(iang) * scale).float()) * win.float()
    b, tf, _ = fr.shape
    r = n_fft // hop
    y = torch.zeros(b, tf - 1 + r, hop, device=dev)
    env = torch.zeros(tf - 1 + r, hop, dtype=torch.float64, device=dev)
    for j in range(r):
        y[:, j:j + tf] += fr[:, :, j * hop:(j + 1) * hop]
        env[j:j + tf] += (win ** 2)[j * hop:(j + 1) * hop]
    y = y.reshape(b, -1) * (1.0 / torch.clamp(env.reshape(-1), min=1e-11)).float()
    return torch.clamp(y[:, n_fft // 2: -(n_fft // 2)], -h["audio_limit"], h["audio_limit"])


def vocode(p: Dict, h: Dict, mel: Tensor, window: Optional[int] = None, halo: int = 32) -> Tensor:
    """(1, T, 80) -> (1, 480 T); window: the long-form decode of
    overlapping windows of window + 2 halo frames whose interiors are
    joined (the source is taken over the whole mel)."""
    src = source(p, h, mel)
    t = mel.shape[1]
    if window is None or t <= window + 2 * halo:
        return decode(p, h, mel, src)
    up = src.shape[1] // t
    wh = window + 2 * halo
    offs = [min(max(w * window - halo, 0), t - wh) for w in range(-(-t // window))]
    parts = []
    for w, o in enumerate(offs):
        wav = decode(p, h, mel[:, o:o + wh], src[:, o * up:(o + wh) * up])
        a, end = w * window, min(w * window + window, t)
        parts.append(wav[:, (a - o) * up:(end - o) * up])
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# one request


def durations(tts: Dict, m: Dict, ids, spk: Tensor) -> Tensor:
    """(T_text,) float32 durations exp(logw) of one request, before the
    ceiling and the length scale."""
    h, _ = text_encoder(tts["encoder"], m["tts"]["encoder"], ids, spk)
    return torch.exp(log_durations(tts["dp"], h, spk))[0]


def mel(tts: Dict, m: Dict, ids, spk: Tensor, frames: Tensor, noise: Tensor, steps: int,
        num: Numerics, band=None) -> Tensor:
    """(1, sum(frames), 80) mel of one request with per-token frame counts
    `frames` (the ceiled, scaled durations; float, summing to an integer)."""
    _, mu = text_encoder(tts["encoder"], m["tts"]["encoder"], ids, spk)
    cum = torch.cumsum(frames.double(), 0)
    y_len = int(torch.clamp(cum[-1], min=1.0))
    tok = torch.searchsorted(cum, torch.arange(y_len, dtype=torch.float64, device=cum.device),
                             right=True)
    mu_y = mu[0, tok.clamp(max=mu.shape[1] - 1)][None]
    spk_n = spk / torch.clamp(spk.norm(dim=1, keepdim=True), min=1e-12)
    c = lin(tts["spk_embed_affine_layer"], spk_n)
    return cfm_solve(tts["decoder"], m["tts"]["cfm"], mu_y, c, noise, steps, num, band)
