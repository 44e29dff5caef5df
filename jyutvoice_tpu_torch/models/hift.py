"""HiFT vocoder: NSF harmonic source + iSTFT HiFi-GAN, mel -> 24 kHz waveform.

The counterpart of the JAX package's `models/hift.py` (deterministic inference
path). The source STFT and the final iSTFT (n_fft=16, hop=4) are framed
matmuls plus an overlap-add; the upsample stages with C <= 128 run their
parallel ResBlocks through kernel 2 (the op `jyutvoice::resblock_stage`,
`nn/resblock_stage.py`) on weights prepared once and held as the module's
buffers, the others as separate convs.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.config import HiFTConfig
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.resblock_stage import (
    PreparedStage,
    pack_stage_weights,
    prepare_stage_weights,
    resblock_stage_prepared,
)
from jyutvoice_tpu_torch.utils.observability import span

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# f0 predictor
# ---------------------------------------------------------------------------


class F0Predictor(nn.Module):
    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        chans = [cfg.in_channels] + [cfg.f0_predictor_cond_channels] * 5
        self.convs = nn.ModuleList(
            core.Conv1d(chans[i], chans[i + 1], 3) for i in range(5)
        )
        self.classifier = core.Linear(cfg.f0_predictor_cond_channels, 1)

    def forward(self, mel: Tensor) -> Tensor:
        """mel (B, T, 80) -> f0 (B, T)."""
        h = mel
        for conv in self.convs:
            h = core.elu(conv(h, padding="same_torch"))
        return torch.abs(self.classifier(h))[..., 0]


# ---------------------------------------------------------------------------
# Sine source
# ---------------------------------------------------------------------------

_PHASE_BLOCK = 16384


def _harmonic_phase_frac(f0_norm: Tensor, mult: Tensor) -> Tensor:
    """frac(cumsum(f0_norm) * h) per harmonic, accumulated blockwise.

    A single f32 running phase sum grows to ~1e5 cycles on long inputs, where
    the f32 ulp is a large fraction of a cycle. Since (x mod 1) is a ring
    homomorphism, the sum is taken per block and only the fractional block
    totals are carried; one base-frequency cumsum serves every harmonic.
    f0_norm (B, L) = f0 / sample_rate; mult (H,) harmonic indices.
    Returns (B, L, H) in [0, 1).
    """
    b, length = f0_norm.shape
    nb = -(-length // _PHASE_BLOCK)
    f = F.pad(f0_norm, (0, nb * _PHASE_BLOCK - length)).view(b, nb, _PHASE_BLOCK)
    inner = torch.cumsum(f, dim=2)
    totals = torch.remainder(torch.sum(f, dim=2), 1.0)  # (B, nb)
    carry = torch.remainder(torch.cumsum(totals, dim=1) - totals, 1.0)
    frac = torch.remainder(
        inner[:, :, :, None] * mult
        + torch.remainder(carry[:, :, None, None] * mult, 1.0),
        1.0,
    )
    return frac.reshape(b, nb * _PHASE_BLOCK, -1)[:, :length]


class SineSource(nn.Module):
    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.l_linear = core.Linear(cfg.nb_harmonics + 1, 1)

    def forward(self, f0_up: Tensor, cfg: HiFTConfig) -> Tensor:
        """f0_up (B, L) at audio rate -> source (B, L, 1). Deterministic:
        zero initial phases and no noise."""
        n_harm = cfg.nb_harmonics + 1
        mult = torch.arange(1, n_harm + 1, dtype=torch.float32, device=f0_up.device)
        theta = 2.0 * math.pi * _harmonic_phase_frac(f0_up / cfg.sampling_rate, mult)
        sine = cfg.nsf_alpha * torch.sin(theta)
        uv = (f0_up > cfg.nsf_voiced_threshold).to(torch.float32)[:, :, None]
        return torch.tanh(self.l_linear(sine * uv))


# ---------------------------------------------------------------------------
# Small STFT / iSTFT (n_fft=16, hop=4)
# ---------------------------------------------------------------------------


def _hann(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic


@functools.lru_cache(maxsize=4)
def _small_dft_matrices(n_fft: int):
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    w = _hann(n_fft)[:, None]
    return (np.cos(ang) * w).astype(np.float32), (-np.sin(ang) * w).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _small_idft_matrices(n_fft: int):
    """(n_bins, n_fft): time = Re @ C + Im @ S, with irfft scaling."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    scale = np.full((n_bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    scale[-1] = 1.0 / n_fft
    return (np.cos(ang) * scale).astype(np.float32), (-np.sin(ang) * scale).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _ola_inv_envelope(t_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """1 / (overlap-added squared window), length (T-1)*hop + n_fft."""
    wsq = _hann(n_fft) ** 2
    r = n_fft // hop
    env = np.zeros((t_frames - 1 + r, hop), np.float64)
    for k in range(r):
        env[k : k + t_frames] += wsq[k * hop : (k + 1) * hop]
    return (1.0 / np.maximum(env.reshape(-1), 1e-11)).astype(np.float32)


def _to_device(make, args: tuple, device: torch.device) -> Tuple[Tensor, ...]:
    arrays = make(*args)
    arrays = arrays if isinstance(arrays, tuple) else (arrays,)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
                     for a in arrays)


_to_device_cached = functools.lru_cache(maxsize=32)(_to_device)
_KEEPERS: list = []  # the lists of the open keep_constants() blocks


@contextlib.contextmanager
def keep_constants():
    """Collect into the list this yields every cached constant that vocoder
    calls inside the block read: `_on_device`'s tensors and the kernel
    stages' prepared buffers. A CUDA graph holds their addresses, not
    references, so whoever captures one keeps this list: no cache eviction
    or re-preparation then frees memory that its replays read."""
    kept: list = []
    _KEEPERS.append(kept)
    try:
        yield kept
    finally:
        _KEEPERS.remove(kept)


def _kept(tensors: Tuple[Tensor, ...]) -> Tuple[Tensor, ...]:
    for kept in _KEEPERS:
        kept.extend(tensors)
    return tensors


def _on_device(make, args: tuple, device: torch.device) -> Tuple[Tensor, ...]:
    """The arrays of make(*args) as float32 tensors on `device`, copied there
    once: a copy per call would make every vocoder call wait for the device
    (a blocking host-to-device copy synchronizes the stream). Made outside
    inference mode, so autograd may use them. While torch.export traces they
    are made afresh and not cached: a cached FakeTensor would be what every
    later eager call gets."""
    if kernels.tracing():
        return _to_device(make, args, device)
    return _kept(_to_device_cached(make, args, device))


def small_stft(x: Tensor, n_fft: int, hop: int) -> Tuple[Tensor, Tensor]:
    """torch.stft(center=True) semantics: (B, L) -> (B, T, n_bins) re, im."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = core.frame_signal(x, n_fft, hop)
    cos_m, sin_m = _on_device(_small_dft_matrices, (n_fft,), x.device)
    return frames @ cos_m, frames @ sin_m


def small_istft(re: Tensor, im: Tensor, n_fft: int, hop: int) -> Tensor:
    """torch.istft(center=True) semantics: (B, T, n_bins) -> (B, (T-1)*hop)."""
    r = n_fft // hop
    b, t_frames, _ = re.shape
    c, s = _on_device(_small_idft_matrices, (n_fft,), re.device)
    (window,) = _on_device(_hann, (n_fft,), re.device)
    frames = (re @ c + im @ s) * window  # (B, T, n_fft)
    # frame m covers hop-groups m..m+r-1: part k of frame m lands in group m+k
    y = torch.zeros((b, t_frames - 1 + r, hop), dtype=torch.float32, device=re.device)
    for k in range(r):
        y[:, k : k + t_frames] += frames[:, :, k * hop : (k + 1) * hop]
    (inv_env,) = _on_device(_ola_inv_envelope, (t_frames, n_fft, hop), re.device)
    y = y.reshape(b, -1) * inv_env
    half = n_fft // 2
    return y[:, half:-half]


# ---------------------------------------------------------------------------
# ResBlock
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        n = len(dilations)
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            core.Conv1d(channels, channels, kernel_size) for _ in range(n)
        )
        self.convs2 = nn.ModuleList(
            core.Conv1d(channels, channels, kernel_size) for _ in range(n)
        )
        self.alphas1 = nn.ParameterList(
            nn.Parameter(torch.empty(channels), requires_grad=False) for _ in range(n)
        )
        self.alphas2 = nn.ParameterList(
            nn.Parameter(torch.empty(channels), requires_grad=False) for _ in range(n)
        )

    def forward(self, x: Tensor) -> Tensor:
        k = self.kernel_size
        for c1, c2, a1, a2, d in zip(
            self.convs1, self.convs2, self.alphas1, self.alphas2, self.dilations
        ):
            pad = (k * d - d) // 2
            xt = c1(core.snake(x, a1), padding=(pad, pad), dilation=d)
            pad1 = (k - 1) // 2
            xt = c2(core.snake(xt, a2), padding=(pad1, pad1))
            x = xt + x
        return x


class SourceDown(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int):
        super().__init__()
        self.conv = core.Conv1d(in_ch, out_ch, kernel_size)


def _source_down_strides(cfg: HiFTConfig):
    downsample_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    return [int(u) for u in list(np.cumprod(downsample_rates))[::-1]]


_STAGE_PARTS = ("flat", "tiles", "params")


class HiFT(nn.Module):
    def __init__(self, cfg: HiFTConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base_channels
        n_fft_src = cfg.istft_n_fft + 2
        self.f0_predictor = F0Predictor(cfg)
        self.m_source = SineSource(cfg)
        self.conv_pre = core.Conv1d(cfg.in_channels, base, 7)
        self.ups = nn.ModuleList(
            core.ConvTranspose1d(base // (2**i), base // (2 ** (i + 1)), k)
            for i, k in enumerate(cfg.upsample_kernel_sizes)
        )
        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        for i, (u, k, d) in enumerate(
            zip(_source_down_strides(cfg), cfg.source_resblock_kernel_sizes,
                cfg.source_resblock_dilation_sizes)
        ):
            ch = base // (2 ** (i + 1))
            self.source_downs.append(SourceDown(n_fft_src, ch, 1 if u == 1 else u * 2))
            self.source_resblocks.append(ResBlock(ch, k, d))
        self.resblocks = nn.ModuleList(
            ResBlock(base // (2 ** (i + 1)), k, d)
            for i in range(len(cfg.upsample_rates))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        )
        self.conv_post = core.Conv1d(base // (2 ** len(cfg.upsample_rates)), n_fft_src, 7)
        # kernel 2's stages (C <= 128, one dilation schedule for every
        # branch): each one's weights in both of the kernel's layouts, as
        # buffers (empty until prepared), so a trace sees them as the
        # module's own tensors
        share = len(set(cfg.resblock_dilation_sizes)) == 1
        self.kernel_stages = tuple(i for i in range(len(cfg.upsample_rates))
                                   if share and base // (2 ** (i + 1)) <= 128)
        for i in self.kernel_stages:
            for part in _STAGE_PARTS:
                self.register_buffer(f"stage{i}_{part}", torch.empty(0), persistent=False)
        self._prepared = {}  # stage -> the weights key its buffers were built from

    def prepared_stage(self, i: int) -> PreparedStage:
        """Stage i's ResBlock weights in kernel 2's layouts, built at the first
        call and again only after a weight of the stage was moved or changed
        in place. While torch.export traces, the buffers are taken as they
        are (a FakeTensor has no data pointer to key on): prepare before
        tracing (`prepare_stages`)."""
        cfg = self.cfg
        n = len(cfg.resblock_kernel_sizes)
        branches = self.resblocks[i * n : (i + 1) * n]
        ks, dil = tuple(cfg.resblock_kernel_sizes), tuple(cfg.resblock_dilation_sizes[0])
        channels = branches[0].convs1[0].weight.shape[0]
        if not kernels.tracing():
            weights = [p for br in branches for p in br.parameters()]
            try:
                versions = tuple(p._version for p in weights)
            except RuntimeError:  # inference tensors keep no version counter
                versions = None
            key = (tuple(p.data_ptr() for p in weights), versions)
            if self._prepared.get(i) != key:
                stage = prepare_stage_weights(
                    pack_stage_weights(branches, dil), channels, ks, dil)
                for part in _STAGE_PARTS:
                    setattr(self, f"stage{i}_{part}", getattr(stage, part))
                self._prepared[i] = key
        elif i not in self._prepared:
            raise RuntimeError(f"HiFT stage {i} was not prepared before tracing: call "
                               "prepare_stages() on the real module first")
        parts = tuple(getattr(self, f"stage{i}_{part}") for part in _STAGE_PARTS)
        if not kernels.tracing():
            _kept(parts)
        return PreparedStage(*parts, channels, ks, dil)

    def prepare_stages(self) -> "HiFT":
        """Prepare every kernel-2 stage now (before a trace or a capture)."""
        for i in self.kernel_stages:
            self.prepared_stage(i)
        return self

    def stage_resblocks(self, i: int, x: Tensor) -> Tensor:
        """The mean of stage i's parallel ResBlocks: kernel 2 for C <= 128
        when the branches share one dilation schedule, else separate convs."""
        cfg = self.cfg
        if i in self.kernel_stages:
            return resblock_stage_prepared(x.contiguous(), self.prepared_stage(i))
        n = len(cfg.resblock_kernel_sizes)
        branches = self.resblocks[i * n : (i + 1) * n]
        xs = None
        for br in branches:
            out = br(x)
            xs = out if xs is None else xs + out
        return xs / n


def hift_decode(model: HiFT, mel: Tensor, source: Tensor) -> Tensor:
    """mel (B, T, 80); source (B, 480T, 1) -> waveform (B, 480T)."""
    cfg = model.cfg
    s_re, s_im = small_stft(source[:, :, 0], cfg.istft_n_fft, cfg.istft_hop_len)
    s_stft = torch.cat([s_re, s_im], dim=-1)  # (B, T_s, n_fft + 2)

    x = model.conv_pre(mel, padding="same_torch")
    num_up = len(cfg.upsample_rates)
    strides = _source_down_strides(cfg)
    for i in range(num_up):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = core.leaky_relu(x, cfg.lrelu_slope)
        x = model.ups[i](x, stride=u, padding=(k - u) // 2)
        if i == num_up - 1:
            # reflection pad (1, 0): duplicate row 1 in front
            x = torch.cat([x[:, 1:2, :], x], dim=1)
        conv = model.source_downs[i].conv
        if strides[i] == 1:
            si = conv(s_stft, padding="valid")
        else:
            pad = strides[i] // 2
            si = conv(s_stft, stride=strides[i], padding=(pad, pad))
        x = x + model.source_resblocks[i](si)
        x = model.stage_resblocks(i, x)

    x = core.leaky_relu(x, 0.01)
    x = model.conv_post(x, padding="same_torch")
    n_bins = cfg.istft_n_fft // 2 + 1
    magnitude = torch.clamp(torch.exp(x[:, :, :n_bins]), max=1e2)
    phase = torch.sin(x[:, :, n_bins:])
    wav = small_istft(
        magnitude * torch.cos(phase), magnitude * torch.sin(phase),
        cfg.istft_n_fft, cfg.istft_hop_len,
    )
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


def _source(model: HiFT, mel: Tensor) -> Tensor:
    f0 = model.f0_predictor(mel)  # (B, T)
    f0_up = torch.repeat_interleave(f0, model.cfg.total_upsample, dim=1)
    return model.m_source(f0_up, model.cfg)


def hift_inference(
    model: HiFT, mel: Tensor, cache_source: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """mel (B, T, 80) -> (wav (B, 480T), source (B, 480T, 1)).

    cache_source (B, L, 1), the streaming source cache: it replaces the
    first L source samples before the decode (zeros included, as on a
    stream's first chunk), so consecutive chunks continue one sine phase."""
    s = _source(model, mel)
    if cache_source is not None and cache_source.shape[1] > 0:
        s = torch.cat([cache_source.to(s.dtype), s[:, cache_source.shape[1] :]], dim=1)
    return hift_decode(model, mel, s), s


def hift_inference_windowed(
    model: HiFT, mel: Tensor, *, window: int = 2048, halo: int = 32
) -> Tuple[Tensor, Tensor]:
    """Long-form vocoding of one mel (B=1) as a batch of overlapping windows.

    f0 and the source are computed over the whole mel; the decode runs once
    over (N, window + 2*halo, 80) mel slices and the interiors are joined.
    The halo covers the decode's receptive field, and window 0 starts at
    row 0 and the last window ends at row T, so the kept samples match the
    whole decode to float tolerance.
    """
    b, t, _ = mel.shape
    if b != 1:
        raise ValueError("windowed vocoding expects batch 1")
    wh = window + 2 * halo
    if t <= wh:
        return hift_inference(model, mel)
    up = model.cfg.total_upsample
    s = _source(model, mel)
    n_win = max(1, -(-t // window))
    offs = [min(max(w * window - halo, 0), t - wh) for w in range(n_win)]
    mel_w = torch.stack([mel[0, o : o + wh] for o in offs])
    src_w = torch.stack([s[0, o * up : (o + wh) * up] for o in offs])
    wavs = hift_decode(model, mel_w, src_w)
    parts = []
    for w, o in enumerate(offs):
        a = w * window
        end = min(a + window, t)
        parts.append(wavs[w, (a - o) * up : (end - o) * up])
    return torch.cat(parts)[None, :], s


def hift_vocode_auto(model: HiFT, mel: Tensor) -> Tuple[Tensor, Tensor]:
    """Batch-1 mels of 4096 frames or more take the windowed path, as in the
    JAX package; everything else the whole decode."""
    with span("vocoder"):
        if mel.shape[0] == 1 and mel.shape[1] >= 4096:
            return hift_inference_windowed(model, mel)
        return hift_inference(model, mel)
