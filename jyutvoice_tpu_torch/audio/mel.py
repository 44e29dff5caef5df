"""Log-mel spectrogram of the voice-cloning prompt, on tensors.

The counterpart of the JAX package's `audio/mel.py`, with its semantics
(the reference mel front end):
  * reflect-pad by (n_fft - hop) / 2 on both sides,
  * torch.stft(center=False) with a periodic hann window,
  * magnitude = sqrt(re^2 + im^2 + 1e-9),
  * a slaney-scale, slaney-normalized mel filterbank (librosa's defaults),
  * log(clamp(min=1e-5)).
The STFT is the same matmul DFT as the JAX package's (frames through the
windowed cos / -sin matrices, then the mel matrix), in f32 on the device of
the signal, so both packages round alike.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from jyutvoice_tpu_torch.nn.core import frame_signal

Tensor = torch.Tensor


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(
        log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]
) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) slaney-normalized triangular filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_min, mel_max = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    mel_f = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _windowed_dft(n_fft: int, win_length: int):
    """(n_fft, n_bins) cos and -sin DFT matrices with the hann window folded in."""
    n_bins = 1 + n_fft // 2
    n = np.arange(win_length)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))  # periodic hann
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


_CONSTANTS: Dict[tuple, Tensor] = {}


def device_constant(key, array: np.ndarray, device) -> Tensor:
    """A numpy constant on `device`, copied there once per device. On the
    CPU too it is a copy: the arrays come from lru_caches, which a tensor
    sharing their memory could change for every later caller."""
    k = (key, str(device))
    if k not in _CONSTANTS:
        _CONSTANTS[k] = torch.tensor(np.asarray(array), device=device)
    return _CONSTANTS[k]


def stft_magnitude(y: Tensor, n_fft: int, hop: int, win_length: int) -> Tensor:
    """(B, L) -> (B, T, n_bins) magnitude, torch.stft(center=False) semantics."""
    frames = frame_signal(y, n_fft, hop)
    cos_m, sin_m = _windowed_dft(n_fft, win_length)
    re = frames @ device_constant(("dft_cos", n_fft, win_length), cos_m, y.device)
    im = frames @ device_constant(("dft_sin", n_fft, win_length), sin_m, y.device)
    return torch.sqrt(re * re + im * im + 1e-9)


class MelSpec:
    """Configured log-mel extractor: (B, L) f32 in [-1, 1] -> (B, T, n_mels),
    on the device of its input."""

    def __init__(
        self,
        sr: int = 24000,
        n_fft: int = 1920,
        hop: int = 480,
        win_length: int = 1920,
        n_mels: int = 80,
        fmin: float = 0.0,
        fmax: Optional[float] = 8000.0,
    ):
        self.sr, self.n_fft, self.hop, self.win_length = sr, n_fft, hop, win_length
        self.n_mels, self.fmin, self.fmax = n_mels, fmin, fmax
        self._key = ("mel", sr, n_fft, n_mels, fmin, fmax)
        self._weights = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T  # (n_bins, n_mels)

    def __call__(self, y: Tensor) -> Tensor:
        pad = (self.n_fft - self.hop) // 2
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        return self.from_padded(y)

    def from_padded(self, y: Tensor) -> Tensor:
        """Log-mel of an already reflect-padded signal. Batched extraction
        pads each row on the host (a reflect of the row's own tail: padding
        the zero-padded batch buffer would reflect zeros for short rows) and
        calls this on the bucketed buffer; rows are exact up to their own
        frame count."""
        spec = stft_magnitude(y, self.n_fft, self.hop, self.win_length)
        mel = spec @ device_constant(self._key, self._weights, y.device)
        return torch.log(torch.clamp(mel, min=1e-5))
