"""Kaldi-compatible log-mel filterbank, the CAM++ speaker embedder's input.

The counterpart of the JAX package's `audio/fbank.py`:
torchaudio.compliance.kaldi.fbank with the reference's arguments
(num_mel_bins=80, dither=0, sample_frequency=16000): 25 ms povey-windowed
frames, 10 ms shift, snip_edges, DC-offset removal, preemphasis 0.97,
HTK-scale mel banks on a 512-point FFT, natural log. `kaldi_fbank` is the
host version (numpy FFT, one utterance); `kaldi_fbank_batch` the device
version (a matmul DFT over a zero-padded batch).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jyutvoice_tpu_torch.audio.mel import device_constant
from jyutvoice_tpu_torch.nn.core import frame_signal

Tensor = torch.Tensor
_LOG_FLOOR = 1.1920928955078125e-07  # f32 epsilon, kaldi's log floor


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def _kaldi_mel_banks(num_bins: int, window_size_padded: int, sample_freq: float):
    """Kaldi MelBanks: triangular filters in mel space over the FFT bins
    (low_freq 20, high_freq nyquist)."""
    nyquist = 0.5 * sample_freq
    low_freq, high_freq = 20.0, nyquist
    fft_bins = window_size_padded // 2
    fft_bin_width = sample_freq / window_size_padded
    mel_low = _hz_to_mel_htk(low_freq)
    mel_high = _hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, fft_bins), dtype=np.float32)
    mel_freqs = _hz_to_mel_htk(fft_bin_width * np.arange(fft_bins))
    for i in range(num_bins):
        left = mel_low + i * mel_delta
        center = mel_low + (i + 1) * mel_delta
        right = mel_low + (i + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[i] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return bins


@functools.lru_cache(maxsize=4)
def _povey_window(n: int) -> np.ndarray:
    a = 2.0 * np.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85


def kaldi_fbank(waveform: np.ndarray, num_mel_bins: int = 80) -> np.ndarray:
    """(num_samples,) 16 kHz float waveform in [-1, 1] -> (T, num_mel_bins)
    log-mel, on the host in f64 (the reference feeds the float waveform
    unscaled)."""
    wav = np.asarray(waveform, dtype=np.float64)
    win, shift = 400, 160  # 25 ms frames, 10 ms shift
    padded = _next_pow2(win)  # 512
    if len(wav) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(wav) - win) // shift
    idx = np.arange(n_frames)[:, None] * shift + np.arange(win)[None, :]
    frames = wav[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)  # DC offset
    first = frames[:, :1]  # preemphasis 0.97, the first sample against itself
    frames = np.concatenate([first - 0.97 * first, frames[:, 1:] - 0.97 * frames[:, :-1]],
                            axis=1)
    frames = frames * _povey_window(win)[None, :]
    frames = np.pad(frames, ((0, 0), (0, padded - win)))
    spec = np.fft.rfft(frames, axis=1)
    power = (spec.real**2 + spec.imag**2)[:, : padded // 2]
    mel = power @ _kaldi_mel_banks(num_mel_bins, padded, 16000.0).T
    return np.log(np.maximum(mel, _LOG_FLOOR)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _fbank_dft(win: int, padded: int):
    """(win, padded // 2) cos / -sin DFT matrices: bins 0 .. padded / 2 - 1,
    the host version's power slice."""
    t = np.arange(win)[:, None]
    k = np.arange(padded // 2)[None, :]
    angle = 2.0 * np.pi * t * k / padded
    return np.cos(angle).astype(np.float32), (-np.sin(angle)).astype(np.float32)


def kaldi_fbank_batch(y: Tensor, wav_len: Tensor, num_mel_bins: int = 80):
    """(B, L) zero-padded 16 kHz rows -> ((B, T, bins) log-mel, (B,) int32
    frame counts), on the device of y, with `kaldi_fbank`'s semantics per row.
    Frames past a row's count 1 + (wav_len - 400) // 160 read padding: the
    caller masks them (CAM++ takes the counts)."""
    win, shift = 400, 160
    padded = _next_pow2(win)
    frames = frame_signal(y, win, shift)  # (B, T, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    window = _povey_window(win).astype(np.float32)
    frames = frames * device_constant(("povey", win), window, y.device)
    cos_m, sin_m = _fbank_dft(win, padded)
    re = frames @ device_constant(("fbank_cos", win, padded), cos_m, y.device)
    im = frames @ device_constant(("fbank_sin", win, padded), sin_m, y.device)
    power = re * re + im * im
    banks = _kaldi_mel_banks(num_mel_bins, padded, 16000.0).T
    mel = power @ device_constant(("kaldi_banks", num_mel_bins, padded), banks, y.device)
    feat = torch.log(torch.clamp(mel, min=_LOG_FLOOR))
    t_len = torch.where(wav_len >= win, 1 + torch.div(wav_len - win, shift, rounding_mode="floor"),
                        torch.zeros_like(wav_len))
    return feat, t_len.to(torch.int32)
