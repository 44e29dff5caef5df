"""Whisper-style 128-bin log-mel, the S3 speech tokenizer's input.

The counterpart of the JAX package's `audio/whisper_mel.py`:
whisper.log_mel_spectrogram as the reference's speech-token extraction
uses it (n_fft 400, hop 160, hann window, slaney mel, log10 with an 8 dB
dynamic-range clamp and (x + 4) / 4 scaling). `whisper_log_mel` is the host
version (numpy FFT), `whisper_log_mel_batch` the device version (a matmul
DFT over a batch).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jyutvoice_tpu_torch.audio.mel import device_constant, mel_filterbank
from jyutvoice_tpu_torch.nn.core import frame_signal

Tensor = torch.Tensor


@functools.lru_cache(maxsize=2)
def _hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def whisper_log_mel(
    audio16k: np.ndarray, n_mels: int = 128, n_fft: int = 400, hop: int = 160
) -> np.ndarray:
    """(num_samples,) 16 kHz float -> (n_mels, T) log-mel, on the host."""
    wav = np.asarray(audio16k, dtype=np.float64)
    pad = n_fft // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(wav[idx] * _hann(n_fft)[None, :], axis=1)
    power = (spec.real**2 + spec.imag**2)[:-1]  # whisper drops the last frame
    mel = power @ mel_filterbank(16000, n_fft, n_mels, 0.0, None).T  # (T, n_mels)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).T.astype(np.float32)  # (n_mels, T)


@functools.lru_cache(maxsize=2)
def _whisper_dft(n_fft: int):
    """(n_fft, n_fft // 2 + 1) cos / -sin DFT matrices, hann window folded in."""
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    w = _hann(n_fft)[:, None]
    return (np.cos(angle) * w).astype(np.float32), (-np.sin(angle) * w).astype(np.float32)


def whisper_log_mel_batch(y_padded: Tensor, wav_len: Tensor, n_mels: int = 128,
                          n_fft: int = 400, hop: int = 160):
    """(B, Lp) rows, each reflect-padded by n_fft // 2 on both sides of its
    own samples on the host and zero-padded to Lp -> ((B, T, n_mels) log-mel,
    (B,) int32 frame counts wav_len // hop: whisper's count without its last
    frame), on the device of y_padded. The 8 dB clamp takes each row's max
    over its valid frames; frames past the count are for the caller to mask."""
    frames = frame_signal(y_padded, n_fft, hop)  # (B, T, n_fft)
    cos_m, sin_m = _whisper_dft(n_fft)
    dev = y_padded.device
    re = frames @ device_constant(("whisper_cos", n_fft), cos_m, dev)
    im = frames @ device_constant(("whisper_sin", n_fft), sin_m, dev)
    power = re * re + im * im
    fb = mel_filterbank(16000, n_fft, n_mels, 0.0, None).T
    mel = power @ device_constant(("whisper_mel", n_fft, n_mels), fb, dev)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    t_len = torch.div(wav_len, hop, rounding_mode="floor").to(torch.int32)
    valid = torch.arange(log_spec.shape[1], device=dev)[None, :] < t_len[:, None]
    row_max = torch.where(valid[..., None], log_spec, -torch.inf).amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, row_max - 8.0)
    return (log_spec + 4.0) / 4.0, t_len
