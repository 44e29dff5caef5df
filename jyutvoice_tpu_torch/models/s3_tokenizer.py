"""S3 speech tokenizer v2 (CosyVoice2's speech_tokenizer_v2).

The counterpart of the JAX package's `models/s3_tokenizer.py`: whisper
128-bin log-mel at 100 frames/s -> speech tokens at 25 Hz, vocabulary
6561 = 3^8. A whisper-style audio encoder (two stride-2 convs with GELU,
sinusoidal positions, pre-LN attention blocks) and a finite-scalar
quantization head (linear d -> 8, tanh, round to {-1, 0, 1}, code =
sum digit_i 3^i), rounded in f32 as the export does. Channels-last
(B, T, C); parameter names follow the JAX tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch.nn import core

Tensor = torch.Tensor

_FSQ_TANH_SCALE = 0.9990000128746033  # keeps round(tanh(x) * s) in {-1, 0, 1}


@dataclasses.dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 6
    n_fsq_dims: int = 8
    fsq_level: int = 3

    @property
    def vocab_size(self) -> int:
        return self.fsq_level**self.n_fsq_dims  # 6561


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """whisper's sinusoidal position table: [sin | cos] halves."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class WhisperMHA(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = core.Linear(d, d)
        self.k = core.Linear(d, d, bias=False)
        self.v = core.Linear(d, d)
        self.out = core.Linear(d, d)

    def forward(self, x: Tensor, n_head: int, bias: Optional[Tensor] = None) -> Tensor:
        b, t, d = x.shape
        scale = (d // n_head) ** -0.25
        q = self.q(x).reshape(b, t, n_head, -1).transpose(1, 2) * scale
        k = self.k(x).reshape(b, t, n_head, -1).permute(0, 2, 3, 1) * scale
        v = self.v(x).reshape(b, t, n_head, -1).transpose(1, 2)
        scores = q @ k
        if bias is not None:  # (B, 1, 1, T): -inf on padded keys
            scores = scores + bias
        w = torch.softmax(scores, dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(b, t, d))


class Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.attn = WhisperMHA(d)
        self.attn_ln = core.LayerNorm(d)
        self.mlp1 = core.Linear(d, d * 4)
        self.mlp2 = core.Linear(d * 4, d)
        self.mlp_ln = core.LayerNorm(d)

    def forward(self, x: Tensor, n_head: int, bias: Optional[Tensor] = None) -> Tensor:
        x = x + self.attn(self.attn_ln(x), n_head, bias)
        return x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x))))


class S3Tokenizer(nn.Module):
    def __init__(self, cfg: S3TokenizerConfig = S3TokenizerConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_audio_state
        self.conv1 = core.Conv1d(cfg.n_mels, d, 3)
        self.conv2 = core.Conv1d(d, d, 3)
        self.pos = nn.Parameter(torch.empty(cfg.n_audio_ctx, d), requires_grad=False)
        self.blocks = nn.ModuleList(Block(d) for _ in range(cfg.n_audio_layer))
        self.fsq = core.Linear(d, cfg.n_fsq_dims)


def out_len(t_len):
    """Valid token count after the two stride-2 k=3 p=1 convs (tensors or
    numpy arrays)."""
    t1 = (t_len - 1) // 2 + 1
    return (t1 - 1) // 2 + 1


def apply_s3_encoder(model: S3Tokenizer, mel: Tensor, t_len: Optional[Tensor] = None) -> Tensor:
    """whisper log-mel (B, T, n_mels) -> hidden states (B, ceil(T / 4), d).

    With t_len ((B,) valid mel frames) the input may be zero-padded: the
    input and conv1's output are zeroed past the valid frames (the convs
    then see the exact-length run's zero padding) and attention masks the
    padded keys, so valid positions match the exact-length run."""
    cfg = model.cfg
    if t_len is not None:
        t_len = t_len.to(torch.int64)
        m = (torch.arange(mel.shape[1], device=mel.device)[None, :] < t_len[:, None])[..., None]
        mel = torch.where(m, mel, 0.0)
    x = F.gelu(model.conv1(mel, stride=2))
    if t_len is not None:
        t1 = torch.div(t_len - 1, 2, rounding_mode="floor") + 1
        m1 = (torch.arange(x.shape[1], device=x.device)[None, :] < t1[:, None])[..., None]
        x = torch.where(m1, x, 0.0)
    x = F.gelu(model.conv2(x, stride=2))
    x = x + model.pos[: x.shape[1]]
    bias = None
    if t_len is not None:
        key_ok = torch.arange(x.shape[1], device=x.device)[None, :] < out_len(t_len)[:, None]
        bias = torch.where(key_ok, 0.0, -torch.inf)[:, None, None, :]
    for blk in model.blocks:
        x = blk(x, cfg.n_audio_head, bias)
    return x


def fsq_encode(fsq: core.Linear, cfg: S3TokenizerConfig, h: Tensor) -> Tensor:
    """FSQ: hidden (B, T, d) -> codes (B, T) int32 in [0, 3^8)."""
    z = torch.tanh(fsq(h).float()) * _FSQ_TANH_SCALE
    digits = torch.round(z) + cfg.fsq_level // 2
    powers = float(cfg.fsq_level) ** torch.arange(
        cfg.n_fsq_dims, dtype=torch.float32, device=h.device)
    return (digits * powers).sum(dim=-1).to(torch.int32)


def apply_s3_tokenizer(model: S3Tokenizer, mel: Tensor, t_len: Optional[Tensor] = None) -> Tensor:
    """whisper log-mel (B, T, n_mels) -> speech tokens (B, ceil(T / 4)) at
    25 Hz; with t_len, tokens past out_len(t_len) come from padding."""
    return fsq_encode(model.fsq, model.cfg, apply_s3_encoder(model, mel, t_len))
