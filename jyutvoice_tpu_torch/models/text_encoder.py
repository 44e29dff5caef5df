"""Text encoder: feature embeddings + prenet + partial-RoPE transformer.

The counterpart of the JAX package's `models/text_encoder.py`, with its
training-time dropout: prenet 0.5 after each ReLU, and p_dropout (0.1) on
the attention probabilities, the attention output, inside the FFN and on
its output. Structure at full width:
  sum(phone/tone/word_pos/syllable_pos embeddings) * sqrt(192)
  -> 3-layer ConvReluNorm prenet (k=5, residual, 1x1 proj)
  -> concat [phoneme 192, tiled speaker 192, lang emb 192] = 576 channels
  -> 6 layers (2 heads, partial RoPE, conv-FFN k=3, channel LN eps 1e-4)
  -> 1x1 proj to 80 mel channels (mu_x)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch.config import TextEncoderConfig
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.attention import RopeMHA

Tensor = torch.Tensor

# The text-encoder attention masks scores with -1e4, not -inf or -1e10.
_ATTN_MASK_VALUE = -1e4
_PRENET_DROPOUT = 0.5


class Prenet(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3):
        super().__init__()
        self.convs = nn.ModuleList(
            core.Conv1d(channels, channels, kernel_size) for _ in range(n_layers)
        )
        self.norms = nn.ModuleList(core.LayerNorm(channels) for _ in range(n_layers))
        self.proj = core.Conv1d(channels, channels, 1)

    def forward(
        self, x: Tensor, x_mask: Tensor, *,
        generator: Optional[torch.Generator] = None, deterministic: bool = True,
    ) -> Tensor:
        x_org = x
        for conv, norm in zip(self.convs, self.norms):
            x = conv(x * x_mask, padding="same_torch")
            x = F.relu(core.channel_layer_norm(norm, x))
            x = core.dropout(x, _PRENET_DROPOUT, generator, deterministic)
        x = x_org + self.proj(x, padding="valid")
        return x * x_mask


class FFN(nn.Module):
    def __init__(self, hidden: int, filter_channels: int, kernel_size: int):
        super().__init__()
        self.conv1 = core.Conv1d(hidden, filter_channels, kernel_size)
        self.conv2 = core.Conv1d(filter_channels, hidden, kernel_size)

    def forward(
        self, x: Tensor, x_mask: Tensor, *, p_dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        x = F.relu(self.conv1(x * x_mask, padding="same_torch"))
        x = core.dropout(x, p_dropout, generator, False)
        x = self.conv2(x * x_mask, padding="same_torch")
        return x * x_mask


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, filter_channels: int, kernel_size: int):
        super().__init__()
        self.attn = RopeMHA(hidden, hidden)
        self.norm1 = core.LayerNorm(hidden)
        self.ffn = FFN(hidden, filter_channels, kernel_size)
        self.norm2 = core.LayerNorm(hidden)


class TextEncoderOutput(NamedTuple):
    x: Tensor  # (B, T, hidden) encoder hidden states (duration predictor input)
    mu: Tensor  # (B, T, n_feats) prior mean
    x_mask: Tensor  # (B, T, 1) float mask


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.n_channels
        self.emb = core.Embedding(cfg.n_vocab, c)
        self.lang_emb = core.Embedding(cfg.n_lang, c)
        self.tone_emb = core.Embedding(cfg.n_tone, c)
        self.word_pos_emb = core.Embedding(cfg.n_word_pos, c)
        self.syllable_pos_emb = core.Embedding(cfg.n_syllable_pos, c)
        self.prenet = Prenet(c, kernel_size=5, n_layers=3)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.hidden_channels, cfg.filter_channels, cfg.kernel_size)
            for _ in range(cfg.n_layers)
        )
        self.proj = core.Conv1d(cfg.hidden_channels, cfg.n_feats, 1)

    def forward(
        self, x_ids: Tensor, x_lengths: Tensor, lang: Tensor, tone: Tensor,
        word_pos: Tensor, syllable_pos: Tensor, spk_embed: Tensor, *,
        generator: Optional[torch.Generator] = None, deterministic: bool = True,
    ) -> TextEncoderOutput:
        """Id tensors (B, T) int64; x_lengths (B,); spk_embed (B, gin).

        With `deterministic=False` and a generator, the training dropout
        draws from the generator in this order: the three prenet layers,
        then per encoder layer the attention probabilities, the attention
        output, the FFN's inner activation and the FFN output."""
        cfg = self.cfg
        b, t = x_ids.shape
        h = (
            self.emb(x_ids) + self.tone_emb(tone) + self.word_pos_emb(word_pos)
            + self.syllable_pos_emb(syllable_pos)
        ) * math.sqrt(cfg.n_channels)
        x_mask = core.sequence_mask(x_lengths, t)[..., None].to(h.dtype)
        h = self.prenet(h, x_mask, generator=generator, deterministic=deterministic)
        spk = spk_embed[:, None, :].to(h.dtype).expand(b, t, cfg.gin_channels)
        h = torch.cat([h, spk, self.lang_emb(lang)], dim=-1)

        # (B, 1, Tq, Tk) additive bias from the pad mask outer product
        m = x_mask[:, :, 0]
        pair = m[:, None, :] * m[:, :, None]
        attn_bias = ((1.0 - pair) * _ATTN_MASK_VALUE)[:, None, :, :]
        rate = 0.0 if deterministic else cfg.p_dropout
        for layer in self.layers:
            h = h * x_mask
            y = layer.attn(h, attn_bias, cfg.n_heads, prob_dropout=rate, generator=generator)
            y = core.dropout(y, rate, generator, False)
            h = core.channel_layer_norm(layer.norm1, h + y)
            y = layer.ffn(h, x_mask, p_dropout=rate, generator=generator)
            y = core.dropout(y, rate, generator, False)
            h = core.channel_layer_norm(layer.norm2, h + y)
        h = h * x_mask
        mu = self.proj(h, padding="valid") * x_mask
        return TextEncoderOutput(x=h, mu=mu, x_mask=x_mask)
