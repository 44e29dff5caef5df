"""Duration predictor: x (B, T, 576) -> log-durations (B, T, 1).

The counterpart of the JAX package's `models/duration.py`, with its
training-time dropout (p_dropout after each conv block) and `duration_loss`.
The input and the speaker embedding are detached: the duration loss trains
the predictor only. The speaker embedding conditions the input through a 1x1
conv.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch.config import DurationPredictorConfig
from jyutvoice_tpu_torch.nn import core

Tensor = torch.Tensor


class DurationPredictor(nn.Module):
    def __init__(self, cfg: DurationPredictorConfig):
        super().__init__()
        self.conv1 = core.Conv1d(cfg.in_channels, cfg.filter_channels, cfg.kernel_size)
        self.norm1 = core.LayerNorm(cfg.filter_channels)
        self.conv2 = core.Conv1d(cfg.filter_channels, cfg.filter_channels, cfg.kernel_size)
        self.norm2 = core.LayerNorm(cfg.filter_channels)
        self.proj = core.Conv1d(cfg.filter_channels, 1, 1)
        self.cond = core.Conv1d(cfg.gin_channels, cfg.in_channels, 1)
        self.p_dropout = cfg.p_dropout

    def forward(
        self, x: Tensor, x_mask: Tensor, spk_embed: Tensor, *,
        generator: Optional[torch.Generator] = None, deterministic: bool = True,
    ) -> Tensor:
        """x (B, T, 576); x_mask (B, T, 1); spk_embed (B, gin) -> (B, T, 1).
        Training dropout draws from `generator`, after block 1 then block 2."""
        x = x.detach()
        g = spk_embed.detach()[:, None, :].to(x.dtype)
        x = x + self.cond(g, padding="valid")
        x = F.relu(self.conv1(x * x_mask, padding="same_torch"))
        x = core.channel_layer_norm(self.norm1, x)
        x = core.dropout(x, self.p_dropout, generator, deterministic)
        x = F.relu(self.conv2(x * x_mask, padding="same_torch"))
        x = core.channel_layer_norm(self.norm2, x)
        x = core.dropout(x, self.p_dropout, generator, deterministic)
        x = self.proj(x * x_mask, padding="valid")
        return x * x_mask


def duration_loss(logw: Tensor, logw_target: Tensor, lengths: Tensor) -> Tensor:
    """Log-domain MSE, normalised by the total text length (of the global
    batch in a data-parallel step: `core.batch_total`)."""
    return torch.sum(torch.square(logw - logw_target)) / core.batch_total(torch.sum(lengths))
