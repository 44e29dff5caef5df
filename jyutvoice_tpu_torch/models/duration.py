"""Duration predictor: x (B, T, 576) -> log-durations (B, T, 1).

The counterpart of the JAX package's `models/duration.py` (inference only);
the speaker embedding conditions the input through a 1x1 conv.
"""

from __future__ import annotations

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

    def forward(self, x: Tensor, x_mask: Tensor, spk_embed: Tensor) -> Tensor:
        """x (B, T, 576); x_mask (B, T, 1); spk_embed (B, gin) -> (B, T, 1)."""
        g = spk_embed[:, None, :].to(x.dtype)
        x = x + self.cond(g, padding="valid")
        x = F.relu(self.conv1(x * x_mask, padding="same_torch"))
        x = core.channel_layer_norm(self.norm1, x)
        x = F.relu(self.conv2(x * x_mask, padding="same_torch"))
        x = core.channel_layer_norm(self.norm2, x)
        x = self.proj(x * x_mask, padding="valid")
        return x * x_mask
