"""FlowEncoder: CosyVoice2 speech tokens -> prompt hidden states.

The counterpart of the JAX package's `models/flow_encoder.py` (the
reference's FlowEncoder around an UpsampleConformerEncoder): a token
embedding, a linear embed with ESPnet relative positions, the 3-token
pre-lookahead conv, `num_blocks` conformer layers, a nearest x2 upsample and
conv, a second embed, `num_up_blocks` more layers, a final LayerNorm and the
512 -> 80 projection. The conformer's macaron feed-forward and convolution
module are built when the config enables them. Channels-last (B, T, C),
masks throughout; parameter names follow the JAX tree
(`weights/from_jax.py`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.attention import RelMHA, espnet_rel_pos_emb

Tensor = torch.Tensor


class ConvModule(nn.Module):
    """Conformer ConvolutionModule: pointwise 1x1 -> GLU -> depthwise k ->
    batch norm (running statistics) or LayerNorm -> swish -> pointwise 1x1."""

    def __init__(self, size: int, kernel: int, norm: str):
        super().__init__()
        self.pw1 = core.Linear(size, 2 * size)
        self.dw = core.DepthwiseConv1d(size, kernel)
        self.norm = core.BatchNorm(size) if norm == "batch_norm" else core.LayerNorm(size)
        self.pw2 = core.Linear(size, size)


def apply_conv_module(conv: ConvModule, x: Tensor, mask_pad: Tensor, kernel: int,
                      causal: bool) -> Tensor:
    """x (B, T, C) -> (B, T, C): pads are zeroed on entry, the input is
    left-padded (causal) or symmetric-padded before the first pointwise conv
    (so the depthwise conv sees pw1(0) = bias at the edges, as the reference
    does), and the output is zeroed past each row's length."""
    x = x * mask_pad.to(x.dtype)[..., None]
    lorder = kernel - 1 if causal else 0
    if lorder > 0:
        x = torch.cat([x.new_zeros(x.shape[0], lorder, x.shape[2]), x], dim=1)
        pad = "valid"
    else:
        pad = "same_torch"
    a, g = conv.pw1(x).chunk(2, dim=-1)
    h = conv.dw(a * torch.sigmoid(g), padding=pad)  # GLU over the channels
    h = conv.norm(h)  # batch norm or LayerNorm, eps 1e-5
    h = conv.pw2(core.silu(h))
    return h * mask_pad.to(h.dtype)[..., None]


class FeedForward(nn.Module):
    def __init__(self, size: int, linear_units: int):
        super().__init__()
        self.w1 = core.Linear(size, linear_units)
        self.w2 = core.Linear(linear_units, size)

    def forward(self, x: Tensor) -> Tensor:
        return self.w2(core.silu(self.w1(x)))


class ConformerLayer(nn.Module):
    """Pre-norm conformer layer: optional 0.5-weighted macaron FF,
    relative-position MHA, optional convolution module, FF (0.5-weighted
    with macaron), a final LayerNorm with the convolution module.
    LayerNorm eps 1e-12."""

    def __init__(self, size: int, linear_units: int, n_heads: int, cfg: FlowEncoderConfig):
        super().__init__()
        self.attn = RelMHA(size, n_heads)
        self.norm_mha = core.LayerNorm(size)
        self.ff = FeedForward(size, linear_units)
        self.norm_ff = core.LayerNorm(size)
        if cfg.macaron_style:
            self.ff_macaron = FeedForward(size, linear_units)
            self.norm_ff_macaron = core.LayerNorm(size)
        if cfg.use_cnn_module:
            self.conv = ConvModule(size, cfg.cnn_module_kernel, cfg.cnn_module_norm)
            self.norm_conv = core.LayerNorm(size)
            self.norm_final = core.LayerNorm(size)


def apply_conformer_layer(layer: ConformerLayer, x: Tensor, pos_emb: Tensor,
                          attn_bias: Tensor, cfg: FlowEncoderConfig, mask_pad: Tensor) -> Tensor:
    macaron = hasattr(layer, "ff_macaron")
    ff_scale = 0.5 if macaron else 1.0
    if macaron:
        x = x + ff_scale * layer.ff_macaron(layer.norm_ff_macaron(x, eps=1e-12))
    x = x + layer.attn(layer.norm_mha(x, eps=1e-12), pos_emb, attn_bias, cfg.attention_heads)
    if hasattr(layer, "conv"):
        x = x + apply_conv_module(layer.conv, layer.norm_conv(x, eps=1e-12), mask_pad,
                                  cfg.cnn_module_kernel, cfg.causal_cnn)
    x = x + ff_scale * layer.ff(layer.norm_ff(x, eps=1e-12))
    if hasattr(layer, "conv"):
        x = layer.norm_final(x, eps=1e-12)
    return x


class Embed(nn.Module):
    """LinearNoSubsampling + EspnetRelPositionalEncoding."""

    def __init__(self, in_dim: int, d: int):
        super().__init__()
        self.linear = core.Linear(in_dim, d)
        self.norm = core.LayerNorm(d)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """-> (LN(linear(x)) * sqrt(d), (2T - 1, d) positions)."""
        h = self.norm(self.linear(x))
        d = h.shape[-1]
        return h * math.sqrt(d), espnet_rel_pos_emb(h.shape[1], d, device=h.device)


class PreLookahead(nn.Module):
    def __init__(self, d: int, pre_len: int):
        super().__init__()
        self.conv1 = core.Conv1d(d, d, pre_len + 1)
        self.conv2 = core.Conv1d(d, d, 3)

    def forward(self, x: Tensor, pre_len: int) -> Tensor:
        """The lookahead conv over the next pre_len tokens, leaky ReLU, a
        causal conv, residual."""
        h = self.conv1(torch.nn.functional.pad(x, (0, 0, 0, pre_len)), padding="valid")
        h = self.conv2(core.leaky_relu(h, 0.01), padding="causal")
        return h + x


def _upsample(conv: core.Conv1d, x: Tensor, stride: int) -> Tensor:
    """Nearest x stride repeat, then a left-padded conv."""
    h = torch.repeat_interleave(x, stride, dim=1)
    h = torch.nn.functional.pad(h, (0, 0, stride * 2, 0))
    return conv(h, padding="valid")


class FlowEncoder(nn.Module):
    def __init__(self, cfg: FlowEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        self.input_embedding = core.Embedding(cfg.vocab_size, cfg.input_size)
        self.embed = Embed(cfg.input_size, d)
        self.pre_lookahead = PreLookahead(d, cfg.pre_lookahead_len)
        self.encoders = nn.ModuleList(
            ConformerLayer(d, cfg.linear_units, cfg.attention_heads, cfg)
            for _ in range(cfg.num_blocks)
        )
        self.up_conv = core.Conv1d(d, d, cfg.upsample_stride * 2 + 1)
        self.up_embed = Embed(cfg.input_size, d)
        self.up_encoders = nn.ModuleList(
            ConformerLayer(d, cfg.linear_units, cfg.attention_heads, cfg)
            for _ in range(cfg.num_up_blocks)
        )
        self.after_norm = core.LayerNorm(d)
        self.encoder_proj = core.Linear(d, cfg.proj_size)


def apply_flow_encoder(
    model: FlowEncoder,
    tokens: Tensor,
    token_lengths: Tensor,
    streaming: bool = False,
    exact_pad: bool = False,
) -> Tuple[Tensor, Tensor]:
    """tokens (B, T) int -> (h (B, 2T, 80), out_lengths (B,)).

    streaming=True masks attention with the static chunk rule
    (cfg.static_chunk_size tokens, x stride after the upsample).
    exact_pad=True re-zeros the hidden states past each row's length where
    padding would leak into valid positions (after the embed, whose bias
    and LayerNorm make pad positions nonzero for the lookahead conv, and
    before the upsample conv), so a zero-padded bucketed run equals the
    exact-length run; False matches the reference's own padded forward."""
    cfg = model.cfg
    t = tokens.shape[1]
    mask = core.sequence_mask(token_lengths, t)  # (B, T) bool
    emb = model.input_embedding(torch.clamp(tokens, min=0).long())
    emb = emb * mask[..., None].to(emb.dtype)

    h, pos_emb = model.embed(emb)
    if exact_pad:
        h = h * mask[..., None].to(h.dtype)
    attn_mask = core.chunk_attn_mask(mask, cfg.static_chunk_size if streaming else 0)
    attn_bias = core.mask_to_bias(attn_mask)[:, None, :, :]
    h = model.pre_lookahead(h, cfg.pre_lookahead_len)
    for layer in model.encoders:
        h = apply_conformer_layer(layer, h, pos_emb, attn_bias, cfg, mask)

    if exact_pad:
        h = h * mask[..., None].to(h.dtype)
    h = _upsample(model.up_conv, h, cfg.upsample_stride)
    up_lengths = token_lengths * cfg.upsample_stride
    mask_up = core.sequence_mask(up_lengths, h.shape[1])
    h, pos_emb_up = model.up_embed(h)
    attn_mask_up = core.chunk_attn_mask(
        mask_up, cfg.static_chunk_size * cfg.upsample_stride if streaming else 0
    )
    attn_bias_up = core.mask_to_bias(attn_mask_up)[:, None, :, :]
    for layer in model.up_encoders:
        h = apply_conformer_layer(layer, h, pos_emb_up, attn_bias_up, cfg, mask_up)
    h = model.encoder_proj(model.after_norm(h))
    return h, up_lengths
