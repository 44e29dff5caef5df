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

`apply_flow_encoder_chunk` is the streaming form (the reference's
forward_chunk): one chunk of tokens at a time over a
`FlowEncoderStreamState` of fixed-capacity KV caches and the two convs'
left-context caches; chained chunks equal `apply_flow_encoder(streaming=
True)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.attention import RelMHA, espnet_rel_pos_emb, rel_mha_chunk

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


# ---------------------------------------------------------------------------
# Streaming: one chunk at a time over KV caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlowEncoderStreamState:
    """Fixed-shape streaming state. Keys and values live in pre-allocated
    (B, H, T_max, D) caches written at `offset`; the pre-lookahead conv2
    and the upsample conv carry exactly the left context they need."""

    offset: int  # tokens already consumed
    conv2_cache: Tensor  # (B, 2, d) pre-lookahead conv2 left context
    enc_kv: List[dict]  # per block {"k", "v"}: (B, H, T_max, D)
    up_conv_cache: Tensor  # (B, 2 * stride, d) repeated-signal left context
    up_kv: List[dict]  # per up block, capacity stride * T_max


def init_stream_state(
    cfg: FlowEncoderConfig, t_max: int, b: int = 1, dtype=torch.float32, chunk: int = 0,
    device="cpu",
) -> FlowEncoderStreamState:
    """t_max is the token capacity. Every chunk writes its full padded width
    into the caches, so the capacity must be a multiple of the chunk: pass
    `chunk` to round t_max up to one."""
    if chunk > 0:
        t_max = -(-t_max // chunk) * chunk
    d, h, s = cfg.output_size, cfg.attention_heads, cfg.upsample_stride

    def kv(cap):
        return {k: torch.zeros((b, h, cap, d // h), dtype=dtype, device=device)
                for k in ("k", "v")}

    return FlowEncoderStreamState(
        offset=0,
        conv2_cache=torch.zeros((b, 2, d), dtype=dtype, device=device),
        enc_kv=[kv(t_max) for _ in range(cfg.num_blocks)],
        up_conv_cache=torch.zeros((b, 2 * s, d), dtype=dtype, device=device),
        up_kv=[kv(s * t_max) for _ in range(cfg.num_up_blocks)],
    )


def _chunk_conformer_stack(layers, h: Tensor, pos_band: Tensor, kv_caches, offset: int,
                           attn_bias: Tensor, n_heads: int) -> Tuple[Tensor, list]:
    new_kv = []
    for layer, cache in zip(layers, kv_caches):
        y, cache = rel_mha_chunk(layer.attn, layer.norm_mha(h, eps=1e-12), pos_band, cache,
                                 offset, attn_bias, n_heads)
        h = h + y
        h = h + layer.ff(layer.norm_ff(h, eps=1e-12))
        new_kv.append(cache)
    return h, new_kv


def _embed_tokens(model: FlowEncoder, tokens: Tensor, n_valid: int) -> Tensor:
    """The token embedding and the linear embed, zero past n_valid."""
    valid = (torch.arange(tokens.shape[1], device=tokens.device) < n_valid)[None, :, None]
    emb = model.input_embedding(torch.clamp(tokens, min=0).long()) * valid
    h = model.embed.norm(model.embed.linear(emb)) * math.sqrt(model.cfg.output_size)
    return h * valid


def apply_flow_encoder_chunk(
    model: FlowEncoder, tokens: Tensor, chunk_len: int, context: Tensor, context_len: int,
    state: FlowEncoderStreamState,
) -> Tuple[Tensor, FlowEncoderStreamState]:
    """One streaming step: (B, c) tokens -> (B, c * stride, 80) hidden frames.

    tokens: the chunk, zero-padded past chunk_len (only the last chunk is
    partial); context (B, pre_lookahead_len): the next chunk's first tokens,
    context_len of them valid (0 at the end). The lookahead conv sees
    [chunk | context], the causal conv2 and the upsample conv continue from
    their caches, and attention sees every cached key plus the chunk. The KV
    caches are written in place; the returned state holds them."""
    cfg = model.cfg
    if cfg.use_cnn_module or cfg.macaron_style:
        raise NotImplementedError(
            "apply_flow_encoder_chunk supports the live FlowEncoder config "
            "(no conv module / macaron, reference infer.py:55-56); use "
            "apply_conformer_layer with cnn_cache for layer-level streaming "
            "of CosyVoice2-style conformer configs"
        )
    c = tokens.shape[1]
    s = cfg.upsample_stride
    t_max = state.enc_kv[0]["k"].shape[2]
    offset = state.offset
    if offset + c > t_max:
        raise ValueError(f"stream exceeds capacity: chunk ends at {offset + c} tokens > "
                         f"t_max={t_max}")

    h = _embed_tokens(model, tokens, chunk_len)
    ctx = _embed_tokens(model, context, context_len)
    # pre-lookahead: conv1 over [chunk | next chunk's context], conv2 causal
    # across chunks through its 2-frame cache
    pre = model.pre_lookahead
    g = core.leaky_relu(pre.conv1(torch.cat([h, ctx], dim=1), padding="valid"), 0.01)
    g_ext = torch.cat([state.conv2_cache.to(g.dtype), g], dim=1)
    new_conv2_cache = g_ext[:, -2:]
    h = pre.conv2(g_ext, padding="valid") + h

    dev = h.device
    pos_band = espnet_rel_pos_emb(t_max, cfg.output_size, device=dev)
    key_ok = torch.arange(t_max, device=dev)[None, None, None, :] < offset + chunk_len
    h, enc_kv = _chunk_conformer_stack(model.encoders, h, pos_band, state.enc_kv, offset,
                                       core.mask_to_bias(key_ok), cfg.attention_heads)

    # the upsample conv across chunk boundaries through the repeated signal
    ext = torch.cat([state.up_conv_cache.to(h.dtype), torch.repeat_interleave(h, s, dim=1)],
                    dim=1)
    new_up_conv_cache = ext[:, -2 * s :]
    hu = model.up_conv(ext, padding="valid")  # (B, c * s, d)
    hu = model.up_embed.norm(model.up_embed.linear(hu)) * math.sqrt(cfg.output_size)

    up_cap = state.up_kv[0]["k"].shape[2]
    pos_band_up = espnet_rel_pos_emb(up_cap, cfg.output_size, device=dev)
    key_ok_up = torch.arange(up_cap, device=dev)[None, None, None, :] < (offset + chunk_len) * s
    hu, up_kv = _chunk_conformer_stack(model.up_encoders, hu, pos_band_up, state.up_kv,
                                       offset * s, core.mask_to_bias(key_ok_up),
                                       cfg.attention_heads)
    hu = model.encoder_proj(model.after_norm(hu))
    return hu, FlowEncoderStreamState(
        offset=offset + chunk_len, conv2_cache=new_conv2_cache, enc_kv=enc_kv,
        up_conv_cache=new_up_conv_cache, up_kv=up_kv,
    )
