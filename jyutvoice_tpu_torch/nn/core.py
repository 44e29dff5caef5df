"""NN primitives on channels-last (B, T, C) tensors.

The counterpart of the JAX package's `nn/core.py`. Leaf modules hold torch-layout
weights (`weight`/`bias`: linear (Cout, Cin), conv (Cout, Cin, K), transposed
conv (Cin, Cout, K)); the functional ops take (B, T, C) activations and return
(B, T, C), transposing around `F.conv1d` where a convolution needs (B, C, T).
The JAX package's `*_matmul` / `*_auto` variants are layout workarounds of the
same math; here each op is one torch call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Leaf modules. Parameters are allocated empty: weights/from_jax.py fills them.
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_dim), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, n_vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_vocab, dim), requires_grad=False)

    def forward(self, ids: Tensor) -> Tensor:
        return F.embedding(ids, self.weight)


class Conv1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size), requires_grad=False
        )
        self.bias = (
            nn.Parameter(torch.empty(out_ch), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor, **kw) -> Tensor:
        return conv1d(x, self.weight, self.bias, **kw)


class ConvTranspose1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel_size), requires_grad=False
        )
        self.bias = (
            nn.Parameter(torch.empty(out_ch), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor, *, stride: int, padding: int = 0) -> Tensor:
        return conv_transpose1d(
            x, self.weight, self.bias, stride=stride, padding=padding
        )


class Conv2d(nn.Module):
    """2-D convolution over NHWC (B, H, W, C); weight (Cout, Cin, KH, KW)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size), requires_grad=False
        )
        self.bias = (
            nn.Parameter(torch.empty(out_ch), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor, stride=(1, 1), padding=(1, 1)) -> Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride, padding)
        return y.permute(0, 2, 3, 1)


class DepthwiseConv1d(nn.Module):
    """Depthwise (groups == channels) 1-D convolution over (B, T, C);
    weight (C, K), bias (C,)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, kernel_size), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels), requires_grad=False)

    def forward(self, x: Tensor, padding="valid") -> Tensor:
        return conv1d(x, self.weight[:, None, :], self.bias, padding=padding,
                      groups=self.weight.shape[0])


class BatchNorm(nn.Module):
    """Inference-mode batch norm over the last (channel) axis, with running
    statistics (torch BatchNorm.eval semantics); affine=False has no
    weight and bias."""

    def __init__(self, channels: int, affine: bool = True):
        super().__init__()
        self.running_mean = nn.Parameter(torch.empty(channels), requires_grad=False)
        self.running_var = nn.Parameter(torch.empty(channels), requires_grad=False)
        self.weight = (
            nn.Parameter(torch.empty(channels), requires_grad=False) if affine else None
        )
        self.bias = (
            nn.Parameter(torch.empty(channels), requires_grad=False) if affine else None
        )

    def forward(self, x: Tensor) -> Tensor:
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim), requires_grad=False)

    def forward(self, x: Tensor, eps: float = 1e-5) -> Tensor:
        return layer_norm(x, self.weight, self.bias, eps)


# ---------------------------------------------------------------------------
# Convolutions over (B, T, C)
# ---------------------------------------------------------------------------


def conv1d(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    *,
    stride: int = 1,
    padding="same_torch",
    dilation: int = 1,
    groups: int = 1,
) -> Tensor:
    """1-D convolution over (B, T, C) with weight (Cout, Cin/groups, K).

    padding: "same_torch" = K//2 * dilation on both sides (torch's
    padding=K//2), "causal" = left-pad (K-1)*dilation, "valid", or an explicit
    (left, right) pair.
    """
    k = weight.shape[-1]
    eff_k = (k - 1) * dilation + 1
    if padding == "same_torch":
        pad = ((k // 2) * dilation, (k // 2) * dilation)
    elif padding == "causal":
        pad = (eff_k - 1, 0)
    elif padding == "valid":
        pad = (0, 0)
    else:
        pad = tuple(padding)
    xc = x.transpose(1, 2)
    if pad[0] == pad[1]:
        y = F.conv1d(xc, weight, bias, stride, pad[0], dilation, groups)
    else:
        y = F.conv1d(F.pad(xc, pad), weight, bias, stride, 0, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    *,
    stride: int,
    padding: int = 0,
) -> Tensor:
    """torch ConvTranspose1d over (B, T, C); weight (Cin, Cout, K).
    Output length (T-1)*stride - 2*padding + K."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride, padding)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last dim (torch nn.LayerNorm semantics)."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def channel_layer_norm(norm: LayerNorm, x: Tensor) -> Tensor:
    """The glow-TTS channel LayerNorm: last-dim LayerNorm with eps 1e-4."""
    return norm(x, eps=1e-4)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


def snake(x: Tensor, alpha: Tensor) -> Tensor:
    """Snake activation x + sin^2(a*x)/a; alpha (C,) broadcasts over (B, T, C)."""
    return x + (1.0 / (alpha + 1e-9)) * torch.square(torch.sin(x * alpha))


def gelu_torch(x: Tensor) -> Tensor:
    """Exact-erf GELU (torch's F.gelu default)."""
    return F.gelu(x)


def silu(x: Tensor) -> Tensor:
    return F.silu(x)


def elu(x: Tensor) -> Tensor:
    return F.elu(x)


def leaky_relu(x: Tensor, slope: float) -> Tensor:
    return torch.where(x >= 0, x, x * slope)


# ---------------------------------------------------------------------------
# Random draws and loss totals of a data-parallel training step
# ---------------------------------------------------------------------------


class BatchRows:
    """This rank's rows [start, start + rows) of a global batch of `total`
    rows in a data-parallel step (`train/step.py`): random draws are made at
    the global batch's shape and cut to these rows, and a loss's
    denominator is summed over the ranks by `reduce`, so the ranks together
    compute what one process computes on the whole batch."""

    def __init__(self, start: int, total: int, reduce: Callable[[Tensor], Tensor]):
        self.start, self.total, self.reduce = start, total, reduce


_ROWS = threading.local()


@contextlib.contextmanager
def batch_rows(rows: Optional[BatchRows]):
    """Run the enclosed loss computation as `rows` of a global batch (None:
    the whole batch, one process)."""
    prev = getattr(_ROWS, "rows", None)
    _ROWS.rows = rows
    try:
        yield
    finally:
        _ROWS.rows = prev


def draw(shape, generator: Optional[torch.Generator], device, dtype=torch.float32,
         normal: bool = False) -> Tensor:
    """torch.rand (normal=False) or torch.randn of `shape` from `generator`,
    whose leading dim is the batch: inside `batch_rows`, drawn at the global
    batch's rows and cut to this rank's."""
    fn = torch.randn if normal else torch.rand
    rows = getattr(_ROWS, "rows", None)
    if rows is None:
        return fn(tuple(shape), generator=generator, device=device, dtype=dtype)
    full = fn((rows.total, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return full[rows.start: rows.start + shape[0]]


def batch_total(x: Tensor) -> Tensor:
    """A loss denominator (a sum over the batch, no gradient): inside
    `batch_rows`, summed over the ranks."""
    rows = getattr(_ROWS, "rows", None)
    return x if rows is None else rows.reduce(x.detach().clone())


def dropout(
    x: Tensor, rate: float, generator: Optional[torch.Generator], deterministic: bool
) -> Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The identity when deterministic,
    at rate 0 or without a generator. Draws come from `generator` only (its
    device must be x's), never from the global RNG; x's leading dim is the
    batch (`draw`)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    u = draw(x.shape, generator, x.device, x.dtype)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


# ---------------------------------------------------------------------------
# Masks and alignment
# ---------------------------------------------------------------------------


def sequence_mask(lengths: Tensor, max_length: int) -> Tensor:
    """(B,) lengths -> (B, T) bool mask."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def subsequent_chunk_mask(
    size: int, chunk_size: int, num_left_chunks: int = -1, device=None
) -> Tensor:
    """(T, T) bool chunk-causal mask."""
    row = torch.arange(size, device=device)
    chunk_idx = row // chunk_size
    ending = torch.clamp((chunk_idx + 1) * chunk_size, max=size)
    if num_left_chunks < 0:
        start = torch.zeros_like(row)
    else:
        start = torch.clamp((chunk_idx - num_left_chunks) * chunk_size, min=0)
    col = torch.arange(size, device=device)
    return (col[None, :] >= start[:, None]) & (col[None, :] < ending[:, None])


def chunk_attn_mask(
    pad_mask: Tensor, static_chunk_size: int, num_left_chunks: int = -1
) -> Tensor:
    """(B, T) bool pad mask -> (B, T, T) bool attention mask (key padding,
    plus the streaming chunk rule when static_chunk_size > 0)."""
    b, t = pad_mask.shape
    keys = pad_mask[:, None, :]
    if static_chunk_size and static_chunk_size > 0:
        cm = subsequent_chunk_mask(
            t, static_chunk_size, num_left_chunks, device=pad_mask.device
        )
        return keys & cm[None, :, :]
    return keys.expand(b, t, t)


def mask_to_bias(mask: Tensor, dtype=torch.float32) -> Tensor:
    """bool mask -> additive bias, 0 kept / -1e10 masked."""
    return (1.0 - mask.to(dtype)) * -1.0e10


def generate_path(duration: Tensor, attn_mask: Tensor) -> Tensor:
    """Durations (B, T_text) -> monotonic path (B, T_text, T_mel): row i
    covers mel frames [cumsum[:i], cumsum[:i+1])."""
    t_y = attn_mask.shape[2]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, device=duration.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).to(attn_mask.dtype)
    prev = F.pad(path, (0, 0, 1, 0))[:, :-1]
    return (path - prev) * attn_mask


def frame_signal(y: Tensor, n_fft: int, hop: int) -> Tensor:
    """(B, L) -> (B, T, n_fft) frames with stride `hop`, no padding."""
    return y.unfold(1, n_fft, hop)
