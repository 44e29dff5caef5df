"""Int8 quantization of the estimator's frozen linears (an optional serving
mode).

The counterpart of the JAX package's `nn/quant.py`:

  * `quantize_linear`: per-output-channel symmetric int8 weights and f32
    scales for one (in, out) linear of a JAX-layout tree;
  * `quantize_estimator`: the same for attention q/k/v/o and ff_in/ff_out of
    every transformer block of an estimator tree, everything else kept f32;
  * `linear_q` and the module `QuantLinear`: dynamic per-row int8
    activations, an int8 x int8 -> int32 product (`torch._int_mm`, on the
    CPU and on the card), then the two scales and the bias.

As in the JAX package, it is off unless the tree was quantized: the bridge
(`weights/from_jax.py`) loads a leaf with `w_q` into a `QuantLinear` where
the estimator takes one (`QUANTIZABLE` on `PlainMHA` and `TransformerBlock`),
the counterpart of `maybe_linear`'s dispatch by tree structure. The int8
product is plain XLA in the JAX package, not a Pallas kernel, so a library
product is its port. The arithmetic follows the JAX package's order
(`acc * sx * scale + b`), so wherever the int8 activations agree the CPU
result matches it to f32 rounding.

On a CUDA tensor the product is `torch._int_mm` or an error, never an f32
matmul: its cuBLASLt route needs more than 16 rows (fewer are padded with
zero rows) and inner and outer sizes that are multiples of 8 (others
raise). It has no gradient (the rounding has none), so a call that autograd
would have to differentiate raises, on every device, as kernels 1 and 2
do.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from jyutvoice_tpu_torch.kernels import refuse_autograd
from jyutvoice_tpu_torch.utils.observability import span

Tensor = torch.Tensor

_CUDA_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows


def quantize_linear(p: Dict) -> Dict:
    """{'w': (in, out), 'b'?} -> {'w_q': int8 (in, out), 'scale': (out,) f32,
    'b'?}, numpy arrays, computed in f32 as the JAX package does: max|w| / 127
    per output column, at least 1e-12, rounded half to even, clipped to
    +-127."""
    w = np.asarray(p["w"], np.float32)
    scale = np.max(np.abs(w), axis=0) / np.float32(127.0)  # (out,)
    scale = np.maximum(scale, np.float32(1e-12))
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = np.asarray(p["b"], np.float32)
    return out


def quantize_estimator(params: Dict) -> Dict:
    """Quantize attention q/k/v/o and ff_in/ff_out of every transformer block
    of an estimator tree; the convs, norms and time MLP stay f32 (a small
    share of the operations). Leaves that are not quantized are the input's
    own arrays."""

    def q_block(blk):
        return {
            "norm1": blk["norm1"],
            "attn": {k: quantize_linear(v) for k, v in blk["attn"].items()},
            "norm3": blk["norm3"],
            "ff_in": quantize_linear(blk["ff_in"]),
            "ff_out": quantize_linear(blk["ff_out"]),
        }

    def q_stage(stage):
        return {
            "resnet": stage["resnet"],
            "blocks": [q_block(b) for b in stage["blocks"]],
        }

    return {
        "time_mlp": params["time_mlp"],
        "down": q_stage(params["down"]),
        "down_conv": params["down_conv"],
        "mid": [q_stage(s) for s in params["mid"]],
        "up": q_stage(params["up"]),
        "up_conv": params["up_conv"],
        "final_block": params["final_block"],
        "final_proj": params["final_proj"],
    }


def quantize_rows(x: Tensor):
    """Dynamic per-row int8 quantization of x (M, in) f32:
    (x_q int8 (M, in), sx (M, 1) f32) with sx = max(max|x| / 127, 1e-12) and
    x_q = clip(round(x / sx), -127, 127), rounded half to even. Both are
    true divisions: a CUDA tensor divided by a Python number is multiplied
    by its reciprocal instead, which moves sx by an ulp in some rows."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return x_q, sx


def int8_matmul(x_q: Tensor, w_q_t: Tensor) -> Tensor:
    """x_q (M, in) int8 @ w_q_t (in, out) int8 -> (M, out) int32. On CUDA the
    rows are padded to 17 where fewer (zero rows, cut off after), and inner
    or outer sizes that are not multiples of 8 raise."""
    if not x_q.is_cuda:
        return torch._int_mm(x_q, w_q_t)
    m, k = x_q.shape
    n = w_q_t.shape[1]
    if k % 8 or n % 8:
        raise ValueError(
            f"int8 linear on CUDA needs inner and outer sizes that are multiples of 8 "
            f"(torch._int_mm), got {k} -> {n}"
        )
    if m < _CUDA_MIN_ROWS:
        pad = torch.zeros((_CUDA_MIN_ROWS - m, k), dtype=x_q.dtype, device=x_q.device)
        return torch._int_mm(torch.cat([x_q, pad]), w_q_t)[:m]
    return torch._int_mm(x_q, w_q_t)


def _linear_q(x: Tensor, w_q_t: Tensor, scale: Tensor, bias) -> Tensor:
    refuse_autograd("the int8 linear", x)
    with span("int8.linear"):
        lead, k = x.shape[:-1], x.shape[-1]
        x_q, sx = quantize_rows(x.reshape(-1, k).float())
        acc = int8_matmul(x_q, w_q_t)
        y = acc.float() * sx * scale
        if bias is not None:
            y = y + bias
        return y.reshape(*lead, -1)


def linear_q(p: Dict, x: Tensor) -> Tensor:
    """The JAX package's `linear_q`: p {'w_q': int8 (in, out), 'scale': (out,),
    'b'?} as tensors on x's device; x (..., in) -> (..., out) f32."""
    return _linear_q(x, p["w_q"], p["scale"], p.get("b"))


class QuantLinear(nn.Module):
    """An int8 linear: `w_q` (out, in) int8 and `scale` (out,) f32 buffers,
    an optional bias. `w_q` is held as the transpose of the JAX leaf, so the
    product reads it through `.t()`, the column-major (in, out) operand that
    cuBLASLt's int8 route takes."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.register_buffer("w_q", torch.zeros(out_dim, in_dim, dtype=torch.int8))
        self.register_buffer("scale", torch.empty(out_dim))
        self.bias = (
            nn.Parameter(torch.empty(out_dim), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        return _linear_q(x, self.w_q.t(), self.scale, self.bias)
