"""Int8 quantization of the estimator's frozen linears (an optional serving
mode).

The counterpart of the JAX package's `nn/quant.py`:

  * `quantize_linear`: per-output-channel symmetric int8 weights and f32
    scales for one (in, out) linear of a JAX-layout tree;
  * `quantize_estimator`: the same for attention q/k/v/o and ff_in/ff_out of
    every transformer block of an estimator tree, everything else kept f32;
  * `linear_q` and the module `QuantLinear`: dynamic per-row int8
    activations, an int8 x int8 -> int32 product, then the two scales and
    the bias.

As in the JAX package, it is off unless the tree was quantized: the bridge
(`weights/from_jax.py`) loads a leaf with `w_q` into a `QuantLinear` where
the estimator takes one (`QUANTIZABLE` on `PlainMHA` and `TransformerBlock`),
the counterpart of `maybe_linear`'s dispatch by tree structure. The
arithmetic follows the JAX package's order (`acc * sx * scale + b`), so
wherever the int8 activations agree the CPU result matches it to f32
rounding.

The int8 product is plain XLA in the JAX package, not a Pallas kernel. On a
CUDA tensor the port runs it as two kernels of its own
(`csrc/int8_linear.cu`): a one-pass row quantization and an int8 wgmma GEMM
whose epilogue applies both scales and the bias, two launches a call
(`LAUNCHES["int8_quant_rows"]`, `LAUNCHES["int8_gemm"]`), bit-equal to the
plain composition `linear_q_plain` (`quantize_rows`, `int8_matmul`, the f32
epilogue), which CPU tensors take. They take inner sizes that are multiples
of 16 up to 1024 and outer sizes that are multiples of 8, and raise on
others. A torch.export or dynamo trace takes the plain composition, whose
operators it can trace (`torch._int_mm`), so an exported int8 graph holds no
launch through ctypes. The linear has no gradient (the rounding has none),
so a call that autograd would have to differentiate raises, on every
device, as kernels 1 and 2 do.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch
from torch import nn

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.kernels import refuse_autograd
from jyutvoice_tpu_torch.utils.observability import span

Tensor = torch.Tensor

_CUDA_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows
MAX_K = 1024  # the quantization kernel holds a row in registers
_QUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_GEMM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ENTRIES = []  # (jv_int8_quant_rows, jv_int8_gemm), once loaded


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
    own arrays. The U-Net's tree only: a DiT tree has no int8 path."""
    if "down" not in params:
        raise NotImplementedError(
            "quantize_estimator quantizes the U-Net estimator's tree; this tree "
            f"(keys {sorted(params)}) is another estimator's, which has no int8 path")

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


def linear_q_plain(x: Tensor, w_q_t: Tensor, scale: Tensor, bias) -> Tensor:
    """The int8 linear as plain tensor code: `quantize_rows`, `int8_matmul`,
    then `acc * sx * scale + b` in f32, one operation at a time. x (..., in),
    w_q_t (in, out) int8 -> (..., out) f32. What CPU tensors and traces run,
    and what the kernels are held to on the card."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, sx = quantize_rows(x.reshape(-1, k).float())
    acc = int8_matmul(x_q, w_q_t)
    y = acc.float() * sx * scale
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1)


def _entries():
    if not _ENTRIES:
        lib = kernels.load("int8_linear")
        quant_fn, gemm_fn = lib.jv_int8_quant_rows, lib.jv_int8_gemm
        quant_fn.argtypes, quant_fn.restype = _QUANT_ARGTYPES, ctypes.c_int
        gemm_fn.argtypes, gemm_fn.restype = _GEMM_ARGTYPES, ctypes.c_int
        _ENTRIES.append((quant_fn, gemm_fn))
    return _ENTRIES[0]


def _check(x: Tensor, w_q: Tensor, scale: Tensor, bias) -> None:
    n, k = w_q.shape
    if not (x.is_cuda and w_q.device == x.device and scale.device == x.device
            and (bias is None or bias.device == x.device)):
        raise ValueError("int8 linear kernels: x, w_q, scale and the bias must share one "
                         "CUDA device")
    if x.dtype != torch.float32 or w_q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise ValueError(f"int8 linear kernels: x, scale and the bias must be float32 and w_q "
                         f"int8, got {x.dtype}, {scale.dtype}, "
                         f"{None if bias is None else bias.dtype} and {w_q.dtype}")
    if x.shape[-1] != k or k % 16 or k > MAX_K or n % 8:
        raise ValueError(f"int8 linear kernels: inner size a multiple of 16 up to {MAX_K} and "
                         f"outer size a multiple of 8, got x {tuple(x.shape)}, w_q (out, in) "
                         f"{tuple(w_q.shape)}")
    if scale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"int8 linear kernels: scale and the bias must be ({n},)")
    if not (w_q.is_contiguous() and scale.is_contiguous()
            and (bias is None or bias.is_contiguous())) or w_q.data_ptr() % 16 \
            or scale.data_ptr() % 8 or (bias is not None and bias.data_ptr() % 8):
        raise ValueError("int8 linear kernels: w_q must be the contiguous (out, in) buffer "
                         "(16-byte aligned), scale and the bias contiguous (8-byte aligned)")


def _rows(x: Tensor, k: int) -> Tensor:
    """x (..., k) as (M, k) rows at one stride with a unit inner stride,
    16-byte aligned: a view where x's rows are so strided, else a copy."""
    if x.dim() == 2:
        x2 = x
    else:
        try:
            x2 = x.view(-1, k)
        except RuntimeError:  # rows at no single stride
            return x.reshape(-1, k).contiguous()
    if x2.stride(1) != 1 or x2.stride(0) % 4 or x2.data_ptr() % 16:
        return x2.contiguous()
    return x2


def int8_linear(x: Tensor, w_q: Tensor, scale: Tensor, bias=None) -> Tensor:
    """The int8 linear on the card: x (..., in) f32, w_q (out, in) int8 (the
    module's buffer), scale (out,), bias (out,) or None -> (..., out) f32,
    bit-equal to `linear_q_plain`. Launches `jv_int8_quant_rows` (x_q, sx)
    and `jv_int8_gemm` on the current stream, without synchronising, so the
    pair can be captured in a CUDA graph; raises on what the kernels do not
    take."""
    _check(x, w_q, scale, bias)
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[0]
    x2 = _rows(x, k)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y.view(*lead, n)
    # x_q (m, k) int8, then sx (m,) f32 at a 16-byte boundary (k % 16 == 0):
    # one block, freed when the call returns
    scratch = torch.empty(m * k + 4 * m, dtype=torch.uint8, device=x.device)
    x_q = scratch.data_ptr()
    sx = x_q + m * k
    quant_fn, gemm_fn = _entries()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    kernels.check(quant_fn(x2.data_ptr(), x2.stride(0), x_q, sx, m, k, stream), "int8_quant_rows")
    kernels.count_launch("int8_quant_rows")
    kernels.check(gemm_fn(x_q, w_q.data_ptr(), sx, scale.data_ptr(),
                          0 if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
                          stream), "int8_gemm")
    kernels.count_launch("int8_gemm")
    return y.view(*lead, n)


def _linear_q(x: Tensor, w_q: Tensor, scale: Tensor, bias) -> Tensor:
    """x (..., in), w_q (out, in) int8 -> (..., out) f32."""
    refuse_autograd("the int8 linear", x)
    with span("int8.linear"):
        # a CUDA tensor runs the kernels; CPU tensors and a trace (whose
        # tensors are not real) the plain composition
        if x.is_cuda and not kernels.tracing():
            return int8_linear(x, w_q, scale, bias)
        return linear_q_plain(x, w_q.t(), scale, bias)


def linear_q(p: Dict, x: Tensor) -> Tensor:
    """The JAX package's `linear_q`: p {'w_q': int8 (in, out), 'scale': (out,),
    'b'?} as tensors on x's device; x (..., in) -> (..., out) f32. The leaf
    is copied to the contiguous (out, in) buffer a `QuantLinear` holds (256
    KB at the estimator's largest), which the kernels read on the card."""
    return _linear_q(x, p["w_q"].t().contiguous(), p["scale"], p.get("b"))


class QuantLinear(nn.Module):
    """An int8 linear: `w_q` (out, in) int8 and `scale` (out,) f32 buffers,
    an optional bias. `w_q` is held as the transpose of the JAX leaf: the
    K-major operand the GEMM kernel reads as it is, and through `.t()` the
    column-major (in, out) operand of the plain composition's
    torch._int_mm."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.register_buffer("w_q", torch.zeros(out_dim, in_dim, dtype=torch.int8))
        self.register_buffer("scale", torch.empty(out_dim))
        self.bias = (
            nn.Parameter(torch.empty(out_dim), requires_grad=False) if bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        return _linear_q(x, self.w_q, self.scale, self.bias)
