"""The DiT's block linears at f32 accuracy on the tensor cores (3xTF32).

`linear(x, images, bias)` computes y = x W^T + b for x (..., K) f32 rows,
W (N, K) and b (N,) f32, from W's prepared images (`prepare_weight`: the
(2, N, K) tf32 hi and lo parts, in the order the kernel reads them). A
CUDA tensor outside a trace launches `csrc/f32_gemm.cu` (one launch a
call, `LAUNCHES["f32_gemm"]`); CPU tensors and traces take `linear_plain`,
which repeats the kernel's arithmetic: x split as W is (`split_tf32`), then
lo_x hi_W + hi_x lo_W + hi_x hi_W, each a product of tf32 values and so
exact in f32, summed in f32, small terms first. The kernel takes K a
multiple of 32 and N a multiple of 128 and raises on other shapes, dtypes,
devices or layouts; there is no fallback. The source's header says what
bounds the kernel and how its design treats it.

`Operands` holds the images of one linear, or of several side by side (the
DiT's q, k and v as one GEMM), built from the modules' weights at the first
call and again only after a weight was replaced or changed in place. The GEMM has
no gradient through the images, so a call that autograd would have to
differentiate raises, on every device, as the int8 linear does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.kernels import refuse_autograd
from jyutvoice_tpu_torch.nn.resblock_stage import tf32_round

Tensor = torch.Tensor

BLOCK_K = 32  # k-values per stage: K is a multiple
BLOCK_N = 128  # output columns per tile: N is a multiple
# the largest f32 that rounds to a finite tf32 (bits 0x7F7FEFFF); a larger
# magnitude takes the largest finite tf32 as its hi part
SPLIT_MAX = float.fromhex("0x1.ffdffep+127")
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ENTRY = []  # jv_f32_gemm, once loaded


def split_tf32(a: Tensor):
    """(hi, lo) of f32 a, elementwise, as f32 tensors with 13 low mantissa
    bits zero: hi = a rounded to the nearest tf32 (ties away from zero, the
    card's cvt.rna; past the largest finite tf32's range, that value), lo =
    a - hi (exact in f32) rounded the same way, so |a - hi - lo| <= 2^-22
    |a| wherever lo is a normal number. The kernel's `split`, bit for bit."""
    a = a.float()
    hi = tf32_round(a.clamp(-SPLIT_MAX, SPLIT_MAX))
    return hi, tf32_round(a - hi)


def prepare_weight(w: Tensor) -> Tensor:
    """W (N, K) f32 -> its (2, N, K) images: the hi rows, then the lo rows,
    contiguous: the kernel's B operand."""
    return torch.stack(split_tf32(w))


def linear_plain(x: Tensor, images: Tensor, bias=None) -> Tensor:
    """The kernel's arithmetic as plain tensor code: x (..., K), images
    (2, N, K), bias (N,) or None -> (..., N) f32."""
    hi_w, lo_w = images
    hi, lo = split_tf32(x)
    y = F.linear(lo, hi_w) + F.linear(hi, lo_w)
    y = y + F.linear(hi, hi_w)
    return y if bias is None else y + bias


def _entry():
    if not _ENTRY:
        fn = kernels.load("f32_gemm").jv_f32_gemm
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _check(x: Tensor, images: Tensor, bias) -> None:
    if not (x.is_cuda and images.device == x.device
            and (bias is None or bias.device == x.device)):
        raise ValueError("f32 GEMM kernel: x, the images and the bias must share one CUDA "
                         "device")
    if x.dtype != torch.float32 or images.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise ValueError(f"f32 GEMM kernel: x, the images and the bias must be float32, got "
                         f"{x.dtype}, {images.dtype} and {None if bias is None else bias.dtype}")
    if images.dim() != 3 or images.shape[0] != 2 or x.shape[-1] != images.shape[2] \
            or x.shape[-1] % BLOCK_K or images.shape[1] % BLOCK_N:
        raise ValueError(f"f32 GEMM kernel: x (..., K) and images (2, N, K) with K a multiple "
                         f"of {BLOCK_K} and N of {BLOCK_N}, got x {tuple(x.shape)}, images "
                         f"{tuple(images.shape)}")
    n = images.shape[1]
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"f32 GEMM kernel: the bias must be ({n},)")
    if not (x.is_contiguous() and images.is_contiguous()
            and (bias is None or bias.is_contiguous())) \
            or x.data_ptr() % 16 or images.data_ptr() % 16 \
            or (bias is not None and bias.data_ptr() % 8):
        raise ValueError("f32 GEMM kernel: x and the images must be contiguous (16-byte "
                         "aligned), the bias contiguous (8-byte aligned)")


def f32_gemm(x: Tensor, images: Tensor, bias=None) -> Tensor:
    """The kernel: x (..., K) f32 contiguous, images (2, N, K), bias (N,)
    or None -> (..., N) f32. Launches `jv_f32_gemm` on the current stream
    without synchronising; raises on what the kernel does not take."""
    _check(x, images, bias)
    lead, k = x.shape[:-1], x.shape[-1]
    n = images.shape[1]
    m = x.numel() // k
    y = torch.empty((*lead, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    kernels.check(_entry()(x.data_ptr(), images.data_ptr(),
                           0 if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
                           stream), "f32_gemm")
    kernels.count_launch("f32_gemm")
    return y


def linear(x: Tensor, images: Tensor, bias=None) -> Tensor:
    """y = x W^T + b from W's images: the kernel for a CUDA tensor outside
    a trace, else `linear_plain`."""
    refuse_autograd("the f32 GEMM", x)
    if x.is_cuda and not kernels.tracing():
        return f32_gemm(x, images, bias)
    return linear_plain(x, images, bias)


class Operands:
    """The GEMM's operands for linear modules (`weight` (N_i, K), `bias`)
    side by side, their outputs concatenated in order: the images of the
    stacked weights and the concatenated bias. Built at the first call and
    again only when a weight or bias was replaced or changed in place (its
    data pointer or version counter), as `HiFT.prepared_stage` keys kernel
    2's weights; so a model prepares them in its warm-up, once. The old
    images are dropped before new ones are built, and `drop` forgets them
    at once (the DiT's blocks call it when the module is moved or cast)."""

    def __init__(self, *linears):
        if len({m.bias is None for m in linears}) != 1:
            raise ValueError("Operands: every linear has a bias, or none has")
        self.linears = linears
        self.drop()

    def __call__(self, x: Tensor) -> Tensor:
        return linear(x, *self.operands())

    def drop(self) -> None:
        """Forget the images and the bias; the next call builds them anew."""
        self.images = self.bias = self._key = None

    def operands(self):
        """(images (2, N, K), bias (N,) or None), rebuilt if stale."""
        params = [p for m in self.linears for p in (m.weight, m.bias) if p is not None]
        try:
            key = tuple((p.data_ptr(), p._version) for p in params)
        except RuntimeError:  # inference tensors keep no version counter
            key = tuple(p.data_ptr() for p in params)
        if key != self._key:
            self.drop()
            with torch.inference_mode(False), torch.no_grad():
                self.images = prepare_weight(torch.cat([m.weight for m in self.linears]))
                self.bias = None if self.linears[0].bias is None else \
                    torch.cat([m.bias for m in self.linears])
            self._key = key
        return self.images, self.bias
