"""Kernel 3: forward flash attention with segment ids built from lengths.

`flash_stock` launches `csrc/flash_stock.cu` on CUDA tensors and runs
`flash_stock_plain` on CPU tensors. Both compute what JAX's stock TPU flash
kernel (`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`,
non-causal, with `SegmentIds`) computes where the JAX package's estimator
calls it (`jyutvoice_tpu/models/estimator.py::_attend`, "flash_stock"):
the segment id of position i is `i < length`, and query i sees key j iff the
two ids are equal. So valid queries see the valid keys, padded queries see
only the padded keys, and no row is empty: every row, padded ones included,
is a softmax over a non-empty key set. Scores are `q.k` in f32, then scaled
(`s *= sm_scale`, after the product); masked entries get `-0.7 * f32 max`.

Layout: q, k, v are (B, T, H, D), last dim contiguous, any other strides
(the estimator's (B, T, H*D) projections go in as views); the output is a
contiguous (B, T, H, D), i.e. merged heads. lengths (B,) int32. The kernel
takes T a multiple of 64 (the long-form gate sends multiples of 512) and
D in (64, 128); the source's header says what bounds it and what its design
does about that.
"""

from __future__ import annotations

import ctypes

import torch

from jyutvoice_tpu_torch import kernels

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 64  # the kernel's query and key tile
_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_void_p]
)


def segment_keep_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 1, T, T) bool: query i sees key j iff (i < len) == (j < len)."""
    pos = torch.arange(t, device=lengths.device)
    seg = pos[None, :] < lengths[:, None].to(pos.dtype)  # (B, T)
    return (seg[:, :, None] == seg[:, None, :])[:, None]


def flash_stock_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
) -> torch.Tensor:
    """Dense f32 scores, the segment-equality mask, softmax, P.V.
    (B, T, H, D) -> contiguous (B, T, H, D)."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = segment_keep_mask(lengths, t)
    s = s + torch.where(keep, 0.0, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).contiguous()


def _lib():
    lib = kernels.load("flash_stock")
    fn = lib.jv_flash_stock_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError("flash_stock: q, k, v and lengths must share one CUDA device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_stock: q, k, v must be (B, T, H, D) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in (64, 128):
        raise ValueError(f"flash_stock: head dim {q.shape[3]} not in (64, 128)")
    if q.shape[1] % TILE or q.shape[1] == 0:
        raise ValueError(f"flash_stock: T={q.shape[1]} is not a positive multiple of {TILE}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != torch.float32:
            raise ValueError(f"flash_stock: {name} must be float32, got {a.dtype}")
        if a.stride(3) != 1 or any(s % 4 for s in a.stride()[:3]) or a.data_ptr() % 16:
            raise ValueError(f"flash_stock: {name} needs a contiguous last dim, "
                             "strides that are multiples of 4 and 16-byte alignment")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) or not lengths.is_contiguous():
        raise ValueError("flash_stock: lengths must be a contiguous (B,) int32 tensor")


def flash_stock(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
) -> torch.Tensor:
    """(B, T, H, D) q/k/v + (B,) lengths -> (B, T, H, D). CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_stock_plain(q, k, v, lengths, scale=scale)
    _check(q, k, v, lengths)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), device=q.device, dtype=torch.float32)
    fn = _lib()
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lengths.data_ptr(),
        b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "flash_stock")
    kernels.LAUNCHES["flash_stock"] += 1
    return out
