"""Kernel 1: forward flash attention with inline key-padding and chunk masks.

`flash_attention` launches `csrc/flash_attention.cu` on CUDA tensors and runs
`flash_attention_plain` on CPU tensors. Both compute what the JAX package's
Pallas kernel `jyutvoice_tpu/nn/pallas/attention.py::flash_attention`
computes, with its rounding points: q is scaled in f32 and rounded to bf16,
k and v are rounded to bf16, the probabilities are rounded to bf16 before
P.V, and everything accumulates in f32. Query rows whose keys are all
masked are not meaningful (the caller masks them downstream): the kernel
writes 0 there, the plain version the mean of v.

Layout: q, k, v are (B, T, H, D), last dim contiguous, any other strides (so
views of (B, T, H*D) projections go in without a copy); the
output is a contiguous (B, T, H, D), i.e. merged heads. lengths (B,) are
the valid key lengths. At the short path's T the kernel is bound by memory
traffic (and in practice by latency and the host), in the top mel bucket
by operations; the source's header says how the design treats both.
"""

from __future__ import annotations

import ctypes

import torch

from jyutvoice_tpu_torch import kernels

NEG_INF = -1e30
_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def key_keep_mask(
    lengths: torch.Tensor, t: int, chunk_size: int, num_left_chunks: int
) -> torch.Tensor:
    """(B, 1, T, T) bool: key j is visible to query i (padding + chunk rule)."""
    pos = torch.arange(t, device=lengths.device)
    keep = (pos[None, None, :] < lengths[:, None, None].to(pos.dtype))  # (B,1,Tk)
    if chunk_size > 0:
        chunk_idx = pos // chunk_size
        ending = (chunk_idx + 1) * chunk_size
        if num_left_chunks >= 0:
            start = torch.clamp((chunk_idx - num_left_chunks) * chunk_size, min=0)
        else:
            start = torch.zeros_like(pos)
        band = (pos[None, :] < ending[:, None]) & (pos[None, :] >= start[:, None])
        keep = keep & band[None]
    return keep[:, None]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    chunk_size: int = 0,
    num_left_chunks: int = -1,
) -> torch.Tensor:
    """Dense masked softmax in the kernel's rounding. (B, T, H, D) -> same."""
    t = q.shape[1]
    bf16 = torch.bfloat16
    q16 = (q.float() * scale).to(bf16).float()
    k16 = k.to(bf16).float()
    v16 = v.to(bf16).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q16, k16)
    keep = key_keep_mask(lengths, t, chunk_size, num_left_chunks)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # (B, H, Tq)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(bf16).float(), v16)
    out = out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.contiguous()


def _lib():
    lib = kernels.load("flash_attention")
    fn = lib.jv_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError("flash_attention: q, k, v and lengths must share one CUDA device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must be (B, T, H, D) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in (64, 128):
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in (64, 128)")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != torch.float32:
            raise ValueError(f"flash_attention: {name} must be float32, got {a.dtype}")
        if a.stride(3) != 1 or any(s % 4 for s in a.stride()[:3]) or a.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous last dim, "
                             "strides that are multiples of 4 and 16-byte alignment")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) or not lengths.is_contiguous():
        raise ValueError("flash_attention: lengths must be a contiguous (B,) int32 tensor")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    chunk_size: int = 0,
    num_left_chunks: int = -1,
) -> torch.Tensor:
    """(B, T, H, D) q/k/v + (B,) lengths -> (B, T, H, D). CUDA tensors launch
    the kernel; CPU tensors take the plain version. Forward only: raises
    when autograd would need a gradient through it."""
    kernels.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, lengths, scale=scale, chunk_size=chunk_size,
            num_left_chunks=num_left_chunks,
        )
    _check(q, k, v, lengths)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), device=q.device, dtype=torch.float32)
    fn = _lib()
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lengths.data_ptr(),
        b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(chunk_size), int(num_left_chunks),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "flash_attention")
    kernels.count_launch("flash_attention")
    return out
