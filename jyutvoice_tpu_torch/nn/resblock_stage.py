"""Kernel 2: one HiFT upsample stage's parallel ResBlocks, fused.

`resblock_stage` launches `csrc/resblock_stage.cu` on CUDA tensors and runs
`resblock_stage_plain` on CPU tensors. Both compute what the JAX package's
Pallas kernel `jyutvoice_tpu/nn/pallas/resblock.py::fused_resblock_stage`
computes: the mean over branches of
    for each dilation d: x = x + conv_k(snake(conv_{k,d}(snake(x, a1)), a2))
with zero "same" padding at the true sequence edges, all in f32.

x is (B, T, C) f32. The weights go in as one flat f32 tensor in the order of
the JAX package's `pack_stage_weights` (`pack_stage_weights` below): per
branch, per step, [w1 (k, C, C) as (tap, in, out), b1, a1, w2, b2, a2]. On
the main path the kernel is bound by f32 arithmetic; the source's header says
how the design treats it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.nn import core

KERNEL_CHANNELS = (8, 16, 32, 64, 128)
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
)


def chain_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """Per-side receptive margin of a full ResBlock chain."""
    h = 0
    for d in dilations:
        h += (kernel_size * d - d) // 2 + (kernel_size - 1) // 2
    return h


def pack_stage_weights(branches, dilations: Sequence[int]) -> torch.Tensor:
    """Flatten ResBlock modules (convs1/convs2/alphas1/alphas2) into the
    kernel's weight order; conv weights go (Cout, Cin, K) -> (K, Cin, Cout)."""
    flat = []
    for br in branches:
        for j in range(len(dilations)):
            for conv, alpha in ((br.convs1[j], br.alphas1[j]), (br.convs2[j], br.alphas2[j])):
                flat += [conv.weight.permute(2, 1, 0).reshape(-1), conv.bias, alpha]
    return torch.cat(flat).contiguous()


def _unpack(weights: torch.Tensor, c: int, kernel_sizes, n_steps: int):
    """Flat weights -> per branch, per step (w1, b1, a1, w2, b2, a2) with the
    convs in torch layout (Cout, Cin, K)."""
    out, off = [], 0

    def take(n):
        nonlocal off
        t = weights[off : off + n]
        off += n
        return t

    for k in kernel_sizes:
        steps = []
        for _ in range(n_steps):
            step = []
            for _ in range(2):
                w = take(k * c * c).view(k, c, c).permute(2, 1, 0)
                step += [w, take(c), take(c)]
            steps.append(step)
        out.append(steps)
    if off != weights.numel():
        raise ValueError(f"resblock_stage: {weights.numel()} weights, layout needs {off}")
    return out


def resblock_stage_plain(
    x: torch.Tensor,
    weights: torch.Tensor,
    *,
    kernel_sizes: Tuple[int, ...],
    dilations: Tuple[int, ...],
) -> torch.Tensor:
    """Unfused stage: separate convs per branch, then the branch mean."""
    c = x.shape[-1]
    acc = None
    for k, steps in zip(kernel_sizes, _unpack(weights, c, kernel_sizes, len(dilations))):
        h = x
        for (w1, b1, a1, w2, b2, a2), d in zip(steps, dilations):
            pad1 = (k * d - d) // 2
            xt = core.conv1d(core.snake(h, a1), w1, b1, padding=(pad1, pad1), dilation=d)
            pad2 = (k - 1) // 2
            xt = core.conv1d(core.snake(xt, a2), w2, b2, padding=(pad2, pad2))
            h = xt + h
        acc = h if acc is None else acc + h
    return acc / len(kernel_sizes)


def _lib():
    lib = kernels.load("resblock_stage")
    fn = lib.jv_resblock_stage_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.jv_resblock_stage_tile.argtypes = [ctypes.c_int]
        lib.jv_resblock_stage_tile.restype = ctypes.c_int
    return lib


def resblock_stage(
    x: torch.Tensor,
    weights: torch.Tensor,
    *,
    kernel_sizes: Tuple[int, ...],
    dilations: Tuple[int, ...],
) -> torch.Tensor:
    """(B, T, C) -> (B, T, C). CUDA tensors launch the kernel; CPU tensors
    take the plain version. Forward only: raises when autograd would need a
    gradient through it."""
    kernels.refuse_autograd("resblock_stage", x, weights)
    if x.device.type == "cpu":
        return resblock_stage_plain(
            x, weights, kernel_sizes=kernel_sizes, dilations=dilations
        )
    if not (x.is_cuda and weights.device == x.device):
        raise ValueError("resblock_stage: x and weights must share one CUDA device")
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("resblock_stage: x and weights must be float32")
    if x.dim() != 3 or not x.is_contiguous() or not weights.is_contiguous():
        raise ValueError("resblock_stage: x must be a contiguous (B, T, C) tensor")
    b, t, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"resblock_stage: C={c} not in {KERNEL_CHANNELS}")
    if not 1 <= len(kernel_sizes) <= 4 or not 1 <= len(dilations) <= 4:
        raise ValueError("resblock_stage: 1-4 branches and 1-4 steps")
    need = sum(len(dilations) * (2 * k * c * c + 4 * c) for k in kernel_sizes)
    if weights.numel() != need:
        raise ValueError(f"resblock_stage: {weights.numel()} weights, layout needs {need}")
    lib = _lib()
    halo = max(chain_halo(k, dilations) for k in kernel_sizes)
    tile = lib.jv_resblock_stage_tile(c)
    n_tiles = -(-t // tile)
    out = torch.empty_like(x)
    scratch = torch.empty(b * n_tiles * (tile + 2 * halo) * c, device=x.device,
                          dtype=torch.float32)
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    dil = (ctypes.c_int * len(dilations))(*dilations)
    status = lib.jv_resblock_stage_fwd(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), weights.data_ptr(),
        b, t, c, len(kernel_sizes), ks, len(dilations), dil, halo,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(status, "resblock_stage")
    kernels.LAUNCHES["resblock_stage"] += 1
    return out
