"""Kernel 2: one HiFT upsample stage's parallel ResBlocks, fused.

`resblock_stage` launches `csrc/resblock_stage.cu` on CUDA tensors and runs
`resblock_stage_plain` on CPU tensors. Both compute what the JAX package's
Pallas kernel `jyutvoice_tpu/nn/pallas/resblock.py::fused_resblock_stage`
computes: the mean over branches of
    for each dilation d: x = x + conv_k(snake(conv_{k,d}(snake(x, a1)), a2))
with zero "same" padding at the true sequence edges, at f32 accuracy.

x is (B, T, C) f32. The weights go in as one flat f32 tensor in the order of
the JAX package's `pack_stage_weights` (`pack_stage_weights` below): per
branch, per step, [w1 (k, C, C) as (tap, in, out), b1, a1, w2, b2, a2].
The kernel runs its products on the tensor cores in 3xTF32 and takes its
weights in another layout, built once by `prepare_stage_weights`: HiFT holds
the result per stage and calls `resblock_stage_prepared`, which reaches the
kernel through the op `jyutvoice::resblock_stage` (`resblock_stage_op`:
the plain version on the CPU, the launch on CUDA, a fake for torch.export).
The source's header says what bounds the kernel and how the design treats it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.nn import core

KERNEL_CHANNELS = (8, 16, 32, 64, 128)
CHUNK_CHANNELS = 32  # input channels per weight chunk: one 128-byte tf32 row
_ARGTYPES = (
    [ctypes.c_void_p] * 5
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
    JAX package's weight order; conv weights go (Cout, Cin, K) -> (K, Cin, Cout)."""
    flat = []
    for br in branches:
        for j in range(len(dilations)):
            for conv, alpha in ((br.convs1[j], br.alphas1[j]), (br.convs2[j], br.alphas2[j])):
                flat += [conv.weight.permute(2, 1, 0).reshape(-1), conv.bias, alpha]
    return torch.cat(flat).contiguous()


def _split(weights: torch.Tensor, c: int, kernel_sizes, n_steps: int):
    """Flat weights -> per branch, per step [w1 (k, Cin, Cout), b1, a1, w2, b2, a2]."""
    need = sum(n_steps * (2 * k * c * c + 4 * c) for k in kernel_sizes)
    if weights.dim() != 1 or weights.numel() != need:
        raise ValueError(f"resblock_stage: {weights.numel()} weights, layout needs {need}")
    out, off = [], 0
    for k in kernel_sizes:
        steps = []
        for _ in range(n_steps):
            step = []
            for _ in range(2):
                step.append(weights[off : off + k * c * c].view(k, c, c))
                step += [weights[off + k * c * c : off + k * c * c + c],
                         weights[off + k * c * c + c : off + k * c * c + 2 * c]]
                off += k * c * c + 2 * c
            steps.append(step)
        out.append(steps)
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
    for k, steps in zip(kernel_sizes, _split(weights, c, kernel_sizes, len(dilations))):
        h = x
        for (w1, b1, a1, w2, b2, a2), d in zip(steps, dilations):
            pad1 = (k * d - d) // 2
            xt = core.conv1d(core.snake(h, a1), w1.permute(2, 1, 0), b1,
                             padding=(pad1, pad1), dilation=d)
            pad2 = (k - 1) // 2
            xt = core.conv1d(core.snake(xt, a2), w2.permute(2, 1, 0), b2, padding=(pad2, pad2))
            h = xt + h
        acc = h if acc is None else acc + h
    return acc / len(kernel_sizes)


# ---------------------------------------------------------------------------
# The kernel's weight layout
# ---------------------------------------------------------------------------


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 (10 mantissa bits), ties away from zero, as
    f32: the card's cvt.rna.tf32.f32, by bit arithmetic."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@functools.lru_cache(maxsize=8)
def _swizzle_index(rows: int) -> np.ndarray:
    r = np.arange(rows)[:, None]
    c = np.arange(CHUNK_CHANNELS)[None, :]
    return (r * CHUNK_CHANNELS + (((c // 4) ^ (r % 8)) * 4) + c % 4).reshape(-1)


def swizzle_index(rows: int) -> torch.Tensor:
    """Position of element (r, c) of a (rows x 32) f32 tile in its 128-byte-
    swizzled image (16-byte chunk c // 4 of row r stored at chunk
    (c // 4) ^ (r % 8)), flattened: what wgmma reads as a K-major operand.
    The permutation is its own inverse. The cache holds numpy, so a tensor
    made while torch.export traces is never kept."""
    return torch.from_numpy(_swizzle_index(rows).copy())


def pass_channels(c: int) -> int:
    """Output channels the kernel computes per pass of a conv at C channels
    (`Geo<C>::NB` in the source): 64 at C=128, else all."""
    return 64 if c == 128 else c


def _conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """One conv's (k, Cin, Cout) weights -> its chunks (passes * k *
    ceil(Cin / 32), 2 (hi, lo), NB * 32): per pass of NB output channels, tap
    and group of 32 input channels (zero-padded to 32), the (NB x 32)
    K-major slice, swizzled, split in tf32."""
    k, cin, cout = w.shape
    nb = pass_channels(cout)
    kp = -(-cin // CHUNK_CHANNELS) * CHUNK_CHANNELS
    w = torch.nn.functional.pad(w, (0, 0, 0, kp - cin))  # (k, kp, cout)
    # (pass, tap, in group, NB out, 32 in)
    w = w.view(k, kp // CHUNK_CHANNELS, CHUNK_CHANNELS, cout // nb, nb).permute(3, 0, 1, 4, 2)
    # the swizzle swaps chunk pairs, so gathering through it also scatters
    tiles = w.reshape(-1, nb * CHUNK_CHANNELS)[:, swizzle_index(nb).to(w.device)]
    hi = tf32_round(tiles)
    lo = tf32_round(tiles - hi)
    return torch.stack([hi, lo], dim=1)


@dataclasses.dataclass(frozen=True)
class PreparedStage:
    """One stage's weights, as the plain version and as the kernel take them.

    flat: the JAX-layout flat weights (`pack_stage_weights`);
    tiles: the conv weights, per branch, step, conv, pass of NB output
      channels (`pass_channels`), tap and 32 input channels, the hi then the
      lo tf32 part of a swizzled (NB x 32) K-major tile;
    params: per branch and step [b1, a1, 1/(a1 + 1e-9), b2, a2, 1/(a2 + 1e-9)].
    """

    flat: torch.Tensor
    tiles: torch.Tensor
    params: torch.Tensor
    channels: int
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]


def tiles_numel(c: int, kernel_sizes: Sequence[int], n_steps: int) -> int:
    """Floats of the kernel's weight tiles for one stage."""
    chunks_per_tap = -(-c // CHUNK_CHANNELS)
    return sum(n_steps * 2 * k for k in kernel_sizes) * chunks_per_tap * 2 * c * CHUNK_CHANNELS


def prepare_stage_weights(
    weights: torch.Tensor,
    channels: int,
    kernel_sizes: Sequence[int],
    dilations: Sequence[int],
) -> PreparedStage:
    """JAX-layout flat weights -> the kernel's layout (plain PyTorch, once
    per model)."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    weights = weights.detach().contiguous()
    tiles, params = [], []
    with torch.no_grad():
        for steps in _split(weights, channels, kernel_sizes, len(dilations)):
            for w1, b1, a1, w2, b2, a2 in steps:
                tiles += [_conv_tiles(w1), _conv_tiles(w2)]
                params += [b1, a1, 1.0 / (a1 + 1e-9), b2, a2, 1.0 / (a2 + 1e-9)]
        tiles = torch.cat(tiles).reshape(-1).contiguous()
        params = torch.cat(params).contiguous()
    return PreparedStage(weights, tiles, params, channels, kernel_sizes, dilations)


# ---------------------------------------------------------------------------
# The tile length and the work it costs
# ---------------------------------------------------------------------------


def conv_rows(tt: int, kernel_size: int, dilations: Sequence[int]):
    """(rows, dilation) of each conv a block runs for one branch, in order."""
    w = tt + 2 * chain_halo(kernel_size, dilations)
    out = []
    for d in dilations:
        p1, p2 = (kernel_size * d - d) // 2, (kernel_size - 1) // 2
        out += [(w - 2 * p1, d), (w - 2 * p1 - 2 * p2, 1)]
        w -= 2 * (p1 + p2)
    return out


def block_tile_rows(tt: int, kernel_sizes: Sequence[int], dilations: Sequence[int]) -> int:
    """Sum over a block's convs of taps x rows rounded up to wgmma's 64-row
    tiles: the block's tensor-core work in units of one tap of 64 rows."""
    return sum(k * 64 * -(-rows // 64)
               for k in kernel_sizes for rows, _ in conv_rows(tt, k, dilations))


def pick_tile(t: int, b: int, kernel_sizes: Sequence[int], dilations: Sequence[int],
              rows: int, sms: int) -> int:
    """Output rows per block: the longest the window of `rows` rows leaves
    after the halos, or a shorter one where the grid's waves (one block per
    SM) times a block's work is less (a short grid's last wave would
    otherwise leave most SMs idle)."""
    halo = max(chain_halo(k, dilations) for k in kernel_sizes)
    tt_max = rows - 2 * halo
    if tt_max < 8:
        raise ValueError(f"resblock_stage: a halo of {halo} rows leaves no tile in {rows} rows")
    best, best_cost = tt_max, None
    for tt in range(tt_max, max(8, tt_max // 2) - 1, -8):
        waves = -(-b * -(-t // tt) // sms)
        cost = waves * block_tile_rows(tt, kernel_sizes, dilations)
        if best_cost is None or cost < best_cost:
            best, best_cost = tt, cost
    return best


def recompute_factor(t: int, b: int, tt: int, kernel_sizes: Sequence[int],
                     dilations: Sequence[int]) -> float:
    """The tensor-core work the kernel does (64-row tiles, halos, the last
    tile's rows past T) over the stage's own."""
    useful = b * t * 2 * len(dilations) * sum(kernel_sizes)
    return b * -(-t // tt) * block_tile_rows(tt, kernel_sizes, dilations) / useful


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    lib = kernels.load("resblock_stage")
    fn = lib.jv_resblock_stage_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        for name in ("jv_resblock_stage_rows", "jv_resblock_stage_pass_channels",
                     "jv_resblock_stage_scratch"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def launch_tile(t: int, b: int, c: int, kernel_sizes: Sequence[int], dilations: Sequence[int],
                device: torch.device) -> int:
    """The output rows per block the kernel runs with for this launch."""
    rows = _lib().jv_resblock_stage_rows(c)
    return pick_tile(t, b, kernel_sizes, dilations, rows, _sm_count(device.index or 0))


@torch.library.custom_op("jyutvoice::resblock_stage", mutates_args=(), device_types="cpu")
def resblock_stage_op(
    x: torch.Tensor,
    flat: torch.Tensor,
    tiles: torch.Tensor,
    params: torch.Tensor,
    kernel_sizes: List[int],
    dilations: List[int],
) -> torch.Tensor:
    """Kernel 2 as the op `jyutvoice::resblock_stage`: (B, T, C) -> (B, T, C)
    from one stage's weights in both layouts (`PreparedStage`'s flat, tiles
    and params). CPU tensors take the plain version (this function); CUDA
    tensors launch the kernel (`_resblock_stage_cuda`); under torch.export
    the fake implementation stands in, so an exported graph holds the op as
    one node that runs wherever this module is imported."""
    out = resblock_stage_plain(x, flat, kernel_sizes=tuple(kernel_sizes),
                               dilations=tuple(dilations))
    return out.contiguous()


@resblock_stage_op.register_fake
def _resblock_stage_fake(x, flat, tiles, params, kernel_sizes, dilations):
    return x.new_empty(x.shape)


@resblock_stage_op.register_kernel("cuda")
def _resblock_stage_cuda(x, flat, tiles, params, kernel_sizes, dilations):
    """The launch: checks what the kernel takes (raises on the rest), runs
    on the current stream and counts the launch."""
    ks, dil = tuple(kernel_sizes), tuple(dilations)
    if not (x.is_cuda and tiles.device == x.device and params.device == x.device):
        raise ValueError("resblock_stage: x and the weights must share one CUDA device")
    if torch.float32 != x.dtype or {tiles.dtype, params.dtype} != {torch.float32}:
        raise ValueError("resblock_stage: x and weights must be float32")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resblock_stage: x must be a contiguous (B, T, C) tensor")
    b, t, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"resblock_stage: C={c} not in {KERNEL_CHANNELS}")
    if not 1 <= len(ks) <= 4 or not 1 <= len(dil) <= 4:
        raise ValueError("resblock_stage: 1-4 branches and 1-4 steps")
    if (tiles.dim() != 1 or not tiles.is_contiguous()
            or tiles.numel() != tiles_numel(c, ks, len(dil))
            or not params.is_contiguous()
            or params.numel() != 6 * c * len(ks) * len(dil)):
        raise ValueError(
            f"resblock_stage: prepared weights are not the kernel's layout for C={c}, "
            f"kernel sizes {ks}, dilations {dil} (use prepare_stage_weights)")
    lib = _lib()
    if lib.jv_resblock_stage_pass_channels(c) != pass_channels(c):
        raise RuntimeError("resblock_stage: the kernel's passes differ from pass_channels()")
    tt = launch_tile(t, b, c, ks, dil, x.device)
    out = torch.empty_like(x)
    scratch = torch.empty(b * -(-t // tt) * lib.jv_resblock_stage_scratch(c), device=x.device,
                          dtype=torch.float32)
    status = lib.jv_resblock_stage_fwd(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), tiles.data_ptr(),
        params.data_ptr(), b, t, c, len(ks), (ctypes.c_int * len(ks))(*ks), len(dil),
        (ctypes.c_int * len(dil))(*dil), tt, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(status, "resblock_stage")
    kernels.count_launch("resblock_stage")
    return out


def resblock_stage_prepared(x: torch.Tensor, stage: PreparedStage) -> torch.Tensor:
    """(B, T, C) -> (B, T, C) with prepared weights, through the op
    `jyutvoice::resblock_stage` on every device: CUDA tensors launch the
    kernel, CPU tensors take the plain version. Forward only: raises when
    autograd would need a gradient through it."""
    kernels.refuse_autograd("resblock_stage", x, stage.flat)
    ks, dil = stage.kernel_sizes, stage.dilations
    if stage.channels != x.shape[-1]:
        raise ValueError(
            f"resblock_stage: prepared weights are not the kernel's layout for "
            f"C={x.shape[-1]}, kernel sizes {ks}, dilations {dil} (prepared for "
            f"C={stage.channels})")
    return resblock_stage_op(x, stage.flat, stage.tiles, stage.params, list(ks), list(dil))


def resblock_stage(
    x: torch.Tensor,
    weights: torch.Tensor,
    *,
    kernel_sizes: Tuple[int, ...],
    dilations: Tuple[int, ...],
) -> torch.Tensor:
    """(B, T, C) -> (B, T, C) from the JAX-layout flat weights. CUDA tensors
    prepare the kernel's layout for this call and launch the kernel; CPU
    tensors take the plain version. Forward only."""
    kernels.refuse_autograd("resblock_stage", x, weights)
    if x.device.type == "cpu":
        return resblock_stage_plain(x, weights, kernel_sizes=kernel_sizes, dilations=dilations)
    if x.shape[-1] not in KERNEL_CHANNELS:
        raise ValueError(f"resblock_stage: C={x.shape[-1]} not in {KERNEL_CHANNELS}")
    if weights.dtype != torch.float32:
        raise ValueError("resblock_stage: x and weights must be float32")
    stage = prepare_stage_weights(weights, x.shape[-1], kernel_sizes, dilations)
    return resblock_stage_prepared(x, stage)
