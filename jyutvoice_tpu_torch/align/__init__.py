"""Monotonic Alignment Search.

Two implementations of the same Viterbi max-path DP, the counterparts of
the JAX package's `align/__init__.py`:

  * `maximum_path`, on the tensors' device: the counterpart of
    `maximum_path_jax`, which `compute_losses` calls. The DP as a forward
    wavefront over mel frames, vectorised over text positions, then the same
    reverse backtrack carrying the current text index. Plain torch under
    `no_grad`: the JAX package computes it in XLA, not in a Pallas kernel.
  * `maximum_path_host`, on the host: the counterpart of the JAX package's
    `maximum_path`. numpy in, numpy out, through `mas.cpp` (a byte-for-byte
    copy of the JAX package's, OpenMP over the batch), built with g++ at
    first use into `jyutvoice_tpu_torch/_build/` under a name hashed from its
    source and bound by ctypes; without g++ it logs a warning and takes the
    numpy DP `_maximum_path_numpy`.

The DP over value (B, t_x, t_y), masked by `mask`, for one row with text
length n and mel length m:
    V[x, y] = max(V[x, y-1], V[x-1, y-1]) + value[x, y]   inside the band
with V[0, 0] = value[0, 0] and the band lo <= x < hi,
lo = max(0, n + y - m), hi = min(n, y + 1). Cells outside the band hold
-inf in `maximum_path` where the host versions (and the JAX package) write
-1e9; with n <= m every cell of the band has a predecessor inside it, so the
sums and the path are the same. The backtrack moves down one text position
out of (x, y) when x == y or V[x, y-1] < V[x-1, y-1].

`maximum_path`'s loops run t_y steps of two small kernels; what that costs on
the card, and what the host version costs with its device-to-host copy, is
measured by `chip_smoke.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.kernels import BUILD_DIR

Tensor = torch.Tensor
_log = logging.getLogger(__name__)


@torch.no_grad()
def maximum_path(value: Tensor, mask: Tensor) -> Tensor:
    """value, mask (B, t_x, t_y) -> the 0/1 monotonic path (B, t_x, t_y) f32."""
    value = value.float() * mask
    b, t_x, t_y = value.shape
    dev = value.device
    ninf = float("-inf")
    t_xs = mask[:, :, 0].sum(dim=1).to(torch.int64)  # (B,)
    t_ys = mask[:, 0, :].sum(dim=1).to(torch.int64)
    xs = torch.arange(t_x, device=dev)
    ys = torch.arange(t_y, device=dev)
    lo = torch.clamp(t_xs[:, None] + ys[None, :] - t_ys[:, None], min=0)  # (B, t_y)
    hi = torch.minimum(t_xs[:, None], ys[None, :] + 1)
    in_band = (xs[None, :, None] >= lo[:, None, :]) & (xs[None, :, None] < hi[:, None, :])
    vals = torch.where(in_band, value, ninf).permute(2, 0, 1).contiguous()  # (t_y, B, t_x)

    # forward wavefront, one (B, t_x) row per mel frame. Column 0 of the
    # buffer stays -inf, so row y-1 read at [:-1] is V[x-1, y-1]
    v = torch.full((t_y, b, t_x + 1), ninf, device=dev)
    v[0, :, 1:] = torch.where(xs == 0, 0.0, ninf) + vals[0]  # the start (0, 0)
    for y in range(1, t_y):
        row = v[y, :, 1:]
        torch.maximum(v[y - 1, :, 1:], v[y - 1, :, :-1], out=row)
        row.add_(vals[y])

    # backtrack: the move out of (x, y) depends on V[:, y-1] alone, so every
    # cell's decision is computed at once and the reverse loop only follows
    # them
    active = ys[None, :] < t_ys[:, None]  # (B, t_y)
    cur = v[:, :, 1:].permute(1, 2, 0)  # V as (B, t_x, t_y)
    prev = torch.full_like(cur, ninf)
    prev[:, :, 1:] = cur[:, :, :-1]  # V[x, y-1]
    prev_lower = torch.full_like(cur, ninf)
    prev_lower[:, 1:, 1:] = cur[:, :-1, :-1]  # V[x-1, y-1]
    move = (xs[None, :, None] != 0) & (
        (xs[None, :, None] == ys[None, None, :]) | (prev < prev_lower)
    ) & active[:, None, :]
    move = move.to(torch.int64).permute(2, 0, 1).contiguous()  # (t_y, B, t_x)
    index = torch.clamp(t_xs - 1, min=0)[:, None]  # (B, 1)
    path_idx = [None] * t_y
    for y in range(t_y - 1, -1, -1):
        path_idx[y] = index
        index = index - move[y].gather(1, index)
    path_idx = torch.cat(path_idx, dim=1)  # (B, t_y)
    path = (xs[None, :, None] == path_idx[:, None, :]) & active[:, None, :]
    return path.float() * mask


# ---------------------------------------------------------------------------
# Host MAS: mas.cpp through ctypes, the numpy DP without g++
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mas.cpp")
_GXX = ("g++", "-O3", "-shared", "-fPIC")
_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _lib_path() -> str:
    """The library's path under _build/, named by a hash of mas.cpp."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()
    return os.path.join(BUILD_DIR, f"libmas-{digest[:12]}.so")


def _build_lib() -> Optional[str]:
    """Compile mas.cpp with OpenMP, else without; None when neither builds.
    The library is written to a temporary file and renamed into place, so
    processes building at once never load a half-written one."""
    out = _lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    for extra in (("-fopenmp",), ()):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([*_GXX, *extra, _SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        return out
    return None


def _get_lib():
    """The loaded native library, built at the first call; None (logged)
    when g++ cannot build it or it does not load."""
    global _lib, _lib_tried
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        path = _build_lib()
        if path is None:
            _log.warning("MAS C++ extension unavailable; using numpy fallback")
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _log.warning("failed to load MAS library: %s", e)
            return None
        lib.maximum_path_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.maximum_path_batch.restype = None
        _lib = lib
        return _lib


def _maximum_path_numpy(value: np.ndarray, t_xs: np.ndarray, t_ys: np.ndarray):
    """Vectorized-over-x numpy DP (fallback); writes the DP into `value`."""
    b, t_x, t_y = value.shape
    path = np.zeros((b, t_x, t_y), dtype=np.int32)
    max_neg = -1e9
    for i in range(b):
        v = value[i]
        tx, ty = int(t_xs[i]), int(t_ys[i])
        for y in range(ty):
            x_lo, x_hi = max(0, tx + y - ty), min(tx, y + 1)
            if x_hi <= x_lo:
                continue
            xs = np.arange(x_lo, x_hi)
            v_cur = np.where(xs == y, max_neg, v[xs, y - 1] if y > 0 else max_neg)
            if y == 0:
                v_cur = np.full(xs.shape, max_neg)
            v_prev = np.where(
                xs == 0,
                0.0 if y == 0 else max_neg,
                v[np.maximum(xs - 1, 0), y - 1] if y > 0 else max_neg,
            )
            if y == 0:
                v_prev = np.where(xs == 0, 0.0, max_neg)
            v[xs, y] += np.maximum(v_cur, v_prev)
        index = tx - 1
        for y in range(ty - 1, -1, -1):
            path[i, index, y] = 1
            if index != 0 and (
                index == y or v[index, y - 1] < v[index - 1, y - 1]
            ):
                index -= 1
    return path


def maximum_path_host(value, mask) -> np.ndarray:
    """Host MAS. value, mask (B, t_x, t_y), numpy arrays or anything
    np.asarray takes (a CUDA tensor must be copied to the host first) ->
    the 0/1 path as a float32 numpy array. value is masked here, as the
    reference's monotonic_align/__init__.py:7-22 does."""
    value = np.ascontiguousarray(np.asarray(value, dtype=np.float32))
    mask_np = np.asarray(mask)
    value = value * mask_np
    b, t_x, t_y = value.shape
    t_xs = np.ascontiguousarray(mask_np.sum(axis=1)[:, 0].astype(np.int32))
    t_ys = np.ascontiguousarray(mask_np.sum(axis=2)[:, 0].astype(np.int32))

    lib = _get_lib()
    if lib is not None:
        path = np.zeros((b, t_x, t_y), dtype=np.int32)
        lib.maximum_path_batch(
            path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            value.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b,
            t_x,
            t_y,
        )
    else:
        path = _maximum_path_numpy(value, t_xs, t_ys)
    return path.astype(np.float32) * mask_np
