"""Monotonic Alignment Search on the tensors' device.

The counterpart of the JAX package's `align/__init__.py::maximum_path_jax`,
which `compute_losses` calls: the same Viterbi max-path DP as a forward
wavefront over mel frames, vectorised over text positions, then the same
reverse backtrack carrying the current text index. Plain torch under
`no_grad`: the JAX package computes it in XLA, not in a Pallas kernel.

The DP over value (B, t_x, t_y), masked by `mask`, for one row with text
length n and mel length m:
    V[x, y] = max(V[x, y-1], V[x-1, y-1]) + value[x, y]   inside the band
with V[0, 0] = value[0, 0] and the band lo <= x < hi,
lo = max(0, n + y - m), hi = min(n, y + 1). Cells outside the band hold
-inf here where the JAX package writes -1e9; with n <= m every cell of the
band has a predecessor inside it, so the sums and the path are the same.
The backtrack moves down one text position out of (x, y) when x == y or
V[x, y-1] < V[x-1, y-1].

Each loop runs t_y steps of two small kernels; what that costs on the card
is measured by `chip_smoke.py`.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
