"""Ring attention for sequence-parallel long-form decoding.

The counterpart of the JAX package's `dist/ring.py`. The "scores" path of
`dist/sp.py` gathers the whole K/V onto every rank, so per-rank score
memory is (2B, H, T/n, T). Ring attention shards both axes: each rank holds
a (T/n, D) K/V block, folds a local (T/n, T/n) score tile into an f32
online-softmax accumulator (the flash-attention recurrence), and passes
its block to the next rank: n - 1 rotations visit every block, and each
exchange is posted (`batch_isend_irecv`) before the tile that reads the
current block, so it overlaps the compute. The last block is absorbed
without a rotation. Key validity travels with the block (a (B, T/n) mask
shard), so any padding works; queries in padded rows come out
unnormalized, and the caller's output mask removes them, as with the
estimator's other attention backends.

Plain torch: the JAX package's ring is plain jnp and lax, so this is its
counterpart on every device.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch

Tensor = torch.Tensor

_NEG = -1e30  # not -inf: an all-masked tile must not NaN the running max

# The mesh and axis that the estimator's "ring" backend rotates over.
# Config dataclasses hold only primitives, so sp_cfm_solve registers the live
# mesh here before each call. The registry is thread-local, so two threads
# solving on different meshes cannot cross-wire them.
_ACTIVE = threading.local()


def set_ring_context(mesh, axis_name: str) -> None:
    _ACTIVE.mesh = mesh
    _ACTIVE.axis = axis_name


def get_ring_context():
    if getattr(_ACTIVE, "mesh", None) is None:
        raise RuntimeError(
            "attention_backend='ring' requires dist.ring.set_ring_context"
            "(mesh, axis) first (dist/sp.py::sp_cfm_solve does this) — "
            "note the registry is thread-local: bind it in the thread "
            "that makes the first (tracing) call"
        )
    return _ACTIVE.mesh, _ACTIVE.axis


def ring_attention_local(
    q: Tensor, k: Tensor, v: Tensor, kv_valid: Tensor, comm, scale: Optional[float] = None,
) -> Tensor:
    """One rank's part: full attention over the ring of K/V blocks.

    q, k, v: (B, H, Tl, D) this rank's shards of the sequence axis;
    kv_valid: (B, Tl) bool / 0-1 validity of the local key block; comm: the
    ring's collectives (`dist/mesh.py::_Comm` over the sequence axis).
    Returns (B, H, Tl, D) = softmax(q K^T * scale) V over the global
    sequence, never materializing a (Tl, T) tile."""
    n = comm.size
    d = q.shape[-1]
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    b, h, tl, _ = q.shape

    def absorb(o, m, l, k_blk, v_blk, m_blk):
        """Fold one (B, H, Tl, Tl) score tile into the accumulator, in f32."""
        t = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float()) * s
        t = torch.where(m_blk[:, None, None, :] > 0, t, _NEG)
        m_new = torch.maximum(m, torch.amax(t, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(t - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
        return o, m_new, l

    o = torch.zeros((b, h, tl, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tl, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl, 1), dtype=torch.float32, device=q.device)
    blk = (k.contiguous(), v.contiguous(), kv_valid.to(torch.float32).contiguous())
    for _ in range(n - 1):
        # post the neighbour's block first: the exchange does not depend on
        # this step's tile, which reads the current block
        wait = comm.shift(blk)
        o, m, l = absorb(o, m, l, *blk)
        blk = tuple(wait())
    # last block: absorb only (n = 1 is a single local tile)
    o, m, l = absorb(o, m, l, *blk)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention(
    q: Tensor, k: Tensor, v: Tensor, kv_valid: Tensor, mesh, axis_name: str,
    scale: Optional[float] = None,
) -> Tensor:
    """`ring_attention_local` on this rank of `mesh`, rotating over
    `axis_name`: q/k/v are this rank's (B, H, T/n, D) shards and kv_valid
    its (B, T/n) mask shard; returns this rank's (B, H, T/n, D) output."""
    return ring_attention_local(q, k, v, kv_valid, mesh.comm(axis_name), scale)
