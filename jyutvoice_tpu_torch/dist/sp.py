"""Sequence-parallel (context-parallel) CFM decoding for long-form synthesis.

The counterpart of the JAX package's `dist/sp.py`. There GSPMD partitions
the solve from sharding annotations; here the sharding is written by hand.
Each rank of the mesh's "seq" axis holds T/n frames of every activation
(rank s: frames [s T/n, (s + 1) T/n)) and runs the whole Euler solve on
them; the estimator (`models/estimator.py`) reads this rank's piece from
`current_shard()`:

  * the k=3 causal convolutions take the two frames before the shard from
    the ranks to the left (`SeqShard.left_halo`); the 1x1 convolutions,
    each frame's LayerNorm, Mish, the time MLP and the feed-forwards are
    local;
  * attention="scores" (the estimator's "plain" route, the JAX package's
    "xla_scores"): K, V and the key mask are gathered along T and each rank
    attends with its own queries over all keys; per-rank score memory is
    (2B, H, T/n, T);
  * attention="ring": ring attention (`dist/ring.py`), per-rank score tile
    (2B, H, T/n, T/n);
  * attention="banded": the chunk band (`nn/attention.py::banded_sdpa`);
    each rank gathers the neighbour frames its band reads, so per-rank work
    and memory are (2B, H, T/n, w);
  * streaming chunk masks use global frame positions (the rank's offset
    added).
The Euler loop, the CFG batch doubling and the mask arithmetic are
untouched. A ("model", "seq") mesh adds tensor parallelism over "model"
(`dist/tp.py`): each rank runs its heads and hidden slice, with the two
all-reduces per transformer block on its model line.

Process model: `make_sp_mesh` spawns the mesh (`dist/mesh.py::Mesh.spawn`):
the caller is rank 0, each other rank a follower process. `sp_cfm_solve`'s
`run`, called on rank 0, scatters the mu, mask, cond and noise shards,
broadcasts spks, runs the solve on every rank and gathers the mel to rank
0. `shard_params` sends the decoder's weights to the followers once.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch
from torch import nn

from jyutvoice_tpu_torch.config import require_unet
from jyutvoice_tpu_torch.dist.mesh import Mesh

Tensor = torch.Tensor

SEQ_AXIS = "seq"
MODEL_AXIS = "model"

_SHARD = threading.local()
_KEYS = itertools.count()


def make_sp_mesh(
    n_seq: Optional[int] = None, n_model: int = 1, *, devices=None,
    backend: Optional[str] = None,
) -> Mesh:
    """1-D ("seq",) mesh, or ("model", "seq") when n_model > 1. devices: one
    per rank (default: the visible CUDA devices); backend: NCCL for CUDA
    devices and Gloo for the CPU unless named."""
    visible = len(devices) if devices is not None else torch.cuda.device_count()
    if n_seq is None:
        n_seq = visible // n_model
    if n_seq < 1 or n_model < 1:
        raise ValueError(
            f"mesh sizes must be >= 1, got n_seq={n_seq} n_model={n_model}"
        )
    if n_model * n_seq > visible:
        raise ValueError(
            f"mesh needs {n_model * n_seq} devices, only {visible} "
            f"visible"
        )
    if devices is not None:
        devices = list(devices)[: n_model * n_seq]
    if n_model > 1:
        return Mesh.spawn((MODEL_AXIS, SEQ_AXIS), (n_model, n_seq), devices, backend)
    return Mesh.spawn((SEQ_AXIS,), (n_seq,), devices, backend)


class SeqSharding:
    """(B, T, C) activations split along T over the mesh's "seq" axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.axis_size(SEQ_AXIS)

    def piece(self, t: int) -> int:
        if t % self.n:
            raise ValueError(f"T={t} not divisible by seq mesh size {self.n}")
        return t // self.n


def seq_sharding(mesh: Mesh) -> SeqSharding:
    """(B, T, C) activations sharded along T."""
    return SeqSharding(mesh)


def sp_param_shardings(params: nn.Module, mesh: Mesh):
    """The estimator's parameter placement on the mesh: TP-sharded over
    "model" when the mesh has that axis (`dist/tp.py` specs: name ->
    (axis, dim)), replicated otherwise (name -> None)."""
    if MODEL_AXIS in mesh.axis_names:
        from jyutvoice_tpu_torch.dist.tp import estimator_partition_specs

        return estimator_partition_specs(params, MODEL_AXIS)
    return {name: None for name, _ in params.named_parameters()}


# ---------------------------------------------------------------------------
# This rank's piece of a sharded estimator call
# ---------------------------------------------------------------------------


class SeqShard:
    """Rank `index` of `n` along the sequence: frames [offset, offset + t_local)
    of a T-frame sequence. Collectives go over `comm`."""

    def __init__(self, comm, t_local: int):
        self.comm = comm
        self.n, self.index = comm.size, comm.rank
        self.t_local = t_local
        self.t = t_local * self.n
        self.offset = self.index * t_local

    def left_halo(self, x: Tensor, width: int, dim: int = 1) -> Tensor:
        """The `width` frames just before this shard along `dim` (zeros
        before frame 0), from the ranks to the left."""
        w = min(width, self.t_local)
        tails = self.comm.all_gather(x.narrow(dim, self.t_local - w, w), dim)
        have = torch.cat(tails[: self.index], dim=dim) if self.index else x.narrow(dim, 0, 0)
        have = have.narrow(dim, max(have.shape[dim] - width, 0), min(width, have.shape[dim]))
        return _pad_along(have, dim, width - have.shape[dim], before=True)

    def right_halo(self, x: Tensor, width: int, dim: int = 1) -> Tensor:
        """The `width` frames just after this shard along `dim` (zeros past
        the last frame), from the ranks to the right."""
        w = min(width, self.t_local)
        heads = self.comm.all_gather(x.narrow(dim, 0, w), dim)
        rest = heads[self.index + 1:]
        have = torch.cat(rest, dim=dim) if rest else x.narrow(dim, 0, 0)
        have = have.narrow(dim, 0, min(width, have.shape[dim]))
        return _pad_along(have, dim, width - have.shape[dim], before=False)

    def gather(self, x: Tensor, dim: int = 1) -> Tensor:
        """x of every shard concatenated along `dim`: the whole sequence."""
        return self.comm.cat(x, dim)

    def gather_kv(self, k: Tensor, v: Tensor):
        """(B, T/n, H, D) k and v -> (B, T, H, D) each, in one gather."""
        kv = self.gather(torch.stack([k, v]), dim=2)
        return kv[0], kv[1]

    def sum(self, x: Tensor) -> Tensor:
        return self.comm.all_reduce(x.clone())

    def key_mask(self, mask: Tensor) -> Tensor:
        """This shard's (B, T/n) 0/1 mask -> the (B, T) bool key mask."""
        return self.gather(mask.to(torch.float32), dim=1) > 0

    def query_rows(self, full: Tensor) -> Tensor:
        """This shard's query rows of a (..., T, T) mask."""
        return full[..., self.offset: self.offset + self.t_local, :]


def _pad_along(x: Tensor, dim: int, n: int, before: bool) -> Tensor:
    if n <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    z = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([z, x] if before else [x, z], dim=dim)


def current_shard() -> Optional[SeqShard]:
    """The sequence shard of the estimator call running in this thread, or
    None on one device."""
    return getattr(_SHARD, "shard", None)


def set_shard(shard: Optional[SeqShard]) -> None:
    _SHARD.shard = shard


# ---------------------------------------------------------------------------
# The decoder on the mesh
# ---------------------------------------------------------------------------


class MeshParams:
    """A decoder placed on a mesh: every rank holds its copy (TP-sliced over
    "model" when the mesh has it) under `key` in its `mesh.state`."""

    def __init__(self, mesh: Mesh, key: str, cfg):
        self.mesh, self.key, self.cfg = mesh, key, cfg


def _skeleton(module: nn.Module) -> nn.Module:
    """A copy of `module` with every parameter and buffer on the meta device:
    its structure without its weights, small enough to pickle."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(meta, requires_grad=t.requires_grad) \
            if isinstance(t, nn.Parameter) else meta
    return copy.deepcopy(module, memo)


def _load_rank(mesh: Mesh, key: str, skeleton: nn.Module, tp: bool) -> None:
    if mesh.rank == 0:
        module = mesh.state.pop("_outgoing")
    else:
        module = skeleton.to_empty(device=mesh.device)
    comm = mesh.comm()
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            comm.broadcast(t.data)
    if tp:
        from jyutvoice_tpu_torch.dist.tp import tp_shard_estimator

        module = tp_shard_estimator(module, mesh, MODEL_AXIS)
    mesh.state[key] = module


def shard_params(params: nn.Module, mesh: Mesh) -> MeshParams:
    """Place a loaded estimator on the mesh (`sp_param_shardings`): the
    followers receive its weights once, by broadcast from rank 0; rank 0
    keeps using `params` itself unless the mesh has a model axis."""
    require_unet(params, "dist/ (the decoder on a mesh)")
    specs = sp_param_shardings(params, mesh)  # raises for an int8 estimator under TP
    tp = mesh.axis_size(MODEL_AXIS) > 1 and any(v is not None for v in specs.values())
    key = f"decoder-{next(_KEYS)}"
    mesh.state["_outgoing"] = params
    mesh.run(_load_rank, key, _skeleton(params) if mesh.size > 1 else None, tp)
    return MeshParams(mesh, key, params.cfg)


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------


def _solve_rank(mesh: Mesh, key: str, cfm_cfg, n_timesteps: int, streaming: bool,
                backend: str, b: int, t: int, timing: bool):
    from jyutvoice_tpu_torch.dist import ring as ring_mod
    from jyutvoice_tpu_torch.models.cfm import cosine_t_span, solve_euler_cfg
    from jyutvoice_tpu_torch.models.estimator import with_config

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    seq, model = mesh.comm(SEQ_AXIS), mesh.comm(MODEL_AXIS)
    n_seq = mesh.axis_size(SEQ_AXIS)
    tl = t // n_seq
    comms = [c for c in {id(c): c for c in (mesh.comm(), seq, model)}.values()]
    for c in comms:
        c.timing, c.seconds = timing, 0.0
    inputs = noise = spks = None
    if mesh.rank == 0:
        mu, mask, spks, cond, noise = mesh.state.pop("_inputs")
        inputs = torch.cat([mu, cond, mask], dim=-1)
    on_first_line = mesh.axis_index(MODEL_AXIS) == 0
    x = torch.empty((b, tl, 161), device=dev)
    z = torch.empty((1, tl, 80), device=dev)
    if on_first_line:
        x = seq.scatter(inputs, x, dim=1)
        z = seq.scatter(noise, z, dim=1)
    x, z = model.broadcast(x), model.broadcast(z)
    if spks is None:
        spks = torch.empty((b, 80), device=dev)
    spks = mesh.comm().broadcast(spks)
    mu, cond, mask = x[..., :80], x[..., 80:160], x[..., 160:]
    est = with_config(mesh.state[key], cfm_cfg.estimator)
    z = z.expand(mu.shape)
    t_span = cosine_t_span(n_timesteps, device=dev)
    set_shard(SeqShard(seq, tl) if n_seq > 1 else None)
    if backend == "ring":
        ring_mod.set_ring_context(mesh, SEQ_AXIS)
    try:
        with torch.inference_mode():
            mel = solve_euler_cfg(est, cfm_cfg, z, t_span, mu.contiguous(), mask.contiguous(),
                                  spks, cond.contiguous(), streaming)
            mel = seq.cat(mel, dim=1)
    finally:
        set_shard(None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats = torch.tensor([[(time.perf_counter() - t0) * 1e3,
                           sum(c.seconds for c in comms) * 1e3,
                           torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0.0]],
                         dtype=torch.float64)
    for c in comms:
        c.timing = False
    mesh.last_stats = torch.cat(mesh.comm().all_gather(stats.to(dev), 0)).cpu() \
        if mesh.size > 1 else stats
    return mel


def sp_cfm_solve(
    params,
    cfm_cfg,
    mesh: Mesh,
    *,
    n_timesteps: int,
    streaming: bool = False,
    attention: str = "scores",
):
    """Build a sequence-parallel `cfm_forward` for `mesh`.

    Returns fn(params_on_mesh, mu, mask, spks, cond, noise) -> mel, called on
    rank 0 with whole tensors on its device: mu / cond (B, T, 80), mask (B,
    T, 1), spks (B, 80) and `noise` the seed-0 buffer pre-sliced to (1, T,
    80) (weights/noise.py); the mel comes back whole, (B, T, 80).
    `params_on_mesh` is `shard_params(params, mesh)`: place it once and
    reuse it. T must be a multiple of the mesh's "seq" size.

    attention="scores" (default): K/V gathered, per-rank score memory
    (2B, H, T/n, T). attention="ring": ring attention, per-rank tile
    (2B, H, T/n, T/n); a 1-D ("seq",) mesh only. attention="banded": the
    chunk band (geometry from cfm_cfg.estimator.banded_*), per-rank work
    and memory (2B, H, T/n, w); approximate (~2% mel divergence from full
    attention in the JAX package's measurements); full attention only.

    After each call `mesh.last_stats` holds one row per rank: the solve's
    ms on the host clock (scatter and gather included), the ms spent in
    collectives (when `mesh.timing` is set, which synchronizes the device
    around each; else 0) and the peak device bytes."""
    require_unet(cfm_cfg, "the sequence-parallel solve (dist/sp.py)")
    if attention == "ring":
        if MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1:
            raise ValueError("ring attention composes with 1-D seq meshes "
                             "only (no model axis)")
        if streaming:
            raise ValueError(
                "attention='ring' does not support streaming chunk masks; "
                "use attention='scores' for the chunk-masked solve"
            )
        backend = "ring"
    elif attention == "banded":
        if streaming:
            raise ValueError(
                "attention='banded' supports full attention only; use "
                "attention='scores' for the chunk-masked solve"
            )
        backend = "banded"
    elif attention == "scores":
        backend = "xla_scores"
    else:
        raise ValueError(
            f"unknown attention={attention!r}: expected 'scores', 'ring' "
            "or 'banded'"
        )
    est_cfg = dataclasses.replace(cfm_cfg.estimator, attention_backend=backend)
    cfm_cfg = dataclasses.replace(cfm_cfg, estimator=est_cfg)
    sharding = seq_sharding(mesh)

    def run(params_on_mesh: MeshParams, mu, mask, spks, cond, noise):
        if params_on_mesh.mesh is not mesh:
            raise ValueError("the decoder was placed on another mesh (shard_params)")
        b, t = mu.shape[0], mu.shape[1]
        tl = sharding.piece(t)
        if backend == "banded" and (t % est_cfg.banded_chunk or tl % est_cfg.banded_chunk):
            raise ValueError(
                f"attention='banded' on {sharding.n} ranks needs T and T/{sharding.n} to be "
                f"multiples of the band's chunk {est_cfg.banded_chunk}, got T={t}"
            )
        dev = mesh.device
        mesh.state["_inputs"] = tuple(
            a.to(dev, torch.float32).contiguous() for a in (mu, mask, spks, cond, noise[:, :t]))
        return mesh.run(_solve_rank, params_on_mesh.key, cfm_cfg, n_timesteps, streaming,
                        backend, b, t, mesh.timing)

    return run
