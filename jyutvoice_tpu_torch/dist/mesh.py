"""Meshes of ranks and the collectives the port's multi-device paths use.

The counterpart of the JAX package's `dist/mesh.py`. A JAX `Mesh` is a grid
of devices that one process drives; here every device of a mesh is driven
by its own process (a rank of a torch.distributed process group). Two kinds
of mesh exist:

  * the data mesh of a torchrun job (`make_mesh`): every process of the job
    is a rank; `shard_batch` keeps this rank's rows of the global batch and
    `replicate` broadcasts a state from rank 0 (data-parallel training,
    `cli/train.py`);
  * a spawned mesh (`Mesh.spawn`, behind `dist/sp.py::make_sp_mesh` and
    `dist/tp.py::make_tp_mesh`): the calling process is rank 0 and starts
    one follower process (`dist/follower.py`) per other rank. `Mesh.run(fn,
    *args)` calls the module-level `fn(mesh, *args)` on every rank at once,
    SPMD style, and returns rank 0's result; followers keep what a command
    loads in `mesh.state` (a sharded decoder, loaded once per mesh).
    Followers read their commands from a pipe, so they end with their
    parent; `close()` ends them sooner. A mesh takes an explicit device per
    rank, as a JAX `Mesh` takes its devices: two ranks may share one card.

The process group's backend follows the devices: NCCL on CUDA, Gloo on the
CPU, unless the caller names one (NCCL refuses two ranks on one GPU, so two
ranks sharing a card use Gloo). Gloo moves CUDA tensors through host memory
for the collectives it takes on them (`GLOO_CUDA_OPS`); for the others the
mesh copies the tensor to the host and back itself. A process holds one
spawned mesh at a time: its process group is the default one.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from jyutvoice_tpu_torch.dist.multihost import backend_for

Tensor = torch.Tensor

# collectives that the Gloo backend takes on CUDA tensors, as
# scripts/gloo_cuda_probe.py found them on an H100 with torch 2.11: every
# collective; its point-to-point ops (send / recv, batch_isend_irecv) fail,
# so `_Comm.shift` stages those through host memory
GLOO_CUDA_OPS = frozenset({"broadcast", "all_reduce", "all_gather", "scatter"})

_TIMEOUT = datetime.timedelta(seconds=900)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Clock:
    """Adds the wall time of a collective to `comm.seconds` when
    `comm.timing` is set, synchronizing the device first so that queued
    compute is not counted (and again after, for the collective's own)."""

    def __init__(self, comm, device):
        self.comm, self.device = comm, device

    def __enter__(self):
        if self.comm.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.comm.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.comm.seconds += time.perf_counter() - self.t0


class _Comm:
    """Collectives over one process group, with Gloo's CUDA gaps staged
    through host memory. With `timing` set, `seconds` adds up their time."""

    timing = False
    seconds = 0.0

    def __init__(self, group, backend: str):
        self.group = group
        self.backend = backend
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _staged(self, op: str, *tensors: Tensor) -> bool:
        return (self.backend == "gloo" and op not in GLOO_CUDA_OPS
                and any(t is not None and t.is_cuda for t in tensors))

    def global_rank(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank) if self.group is not None \
            else group_rank

    def all_reduce(self, x: Tensor) -> Tensor:
        """Sum over the group, in place; returns x."""
        with _Clock(self, x.device):
            if self._staged("all_reduce", x):
                host = x.cpu()
                dist.all_reduce(host, group=self.group)
                x.copy_(host)
            else:
                dist.all_reduce(x, group=self.group)
        return x

    def broadcast(self, x: Tensor, src: int = 0) -> Tensor:
        """x from group rank `src` to every rank, in place; returns x."""
        with _Clock(self, x.device):
            if self._staged("broadcast", x):
                host = x.cpu()
                dist.broadcast(host, src=self.global_rank(src), group=self.group)
                x.copy_(host)
            else:
                dist.broadcast(x, src=self.global_rank(src), group=self.group)
        return x

    def all_gather(self, x: Tensor, dim: int) -> List[Tensor]:
        """Every rank's x (equal shapes), in group-rank order."""
        x = x.contiguous()
        with _Clock(self, x.device):
            if self._staged("all_gather", x):
                out = [torch.empty(x.shape, dtype=x.dtype) for _ in range(self.size)]
                dist.all_gather(out, x.cpu(), group=self.group)
                return [o.to(x.device) for o in out]
            out = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(out, x, group=self.group)
        return out

    def cat(self, x: Tensor, dim: int) -> Tensor:
        """The group's x concatenated along `dim` in rank order."""
        return torch.cat(self.all_gather(x, dim), dim=dim)

    def scatter(self, full: Optional[Tensor], like: Tensor, dim: int, src: int = 0) -> Tensor:
        """Group rank `src` splits `full` along `dim` into equal pieces; each
        rank receives its own. `like` gives the piece's shape, dtype and
        device on every rank."""
        out = torch.empty_like(like)
        pieces = None
        if self.rank == src:
            pieces = [p.contiguous() for p in torch.chunk(full, self.size, dim=dim)]
        with _Clock(self, out.device):
            if self._staged("scatter", out):
                host = torch.empty(out.shape, dtype=out.dtype)
                dist.scatter(host, [p.cpu() for p in pieces] if pieces else None,
                             src=self.global_rank(src), group=self.group)
                return out.copy_(host)
            dist.scatter(out, pieces, src=self.global_rank(src), group=self.group)
        return out

    def shift(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """Post the exchange of each tensor with the ring neighbours (send to
        rank + 1, receive from rank - 1) and return (received buffers,
        wait) as a pair: `wait()` completes the exchange."""
        nxt = self.global_rank((self.rank + 1) % self.size)
        prv = self.global_rank((self.rank - 1) % self.size)
        device = tensors[0].device
        with _Clock(self, device):
            staged = self._staged("batch_isend_irecv", *tensors)
            src = [t.cpu() if staged else t.contiguous() for t in tensors]
            recv = [torch.empty_like(t) for t in src]
            ops = []
            for s, r in zip(src, recv):
                ops.append(dist.P2POp(dist.isend, s, nxt, group=self.group))
                ops.append(dist.P2POp(dist.irecv, r, prv, group=self.group))
            works = dist.batch_isend_irecv(ops)

        def wait() -> List[Tensor]:
            with _Clock(self, device):
                for w in works:
                    w.wait()
                return [r.to(device) for r in recv] if staged else recv

        return wait


class Mesh:
    """A grid of ranks: `axis_names` with `shape[axis]` ranks along each,
    rank = row-major index over the axes (the JAX package's
    `devices.reshape(n_model, n_seq)`). `devices[r]` is rank r's device."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...],
                 devices: Sequence, backend: str, rank: int):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        self.devices = [torch.device(d) for d in devices]
        self.backend = backend
        self.rank = rank
        self.device = self.devices[rank]
        self.state: dict = {}  # what commands load on this rank (sharded decoders)
        self.last_stats = None  # per-rank figures of the last solve (dist/sp.py)
        self.timing = False  # time the collectives of the next solves (dist/sp.py)
        self._followers: List[subprocess.Popen] = []
        self._lock = threading.Lock()
        self._closed = False
        self._owns_group = False
        self._rendezvous: Optional[str] = None  # rank 0's rendezvous directory
        self._comms: Dict[str, _Comm] = {}
        self._world: Optional[_Comm] = None  # set once the process group exists

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"devices={[str(d) for d in self.devices]})")

    # -- axes ----------------------------------------------------------------

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """This rank's (or `rank`'s) index along each axis."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords().get(axis, 0)

    def comm(self, axis: Optional[str] = None) -> _Comm:
        """Collectives over `axis` (the ranks that differ from this one only
        along it), or over the whole mesh."""
        if axis is not None and axis not in self.axis_names:
            return _Comm1()
        if axis is None or len(self.axis_names) == 1:
            return self._world or _Comm1()
        return self._comms.get(axis) or _Comm1()

    def _make_axis_groups(self) -> None:
        """One process group per line of each axis; every rank creates every
        group, in the same order (torch.distributed requires it)."""
        if len(self.axis_names) < 2 or self.size == 1:
            return
        mine = self.coords()
        for axis in self.axis_names:
            others = [a for a in self.axis_names if a != axis]
            lines: Dict[tuple, list] = {}
            for r in range(self.size):
                c = self.coords(r)
                lines.setdefault(tuple(c[a] for a in others), []).append(r)
            for key, ranks in sorted(lines.items()):
                g = dist.new_group(ranks, backend=self.backend)
                if key == tuple(mine[a] for a in others) and len(ranks) > 1:
                    self._comms[axis] = _Comm(g, self.backend)

    # -- spawned meshes --------------------------------------------------------

    @classmethod
    def spawn(cls, axis_names, sizes, devices=None, backend: Optional[str] = None) -> "Mesh":
        """Start a mesh whose rank 0 is this process and whose other ranks are
        follower processes. devices: one per rank (default: the visible CUDA
        devices, one per rank); backend: NCCL for CUDA devices, Gloo for the
        CPU, unless named."""
        n = int(np.prod(sizes))
        if devices is None:
            visible = torch.cuda.device_count()
            if n > visible:
                raise ValueError(f"mesh needs {n} devices, only {visible} visible")
            devices = [f"cuda:{i}" for i in range(n)]
        devices = [str(torch.device(d)) for d in devices]
        if len(devices) != n:
            raise ValueError(f"a mesh of {n} ranks needs {n} devices, got {len(devices)}")
        kinds = {torch.device(d).type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's ranks share one device type, got {devices}")
        backend = backend or backend_for(devices[0])
        mesh = cls(axis_names, sizes, devices, backend, rank=0)
        if n == 1 and backend != "nccl":
            return mesh
        if dist.is_initialized():
            raise RuntimeError(
                "this process already belongs to a process group (a torchrun job or "
                "another mesh): close() that mesh first"
            )
        # rendezvous through a file of a fresh directory: no port to race for
        mesh._rendezvous = tempfile.mkdtemp(prefix="jyutvoice-mesh-")
        init = "file://" + os.path.join(mesh._rendezvous, "store")
        env = dict(os.environ)
        # the followers import what this process can (a command's function
        # may live in any module on its path)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO_ROOT] + [p for p in sys.path if p and os.path.isdir(p)])
        # the followers compute as this process does: its thread count and
        # its TF32 settings (the port keeps TF32 off on the card)
        spec = {"axis_names": list(axis_names), "sizes": [int(s) for s in sizes],
                "devices": devices, "backend": backend, "init": init,
                "threads": torch.get_num_threads(), "parent": os.getpid(),
                "tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]}
        try:
            for r in range(1, n):
                mesh._followers.append(subprocess.Popen(
                    [sys.executable, "-m", "jyutvoice_tpu_torch.dist.follower", str(r),
                     repr(spec)],
                    stdin=subprocess.PIPE, stdout=sys.stderr.fileno(), env=env,
                    cwd=_REPO_ROOT,
                ))
            mesh._init_group(init)
        except BaseException:
            mesh._kill()
            raise
        atexit.register(mesh.close)
        return mesh

    def _init_group(self, init_method: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(self.backend, init_method=init_method,
                                world_size=self.size, rank=self.rank, timeout=_TIMEOUT)
        self._owns_group = True
        self._world = _Comm(None, self.backend)
        self._make_axis_groups()

    def run(self, fn, *args):
        """Call the module-level `fn(mesh, *args)` on every rank (args are
        pickled to the followers) and return rank 0's result. A rank that
        fails ends the mesh: the error is raised here and the mesh closed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the mesh is closed")
            module = fn.__module__
            if module == "__main__":  # a script's function: the followers import the script
                module = os.path.splitext(os.path.basename(sys.modules["__main__"].__file__))[0]
            msg = pickle.dumps(("call", module, fn.__qualname__, args))
            try:
                for p in self._followers:
                    p.stdin.write(len(msg).to_bytes(8, "little") + msg)
                    p.stdin.flush()
                return fn(self, *args)
            except BaseException:
                self._kill()
                raise

    def _kill(self) -> None:
        self._closed = True
        for p in self._followers:
            if p.poll() is None:
                p.kill()
            p.wait()
        self._release_group()

    def _release_group(self) -> None:
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
        if self._rendezvous:
            shutil.rmtree(self._rendezvous, ignore_errors=True)
            self._rendezvous = None

    def close(self) -> None:
        """End the followers and this process's group. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for p in self._followers:
                try:
                    p.stdin.close()  # a follower exits at the end of its pipe
                except OSError:
                    pass
            for p in self._followers:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            self._release_group()
            self.state.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Comm1:
    """The collectives of a group of one: identities."""

    size, rank = 1, 0
    timing, seconds = False, 0.0

    def all_reduce(self, x):
        return x

    def broadcast(self, x, src=0):
        return x

    def all_gather(self, x, dim):
        return [x]

    def cat(self, x, dim):
        return x

    def scatter(self, full, like, dim, src=0):
        return full

    def shift(self, tensors):
        return lambda: list(tensors)


# ---------------------------------------------------------------------------
# The data mesh of a torchrun job
# ---------------------------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """The data mesh: every process of the job's process group (torchrun),
    or this process alone when none is initialized. Asking for more ranks
    than the job has raises, with the JAX package's message; a data mesh
    spans the whole job."""
    if dist.is_initialized():
        visible, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        visible, rank, backend = 1, 0, "gloo"
    if n_devices is not None:
        if n_devices > visible:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{visible} device(s) are visible"
            )
        if n_devices != visible:
            raise ValueError(
                f"a data mesh spans the whole process group ({visible} ranks), "
                f"got n_devices={n_devices}"
            )
    mesh = Mesh((axis_name,), (visible,), ["cpu"] * visible, backend, rank)
    if visible > 1:
        mesh._world = _Comm(None, backend)
    return mesh


class BatchSharding:
    """The leading (batch) dim split over the mesh's ranks in order."""

    def __init__(self, mesh: Mesh, axis_name: str = "data"):
        self.mesh, self.axis_name = mesh, axis_name

    def rows(self, b: int) -> slice:
        n, r = self.mesh.axis_size(self.axis_name), self.mesh.axis_index(self.axis_name)
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over {n} ranks")
        return slice(r * (b // n), (r + 1) * (b // n))


class Replicated:
    """A state held whole by every rank: placing it broadcasts rank 0's."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def put(self, tensors) -> None:
        """Overwrite every tensor with rank 0's, in place."""
        comm = self.mesh.comm()
        with torch.no_grad():
            for t in tensors:
                comm.broadcast(t)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> BatchSharding:
    """Shard the leading (batch) dim over the mesh."""
    return BatchSharding(mesh, axis_name)


def replicate(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's rows of every array in a batch dict."""
    sharding = batch_sharding(mesh, axis_name)
    return {k: v[sharding.rows(v.shape[0])] for k, v in batch.items()}
