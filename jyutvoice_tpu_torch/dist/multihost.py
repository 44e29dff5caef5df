"""Multi-process initialisation (data-parallel training under torchrun).

The counterpart of the JAX package's `dist/multihost.py` on
torch.distributed. torchrun sets MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
RANK and LOCAL_RANK for each process it starts; this module is the single
entry point that reads them, so launchers stay trivial:

    from jyutvoice_tpu_torch.dist.multihost import init_distributed
    init_distributed(device="cuda")  # no-op in a single-process run

The process group's backend follows the device the caller names: NCCL for
"cuda", Gloo for "cpu". `backend=` overrides it (two ranks sharing one card
cannot use NCCL, which refuses two ranks on one GPU); it is never probed.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)


def backend_for(device) -> str:
    """NCCL for a CUDA device, Gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """The device of this process: "cuda" binds cuda:LOCAL_RANK; a device
    with an explicit index (two ranks sharing one card) or "cpu" is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout_s: float = 1800.0,
) -> bool:
    """Initialize the default process group when running multi-process.

    Returns True if a process group was initialized. The arguments default
    to torchrun's environment: MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK.
    As in the JAX package, a run with no coordinator address and one
    process (or none named) is single-process and initializes nothing; a
    coordinator address with WORLD_SIZE=1 (torchrun --nproc-per-node 1)
    initializes a group of one. A CUDA rank binds its device first
    (`rank_device`)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        _log.info("single-process run: torch.distributed not initialized")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of "
            "processes and this process's id (torchrun sets MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK)"
        )
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    _log.info("torch.distributed initialized: process %d/%d over %s on %s",
              dist.get_rank(), dist.get_world_size(), backend, dev)
    return True


def global_batch_sharding(axis_name: str = "data"):
    """Mesh + sharding over every process of the group (multi-process data
    parallel): the rows of the global batch that this rank holds."""
    from jyutvoice_tpu_torch.dist.mesh import batch_sharding, make_mesh

    mesh = make_mesh(axis_name=axis_name)
    return mesh, batch_sharding(mesh, axis_name)
