"""Rank functions of the port's multi-device tests (`test_torch_port_dist.py`):
each runs on every rank of a spawned mesh at once (`dist/mesh.py::Mesh.run`:
rank 0 is the test process, the others import this module), or as one
process of a torchrun-style pair (`python tests/torch_port_dist_ranks.py`).
torch and the port only: the followers never import JAX."""

import json
import os
import sys

import numpy as np
import torch


def ring_unit(mesh, q, k, v, valid):
    """`dist/ring.py::ring_attention` on each rank's shard of whole (B, H,
    T, D) numpy q / k / v and (B, T) validity; rank 0 returns the whole
    output, gathered along T."""
    from jyutvoice_tpu_torch.dist.ring import ring_attention

    n, r = mesh.axis_size("seq"), mesh.axis_index("seq")
    tl = q.shape[2] // n
    part = [torch.from_numpy(np.ascontiguousarray(a[:, :, r * tl:(r + 1) * tl]))
            for a in (q, k, v)]
    mask = torch.from_numpy(np.ascontiguousarray(valid[:, r * tl:(r + 1) * tl]))
    out = ring_attention(*part, mask, mesh, "seq")
    return mesh.comm("seq").cat(out.contiguous(), 2).numpy()


def small_trainer(cfg, seed, mesh=None):
    from jyutvoice_tpu_torch.models.tts import TTS
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    model = load_jax_params(TTS(cfg.tts), random_init.init_tts_tree(cfg.tts, seed=seed))
    return Trainer(model, cfg.train, torch.Generator().manual_seed(seed), mesh=mesh)


def ddp_steps(mesh, cfg, seed, batch, steps):
    """`steps` data-parallel steps on the global batch; rank 0 returns the
    first step's metrics and all-reduced gradients (numpy), every step's
    metrics, the parameters after and every rank's checksum of them. The
    data mesh's `replicate` first overwrites a rank-dependent tensor with
    rank 0's."""
    from jyutvoice_tpu_torch.dist.mesh import make_mesh, replicate

    data = make_mesh()
    probe = torch.full((3,), float(data.rank + 1))
    replicate(data).put([probe])
    assert probe.tolist() == [1.0, 1.0, 1.0]
    trainer = small_trainer(cfg, seed, data)
    metrics, grads = trainer.gradients(batch)
    first = ({k: float(v) for k, v in metrics.items()}, [g.numpy().copy() for g in grads])
    trainer.generator.manual_seed(seed)  # the same draws as a step from the start
    history = []
    for _ in range(steps):
        history.append({k: float(v) for k, v in trainer.step(batch).items()})
    params = [p.detach().numpy().copy() for p in trainer.params]
    check = torch.tensor([[sum(float(np.abs(p).sum()) for p in params)]], dtype=torch.float64)
    sums = torch.cat(mesh.comm().all_gather(check, 0))[:, 0].tolist()
    frozen = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()
              if n.startswith("decoder.")}
    return first, history, params, sums, frozen


_TRAIN_CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from torch_port_setup import PORT_CFG
from jyutvoice_tpu_torch.cli import train
out = train.main({argv!r}, cfg=PORT_CFG)
print("TRAIN_OUT", json.dumps(out))
"""


def train_child_source(argv):
    """The source of a `cli.train` process on the small configuration."""
    return _TRAIN_CHILD.format(tests=os.path.dirname(os.path.abspath(__file__)), argv=list(argv))


if __name__ == "__main__":  # one rank of a torchrun-style pair
    exec(train_child_source(json.loads(sys.argv[1])))
