"""Tensor-parallel sharding of the CFM estimator (serving latency scaling).

The counterpart of the JAX package's `dist/tp.py`. There GSPMD partitions
the estimator from Megatron-style annotations over a "model" mesh axis;
here each rank of that axis holds its slices and the two all-reduces per
transformer block are written out:

  * attn q / k / v: (H*D, C) sliced by heads (this rank's H/n heads),
  * attn out:       (C, H*D) sliced on its input; all-reduce, bias once,
  * ff_in:          (4C, C) sliced on the hidden axis, bias sliced,
  * ff_out:         (C, 4C) sliced on its input; all-reduce, bias once,
  * conv / resnet / time / etc.: replicated (small).

Each rank runs attention over its own heads. Graphs over these slices take
`tp_cfm_cfg(cfm_cfg)`: the JAX package's rewrite to "xla_scores" (plain
attention; `dist/gspmd.py`). TP is an inference path: the all-reduce has
no backward here.

Usage:
    mesh = make_tp_mesh(n)                        # or make_sp_mesh(n_seq, n_model)
    dec = shard_params(tts.decoder, mesh)         # dist/sp.py: weights sent once
    mel = tp_cfm_solve(tts.decoder, cfm_cfg, mesh, n_timesteps=10)(dec, ...)
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from jyutvoice_tpu_torch.config import require_unet
from jyutvoice_tpu_torch.dist.mesh import Mesh
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.attention import PlainMHA

Tensor = torch.Tensor

INT8_TP_ERROR = (
    "int8-quantized estimator params cannot be tensor-parallel "
    "sharded (the TP partition specs cover the f32 layout only); "
    "quantize AFTER deciding the parallelism, or serve int8 "
    "single-chip / data-parallel"
)


def make_tp_mesh(n_devices: Optional[int] = None, axis_name: str = "model", *,
                 devices=None, backend: Optional[str] = None) -> Mesh:
    """A 1-D mesh of n_devices ranks along `axis_name` (default: every
    visible CUDA device); see `dist/mesh.py::Mesh.spawn`."""
    visible = len(devices) if devices is not None else torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n > visible:
        raise ValueError(
            f"requested a {n}-device mesh but only "
            f"{visible} device(s) are visible"
        )
    return Mesh.spawn((axis_name,), (n,), None if devices is None else list(devices)[:n],
                      backend)


def tp_cfm_cfg(cfm_cfg):
    """CFM config for graphs over TP slices: the score-materializing path
    (dist/gspmd.py::gspmd_safe_cfm_cfg)."""
    from jyutvoice_tpu_torch.dist.gspmd import gspmd_safe_cfm_cfg

    return gspmd_safe_cfm_cfg(cfm_cfg)


# name suffix inside a transformer block -> the weight's sharded dim (torch
# layout: a linear's weight is (out, in)); None: replicated
_BLOCK_SPECS = {
    "attn.q.weight": 0, "attn.k.weight": 0, "attn.v.weight": 0,
    "attn.o.weight": 1, "attn.o.bias": None,
    "ff_in.weight": 0, "ff_in.bias": 0,
    "ff_out.weight": 1, "ff_out.bias": None,
}


def _is_quantized(module: nn.Module) -> bool:
    return any(name.endswith("w_q") for name, _ in module.named_buffers())


def estimator_partition_specs(est: nn.Module, axis: str = "model") -> Dict[str, Optional[tuple]]:
    """Parameter name -> (axis, dim) for the slices of a loaded estimator
    that shard over `axis`, None for the replicated ones."""
    if _is_quantized(est):
        raise ValueError(INT8_TP_ERROR)
    specs = {}
    for name, _ in est.named_parameters():
        dim = None
        if ".blocks." in name:
            suffix = name.split(".blocks.")[1].split(".", 1)[1]
            dim = _BLOCK_SPECS.get(suffix)
        specs[name] = None if dim is None else (axis, dim)
    return specs


def tts_partition_tree(model: nn.Module, mesh: Mesh, axis: str = "model"):
    """Specs for a whole TTS module: estimator weights TP-sharded, everything
    else replicated (names prefixed as in `model.named_parameters()`)."""
    specs = {name: None for name, _ in model.named_parameters()}
    for name, spec in estimator_partition_specs(model.decoder, axis).items():
        specs["decoder." + name] = spec
    return specs


class RowParallelLinear(nn.Module):
    """This rank's input slice of a linear: y = all_reduce(x W_r^T) + b,
    the bias added once, after the sum."""

    def __init__(self, weight: Tensor, bias: Optional[Tensor], comm):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.comm = comm

    def forward(self, x: Tensor) -> Tensor:
        y = self.comm.all_reduce(F.linear(x, self.weight))
        return y if self.bias is None else y + self.bias


class TPPlainMHA(PlainMHA):
    """`PlainMHA` over this rank's heads: the estimator passes the model's
    head count, this module runs H / n of them."""

    def __init__(self, attn: PlainMHA, n_heads: int, n: int, r: int, comm):
        inner, dim = attn.q.weight.shape
        local = inner // n
        super().__init__(dim, n_heads // n, inner // n_heads)
        rows = slice(r * local, (r + 1) * local)
        with torch.no_grad():
            for name in ("q", "k", "v"):
                getattr(self, name).weight = nn.Parameter(
                    getattr(attn, name).weight[rows].clone(), requires_grad=False)
        self.o = RowParallelLinear(attn.o.weight[:, rows].clone(), attn.o.bias, comm)
        self.tp = n

    def forward(self, x: Tensor, lengths: Tensor, n_heads: int, **kw) -> Tensor:
        return super().forward(x, lengths, n_heads // self.tp, **kw)


def tp_shard_estimator(est: nn.Module, mesh: Mesh, axis: str = "model") -> nn.Module:
    """This rank's TP copy of a loaded estimator (the module given is left
    as it is): every transformer block's attention over H/n heads and its
    feed-forward over a 1/n hidden slice, the rest replicated."""
    require_unet(est, "tensor parallelism (dist/tp.py)")
    if _is_quantized(est):
        raise ValueError(INT8_TP_ERROR)
    n, r, comm = mesh.axis_size(axis), mesh.axis_index(axis), mesh.comm(axis)
    heads = est.cfg.num_heads
    if heads % n:
        raise ValueError(f"{heads} heads do not split over {n} model ranks")
    from jyutvoice_tpu_torch.models.estimator import TransformerBlock

    out = copy.deepcopy(est)
    for blk in out.modules():
        if not isinstance(blk, TransformerBlock):
            continue
        hidden = blk.ff_in.weight.shape[0]
        if hidden % n:
            raise ValueError(f"feed-forward width {hidden} does not split over {n} ranks")
        cols = slice(r * hidden // n, (r + 1) * hidden // n)
        blk.attn = TPPlainMHA(blk.attn, heads, n, r, comm)
        ff_in = core.Linear(blk.ff_in.weight.shape[1], hidden // n)
        with torch.no_grad():
            ff_in.weight = nn.Parameter(blk.ff_in.weight[cols].clone(), requires_grad=False)
            ff_in.bias = nn.Parameter(blk.ff_in.bias[cols].clone(), requires_grad=False)
        blk.ff_in = ff_in
        blk.ff_out = RowParallelLinear(blk.ff_out.weight[:, cols].clone(), blk.ff_out.bias, comm)
    return out.to(mesh.device)


def tp_cfm_solve(params: nn.Module, cfm_cfg, mesh: Mesh, *, n_timesteps: int):
    """`cfm_forward` with the estimator TP-sharded over `mesh`'s model axis:
    `dist/sp.py::sp_cfm_solve` on `tp_cfm_cfg(cfm_cfg)` (a mesh without a
    "seq" axis runs the whole sequence on every rank)."""
    from jyutvoice_tpu_torch.dist.sp import sp_cfm_solve

    return sp_cfm_solve(params, tp_cfm_cfg(cfm_cfg), mesh, n_timesteps=n_timesteps)


def _estimator_rank(mesh: Mesh, key: str, shapes) -> Tensor:
    from jyutvoice_tpu_torch.models.estimator import with_attention_backend

    dev = mesh.device
    if mesh.rank == 0:
        args = mesh.state.pop("_inputs")
    else:
        args = tuple(torch.empty(s, device=dev) for s in shapes)
    comm = mesh.comm()
    for a in args:
        comm.broadcast(a)
    from jyutvoice_tpu_torch.dist.gspmd import safe_backend

    est = mesh.state[key]
    est = with_attention_backend(est, safe_backend(est.cfg.attention_backend))
    with torch.inference_mode():
        return est(*args)


def tp_estimator(params_on_mesh, x, mask, mu, t, spks, cond) -> Tensor:
    """One estimator call with the estimator TP-sharded over the mesh of
    `params_on_mesh` (`dist/sp.py::shard_params`), inputs whole on rank 0,
    on the score-materializing route: returns the velocity (B, T, 80)."""
    mesh = params_on_mesh.mesh
    if mesh.axis_size("seq") > 1:
        raise ValueError("tp_estimator runs on a mesh without a sequence axis")
    args = tuple(a.to(mesh.device, torch.float32).contiguous()
                 for a in (x, mask, mu, t, spks, cond))
    mesh.state["_inputs"] = args
    return mesh.run(_estimator_rank, params_on_mesh.key, [tuple(a.shape) for a in args])
