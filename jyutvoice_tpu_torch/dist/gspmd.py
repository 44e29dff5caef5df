"""The attention rewrite shared by the multi-device estimator paths.

The counterpart of the JAX package's `dist/gspmd.py`. There it keeps
Pallas calls out of GSPMD-partitioned graphs (XLA cannot partition a
custom call and would gather the whole sequence onto every chip). Here the
sharded paths are written by hand, so the kernels could run on a rank's
local heads or shard; the port follows the JAX package's route all the
same (a later, measured decision): the tensor-parallel estimator
(`dist/tp.py::tp_cfm_cfg`) and the sequence-parallel solve
(`dist/sp.py::sp_cfm_solve`) rewrite the kernel-capable backends to
"xla_scores", which routes to plain attention (`models/estimator.py::
attention_route`). The data-parallel fine-tune runs each rank's rows whole
and keeps kernels 3-5, so training needs no rewrite.
"""

from __future__ import annotations

import dataclasses

_KERNEL_CAPABLE = ("xla", "pallas")
# "ring" only works inside dist/sp.py's solver, which sets it itself
_UNSAFE = _KERNEL_CAPABLE + ("ring",)
# the loss rewrites "banded" to "xla" (a band is never backpropagated), whose
# stock-flash gate then fires; train=True keeps such a config on "xla_scores"
_UNSAFE_TRAIN = _UNSAFE + ("banded",)


def safe_backend(backend: str, *, train: bool = False) -> str:
    """'xla_scores' for a kernel-capable (or ring) backend, else `backend`;
    train=True also rewrites 'banded'."""
    return "xla_scores" if backend in (_UNSAFE_TRAIN if train else _UNSAFE) else backend


def gspmd_safe_cfm_cfg(cfm_cfg, *, train: bool = False):
    """Rewrite any kernel-capable (or ring) attention backend to
    'xla_scores'. train=True also rewrites 'banded'."""
    backend = safe_backend(cfm_cfg.estimator.attention_backend, train=train)
    if backend == cfm_cfg.estimator.attention_backend:
        return cfm_cfg
    return dataclasses.replace(
        cfm_cfg,
        estimator=dataclasses.replace(cfm_cfg.estimator, attention_backend="xla_scores"),
    )
