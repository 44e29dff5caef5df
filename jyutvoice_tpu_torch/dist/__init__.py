"""Multi-device paths of the port on torch.distributed: the data mesh of a
torchrun job, spawned meshes of ranks, and the sequence- and
tensor-parallel estimator (the counterpart of the JAX package's `dist/`)."""

from jyutvoice_tpu_torch.dist.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from jyutvoice_tpu_torch.dist.gspmd import gspmd_safe_cfm_cfg  # noqa: F401
from jyutvoice_tpu_torch.dist.ring import ring_attention  # noqa: F401
from jyutvoice_tpu_torch.dist.sp import (  # noqa: F401
    make_sp_mesh,
    seq_sharding,
    shard_params,
    sp_cfm_solve,
    sp_param_shardings,
)
from jyutvoice_tpu_torch.dist.tp import make_tp_mesh, tp_cfm_cfg  # noqa: F401
