"""Multi-device training behind ``--mesh`` (counterpart of
``dyadic_interaction_modeling_tpu/parallel/``), on ``torch.distributed``."""

from .mesh import (
    data_sharding,
    fsdp_param_shardings,
    fsdp_param_spec,
    init_distributed,
    is_master,
    make_mesh,
    replicate,
    shard_batch,
    tp_param_shardings,
    tp_param_spec,
)
from .plan import MeshPlan, launch

__all__ = [
    "MeshPlan",
    "make_mesh",
    "shard_batch",
    "replicate",
    "tp_param_spec",
    "tp_param_shardings",
    "fsdp_param_spec",
    "fsdp_param_shardings",
    "data_sharding",
    "init_distributed",
    "is_master",
    "launch",
]
