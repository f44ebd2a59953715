"""Multi-process execution on ``torch.distributed``: process groups, row
and block sharding, collective Gauss-Newton (port of
``dynamicfuion_python_tpu/parallel``)."""

from dynamicfuion_python_tpu_torch.parallel.distributed import (
    distributed_fit_step_global,
    global_rows_from_local,
    initialize,
    run_ranks,
)
from dynamicfuion_python_tpu_torch.parallel.spmd import (
    distributed_fit_step,
    fusion_group,
    replicate,
    shard_blocks,
    shard_pixel_rows,
)

__all__ = [
    "distributed_fit_step",
    "distributed_fit_step_global",
    "fusion_group",
    "global_rows_from_local",
    "initialize",
    "replicate",
    "run_ranks",
    "shard_blocks",
    "shard_pixel_rows",
]
