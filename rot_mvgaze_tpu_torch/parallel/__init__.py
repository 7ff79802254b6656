"""Data-parallel training over processes, one card each (counterpart of
``rot_mvgaze_tpu/parallel``: the parts that training needs; meshes and
spatial partitioning are not ported)."""

from rot_mvgaze_tpu_torch.parallel.distributed import (
    all_gather_object,
    any_process,
    broadcast_object,
    configured_world_size,
    device_group,
    host_group,
    initialize,
    local_rank,
    process_count,
    process_index,
    set_batchnorm_group,
    shutdown,
)

__all__ = [
    "initialize",
    "shutdown",
    "configured_world_size",
    "process_index",
    "process_count",
    "local_rank",
    "device_group",
    "host_group",
    "broadcast_object",
    "all_gather_object",
    "any_process",
    "set_batchnorm_group",
]
