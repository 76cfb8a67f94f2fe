"""Data-parallel, ZeRO-3 (fsdp), tensor-parallel and spatial sharding across
processes (PyTorch port of `fidm_tpu/parallel`)."""
from .mesh import (
    auto_mesh,
    batch_sharding,
    create_mesh,
    fsdp_param_specs,
    replicated,
    shard_batch,
    shard_params,
)
from .multihost import (barrier, global_batch, host_local_slice, initialize, is_primary,
                        launched_by_env)
from .tp import spatial_sharding, tp_param_specs, tp_shard_params

__all__ = ["auto_mesh", "batch_sharding", "create_mesh", "fsdp_param_specs", "replicated",
           "shard_batch", "shard_params", "global_batch", "host_local_slice", "initialize",
           "launched_by_env", "is_primary", "barrier", "spatial_sharding", "tp_param_specs",
           "tp_shard_params"]
