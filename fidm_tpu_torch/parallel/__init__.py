"""Data-parallel and ZeRO-3 (fsdp) sharding across processes (PyTorch port
of `fidm_tpu/parallel`, less the tensor-parallel `tp.py`, which is the next
slice)."""
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

__all__ = ["auto_mesh", "batch_sharding", "create_mesh", "fsdp_param_specs", "replicated",
           "shard_batch", "shard_params", "global_batch", "host_local_slice", "initialize",
           "launched_by_env", "is_primary", "barrier"]
