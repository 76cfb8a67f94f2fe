"""Multi-process initialization and per-process data slicing (PyTorch port
of `fidm_tpu/parallel/multihost.py`).

The JAX package runs one controller per host over many devices; the port
runs one process per device over `torch.distributed`. `initialize` joins
this process to the process group (NCCL on a CUDA device, gloo on the CPU),
every rank feeds only its rows of each global batch (`host_local_slice`),
and the steps average over the ranks (`parallel/collectives.py`).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "launched_by_env", "host_local_slice", "global_batch",
           "is_primary", "barrier", "process_count", "process_index"]

# markers of the multi-process launchers that the JAX package auto-detects
_LAUNCHER_ENV_VARS = (
    "COORDINATOR_ADDRESS",
    "JAX_COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)
# launchers that also need evidence of MORE than one task: a bare SLURM job
# of one task stays a no-op; torchrun's WORLD_SIZE joins them here
_LAUNCHER_SIZE_VARS = ("SLURM_STEP_NUM_TASKS", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                       "WORLD_SIZE")
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")


def launched_by_env() -> bool:
    """True when a multi-process launcher's environment is present: a host
    list of more than one entry (TPU_WORKER_HOSTNAMES), a coordinator
    address, or a size variable above 1 (SLURM, Open MPI, torchrun's
    WORLD_SIZE). A plain shell or a single-task launcher gives False, so
    `initialize()` is a no-op there."""
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return True
    if any(v in os.environ for v in _LAUNCHER_ENV_VARS):
        return True
    for v in _LAUNCHER_SIZE_VARS:
        try:
            if int(os.environ.get(v, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def _env_int(names, default: Optional[int] = None) -> Optional[int]:
    for v in names:
        if os.environ.get(v, "").strip():
            return int(os.environ[v])
    return default


def _env_address() -> Optional[str]:
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    for v in _LAUNCHER_ENV_VARS:
        if os.environ.get(v):
            return os.environ[v]
    return None


def local_device(device="cuda") -> torch.device:
    """This process's device: for CUDA, the card numbered by the launcher's
    local rank (LOCAL_RANK, else 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _env_int(_LOCAL_RANK_VARS, 0))
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> bool:
    """Join this process to the process group. Returns True if it did (or
    the group already exists), False for a single process.

    - explicit `num_processes` > 1: `init_process_group` at
      tcp://`coordinator_address` (host:port) as rank `process_id`;
      `num_processes` <= 1 is a no-op;
    - no arguments under a launcher (`launched_by_env`): rank, size and
      address from its environment (torchrun's RANK, WORLD_SIZE,
      MASTER_ADDR and MASTER_PORT; SLURM's or Open MPI's rank and size with a
      coordinator address);
    - no arguments and no launcher: a no-op.

    The backend is NCCL when `device` is CUDA (this process then works on
    `local_device(device)`, the card of its LOCAL_RANK) and gloo on the CPU.
    A CUDA run without NCCL raises; it never moves to gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    if num_processes is not None:
        if num_processes <= 1:
            return False
        if coordinator_address is None or process_id is None:
            raise ValueError("initialize(num_processes=...) needs coordinator_address "
                             "and process_id")
        world, rank, address = int(num_processes), int(process_id), coordinator_address
    elif launched_by_env():
        world = _env_int(("WORLD_SIZE", "SLURM_STEP_NUM_TASKS", "SLURM_NTASKS",
                          "OMPI_COMM_WORLD_SIZE"))
        rank = _env_int(_RANK_VARS)
        address = _env_address()
        if world is None or rank is None or address is None:
            raise RuntimeError(
                "a launcher environment is present but its rank, size or coordinator "
                "address is missing (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR and "
                "MASTER_PORT); pass initialize(coordinator_address, num_processes, "
                "process_id)")
        if world <= 1:
            return False
    else:
        return False
    device = local_device(device)
    if device.type == "cuda":
        from ..device import resolve_device

        resolve_device(device)
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA process group needs NCCL, which this torch lacks")
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    return True


def process_count() -> int:
    """The number of ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_local_slice(global_index: np.ndarray,
                     global_batch_size: Optional[int] = None) -> np.ndarray:
    """This process's slice of a global example-index array.

    Without `global_batch_size`: the contiguous 1/process_count slice.

    With `global_batch_size` B: the per-batch slice. The order is viewed as
    consecutive global batches of B, and this process takes rows
    [i*B/n, (i+1)*B/n) of each, so the ranks' rows of every step, in rank
    order, are exactly the batch one process would make. A ragged tail short
    of a full global batch is dropped."""
    n = process_count()
    i = process_index()
    if global_batch_size is None:
        per = len(global_index) // n
        return global_index[i * per: (i + 1) * per]
    B = int(global_batch_size)
    if B % n:
        raise ValueError(f"global batch size {B} must divide by process count {n}")
    local = B // n
    nb = len(global_index) // B
    arr = np.asarray(global_index)[: nb * B].reshape(nb, B)
    return arr[:, i * local: (i + 1) * local].reshape(-1)


def is_primary() -> bool:
    """True on the process that owns the singleton host-side effects
    (checkpoint directory surgery, marker writes, reports, logging)."""
    return process_index() == 0


def barrier(tag: str = "") -> None:
    """Cross-process sync point; a no-op in one process. `tag` names the
    point for a reader of the code (torch's barrier takes no name)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def global_batch(local_arrays, mesh=None, sharding=None):
    """The global batch of a step, from this process's local rows.

    In the JAX package this assembles one globally sharded array. In the
    port each rank is one process that holds its rows and runs the step on
    them (the steps reduce over the ranks), so the rows ARE this rank's
    part of the global batch and come back unchanged. Kept for the JAX
    package's callers."""
    return local_arrays
