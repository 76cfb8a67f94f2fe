"""Device meshes and sharding over `torch.distributed` (PyTorch port of
`fidm_tpu/parallel/mesh.py`).

The JAX package shards one program over a `jax.sharding.Mesh`; the port runs
one process per device, and a `torch.distributed.device_mesh.DeviceMesh`
with the dimension names ("data", "fsdp") names the ranks:

  - "data": the batch is split over the ranks and the gradients averaged
    (data parallelism, for training, distillation and eval sampling);
  - "fsdp": the parameters at least `min_size` elements large are split too,
    each rank holding one shard between steps (ZeRO-3); a step gathers them
    for the forward and reduce-scatters their gradients
    (`parallel/collectives.py`).

The batch is split over both axes, rank r = d * fsdp + f taking chunk r of
every global batch, as the JAX package's `P(("data", "fsdp"))` splits it.
The JAX package's third axis, "model" (tensor and spatial parallelism), is
not in the port yet: `create_mesh(model > 1)` and
`shard_batch(spatial=True)` raise NotImplementedError.

Differences from the JAX package:
  - every rank of the process group must be in the mesh (a rank outside a
    JAX mesh is an idle device; here it would be a process that deadlocks
    the collectives), so `auto_mesh` raises where the JAX version would
    leave devices idle;
  - `create_mesh` needs the process group (`multihost.initialize`);
    `devices`, when given, must be its ranks in rank order (rank r takes
    chunk r of every batch);
  - specs and shardings are DTensor placements (`Shard(d)`, `Replicate()`)
    keyed by the ADM parameter name, where the JAX package has
    `PartitionSpec`s over the Flax tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

__all__ = [
    "create_mesh",
    "auto_mesh",
    "batch_sharding",
    "replicated",
    "fsdp_param_specs",
    "shard_params",
    "shard_batch",
    "axis_size",
    "batch_index",
]

AXES = ("data", "fsdp")
_NEXT_SLICE = ("the 'model' mesh axis (tensor and spatial parallelism, parallel/tp.py) "
               "is not ported yet; it is the next slice of the port")


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs the process group: call parallel.multihost.initialize() "
            "(or torch.distributed.init_process_group) first")
    return dist.get_world_size()


def create_mesh(data: Optional[int] = None, fsdp: int = 1,
                devices: Optional[Sequence[int]] = None, model: int = 1) -> DeviceMesh:
    """A (data, fsdp) mesh over the ranks of the process group, in rank
    order (`devices`, when given, must be those ranks). `data=None` takes
    every rank the fsdp axis leaves. The fsdp ranks of one data index are
    adjacent, so the parameter gathers run between neighbours."""
    if model > 1:
        raise NotImplementedError(f"create_mesh(model={model}): {_NEXT_SLICE}")
    world = _world()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data is None:
        data = n // fsdp
    if data * fsdp != n:
        raise ValueError(f"mesh {data}x{fsdp} != {n} devices")
    if ranks != list(range(world)):
        raise ValueError(f"the mesh must hold every rank of the process group in rank "
                         f"order ({world} ranks), got {ranks}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, fsdp),
                      mesh_dim_names=AXES)


def auto_mesh(batch_size: int, fsdp: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """The mesh of every rank, data axis = ranks / fsdp. The batch must
    divide over all of them: where the JAX version would pick a smaller data
    axis and leave devices idle, this raises with the numbers."""
    world = _world() if devices is None else len(devices)
    if world % fsdp:
        raise ValueError(f"fsdp={fsdp} does not divide the {world} ranks")
    data = world // fsdp
    if batch_size % world:
        jax_data = max(d for d in range(1, data + 1) if batch_size % d == 0)
        raise ValueError(
            f"batch size {batch_size} does not divide over the {world} ranks "
            f"(data={data} x fsdp={fsdp}); the JAX package would use a data axis of "
            f"{jax_data} and leave {(data - jax_data) * fsdp} device(s) idle, but every "
            "rank of a process group must take rows: pick a batch size that is a "
            f"multiple of {world}")
    return create_mesh(data=data, fsdp=fsdp, devices=devices)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis `name` (1 if the mesh has no such axis)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.shape[names.index(name)]) if name in names else 1


def batch_index(mesh: DeviceMesh) -> int:
    """This rank's chunk of every global batch: d * fsdp + f at mesh
    coordinate (d, f), which is its rank."""
    d, f = mesh.get_coordinate()
    return d * axis_size(mesh, "fsdp") + f


def batch_sharding(mesh) -> Tuple:
    """The batch dimension split over the data and fsdp axes, as DTensor
    placements over the mesh."""
    return (Shard(0), Shard(0))


def replicated(mesh) -> Tuple:
    return (Replicate(), Replicate())


def _jax_axes(name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The tensor's axes in the order of the JAX package's layout of the
    same parameter: a conv [O, I, kh, kw] is [kh, kw, I, O] there, a linear
    [O, I] and an attention Conv1d [O, I, 1] are Dense [I, O], an embedding
    and the vectors are the same."""
    if t.ndim == 4:
        return (2, 3, 1, 0)
    if t.ndim == 3 and t.shape[-1] == 1:
        return (1, 0)
    if t.ndim == 2 and not name.endswith("label_emb.weight"):
        return (1, 0)
    return tuple(range(t.ndim))


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def fsdp_param_specs(params, mesh, min_size: int = 2**18) -> Dict:
    """ZeRO-3 placements by parameter name: each tensor of at least
    `min_size` elements is `Shard(d)` along its largest axis that divides by
    the fsdp axis size, the first such axis in the JAX layout's order
    (`_jax_axes`), so the port splits the same logical dimension as the JAX
    package; everything else is `Replicate()`. `params` is a dict by ADM
    name or a module."""
    n = axis_size(mesh, "fsdp")

    def spec_for(name, t):
        if n <= 1 or t.numel() < min_size:
            return Replicate()
        axes = _jax_axes(name, t)
        for a in sorted(range(len(axes)), key=lambda a: -t.shape[axes[a]]):
            if t.shape[axes[a]] % n == 0:
                return Shard(axes[a])
        return Replicate()

    return {k: spec_for(k, t) for k, t in _named(params).items()}


def fsdp_rank(mesh) -> int:
    """This rank's index on the fsdp axis, in the order of its group's
    collectives."""
    group = mesh.get_group("fsdp")
    return dist.get_group_rank(group, dist.get_rank())


@torch.no_grad()
def shard_params(params, mesh, use_fsdp: bool = False,
                 min_size: int = 2**18) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(params, specs): with `use_fsdp`, each `Shard(d)` tensor replaced by
    this rank's shard (a copy; the caller's full tensor is left as it is);
    otherwise the tensors as they are (each rank holds its replica) and
    every spec `Replicate()`."""
    params = _named(params)
    if not use_fsdp:
        return dict(params), {k: Replicate() for k in params}
    specs = fsdp_param_specs(params, mesh, min_size)
    n, i = axis_size(mesh, "fsdp"), fsdp_rank(mesh)
    out = {k: (t.detach().chunk(n, specs[k].dim)[i].clone() if isinstance(specs[k], Shard)
               else t) for k, t in params.items()}
    return out, specs


def shard_batch(batch, mesh, spatial: bool = False, spatial_axis: str = "model"):
    """This rank's rows of a host batch that every rank holds whole (a dict
    of arrays or tensors, or one array): chunk `batch_index(mesh)` of the
    batch dimension. `spatial=True` is the next slice's."""
    if spatial:
        raise NotImplementedError(f"shard_batch(spatial=True): {_NEXT_SLICE}")
    W, r = mesh.size(), batch_index(mesh)

    def rows(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        b = x.shape[0]
        if b % W:
            raise ValueError(f"batch {b} does not divide over the {W} ranks of the mesh")
        return x[r * (b // W): (r + 1) * (b // W)]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch) if isinstance(batch, (np.ndarray, torch.Tensor)) else batch
