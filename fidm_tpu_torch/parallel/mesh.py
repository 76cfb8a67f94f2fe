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

  - "model" (only when `create_mesh(model > 1)`, the innermost axis, so rank
    = (d * fsdp + f) * model + m, as the JAX package's reshape(data, fsdp,
    model) lays its devices out): Megatron tensor parallelism of the UNet's
    channels, or spatial partitioning of its images along H
    (`parallel/tp.py`). The ranks of one model group hold the same rows.

The batch is split over the data and fsdp axes, the ranks at (d, f) taking
chunk d * fsdp + f of every global batch, as the JAX package's
`P(("data", "fsdp"))` splits it; `shard_batch(spatial=True)` also gives each
rank of a model group its block of H rows of every image leaf.

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
    `PartitionSpec`s over the Flax tree; a tensor split over the model axis
    is a `ModelShard(dim, parts)`, whose rank-local slice `local_slice` cuts
    and `join_slices` joins back (`parallel/tp.py` says why it is not a
    contiguous chunk).
"""
from __future__ import annotations

import dataclasses
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
    "spatial_block",
    "axis_size",
    "batch_index",
    "row_ranks",
    "rows_group",
    "model_rank",
    "ModelShard",
    "local_slice",
    "join_slices",
]

AXES = ("data", "fsdp")
MODEL_AXES = ("data", "fsdp", "model")

# mesh -> the group of the ranks that share its model index (data x fsdp)
_ROW_GROUPS: Dict = {}


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs the process group: call parallel.multihost.initialize() "
            "(or torch.distributed.init_process_group) first")
    return dist.get_world_size()


def create_mesh(data: Optional[int] = None, fsdp: int = 1,
                devices: Optional[Sequence[int]] = None, model: int = 1) -> DeviceMesh:
    """A (data, fsdp[, model]) mesh over the ranks of the process group, in
    rank order (`devices`, when given, must be those ranks). `data=None`
    takes every rank the other axes leave. The model ranks of one (data,
    fsdp) index are adjacent, then the fsdp ranks, so the chattiest
    collectives run between neighbours. The "model" axis exists only when
    model > 1, so two-axis meshes stay as they are."""
    world = _world()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data is None:
        data = n // (fsdp * model)
    if data * fsdp * model != n:
        shape = f"{data}x{fsdp}" + (f"x{model}" if model > 1 else "")
        raise ValueError(f"mesh {shape} != {n} devices")
    if ranks != list(range(world)):
        raise ValueError(f"the mesh must hold every rank of the process group in rank "
                         f"order ({world} ranks), got {ranks}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model <= 1:
        return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, fsdp),
                          mesh_dim_names=AXES)
    mesh = DeviceMesh(device_type, torch.tensor(ranks).reshape(data, fsdp, model),
                      mesh_dim_names=MODEL_AXES)
    # every rank makes every group, in the same order
    groups = [dist.new_group(list(range(m, n, model))) for m in range(model)]
    _ROW_GROUPS[mesh] = groups[dist.get_rank() % model]
    return mesh


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
    coordinate (d, f[, m]) (its rank without a model axis)."""
    d, f = mesh.get_coordinate()[:2]
    return d * axis_size(mesh, "fsdp") + f


def row_ranks(mesh) -> int:
    """The number of chunks a global batch splits into: data x fsdp (the
    ranks of one model group hold the same rows)."""
    return axis_size(mesh, "data") * axis_size(mesh, "fsdp")


def rows_group(mesh):
    """The process group of the ranks that share this rank's model index
    (the data x fsdp ranks, over which rows are split and gradients
    summed): None, the whole group, for a mesh without a model axis."""
    return _ROW_GROUPS[mesh] if axis_size(mesh, "model") > 1 else None


def model_rank(mesh) -> int:
    """This rank's index on the model axis (0 without one)."""
    return mesh.get_coordinate()[2] if axis_size(mesh, "model") > 1 else 0


def batch_sharding(mesh) -> Tuple:
    """The batch dimension split over the data and fsdp axes, as DTensor
    placements over the mesh (replicated over the model axis)."""
    return (Shard(0), Shard(0)) + (Replicate(),) * (len(mesh.mesh_dim_names) - 2)


def replicated(mesh) -> Tuple:
    return (Replicate(),) * len(mesh.mesh_dim_names)


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
    out = {k: fsdp_shard(t, specs[k].dim, mesh) if isinstance(specs[k], Shard) else t
           for k, t in params.items()}
    return out, specs


def fsdp_shard(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's fsdp shard of the whole tensor `t` along `dim` (a copy)."""
    return t.detach().chunk(axis_size(mesh, "fsdp"), dim)[fsdp_rank(mesh)].clone()


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A tensor split over the model axis along torch axis `dim`: that axis
    is `parts` equal runs (q | k | v, scale | shift, or one) and a rank
    holds its 1/k of each run."""

    dim: int
    parts: int = 1


def local_slice(t: torch.Tensor, spec: ModelShard, k: int, i: int) -> torch.Tensor:
    """Rank i's slice of the whole tensor `t` (a view)."""
    n = t.shape[spec.dim] // spec.parts
    runs = t.unflatten(spec.dim, (spec.parts, n))
    return runs.narrow(spec.dim + 1, i * (n // k), n // k).flatten(spec.dim, spec.dim + 1)


def join_slices(slices, spec: ModelShard) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order: the inverse
    of `local_slice`."""
    runs = [s.unflatten(spec.dim, (spec.parts, s.shape[spec.dim] // spec.parts))
            for s in slices]
    return torch.cat(runs, dim=spec.dim + 1).flatten(spec.dim, spec.dim + 1)


def shard_batch(batch, mesh, spatial: bool = False, spatial_axis: str = "model"):
    """This rank's rows of a host batch that every rank holds whole (a dict
    of arrays or tensors, or one array): chunk `batch_index(mesh)` of the
    batch dimension. With `spatial=True` (and a `spatial_axis` of more than
    one rank) an image-like leaf (ndim >= 4, NHWC) whose H divides by that
    axis's size also keeps only block `model_rank(mesh)` of its H rows; every
    other leaf keeps its rows only, as in the JAX package."""
    W, r = row_ranks(mesh), batch_index(mesh)

    def rows(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        b = x.shape[0]
        if b % W:
            raise ValueError(f"batch {b} does not divide over the {W} ranks of the mesh")
        return x[r * (b // W): (r + 1) * (b // W)]

    batch = _leaves(batch, rows)
    return spatial_block(batch, mesh, spatial_axis) if spatial else batch


def spatial_block(batch, mesh, axis: str = "model"):
    """The spatial half of `shard_batch(spatial=True)`: of rows this rank
    already holds (a dict, or one array or tensor), each image-like leaf
    (ndim >= 4, NHWC) whose H divides by the size of `axis` keeps block
    `model_rank(mesh)` of its H rows; the rest stays as it is. `fit` cuts a
    process-local loader's rows so for a spatial step."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return batch
    m = mesh.get_coordinate()[list(mesh.mesh_dim_names).index(axis)]

    def block(x):
        if hasattr(x, "shape") and len(x.shape) >= 4 and x.shape[1] % n == 0:
            h = x.shape[1] // n
            return x[:, m * h:(m + 1) * h]
        return x

    return _leaves(batch, block)


def _leaves(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch) if isinstance(batch, (np.ndarray, torch.Tensor)) else batch
