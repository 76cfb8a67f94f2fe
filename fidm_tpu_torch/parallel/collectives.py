"""What a step does under a mesh, one process per rank (the port's
counterpart of the collectives XLA inserts into a meshed JAX program).

- `Rows` and `RowDraws`: a rank holds rows [lo, hi) of a global batch of
  `total`; its random draws are ITS ROWS of the draws one process would make
  for the whole batch (the JAX step draws for the global batch from one
  replicated key), so the ranks together make exactly the one-process run.
- `RowNoise`: the same for a sampler's noise source.
- `mean_over_ranks`: in-place sum over every rank, times 1 / world (the
  global-batch mean of equal slices; bit for bit the input on one rank).
- `gathered`: a module whose sharded parameters hold their full tensors
  inside the block (all-gather over the fsdp axis) and an empty placeholder
  after it, so a ZeRO-3 rank keeps only its shards between steps.
- `reduce_gradients`: full gradients to the state's layout, averaged over
  the ranks: reduce-scatter over the fsdp axis for the sharded tensors, then
  all-reduce over the data axis; all-reduce over every rank for the rest,
  one collective per dtype over the tensors' concatenation.
- `global_grad_norm`: the norm of the whole gradient from the shards.
- `broadcast_object`: the primary's value on every rank.
- `ShardedModule`: a frozen module kept as shards between calls.
- The model axis (`parallel/tp.py`): `ModelGroup` (`model_group(mesh)`)
  is this rank's model group, the process group of the collectives below;
  `HBlock`, `SpatialDraws` and `SpatialNoise` cut a rank's block of H rows
  from its rows' draws, as `RowDraws` cuts rows; `copy_to_model` (identity forward, all-reduce
  backward: before a column-parallel layer), `reduce_from_model`
  (all-reduce forward, identity backward: after a row-parallel one),
  `halo_rows` (the neighbours' boundary rows of an H block, zeros at the
  image's edges; the backward hands each halo's gradient to its owner),
  `gather_h` (the H blocks joined; the backward all-reduces and keeps this
  rank's block), `gather_stats` (every rank's GroupNorm statistics; the same
  backward) and `gather_slices` (a tensor's model-axis slices joined whole
  for a block that cannot run split; the backward keeps this rank's slice).
  They use `all_reduce` and `all_gather` only, over the model group.

The collectives are `all_reduce`, `all_gather(_into_tensor)`,
`reduce_scatter_tensor` and `broadcast_object_list` (NCCL on CUDA, gloo on
the CPU; gloo also carries the model axis's on CUDA tensors).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from .mesh import (ModelShard, axis_size, batch_index, join_slices, local_slice, model_rank,
                   row_ranks, rows_group)

__all__ = ["Rows", "rank_rows", "RowDraws", "RowNoise", "mean_over_ranks", "gather_rows",
           "gathered", "release", "reduce_gradients", "global_grad_norm",
           "broadcast_object", "sharded_names", "model_sharded_names", "full_params",
           "ShardedModule", "whole", "ModelGroup", "model_group", "HBlock", "rank_hblock",
           "SpatialDraws", "SpatialNoise", "copy_to_model", "reduce_from_model", "halo_rows", "gather_h", "gather_stats",
           "gather_slices"]


class Rows(NamedTuple):
    """Rows [lo, hi) of a global batch of `total` rows."""

    lo: int
    hi: int
    total: int

    def of(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.lo:self.hi]


def rank_rows(mesh, local_batch: int) -> Rows:
    """This rank's rows when every rank holds `local_batch` of them (the
    ranks of a model group hold the same ones)."""
    i = batch_index(mesh)
    return Rows(i * local_batch, (i + 1) * local_batch, local_batch * row_ranks(mesh))


class RowDraws:
    """A training draws object (`training.TrainDraws` or a stand-in) whose
    batch-shaped draws are made for the global batch and cut to `rows`.
    `split(n)` (microbatches) keeps this rank's rows of each global
    microbatch."""

    def __init__(self, draws, rows: Rows):
        self.draws, self.rows = draws, rows

    def fold(self, index: int) -> "RowDraws":
        return RowDraws(self.draws.fold(index), self.rows)

    def split(self, n: int) -> List["RowDraws"]:
        lo, hi, total = self.rows
        if (hi - lo) % n or total % n:
            raise ValueError(f"{hi - lo} rows of {total} do not split into {n} microbatches")
        sub = Rows(lo // n, hi // n, total // n)
        return [RowDraws(d, sub) for d in self.draws.split(n)]

    def generator(self, stream: int = 3):
        return self.draws.generator(stream)

    def _check(self, b: int):
        if b != self.rows.hi - self.rows.lo:
            raise ValueError(f"a draw of {b} rows on a rank that holds "
                             f"{self.rows.hi - self.rows.lo}")

    def timesteps(self, batch: int, num_timesteps: int) -> torch.Tensor:
        self._check(batch)
        return self.rows.of(self.draws.timesteps(self.rows.total, num_timesteps))

    def noise(self, shape) -> torch.Tensor:
        self._check(shape[0])
        return self.rows.of(self.draws.noise((self.rows.total,) + tuple(shape[1:])))

    def inject(self, shape) -> torch.Tensor:
        self._check(shape[0])
        return self.rows.of(self.draws.inject((self.rows.total,) + tuple(shape[1:])))


class RowNoise:
    """A sampler noise source (`init`, `step`, `inject`) drawn for the
    global batch and cut to `rows`."""

    def __init__(self, noise, rows: Rows):
        self.noise, self.rows = noise, rows

    def _full(self, shape):
        return (self.rows.total,) + tuple(shape[1:])

    def init(self, shape):
        return self.rows.of(self.noise.init(self._full(shape)))

    def step(self, index, shape):
        return self.rows.of(self.noise.step(index, self._full(shape)))

    def inject(self, timestep, shape):
        return self.rows.of(self.noise.inject(timestep, self._full(shape)))


class HBlock(NamedTuple):
    """Rows [lo, hi) of the H axis (axis 1 of NHWC) of `total`: a rank's
    block under spatial partitioning."""

    lo: int
    hi: int
    total: int

    def of(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x.narrow(dim, self.lo, self.hi - self.lo)


def rank_hblock(mesh, local_h: int) -> HBlock:
    """This rank's block of H rows when each holds `local_h` of them."""
    m = model_rank(mesh)
    return HBlock(m * local_h, (m + 1) * local_h, local_h * axis_size(mesh, "model"))


class SpatialDraws:
    """A training draws object whose image-shaped draws are made at the
    whole H and cut to `block` (wrapping `RowDraws`, which cuts the rows)."""

    def __init__(self, draws, block: HBlock):
        self.draws, self.block = draws, block
        self.rows = getattr(draws, "rows", None)

    def _full(self, shape):
        return (shape[0], self.block.total) + tuple(shape[2:])

    def fold(self, index: int) -> "SpatialDraws":
        return SpatialDraws(self.draws.fold(index), self.block)

    def split(self, n: int) -> List["SpatialDraws"]:
        return [SpatialDraws(d, self.block) for d in self.draws.split(n)]

    def generator(self, stream: int = 3):
        return self.draws.generator(stream)

    def timesteps(self, batch: int, num_timesteps: int) -> torch.Tensor:
        return self.draws.timesteps(batch, num_timesteps)

    def noise(self, shape) -> torch.Tensor:
        return self.block.of(self.draws.noise(self._full(shape)))

    def inject(self, shape) -> torch.Tensor:
        return self.block.of(self.draws.inject(self._full(shape)))


class SpatialNoise:
    """A sampler noise source drawn at the whole H and cut to `block`
    (wrapping `RowNoise`, which cuts the rows)."""

    def __init__(self, noise, block: HBlock):
        self.noise, self.block = noise, block

    def _full(self, shape):
        return (shape[0], self.block.total) + tuple(shape[2:])

    def init(self, shape):
        return self.block.of(self.noise.init(self._full(shape)))

    def step(self, index, shape):
        return self.block.of(self.noise.step(index, self._full(shape)))

    def inject(self, timestep, shape):
        return self.block.of(self.noise.inject(timestep, self._full(shape)))


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Each tensor summed over `group`, in place, by one all-reduce per
    dtype over their concatenation (one collective, not one per tensor: a
    call costs the host about as much as a small tensor's reduction). The
    sums are copied back into the tensors, whose own storage keeps the
    alignment later reductions over them see without a mesh."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.all_reduce(flat, group=group)
        views = torch.split(flat, [t.numel() for t in group_tensors])
        torch._foreach_copy_(group_tensors, [v.view_as(t) for v, t in zip(views, group_tensors)])


def mean_over_ranks(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Each tensor becomes its mean over every rank of the mesh, in place:
    the sum, then times 1 / size."""
    tensors = list(tensors)
    _all_reduce_flat(tensors, None)
    if mesh.size() > 1:
        torch._foreach_mul_(tensors, 1.0 / mesh.size())


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of `x`, in batch order (rank r holds chunk r): the
    global batch (over the ranks of this rank's model group, which hold
    its block of H rows under spatial partitioning)."""
    W = row_ranks(mesh)
    if W == 1:
        return x
    out = torch.empty((W * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=rows_group(mesh))
    return out


def sharded_names(specs: Optional[Dict]) -> List[str]:
    return [k for k, s in (specs or {}).items() if isinstance(s, Shard)]


def _all_gather_dim(local: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = local.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(full: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = full.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def release(module: torch.nn.Module, specs: Optional[Dict]) -> None:
    """Drop the full tensors of the module's sharded parameters: each holds
    an empty placeholder of its dtype until the next `gathered`."""
    named = dict(module.named_parameters())
    for k in sharded_names(specs):
        p = named[k]
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


@contextlib.contextmanager
def gathered(module: torch.nn.Module, params: Dict[str, torch.Tensor], specs: Optional[Dict],
             mesh, keep: bool = False):
    """Inside the block every sharded parameter of `module` holds its full
    tensor, all-gathered over the fsdp axis from the shards in `params`
    (the parameter's own dtype); after it, an empty placeholder, unless
    `keep`. Without sharded parameters this does nothing."""
    names = sharded_names(specs)
    if not names:
        yield module
        return
    group, n = mesh.get_group("fsdp"), axis_size(mesh, "fsdp")
    named = dict(module.named_parameters())
    for k in names:
        named[k].data = _all_gather_dim(params[k], specs[k].dim, group, n).to(named[k].dtype)
    try:
        yield module
    finally:
        if not keep:
            release(module, specs)


def model_sharded_names(specs: Optional[Dict]) -> List[str]:
    """The names that `specs` split over the model axis (`ModelShard`)."""
    return [k for k, s in (specs or {}).items() if isinstance(s, ModelShard)]


def reduce_gradients(names: Sequence[str], grads: Sequence[torch.Tensor],
                     specs: Optional[Dict], mesh, partial: bool = False) -> List[torch.Tensor]:
    """Full per-rank gradients -> the global-batch mean in the state's
    layout: a sharded tensor's gradient reduce-scattered over the fsdp axis
    (its shard), then summed over the data axis; every other gradient summed
    over the ranks that hold other rows (one all-reduce per dtype; a model
    slice's gradient is this rank's slice already); all times 1 / the
    number of row chunks. `partial`: every gradient is this rank's part of
    a sum over the model axis, so each is also summed over it (spatial
    partitioning, where a rank saw only its H block of its rows; a LoRA
    adapter over a tensor-parallel base, where a rank differentiated only
    its slice of each delta). Otherwise, over a model axis, a tensor the
    axis keeps whole has its gradient computed by every rank of the group
    from the same inputs, but on the card cuDNN's weight-gradient kernels
    need not sum in the same order on each: it is averaged over the group,
    so that the ranks keep one value of it (the mean of k equal values is
    that value at k = 2). Without a mesh, the gradients as they are."""
    if mesh is None:
        return list(grads)
    W = row_ranks(mesh)
    out = list(grads)
    shard = set(sharded_names(specs))
    _all_reduce_flat([g for k, g in zip(names, out) if k not in shard], rows_group(mesh))
    if shard:
        fgroup, n = mesh.get_group("fsdp"), axis_size(mesh, "fsdp")
        idx = [i for i, k in enumerate(names) if k in shard]
        for i in idx:
            out[i] = _reduce_scatter_dim(out[i], specs[names[i]].dim, fgroup, n)
        if axis_size(mesh, "data") > 1:
            _all_reduce_flat([out[i] for i in idx], mesh.get_group("data"))
    k = axis_size(mesh, "model")
    if partial:
        _all_reduce_flat(out, mesh.get_group("model"))
    elif k > 1:
        model = set(model_sharded_names(specs))
        whole = [g for name, g in zip(names, out) if name not in model]
        if whole:
            _all_reduce_flat(whole, mesh.get_group("model"))
            torch._foreach_mul_(whole, 1.0 / k)
    if W > 1:
        torch._foreach_mul_(out, 1.0 / W)
    return out


def global_grad_norm(names: Sequence[str], grads: Sequence[torch.Tensor],
                     specs: Optional[Dict], mesh) -> torch.Tensor:
    """The global norm of gradients in the state's layout: the fsdp shards'
    squares summed over the fsdp axis, the model slices' over the model
    axis, the replicated ones counted once (without either, `global_norm` of
    the gradients)."""
    from ..training.train_state import global_norm

    shard, model = set(sharded_names(specs)), set(model_sharded_names(specs))
    if not shard and not model:
        return global_norm(grads)
    sq = lambda ts: torch.stack(torch._foreach_norm(ts)).square().sum()  # noqa: E731
    total = []
    for part, axis in ((shard, "fsdp"), (model, "model")):
        if part:
            s = sq([g for k, g in zip(names, grads) if k in part])
            dist.all_reduce(s, group=mesh.get_group(axis))
            total.append(s)
    rest = [g for k, g in zip(names, grads) if k not in shard and k not in model]
    if rest:
        total.append(sq(rest))
    return torch.sqrt(sum(total[1:], total[0]))


def broadcast_object(obj, src: int = 0):
    """The value of `obj` on rank `src`, on every rank (itself in one
    process)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def full_params(params: Dict[str, torch.Tensor], specs: Optional[Dict],
                mesh, model: bool = True) -> Dict[str, torch.Tensor]:
    """`params` with every sharded entry all-gathered whole (e.g. an EMA of
    shards, for a `functional_call`): fsdp shards over the fsdp axis, model
    slices over the model axis (`join_slices`). `model=False` leaves the
    model slices as they are, for a call under `tp.attach`."""
    names = sharded_names(specs)
    model = model_sharded_names(specs) if model else []
    if not names and not model:
        return params
    out = dict(params)
    if names:
        group, n = mesh.get_group("fsdp"), axis_size(mesh, "fsdp")
        out.update({k: _all_gather_dim(params[k], specs[k].dim, group, n) for k in names})
    if model:
        group, n = mesh.get_group("model"), axis_size(mesh, "model")
        out.update({k: join_slices(list(_all_gather_stack(params[k].detach(), group, n)),
                                   specs[k]) for k in model})
    return out


class ShardedModule:
    """A frozen module held as this rank's fsdp shards between calls (the
    teacher of distillation under --fsdp, an eval pipeline's model with
    fsdp_params): `with m.gathered() as module:` gives the whole module.
    The module's sharded parameters hold empty placeholders outside.
    `params` and `specs`, when given, are the shards already cut (e.g. by
    `tp.tp_shard_params`, which fills in fsdp shards beside model slices)."""

    def __init__(self, module: torch.nn.Module, mesh, min_size: int = 2**18,
                 params: Optional[Dict] = None, specs: Optional[Dict] = None):
        from .mesh import shard_params

        self.module, self.mesh = module, mesh
        if params is None:
            params, specs = shard_params(module, mesh, use_fsdp=True, min_size=min_size)
        self.params, self.specs = params, specs
        release(module, self.specs)

    def gathered(self):
        return gathered(self.module, self.params, self.specs, self.mesh)


@contextlib.contextmanager
def whole(module):
    """The module itself, or a `ShardedModule`'s module gathered whole."""
    if isinstance(module, ShardedModule):
        with module.gathered() as m:
            yield m
    else:
        yield module


# ------------------------------------------------------------ the model axis

@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's model group: its process group, its size and this
    rank's index in it (the `axis` of the functions below)."""

    group: object
    size: int
    rank: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum completed over the group (`reduce_from_model`): a
        block of H rows' share of a per-sample sum, under spatial
        partitioning."""
        return reduce_from_model(t, self)


def model_group(mesh) -> ModelGroup:
    """The model group of this rank of `mesh` (its "model" axis)."""
    return ModelGroup(mesh.get_group("model"), axis_size(mesh, "model"), model_rank(mesh))


def _all_gather_stack(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *t.shape]: every rank's `t` of the group, in group order."""
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        k, r = axis.size, axis.rank
        edges = _all_gather_stack(torch.stack([x[:, :, 0], x[:, :, -1]]), axis.group, k)
        zero = torch.zeros_like(x[:, :, :1])
        top = edges[r - 1, 1].unsqueeze(2) if r > 0 else zero
        bottom = edges[r + 1, 0].unsqueeze(2) if r < k - 1 else zero
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        k, r = ctx.axis.size, ctx.axis.rank
        edges = _all_gather_stack(torch.stack([g[:, :, 0], g[:, :, -1]]), ctx.axis.group, k)
        gx = g[:, :, 1:-1].clone()
        if r > 0:  # the rank above took my top row as its bottom halo
            gx[:, :, 0] += edges[r - 1, 1]
        if r < k - 1:  # the rank below took my bottom row as its top halo
            gx[:, :, -1] += edges[r + 1, 0]
        return gx, None


class _GatherStack(torch.autograd.Function):
    """[k, *x.shape] of every rank's x; the backward sums the gradient over
    the ranks (each used every block) and keeps this rank's entry."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather_stack(x, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis.group)[ctx.axis.rank], None


class _GatherSlices(torch.autograd.Function):
    """A model slice joined whole (`join_slices`); the backward keeps
    this rank's slice of the gradient (the whole tensor's use is the same
    on every rank of the group)."""

    @staticmethod
    def forward(ctx, x, axis, spec):
        ctx.axis, ctx.spec = axis, spec
        return join_slices(list(_all_gather_stack(x, axis.group, axis.size)), spec)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.spec, ctx.axis.size, ctx.axis.rank), None, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """x as it is; its gradient summed over the model group (the input of
    a column-parallel layer, whose ranks each use it for their slice)."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """x summed over the model group (a row-parallel layer's partial
    outputs); its gradient as it is."""
    return _ReduceFromModel.apply(x, axis)


def halo_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """An NCHW block of H rows with one row above and one below it: the
    neighbouring ranks' boundary rows, zeros at the image's edges."""
    return _Halo.apply(x, axis)


def gather_h(x: torch.Tensor, axis, dim: int = 2) -> torch.Tensor:
    """Every rank's block of `x` joined along `dim` (H), in rank order."""
    return torch.cat(list(_GatherStack.apply(x, axis).unbind(0)), dim=dim)


def gather_stats(x: torch.Tensor, axis) -> torch.Tensor:
    """[k, *x.shape]: every rank's x (statistics of its block)."""
    return _GatherStack.apply(x, axis)


def gather_slices(x: torch.Tensor, axis, spec) -> torch.Tensor:
    """A tensor's model slices joined whole, on every rank."""
    return _GatherSlices.apply(x, axis, spec)
