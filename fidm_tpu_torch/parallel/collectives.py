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

The collectives are `all_reduce`, `all_gather_into_tensor`,
`reduce_scatter_tensor` and `broadcast_object_list` (NCCL on CUDA, gloo on
the CPU).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from .mesh import axis_size, batch_index

__all__ = ["Rows", "rank_rows", "RowDraws", "RowNoise", "mean_over_ranks", "gather_rows",
           "gathered", "release", "reduce_gradients", "global_grad_norm",
           "broadcast_object", "sharded_names", "full_params", "ShardedModule", "whole"]


class Rows(NamedTuple):
    """Rows [lo, hi) of a global batch of `total` rows."""

    lo: int
    hi: int
    total: int

    def of(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.lo:self.hi]


def rank_rows(mesh, local_batch: int) -> Rows:
    """This rank's rows when every rank holds `local_batch` of them."""
    i = batch_index(mesh)
    return Rows(i * local_batch, (i + 1) * local_batch, local_batch * mesh.size())


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
    global batch."""
    W = mesh.size()
    if W == 1:
        return x
    out = torch.empty((W * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous())
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


def reduce_gradients(names: Sequence[str], grads: Sequence[torch.Tensor],
                     specs: Optional[Dict], mesh) -> List[torch.Tensor]:
    """Full per-rank gradients -> the global-batch mean in the state's
    layout: a sharded tensor's gradient reduce-scattered over the fsdp axis
    (its shard), then summed over the data axis; every other gradient summed
    over all ranks (one all-reduce per dtype); all times 1 / world. Without
    a mesh, the gradients as they are."""
    if mesh is None:
        return list(grads)
    W = mesh.size()
    out = list(grads)
    shard = set(sharded_names(specs))
    _all_reduce_flat([g for k, g in zip(names, out) if k not in shard], None)
    if shard:
        fgroup, n = mesh.get_group("fsdp"), axis_size(mesh, "fsdp")
        idx = [i for i, k in enumerate(names) if k in shard]
        for i in idx:
            out[i] = _reduce_scatter_dim(out[i], specs[names[i]].dim, fgroup, n)
        if axis_size(mesh, "data") > 1:
            _all_reduce_flat([out[i] for i in idx], mesh.get_group("data"))
    if W > 1:
        torch._foreach_mul_(out, 1.0 / W)
    return out


def global_grad_norm(names: Sequence[str], grads: Sequence[torch.Tensor],
                     specs: Optional[Dict], mesh) -> torch.Tensor:
    """The global norm of gradients in the state's layout: the shards'
    squares summed over the fsdp axis, the replicated ones counted once
    (without shards, `global_norm` of the gradients)."""
    from ..training.train_state import global_norm

    shard = set(sharded_names(specs))
    if not shard:
        return global_norm(grads)
    sq = lambda ts: torch.stack(torch._foreach_norm(ts)).square().sum()  # noqa: E731
    s = sq([g for k, g in zip(names, grads) if k in shard])
    dist.all_reduce(s, group=mesh.get_group("fsdp"))
    rest = [g for k, g in zip(names, grads) if k not in shard]
    return torch.sqrt(s + sq(rest)) if rest else torch.sqrt(s)


def broadcast_object(obj, src: int = 0):
    """The value of `obj` on rank `src`, on every rank (itself in one
    process)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def full_params(params: Dict[str, torch.Tensor], specs: Optional[Dict],
                mesh) -> Dict[str, torch.Tensor]:
    """`params` with every sharded entry all-gathered whole (e.g. an EMA of
    shards, for a `functional_call`)."""
    names = sharded_names(specs)
    if not names:
        return params
    group, n = mesh.get_group("fsdp"), axis_size(mesh, "fsdp")
    return {k: _all_gather_dim(v, specs[k].dim, group, n) if k in names else v
            for k, v in params.items()}


class ShardedModule:
    """A frozen module held as this rank's fsdp shards between calls (the
    teacher of distillation under --fsdp, an eval pipeline's model with
    fsdp_params): `with m.gathered() as module:` gives the whole module.
    The module's sharded parameters hold empty placeholders outside."""

    def __init__(self, module: torch.nn.Module, mesh, min_size: int = 2**18):
        from .mesh import shard_params

        self.module, self.mesh = module, mesh
        self.params, self.specs = shard_params(module, mesh, use_fsdp=True, min_size=min_size)
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
