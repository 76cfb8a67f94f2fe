"""Tensor parallelism (Megatron) and spatial partitioning of the UNet over
the mesh's "model" axis (PyTorch port of `fidm_tpu/parallel/tp.py`).

The JAX package writes partition specs on the parameter tree and lets XLA's
SPMD partitioner insert the collectives. The port has no partitioner: one
process per rank runs its part of every block, and the contexts `attach`
gives the model's layers call the model-axis collectives of
`parallel/collectives.py`. Both layouts
cut the latency of one request, where the data axis only adds throughput.

Tensor parallelism (`tp_param_specs`, `tp_shard_params`), per ResBlock (the
Megatron column/row pairing, arXiv:1909.08053 §3, mapped onto convs):

  in_layers.2   conv [O, I, 3, 3]  column-parallel: O (and its bias) split
  emb_layers.1  linear [O|2O, E]   column-parallel: output split
  out_layers.0  GroupNorm [O]      split: each rank normalises its groups
  out_layers.3  conv [O', O, 3, 3] row-parallel: the input channels split,
                                   the partial outputs summed over the axis,
                                   the bias (replicated) added once after

and per AttentionBlock: `qkv` [3C, C, 1] column-parallel on whole heads,
`proj_out` [C, C, 1] row-parallel. Everything else is replicated, and so are
the activations at every block boundary. The column-parallel layers' input
(the replicated stream, and the time embedding of `emb_layers.1`) passes
`copy_to_model`, whose backward sums its gradient over the axis, so the
replicated tensors' gradients are the same on every rank of a model group.

The specs report the JAX package's placements: `ModelShard(dim, parts)` on
the torch axis that holds JAX's sharded axis (a tensor whose axis does not
divide stays `Replicate()`). JAX shards qkv's [C, 3C] and emb_proj's [E, 2O]
(scale | shift) contiguously and lets the partitioner re-shard; here rank r
holds channels [rC/k, (r+1)C/k) of EACH of the `parts` runs (q, k and v:
whole heads of each; scale and shift), so the local layer computes its
slice with no re-shard. `local_slice` cuts that slice and `join_slices` is
its inverse (both in `parallel/mesh.py`, beside `ModelShard`); everything that moves slices (`tp_shard_params`,
`collectives.full_params`, the checkpoint) uses that pair.

A block whose heads do not divide over the axis, or whose local channels
are not whole GroupNorm groups, computes whole: its sliced weights are
gathered for the call (`collectives.gather_slices`), which is exact.

Spatial partitioning (`spatial_sharding`, `parallel.shard_batch(...,
spatial=True)`): each rank of a model group holds a block of H rows of its
rows' images; the parameters stay replicated. Every 3x3 convolution takes
one halo row from each neighbour first (`collectives.halo_rows`: the stride-2
downsample and the convs after an upsample too), GroupNorm combines every
rank's per-group mean and squared deviations (`collectives.gather_stats`),
and attention gathers the normed tokens, runs on the whole sequence and keeps
its rows. Each level's H must split into even blocks of at least one row
(`check_spatial`: H divisible by size * 2^(levels - 1)); the JAX partitioner
pads instead.

Deliberate differences from the JAX package:
  - the attention kernel runs under both layouts, on each rank's H/k heads
    under TP and on the whole sequence under spatial partitioning (JAX runs
    XLA's attention there, because its partitioner cannot split the custom
    call);
  - the per-part local layout above;
  - spatial partitioning refuses uneven H blocks with a ValueError;
  - the collectives are all_reduce and all_gather only.

`attach(model, mesh, mode, specs)` sets a context on the layers concerned
for a call (a `model_axis` attribute each holds: the column-parallel,
row-parallel, split-norm or joined-whole role of a TP layer; the halo, the
statistics and the token gather of spatial partitioning). The blocks keep
their one forward, and `models/layers.py` hands a layer with a context to
it; the steps and the pipeline attach. Without it every module runs as it
does without a mesh.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from . import collectives as C
from .mesh import (ModelShard, _jax_axes, _named, axis_size, fsdp_param_specs, fsdp_shard,
                   join_slices, local_slice)

__all__ = ["ModelShard", "tp_param_specs", "tp_shard_params", "spatial_sharding",
           "local_slice", "join_slices", "attach", "check_spatial"]

# ADM names in a ResBlock / AttentionBlock and the JAX module each is there
_COLUMN = ("in_layers.2", "emb_layers.1", "qkv")      # output-sharded (in_conv, emb_proj, qkv)
_ROW = ("out_layers.3", "proj_out")                   # kernel input-sharded (out_conv, proj)
_NORM = ("out_layers.0",)                             # out_norm's scale and bias
_BLOCK_ROOTS = ("input_blocks.", "middle_block.", "output_blocks.")


def _role(name: str) -> Optional[str]:
    """"column", "row" or "norm" for a block-internal tensor of the TP
    pattern, else None (top-level modules and the rest stay replicated)."""
    if not name.startswith(_BLOCK_ROOTS):
        return None
    module, leaf = name.rsplit(".", 1)
    for roles, role in ((_COLUMN, "column"), (_ROW, "row"), (_NORM, "norm")):
        if any(module.endswith("." + r) for r in roles):
            if role == "row" and leaf != "weight":
                return None  # the row-parallel bias is added once, replicated
            return role
    return None


def tp_param_specs(params, mesh, axis: str = "model") -> Dict:
    """Megatron column/row placements by ADM parameter name (`params`: a
    module or a dict of tensors): `ModelShard(dim, parts)` on the torch axis
    of JAX's sharded axis, or `Replicate()`. A tensor whose axis does not
    divide by the axis size is replicated (correct, just less parallel), and
    so is a tensor of runs (qkv, a scale-shift projection) whose runs do not
    each divide: at an axis size that divides 3C and not C (3, 6) JAX's spec
    shards qkv and the port keeps it whole."""
    n = axis_size(mesh, axis)
    named = _named(params)

    def spec_for(name, t):
        role = _role(name) if n > 1 else None
        if role is None:
            return Replicate()
        axes = _jax_axes(name, t)
        # JAX: kernel output axis (column; a bias or norm vector: its axis 0),
        # or the kernel's contracting input axis (row)
        dim = axes[-2] if role == "row" else axes[-1]
        if t.shape[dim] % n:
            return Replicate()
        parts = 1
        if name.rsplit(".", 2)[-2] == "qkv":
            parts = 3
        elif ".emb_layers.1." in name:
            conv = named.get(name.split(".emb_layers.1.")[0] + ".in_layers.2.weight")
            parts = 2 if conv is not None and t.shape[0] == 2 * conv.shape[0] else 1
        if t.shape[dim] % (n * parts):
            return Replicate()  # a run would split unevenly: keep it whole
        return ModelShard(dim, parts)

    return {k: spec_for(k, t) for k, t in named.items()}


@torch.no_grad()
def tp_shard_params(params, mesh, axis: str = "model",
                    fsdp_min_size: Optional[int] = None):
    """(params, specs) with every `ModelShard` tensor cut to this rank's
    slice. TP takes precedence; with `fsdp_min_size` and an fsdp axis > 1
    the tensors TP leaves replicated are also fsdp-sharded (`Shard(d)`,
    this rank's shard), as `parallel.shard_params(use_fsdp=True)` shards.

    Given a module, its sliced parameters become the slices in place (the
    module then computes this rank's part under `attach`) and the returned
    dict holds its own parameters, as a TrainState wants them; given a dict,
    the slices are copies and the input is left as it is."""
    module = params if isinstance(params, nn.Module) else None
    named = _named(params)
    specs = tp_param_specs(named, mesh, axis)
    if fsdp_min_size is not None and axis_size(mesh, "fsdp") > 1:
        fsdp = fsdp_param_specs(named, mesh, fsdp_min_size)
        specs = {k: s if isinstance(s, ModelShard) else fsdp[k] for k, s in specs.items()}
    k, i = axis_size(mesh, axis), mesh.get_coordinate()[list(mesh.mesh_dim_names).index(axis)]
    out = {}
    for name, t in named.items():
        s = specs[name]
        if isinstance(s, ModelShard):
            piece = local_slice(t.detach(), s, k, i).clone()
            if module is not None:
                t.data = piece
                piece = t
        elif isinstance(s, Shard):
            piece = fsdp_shard(t, s.dim, mesh)
        else:
            piece = t
        out[name] = piece
    return out, specs


def spatial_sharding(mesh, axis: str = "model", shard_batch: bool = True) -> Tuple:
    """DTensor placements, one per mesh axis, of an NHWC image batch split
    along H over `axis` and, with `shard_batch`, along the batch over the
    data and fsdp axes (`parallel.shard_batch(spatial=True)` cuts this
    rank's part)."""
    names = list(mesh.mesh_dim_names)
    return tuple(Shard(1) if a == axis else
                 (Shard(0) if shard_batch and a in ("data", "fsdp") else Replicate())
                 for a in names)


def check_spatial(height: int, size: int, levels: int) -> None:
    """ValueError unless an H of `height` splits into `size` blocks of
    whole, even rows at every level but the last (which need one row at
    least): the stride-2 convs and 2x2 pools work inside each block."""
    step = size * 2 ** (levels - 1)
    if height % step:
        blocks = [f"{height >> lv}/{size}" for lv in range(levels)]
        raise ValueError(
            f"spatial partitioning: H={height} over {size} ranks at {levels} levels needs H "
            f"divisible by {size} * 2^{levels - 1} = {step} (each level's block, "
            f"{', '.join(blocks)} rows, whole and even above the last level); the JAX "
            "package pads instead")


# ------------------------------------------------------- the layers' context
#
# `models/layers.py` hands a layer that holds a context (`model_axis`) to it:
# `conv(m, x, w, b)` for a convolution, `linear(x, w, b)` for a dense layer,
# `group_norm(norm, x)` for a GroupNorm32, with the weights already in the
# input's dtype. The unmeshed layer is the same call without a context.

class _Column:
    """A column-parallel layer: its input, the replicated stream, passes
    `copy_to_model`, whose backward sums its gradient over the group."""

    def __init__(self, axis: C.ModelGroup):
        self.axis = axis

    def conv(self, m, x, w, b):
        return F.conv2d(C.copy_to_model(x, self.axis), w, b, m.stride, m.padding)

    def linear(self, x, w, b):
        return F.linear(C.copy_to_model(x, self.axis), w, b)


class _Row:
    """A row-parallel layer: the partial output of this rank's input
    channels, summed over the group, then the replicated bias once."""

    def __init__(self, axis: C.ModelGroup):
        self.axis = axis

    def conv(self, m, x, w, b):
        y = C.reduce_from_model(F.conv2d(x, w, None, m.stride, m.padding), self.axis)
        return y + b[:, None, None]

    def linear(self, x, w, b):
        return C.reduce_from_model(F.linear(x, w), self.axis) + b


class _SplitNorm:
    """The output GroupNorm of a split ResBlock: this rank's groups."""

    def __init__(self, axis: C.ModelGroup):
        self.axis = axis

    def group_norm(self, norm, x):
        from ..models.layers import group_norm_f32

        return group_norm_f32(x, norm.num_groups // self.axis.size, norm.weight, norm.bias,
                              norm.eps)


class _Whole:
    """A layer of a block that cannot run split: its sliced weight and bias
    joined whole for the call (`collectives.gather_slices`, exact), the
    layer computed as without the axis."""

    def __init__(self, axis: C.ModelGroup, weight: Optional[ModelShard],
                 bias: Optional[ModelShard]):
        self.axis, self.weight, self.bias = axis, weight, bias

    def _full(self, w, b):
        return (w if self.weight is None else C.gather_slices(w, self.axis, self.weight),
                b if self.bias is None else C.gather_slices(b, self.axis, self.bias))

    def conv(self, m, x, w, b):
        w, b = self._full(w, b)
        return F.conv2d(x, w, b, m.stride, m.padding)

    def linear(self, x, w, b):
        return F.linear(x, *self._full(w, b))

    def group_norm(self, norm, x):
        from ..models.layers import group_norm_f32

        return group_norm_f32(x, norm.num_groups, *self._full(norm.weight, norm.bias), norm.eps)


class _Spatial:
    """The context of every module under spatial partitioning: halo rows
    for a 3x3 conv, GroupNorm over the whole image, attention on the whole
    sequence, the UNet's check of its input."""

    def __init__(self, axis: C.ModelGroup):
        self.axis = axis

    def check(self, unet, x):
        """`x`, the UNet's NHWC input, is this rank's block of H rows."""
        check_spatial(x.shape[1] * self.axis.size, self.axis.size,
                      len(unet.config.channel_mult))

    def conv(self, m, x, w, b):
        """A 3x3 conv with padding 1 on this rank's block of rows."""
        return F.conv2d(C.halo_rows(x, self.axis), w, b, m.stride, (0, m.padding[1]))

    def group_norm(self, norm, x):
        """GroupNorm over the whole H from every block's per-group mean and
        sum of squared deviations (Chan's combination), in float32."""
        B = x.shape[0]
        g = norm.num_groups
        x32 = x.float().reshape(B, g, -1)
        n = x32.shape[-1]
        mean = x32.mean(-1)
        m2 = (x32 - mean[..., None]).square().sum(-1)
        stats = C.gather_stats(torch.stack([mean, m2], -1), self.axis)  # [k, B, g, 2]
        means = stats[..., 0]
        mu = means.mean(0)
        var = (stats[..., 1].sum(0) + n * (means - mu).square().sum(0)) / (n * self.axis.size)
        y = (x32 - mu[..., None]) * torch.rsqrt(var + norm.eps)[..., None]
        y = y.reshape(x.shape) * norm.weight.float()[:, None, None] + norm.bias.float()[:, None, None]
        return y.to(x.dtype)

    def gather(self, x):
        """Every rank's block of an NCHW `x`: the whole H (attention's
        normed input)."""
        return C.gather_h(x, self.axis)

    def own(self, tokens, n: int):
        """This rank's `n` tokens of a whole sequence [B, S, ...]."""
        return tokens[:, self.axis.rank * n:(self.axis.rank + 1) * n]


_RESBLOCK_SPLIT = {"in_layers.2": _Column, "emb_layers.1": _Column,
                   "out_layers.0": _SplitNorm, "out_layers.3": _Row}
_ATTENTION_SPLIT = {"qkv": _Column, "proj_out": _Row}


def _tp_contexts(block, slices: Dict[str, ModelShard], axis: C.ModelGroup) -> Dict:
    """{layer: context} of one ResBlock or AttentionBlock under tensor
    parallelism (`slices`: its ModelShard tensors, by name in the block):
    the Megatron roles where the block splits, else every sliced layer
    joined whole."""
    from ..models.layers import ResBlock

    k = axis.size
    if isinstance(block, ResBlock):
        roles = _RESBLOCK_SPLIT
        split = (block.in_layers[2].out_channels % k == 0
                 and block.out_layers[0].num_groups % k == 0)
    else:
        roles = _ATTENTION_SPLIT
        split = block.heads % k == 0
    wanted = {f"{layer}.weight" for layer in roles} | {
        f"{layer}.bias" for layer, role in roles.items() if role is not _Row}
    if split and wanted <= set(slices):
        return {block.get_submodule(layer): role(axis) for layer, role in roles.items()}
    layers = {n.rsplit(".", 1)[0] for n in slices}
    return {block.get_submodule(layer): _Whole(axis, slices.get(f"{layer}.weight"),
                                               slices.get(f"{layer}.bias"))
            for layer in layers}


@contextlib.contextmanager
def attach(model: nn.Module, mesh, mode: str, specs: Optional[Dict] = None):
    """Inside the block `model` computes this rank's part over the mesh's
    "model" axis under `mode`: "tp" (its `ModelShard` parameters of `specs`
    hold this rank's slices, `tp_shard_params`) or "spatial" (its inputs are
    this rank's H blocks). Each layer concerned holds its context in
    `model_axis` (and each ResBlock one, so that it builds a decoder skip's
    concatenation); they are cleared after."""
    from ..models.layers import AttentionBlock, GroupNorm32, ResBlock
    from ..models.unet import UNet

    if mode not in ("tp", "spatial"):
        raise ValueError(f"unknown model-axis mode {mode!r}: 'tp' or 'spatial'")
    axis = C.model_group(mesh)
    held = {}
    if mode == "spatial":
        ctx = _Spatial(axis)
        for m in model.modules():
            if isinstance(m, (UNet, ResBlock, AttentionBlock, GroupNorm32)) or (
                    isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)):
                held[m] = ctx
    else:
        slices = {k: s for k, s in (specs or {}).items() if isinstance(s, ModelShard)}
        for prefix, m in model.named_modules():
            if isinstance(m, (ResBlock, AttentionBlock)):
                own = {k[len(prefix) + 1:]: s for k, s in slices.items()
                       if k.startswith(prefix + ".")}
                held.update(_tp_contexts(m, own, axis))
                if isinstance(m, ResBlock):
                    held[m] = axis
    for m, ctx in held.items():
        m.model_axis = ctx
    try:
        yield model
    finally:
        for m in held:
            m.__dict__.pop("model_axis", None)
