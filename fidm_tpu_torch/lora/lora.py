"""LoRA fine-tuning on the port's parameters (PyTorch port of
`fidm_tpu/lora/lora.py`).

Low-rank factors on selected kernels (attention qkv and output projection
by default), in the JAX package's layout: a target is named by its Flax
module path ("base/in_4_attn/qkv"), and its factors are `a` [d_in, r] and
`b` [r, d_out] over the Flax kernel, whose d_in is Kh·Kw·I for a conv and I
for a dense layer. The merged kernel is kernel + scaling · (a @ b), turned
into the torch weight (OIHW, [out, in], or the [out, in, 1] of ADM's
Conv1d) by the same permutations `models/weights.py` uses, so a JAX LoRA
tree carries across one to one.

An adapter here is a flat dict of tensors, "<path>/a", "<path>/b" and
"__meta__/scaling" (the JAX tree flattened with "/"; `flatten_lora` turns
one into the other). As in the JAX package every tensor of it is trained,
the scaling too. `b` starts at zero, so at step 0 the merged model is the
base. Training applies the merged weights through
`models.layers.weight_overrides` (`lora_weights`); evaluation merges them
into a state dict (`merge_lora`).

Over the mesh's "model" axis the adapter is replicated, as in the JAX
package's CLI. On a tensor-parallel base (`parallel.tp_shard_params`) a
target whose weight is this rank's slice gets the same slice of its delta
(`lora_weights(..., specs, mesh)`), so each rank differentiates only its
slice and the factors' gradients are partial sums over the axis, which the
train step sums; a target the specs keep whole gets the whole delta, its
gradient carried by the axis's rank 0 alone, so that the sum counts it
once. Under spatial partitioning the base is whole and so is every delta.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.unet import UNetConfig
from ..models.weights import torch_key_map
from ..parallel.mesh import ModelShard, axis_size, local_slice, model_rank

__all__ = ["DEFAULT_TARGETS", "select_lora_targets", "init_lora", "lora_weights",
           "merge_lora", "lora_param_count", "flatten_lora", "is_lora"]

# attention qkv + output projection kernels
DEFAULT_TARGETS = (r".*_attn/(qkv|proj)$", r"mid_attn/(qkv|proj)$")

_META = "__meta__/scaling"
_KERNEL_KINDS = ("conv", "linear", "qkv", "proj1d")


def _layers(cfg: UNetConfig) -> Dict[str, Tuple[str, str]]:
    """Flax module path ("base/...") -> (torch prefix, kind) of every conv
    and dense layer."""
    return {"/".join(("base",) + flax_path): (prefix, kind)
            for flax_path, prefix, kind in torch_key_map(cfg) if kind in _KERNEL_KINDS}


def select_lora_targets(cfg: UNetConfig, patterns: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    """Flax module paths of the kernels whose path matches any regex, in the
    JAX package's order (its parameter tree's sorted paths)."""
    regexes = [re.compile(p) for p in patterns]
    paths = sorted(_layers(cfg), key=lambda p: tuple(p.split("/")))
    return [p for p in paths if any(r.search(p) for r in regexes)]


def _flax_kernel_shape(shape: Sequence[int], kind: str) -> Tuple[int, ...]:
    """The Flax kernel shape of a torch weight of `shape`."""
    if kind == "conv":  # OIHW -> HWIO
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    o, i = shape[:2]  # [out, in] or [out, in, 1]
    return (i, o)


def _to_torch_layout(kernel: torch.Tensor, kind: str) -> torch.Tensor:
    """A Flax-layout kernel as the torch weight of its layer."""
    if kind == "conv":  # HWIO -> OIHW
        return kernel.permute(3, 2, 0, 1)
    if kind == "linear":  # [in, out] -> [out, in]
        return kernel.t()
    return kernel.t()[..., None]  # Dense [in, out] -> Conv1d [out, in, 1]


def init_lora(seed: int, model: nn.Module, cfg: UNetConfig, rank: int = 8,
              alpha: float = 16.0, patterns: Sequence[str] = DEFAULT_TARGETS
              ) -> Dict[str, torch.Tensor]:
    """The adapter for `model` (a UNet of `cfg`, whole: before
    `parallel.tp_shard_params` cuts it), on its device: `a` normal over
    sqrt(d_in), drawn on the CPU from `seed` in target order, `b` zero, the
    scaling alpha / rank."""
    targets = select_lora_targets(cfg, patterns)
    if not targets:
        raise ValueError(f"no LoRA targets matched patterns {patterns}")
    layers = _layers(cfg)
    g = torch.Generator().manual_seed(int(seed))
    device = next(model.parameters()).device
    lora: Dict[str, torch.Tensor] = {}
    for path in targets:
        prefix, kind = layers[path]
        shape = _flax_kernel_shape(model.get_submodule(prefix).weight.shape, kind)
        d_in, d_out = int(np.prod(shape[:-1])), shape[-1]
        a = torch.randn((d_in, rank), generator=g) / np.float32(math.sqrt(d_in))
        lora[f"{path}/a"] = a.to(device)
        lora[f"{path}/b"] = torch.zeros((rank, d_out), device=device)
    lora[_META] = torch.tensor(alpha / rank, dtype=torch.float32, device=device)
    return lora


def flatten_lora(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's nested adapter tree ({path: {"a", "b"},
    "__meta__": {"scaling"}}, numpy or tensors) as this module's flat dict
    of float32 tensors; a flat dict passes through."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"{k}/{kk}"] = torch.as_tensor(np.asarray(vv, np.float32)
                                                    if not isinstance(vv, torch.Tensor) else vv)
        else:
            flat[k] = v
    return flat


def is_lora(params: Dict) -> bool:
    """Whether a trained-parameter dict is an adapter (it has the scaling)."""
    return _META in params or "__meta__" in params


def _targets(lora: Dict[str, torch.Tensor]) -> List[str]:
    return sorted({k.rsplit("/", 1)[0] for k in lora if k != _META})


def _delta(lora, path: str, kind: str, shape: Sequence[int], dtype) -> torch.Tensor:
    """scaling · a @ b as a torch weight of `shape` (the whole layer's)."""
    delta = (lora[f"{path}/a"] @ lora[f"{path}/b"]) * lora[_META]
    kernel_shape = _flax_kernel_shape(shape, kind)
    return _to_torch_layout(delta.reshape(kernel_shape), kind).to(dtype)


class _FirstRankGradient(torch.autograd.Function):
    """x as it is; its gradient on the model axis's rank 0, zeros on the
    others. Every rank keeps the same graph, so the backward's collectives
    match (a detached delta would leave the layers before it without a
    backward on some ranks only)."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


def lora_weights(model: nn.Module, cfg: UNetConfig, lora: Dict[str, torch.Tensor],
                 specs: Optional[Dict] = None, mesh=None) -> Dict[nn.Module, torch.Tensor]:
    """Module -> merged weight (base + scaling · a @ b in the torch layout)
    for every target of the adapter: the `param_transform` of LoRA
    training, applied through `models.layers.weight_overrides`. Gradients
    flow into the adapter; the base stays frozen.

    `specs` and `mesh`: a base cut by `parallel.tp_shard_params(model,
    mesh)` and its specs; each target gets this rank's part of its delta
    (see the module doc)."""
    from ..parallel.collectives import model_sharded_names

    layers = _layers(cfg)
    tp = mesh is not None and axis_size(mesh, "model") > 1 and bool(model_sharded_names(specs))
    k, rank = (axis_size(mesh, "model"), model_rank(mesh)) if tp else (1, 0)
    out = {}
    for path in _targets(lora):
        prefix, kind = layers[path]
        module = model.get_submodule(prefix)
        w = module.weight
        spec = specs.get(f"{prefix}.weight") if tp else None
        if isinstance(spec, ModelShard):
            shape = list(w.shape)
            shape[spec.dim] *= k
            delta = local_slice(_delta(lora, path, kind, shape, w.dtype), spec, k, rank)
        else:
            delta = _delta(lora, path, kind, w.shape, w.dtype)
            if tp:  # whole on every rank: rank 0 carries its gradient
                delta = _FirstRankGradient.apply(delta, rank)
        if delta.shape != w.shape:
            raise ValueError(
                f"LoRA target {prefix}: the delta is {tuple(delta.shape)} and the weight "
                f"{tuple(w.shape)}; a base cut by parallel.tp_shard_params needs "
                "lora_weights(..., specs, mesh)")
        out[module] = w + delta
    return out


@torch.no_grad()
def merge_lora(state_dict: Dict[str, torch.Tensor], lora, cfg: UNetConfig
               ) -> Dict[str, torch.Tensor]:
    """A new state dict with each target's weight <- weight + scaling · (a @ b)
    (`lora` flat, or the JAX package's nested tree)."""
    lora = flatten_lora(lora)
    layers = _layers(cfg)
    merged = dict(state_dict)
    for path in _targets(lora):
        prefix, kind = layers[path]
        w = state_dict[f"{prefix}.weight"]
        ab = {k: v.to(w.device) for k, v in lora.items()
              if k == _META or k.startswith(path + "/")}
        merged[f"{prefix}.weight"] = w + _delta(ab, path, kind, w.shape, w.dtype)
    return merged


def lora_param_count(lora: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() for k, v in flatten_lora(lora).items() if k != _META)
