"""How weights cross into the port: JAX parameter trees and ADM checkpoints.

Counterpart of `fidm_tpu/models/torch_import.py`, with its own copy of the
key map: `torch_key_map` replays the UNet construction loop and pairs each
Flax parameter path of the JAX package with its ADM torch prefix.

- `state_dict_from_jax` turns the JAX package's `{"params": {"base": ...}}`
  tree (numpy arrays) into the port's state dict; `jax_tree_from_state_dict`
  is its inverse.
- `flax_module_paths` names each conv and dense module of a port model by
  its Flax module path.
- `load_adm_checkpoint` reads an ADM `.pt` and widens a 3-channel first conv
  to `cfg.in_channels`: RGB weights into channels 0-2, zeros elsewhere.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .unet import UNetConfig

__all__ = ["torch_key_map", "state_dict_from_jax", "jax_tree_from_state_dict",
           "flax_module_paths", "load_adm_checkpoint"]

# kinds of torch_key_map entries that are a conv or dense layer in Flax
_LAYER_KINDS = ("conv", "linear", "qkv", "proj1d")


def torch_key_map(cfg: UNetConfig) -> List[Tuple[Tuple[str, ...], str, str]]:
    """(flax_path, torch_prefix, kind) for every parameterized module.

    kinds: conv | linear | groupnorm | qkv | proj1d | embed
    """
    out: List[Tuple[Tuple[str, ...], str, str]] = []

    def res_entries(flax_name: str, torch_prefix: str, has_skip: bool):
        out.extend([
            ((flax_name, "in_norm", "GroupNorm_0"), f"{torch_prefix}.in_layers.0", "groupnorm"),
            ((flax_name, "in_conv"), f"{torch_prefix}.in_layers.2", "conv"),
            ((flax_name, "emb_proj"), f"{torch_prefix}.emb_layers.1", "linear"),
            ((flax_name, "out_norm", "GroupNorm_0"), f"{torch_prefix}.out_layers.0", "groupnorm"),
            ((flax_name, "out_conv"), f"{torch_prefix}.out_layers.3", "conv"),
        ])
        if has_skip:
            out.append(((flax_name, "skip_conv"), f"{torch_prefix}.skip_connection", "conv"))

    def attn_entries(flax_name: str, torch_prefix: str):
        out.extend([
            ((flax_name, "norm", "GroupNorm_0"), f"{torch_prefix}.norm", "groupnorm"),
            ((flax_name, "qkv"), f"{torch_prefix}.qkv", "qkv"),
            ((flax_name, "proj"), f"{torch_prefix}.proj_out", "proj1d"),
        ])

    out.append((("time_embed_0",), "time_embed.0", "linear"))
    out.append((("time_embed_1",), "time_embed.2", "linear"))
    if cfg.num_classes is not None:
        out.append((("label_emb",), "label_emb", "embed"))

    ch = int(cfg.channel_mult[0] * cfg.model_channels)
    out.append((("in_0_conv",), "input_blocks.0.0", "conv"))
    ds = 1
    idx = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out_ch = int(mult * cfg.model_channels)
            res_entries(f"in_{idx}_res", f"input_blocks.{idx}.0", out_ch != ch)
            ch = out_ch
            if ds in cfg.attention_resolutions:
                attn_entries(f"in_{idx}_attn", f"input_blocks.{idx}.1")
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                res_entries(f"in_{idx}_down", f"input_blocks.{idx}.0", False)
            else:
                out.append(((f"in_{idx}_down", "Conv_0"), f"input_blocks.{idx}.0.op", "conv"))
            ds *= 2
            idx += 1

    res_entries("mid_res0", "middle_block.0", False)
    attn_entries("mid_attn", "middle_block.1")
    res_entries("mid_res1", "middle_block.2", False)

    input_block_chans = [int(cfg.channel_mult[0] * cfg.model_channels)]
    c = input_block_chans[0]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            c = int(mult * cfg.model_channels)
            input_block_chans.append(c)
        if level != len(cfg.channel_mult) - 1:
            input_block_chans.append(c)

    idx = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            out_ch = int(cfg.model_channels * mult)
            res_entries(f"out_{idx}_res", f"output_blocks.{idx}.0", (ch + ich) != out_ch)
            ch = out_ch
            j = 1
            if ds in cfg.attention_resolutions:
                attn_entries(f"out_{idx}_attn", f"output_blocks.{idx}.{j}")
                j += 1
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    res_entries(f"out_{idx}_up", f"output_blocks.{idx}.{j}", False)
                else:
                    out.append(((f"out_{idx}_up", "Conv_0"),
                                f"output_blocks.{idx}.{j}.conv", "conv"))
                ds //= 2
            idx += 1

    out.append((("out_norm", "GroupNorm_0"), "out.0", "groupnorm"))
    out.append((("out_conv",), "out.2", "conv"))
    return out


def _deconvert(kind: str, leaves: Dict):
    """Flax leaf dict -> (torch weight, torch bias or None)."""
    if kind == "conv":  # HWIO -> OIHW
        return leaves["kernel"].transpose(3, 2, 0, 1), leaves.get("bias")
    if kind == "linear":  # [in, out] -> [out, in]
        return leaves["kernel"].T, leaves.get("bias")
    if kind == "groupnorm":
        return leaves["scale"], leaves.get("bias")
    if kind in ("qkv", "proj1d"):  # Dense [in, out] -> Conv1d [out, in, 1]
        return leaves["kernel"].T[..., None], leaves.get("bias")
    if kind == "embed":
        return leaves["embedding"], None
    raise ValueError(kind)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(variables: Dict, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX `InpaintingUNet`/`UNet` parameter tree
    (numpy leaves; the `{"params": {"base": ...}}` container or the bare
    tree)."""
    tree = variables
    if isinstance(tree.get("params"), dict):
        tree = tree["params"]
    if isinstance(tree.get("base"), dict):
        tree = tree["base"]
    sd: Dict[str, torch.Tensor] = {}
    missing = []
    for flax_path, prefix, kind in torch_key_map(cfg):
        node = tree
        for p in flax_path:
            node = node.get(p) if isinstance(node, dict) else None
        if node is None:
            missing.append("/".join(flax_path))
            continue
        weight, bias = _deconvert(kind, {k: np.asarray(v) for k, v in node.items()})
        sd[f"{prefix}.weight"] = _tensor(weight)
        if bias is not None:
            sd[f"{prefix}.bias"] = _tensor(bias)
    if missing:
        raise KeyError(f"missing flax params: {missing[:5]} (+{max(len(missing) - 5, 0)} more)")
    return sd


def _convert(kind: str, weight: torch.Tensor, bias) -> Dict[str, torch.Tensor]:
    """Torch weight and bias -> Flax leaf dict, in the order of the JAX
    package's `torch_import._convert`."""
    if kind == "conv":  # OIHW -> HWIO
        return {"kernel": weight.permute(2, 3, 1, 0).contiguous(), "bias": bias}
    if kind == "linear":  # [out, in] -> [in, out]
        return {"kernel": weight.t().contiguous(), "bias": bias}
    if kind == "groupnorm":
        return {"scale": weight, "bias": bias}
    if kind in ("qkv", "proj1d"):  # Conv1d [out, in, 1] -> Dense [in, out]
        return {"kernel": weight[..., 0].t().contiguous(), "bias": bias}
    if kind == "embed":
        return {"embedding": weight}
    raise ValueError(kind)


def jax_tree_from_state_dict(sd: Dict[str, torch.Tensor], cfg: UNetConfig) -> Dict:
    """The JAX package's `{"base": {...}}` parameter tree, in its layout,
    from the port's state dict: the inverse of `state_dict_from_jax`. Leaves
    stay tensors on their device. Keys come in the order of the JAX
    package's tree for a loaded checkpoint (`torch_import.convert_state_dict`),
    which fixes each weight's quantization seed and the order of a quantized
    `.npz`."""
    tree: Dict = {}
    missing = []
    for flax_path, prefix, kind in torch_key_map(cfg):
        weight = sd.get(f"{prefix}.weight")
        if weight is None:
            missing.append(f"{prefix}.weight")
            continue
        node = tree
        for p in flax_path[:-1]:
            node = node.setdefault(p, {})
        leaves = _convert(kind, weight, sd.get(f"{prefix}.bias"))
        node[flax_path[-1]] = {k: v for k, v in leaves.items() if v is not None}
    if missing:
        raise KeyError(f"missing torch keys: {missing[:5]} (+{max(len(missing) - 5, 0)} more)")
    return {"base": tree}


def flax_module_paths(model: nn.Module, cfg: UNetConfig) -> Dict[nn.Module, Tuple[str, ...]]:
    """Each conv and dense module of `model` (an `InpaintingUNet` or `UNet`
    of `cfg`) -> its Flax module path in the JAX `InpaintingUNet`, e.g.
    ("base", "in_1_res", "in_conv")."""
    return {model.get_submodule(prefix): ("base",) + flax_path
            for flax_path, prefix, kind in torch_key_map(cfg) if kind in _LAYER_KINDS}


def load_adm_checkpoint(path: str, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """State dict (float32, CPU) from an ADM-layout `.pt` file.

    Accepts a raw state dict or a training container under
    'model_state_dict' / 'state_dict' / 'model'; strips 'module.' and
    'base_model.' prefixes; widens a 3-channel first conv to
    cfg.in_channels with zeros."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj.get(k), dict):
            obj = obj[k]
            break

    def norm_key(k):
        for pre in ("module.", "base_model."):
            if k.startswith(pre):
                k = k[len(pre):]
        return k

    sd = {norm_key(k): v.detach().float() for k, v in obj.items()}
    w = sd.get("input_blocks.0.0.weight")
    if w is not None and w.shape[1] < cfg.in_channels:
        expanded = torch.zeros((w.shape[0], cfg.in_channels) + tuple(w.shape[2:]))
        expanded[:, : w.shape[1]] = w
        sd["input_blocks.0.0.weight"] = expanded
    return sd
