"""The quantized parameter tree as an `.npz` file, in the JAX package's
format (`fidm_tpu/cli/quantize.py`), so that each package reads the other's
files.

Entries are named by the tree path joined with "/": a quantized kernel is
two entries, `<path>.__q__` (int8, HWIO or [in, out]) and `<path>.__scale__`
(float32 [out]); every other leaf is one entry. They are written in the
tree's order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.unet import UNetConfig
from ..models.weights import state_dict_from_jax
from .int8 import dequantize_params

__all__ = ["flatten_quantized", "save_quantized", "load_quantized",
           "load_quantized_state_dict"]


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_quantized(tree) -> Dict[str, np.ndarray]:
    """{entry name: numpy array} of a quantized tree, in its order."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            p = f"{prefix}{k}"
            if isinstance(v, dict) and set(v) == {"q", "scale"}:
                flat[p + ".__q__"] = _numpy(v["q"])
                flat[p + ".__scale__"] = _numpy(v["scale"])
            elif isinstance(v, dict):
                walk(v, p + "/")
            else:
                flat[p] = _numpy(v)

    walk(tree)
    return flat


def save_quantized(path: str, tree) -> Dict[str, np.ndarray]:
    """Write the tree with `np.savez_compressed`; returns its entries."""
    flat = flatten_quantized(tree)
    np.savez_compressed(path, **flat)
    return flat


def load_quantized(path: str):
    """The quantized tree (CPU tensors) from an `.npz` of either package."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key.endswith(".__scale__"):
                continue
            parts = key.replace(".__q__", "").split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if key.endswith(".__q__"):
                node[parts[-1]] = {
                    "q": torch.from_numpy(data[key]),
                    "scale": torch.from_numpy(data[key.replace(".__q__", ".__scale__")]),
                }
            else:
                node[parts[-1]] = torch.from_numpy(data[key])
    return tree


def load_quantized_state_dict(path: str, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict (float32, CPU) from a quantized `.npz`, the
    weights dequantized: what `InpaintingPipeline.model.load_state_dict`
    takes with strict=True (as `fidm_tpu/cli/evaluate.py` loads an `.npz`)."""
    return state_dict_from_jax(dequantize_params(load_quantized(path)), cfg)
