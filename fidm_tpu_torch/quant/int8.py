"""Weight-only int8 quantization (PyTorch port).

Counterpart of `fidm_tpu/quant/int8.py`. A weight is quantized per output
channel (its last axis, in the JAX layout: HWIO convs, [in, out] dense
layers) to symmetric int8 with absmax scales, and dequantized before use.

Rounding follows the JAX dispatch rule (`fidm_tpu/quant/int8.py:74`): a CUDA
tensor whose [N, C] view has N % 8 == 0 and C % 128 == 0 goes through the
stochastic-rounding kernel (`ops/quantize.py`, the counterpart of the
Pallas `_quantize_pallas`), so the same weights are rounded stochastically
as on a TPU. Every other tensor, and every tensor inside
`kernel_override(False, "quantize")`, is rounded to nearest, as JAX's XLA
path does on every backend without the kernel.

Trees are nested dicts of tensors; a quantized leaf becomes
{"q": int8, "scale": float32 [C]}.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.quantize import column_scales, stochastic_quantize
from ..ops.registry import use_kernel

__all__ = ["quantize_params", "dequantize_params", "quantized_size_bytes",
           "quantize_tensor", "dequantize_tensor"]


def quantize_tensor(x: torch.Tensor, seed: int = 0) -> Dict:
    """Quantize a weight to int8 with per-output-channel (last axis) scales."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).float().contiguous()
    n, c = x2d.shape
    if use_kernel("quantize", x2d.device) and n % 8 == 0 and c % 128 == 0:
        values, scales = stochastic_quantize(x2d, seed)
    else:
        scales = column_scales(x2d)
        values = torch.round(x2d / scales).clamp_(-127, 127).to(torch.int8)
    return {"q": values.reshape(shape), "scale": scales[0]}


def dequantize_tensor(q: Dict, dtype=torch.float32) -> torch.Tensor:
    return (q["q"].float() * q["scale"]).to(dtype)


def _is_quantizable(path: Tuple[str, ...], leaf, min_size: int) -> bool:
    return path[-1] == "kernel" and leaf.ndim >= 2 and leaf.numel() >= min_size


def quantize_params(params, min_size: int = 4096, seed: int = 0):
    """Quantize every large kernel of a parameter tree; biases and norms stay
    float32. The quantized tensors take seeds seed + 1, seed + 2, ... in the
    tree's order, as in the JAX package."""
    counter = [0]

    def q_walk(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            p = prefix + (k,)
            if isinstance(v, dict):
                out[k] = q_walk(v, p)
            elif _is_quantizable(p, v, min_size):
                counter[0] += 1
                out[k] = quantize_tensor(v, seed=seed + counter[0])
            else:
                out[k] = v
        return out

    return q_walk(params)


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def dequantize_params(qparams, dtype=torch.float32):
    def walk(tree):
        if _is_quantized(tree):
            return dequantize_tensor(tree, dtype)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(qparams)


def quantized_size_bytes(tree) -> int:
    """Bytes of every leaf (tensor or numpy array) of the tree."""
    if isinstance(tree, dict):
        return sum(quantized_size_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)
