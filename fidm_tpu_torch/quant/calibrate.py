"""Calibration-based weight quantization (activation-aware scale search),
PyTorch port.

Counterpart of `fidm_tpu/quant/calibrate.py`:

1. `collect_input_moments` runs calibration batches through the model and
   records, for every conv and dense layer, the mean square of each INPUT
   channel (a diagonal proxy of the layer Hessian X^T X), keyed by the
   layer's Flax module path, as the JAX package keys it.
2. `quantize_tensor_calibrated` grid-searches a clipping factor alpha per
   output channel, scale_c = alpha * absmax_c / 127, minimising the
   activation-weighted weight error sum_i h_i (W_ic - dequant(W)_ic)^2.
   alpha = 1 (plain absmax) is in the grid.
3. `quantize_params_calibrated` walks the parameter tree like
   `int8.quantize_params`; kernels without captured moments use h = 1.

Steps 2 and 3 are the JAX package's numpy code, copied, so that they stay
bit-equal to it. The output tree has the `int8.quantize_params` format
({"q": int8, "scale": float32} leaves, as numpy arrays).

The port's UNet applies its layers through the functions `layers.conv` and
`layers.linear`, not by calling the modules, so a module forward hook never
fires; step 1 listens at those two functions (`layers.capture_inputs`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.layers import capture_inputs
from ..models.weights import flax_module_paths

__all__ = [
    "collect_input_moments",
    "quantize_tensor_calibrated",
    "quantize_params_calibrated",
    "DEFAULT_GRID",
]

# clipping-factor search grid; 1.0 (= absmax) always included
DEFAULT_GRID = tuple(np.round(np.linspace(0.4, 1.0, 25), 4))


def collect_input_moments(model, batches: Iterable[Sequence]) -> Dict[Tuple[str, ...], np.ndarray]:
    """Mean-square input-channel statistics per conv / dense layer.

    Args:
      model: the port's `InpaintingUNet` (or `UNet`).
      batches: iterable of argument tuples for `model(*b)`, e.g.
        (x_t, t, masked_image, mask) at random diffusion timesteps.

    Returns {flax_module_path: h} with h = E[x_i^2] per input channel
    (float32 [cin]): the mean over every axis but the channel axis (dim 1 of
    a conv's NCHW input, the last dim of a dense layer's input), averaged
    over the batches.
    """
    paths = flax_module_paths(model, model.config)
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    counts: Dict[Tuple[str, ...], int] = {}

    def record(module, x, channel_dim):
        path = paths.get(module)
        if path is None:
            return
        channel_dim %= x.ndim
        sq = torch.mean(x.float() ** 2, dim=[d for d in range(x.ndim) if d != channel_dim])
        if path in sums:
            sums[path] = sums[path] + sq
            counts[path] += 1
        else:
            sums[path] = sq
            counts[path] = 1

    with torch.inference_mode(), capture_inputs(record):
        for b in batches:
            model(*b)
    return {p: (sums[p] / counts[p]).cpu().numpy() for p in sums}


def quantize_tensor_calibrated(
    w, h: Optional[np.ndarray] = None, grid: Sequence[float] = DEFAULT_GRID
) -> Dict:
    """Per-output-channel int8 with activation-weighted clipping search.

    w: kernel [..., cin, cout] (conv HWIO or dense [cin, cout]), a numpy
    array or a tensor. h: per-input-channel weights [cin] (None = unweighted
    MSE). Returns {"q": int8 like w, "scale": f32 [cout]} as numpy arrays.
    """
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    shape = w.shape
    cout = shape[-1]
    x2d = w.reshape(-1, cout)
    if h is not None:
        cin = shape[-2]
        if h.shape != (cin,):
            raise ValueError(f"h must be [{cin}], got {h.shape}")
        # rows are (*spatial, cin) flattened: every spatial tap of input
        # channel i carries the same activation energy h_i
        hrow = np.broadcast_to(
            np.asarray(h, np.float32), shape[:-1]
        ).reshape(-1, 1)
    else:
        hrow = np.ones((x2d.shape[0], 1), np.float32)

    absmax = np.maximum(np.abs(x2d).max(axis=0, keepdims=True), 1e-8)
    best_err = None
    best_q = None
    best_scale = None
    for alpha in grid:
        scale = absmax * (float(alpha) / 127.0)
        q = np.clip(np.round(x2d / scale), -127, 127)
        err = (hrow * (x2d - q * scale) ** 2).sum(axis=0)  # [cout]
        if best_err is None:
            best_err = err
            best_q = q
            best_scale = np.broadcast_to(scale, (1, cout)).copy()
        else:
            better = err < best_err
            best_err = np.where(better, err, best_err)
            best_q = np.where(better[None, :], q, best_q)
            best_scale = np.where(better[None, :], scale, best_scale)
    return {
        "q": best_q.astype(np.int8).reshape(shape),
        "scale": best_scale[0].astype(np.float32),
    }


def quantize_params_calibrated(
    params,
    moments: Optional[Dict[Tuple[str, ...], np.ndarray]] = None,
    min_size: int = 4096,
    grid: Sequence[float] = DEFAULT_GRID,
):
    """Calibrated drop-in for `int8.quantize_params` (same output tree).

    moments: output of `collect_input_moments`; kernels whose module path
    has no entry (or whose cin does not match) use unweighted-MSE clipping.
    """
    moments = moments or {}

    def walk(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            p = prefix + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k == "kernel" and v.ndim >= 2 and np.prod(v.shape) >= min_size:
                h = moments.get(prefix)
                if h is not None and h.shape != (v.shape[-2],):
                    h = None
                out[k] = quantize_tensor_calibrated(v, h, grid)
            else:
                out[k] = v
        return out

    return walk(params)
