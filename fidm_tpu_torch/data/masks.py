"""Procedural mask generation (5-60% coverage) and mask-file loading
(PyTorch port, numpy only).

Counterpart of `fidm_tpu/data/masks.py`:

- `random_mask`: procedural box / irregular-brush-stroke masks with a target
  coverage range. By default the C++ rasterizer (`native/maskgen.cpp`)
  draws them from a seed taken from the generator, as `fidm_tpu`'s default
  does, so they are bit-equal to its masks for the same generator; where
  the library does not build (or `use_native=False`) the numpy stroke model
  runs, bit-equal to `fidm_tpu`'s numpy path.
- `load_mask`: file loading with the black (< 0.5) = 1 = inpaint, white = 0
  = keep convention. Files decode through the native loader
  (`native/imgload.cpp`, bit-equal to PIL), or with PIL where it is not
  built.

Masks are float32 [H, W, 1] (NHWC), 1 = hole.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["random_mask", "random_box_mask", "random_brush_mask", "load_mask",
           "mask_from_array"]


def random_box_mask(rng: np.random.Generator, size: int,
                    coverage: Tuple[float, float] = (0.05, 0.60)) -> np.ndarray:
    """One or more axis-aligned rectangles totalling the target coverage."""
    target = rng.uniform(*coverage)
    mask = np.zeros((size, size), np.float32)
    # draw boxes until target coverage reached (max 8 boxes)
    for _ in range(8):
        if mask.mean() >= target:
            break
        remaining = max(target - mask.mean(), 0.01)
        area = remaining * size * size * rng.uniform(0.5, 1.2)
        aspect = rng.uniform(0.4, 2.5)
        h = int(np.clip(np.sqrt(area * aspect), 4, size - 1))
        w = int(np.clip(np.sqrt(area / aspect), 4, size - 1))
        y = rng.integers(0, size - h + 1)
        x = rng.integers(0, size - w + 1)
        mask[y : y + h, x : x + w] = 1.0
    return mask[..., None]


def random_brush_mask(rng: np.random.Generator, size: int,
                      coverage: Tuple[float, float] = (0.05, 0.60),
                      max_strokes: int = 12) -> np.ndarray:
    """Irregular free-form brush strokes (random-walk polylines with varying
    radius), the NVIDIA-irregular-mask style."""
    target = rng.uniform(*coverage)
    mask = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(max_strokes):
        if mask.mean() >= target:
            break
        x, y = rng.uniform(0, size, 2)
        angle = rng.uniform(0, 2 * np.pi)
        n_seg = rng.integers(4, 16)
        radius = rng.uniform(size * 0.02, size * 0.08)
        for _ in range(n_seg):
            angle += rng.uniform(-0.7, 0.7)
            length = rng.uniform(size * 0.05, size * 0.2)
            nx = np.clip(x + length * np.cos(angle), 0, size - 1)
            ny = np.clip(y + length * np.sin(angle), 0, size - 1)
            # rasterize a thick segment as a set of discs
            steps = max(int(length), 1)
            ts = np.linspace(0, 1, steps)
            cxs = x + (nx - x) * ts
            cys = y + (ny - y) * ts
            for cx, cy in zip(cxs[:: max(steps // 8, 1)], cys[:: max(steps // 8, 1)]):
                mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= radius**2] = 1.0
            x, y = nx, ny
            if mask.mean() >= target:
                break
    return mask[..., None]


def _native_mask(kind: str, size: int, seed: int, coverage) -> Optional[np.ndarray]:
    """The C++ rasterizer's mask (native/maskgen.cpp); None if it is not
    built."""
    from ..native.build import load

    lib = load()
    if lib is None:
        return None
    import ctypes

    mask = np.zeros((size, size), np.float32)
    fn = lib.fidm_brush_mask if kind == "brush" else lib.fidm_box_mask
    fn(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size, ctypes.c_uint64(seed),
       coverage[0], coverage[1])
    return mask[..., None]


def random_mask(rng: np.random.Generator, size: int,
                coverage: Tuple[float, float] = (0.05, 0.60),
                kind: str = "mixed", use_native: bool = True) -> np.ndarray:
    """Procedural mask: 'box' | 'brush' | 'mixed' (random choice).

    With `use_native` the C++ rasterizer draws it (the same stroke model,
    its own RNG stream seeded by `rng.integers(1, 2**63)`, drawn whether or
    not the library is built, as in `fidm_tpu`); the numpy version
    otherwise. An unknown kind raises ValueError on both paths (the JAX
    package's native path draws a box for it)."""
    if kind not in ("mixed", "box", "brush"):
        raise ValueError(f"unknown mask kind: {kind}")
    if kind == "mixed":
        kind = "box" if rng.uniform() < 0.5 else "brush"
    if use_native:
        native = _native_mask(kind, size, int(rng.integers(1, 2**63)), coverage)
        if native is not None:
            return native
    if kind == "box":
        return random_box_mask(rng, size, coverage)
    return random_brush_mask(rng, size, coverage)


def mask_from_array(gray: np.ndarray) -> np.ndarray:
    """Apply the mask convention to a [H,W] grayscale array in [0,1]:
    black (<0.5) -> 1 (inpaint), white -> 0 (keep)."""
    mask = (gray < 0.5).astype(np.float32)
    return mask[..., None] if mask.ndim == 2 else mask


def load_mask(path: str, size: int) -> np.ndarray:
    """Load a mask file (grayscale, bilinear resize to size x size) and apply
    the black = inpaint inversion. Decodes through the native loader
    (bit-equal to PIL's convert("L") and BILINEAR resize), with PIL where
    the loader is not built or cannot read the file."""
    from ..native.imgload import decode_resize

    m = decode_resize(path, size, "L")
    if m is None:
        from PIL import Image

        m = np.asarray(Image.open(path).convert("L").resize((size, size), Image.BILINEAR))
    return mask_from_array(np.asarray(m, np.float32) / 255.0)
