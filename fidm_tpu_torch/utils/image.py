"""Image save/convert helpers for the eval harness (a copy of
`fidm_tpu/utils/image.py`).

Equivalents of `toU8` and `save_results`
(`test_inpainting_better.py:39-95`): [-1,1] float -> uint8, per-image PNGs,
and row-major comparison grids [original | masked | mask | inpainted].
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["to_uint8", "save_png", "save_comparison_grid"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 (`test_inpainting_better.py:39-48`)."""
    img = np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255)
    return img.astype(np.uint8)


def save_png(img_u8: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if img_u8.ndim == 3 and img_u8.shape[-1] == 1:
        img_u8 = img_u8[..., 0]
    Image.fromarray(img_u8).save(path)


def save_comparison_grid(
    rows: Sequence[Sequence[np.ndarray]],
    path: str,
    pad: int = 2,
) -> None:
    """Grid of uint8 images: one list per row (e.g. [gt, masked, mask, out])."""
    rows = [[np.atleast_3d(im) for im in row] for row in rows]
    h, w = rows[0][0].shape[:2]
    ncol = max(len(r) for r in rows)
    grid = np.full(
        (len(rows) * (h + pad) - pad, ncol * (w + pad) - pad, 3), 255, np.uint8
    )
    for i, row in enumerate(rows):
        for j, im in enumerate(row):
            if im.shape[-1] == 1:
                im = np.repeat(im, 3, axis=-1)
            grid[i * (h + pad) : i * (h + pad) + h,
                 j * (w + pad) : j * (w + pad) + w] = im
    save_png(grid, path)
