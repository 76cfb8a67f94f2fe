"""numpy API over the native image loader, imgload.cpp (PyTorch port of
`fidm_tpu/native/imgload.py`).

`decode_resize` and `decode_resize_batch` return uint8 arrays equal to the
PIL pipeline of the data layer
(`Image.open(p).convert(mode).resize((size, size), Image.BILINEAR)`): the
resize is Pillow's fixed-point resampler, bit for bit; JPEG decode rides the
system libjpeg, which can differ from Pillow's bundled decoder by 1 LSB.

Every entry point returns None when the library is unavailable or the file
cannot be decoded; the callers then decode that item with PIL.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .build import load_imgload

__all__ = ["decode_resize", "decode_resize_batch"]

_MODES = {"RGB": 3, "L": 1}


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_resize(path, size: int, mode: str = "RGB") -> Optional[np.ndarray]:
    """Decode one JPEG or PNG and resize it to (size, size): uint8
    [size, size, 3] for mode "RGB", [size, size] for "L"; None when the
    library is unavailable or the decode fails."""
    lib = load_imgload()
    if lib is None:
        return None
    ch = _MODES[mode]
    out = np.empty((size, size, ch) if ch > 1 else (size, size), np.uint8)
    rc = lib.fidm_load_image(os.fsencode(str(path)), size, ch, _u8p(out))
    return out if rc == 0 else None


def decode_resize_batch(paths: Sequence, size: int, mode: str = "RGB",
                        nthreads: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded batch decode and resize: (out, ok), out uint8
    [N, size, size, C] (C dropped for "L"), ok bool [N] per item (a failed
    row is undefined: load it with PIL). None when the library is
    unavailable. nthreads <= 0 uses every hardware thread."""
    lib = load_imgload()
    if lib is None:
        return None
    n = len(paths)
    ch = _MODES[mode]
    out = np.empty((n, size, size, ch) if ch > 1 else (n, size, size), np.uint8)
    ok = np.zeros((n,), np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    lib.fidm_load_batch(c_paths, n, size, ch, _u8p(out), _u8p(ok), int(nthreads))
    return out, ok.astype(bool)
