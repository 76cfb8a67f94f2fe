"""Build and load the native data-path helpers with g++ and ctypes (PyTorch
port of `fidm_tpu/native/build.py`).

Two shared objects, loaded apart, so that a missing system library for one
never takes down the other:

- `libfidm_native` (maskgen.cpp): procedural masks and the fused
  normalize/compose;
- `libfidm_imgload` (imgload.cpp): libjpeg/libpng decode, a Pillow
  bit-compatible resize and threaded batch loading.

Each is compiled at first use into `_build/` beside this file (listed in
.gitignore), under a file name that carries a hash of its source and flags,
and of the host CPU's model and flags (the code is built for this CPU), so
an edited source or another machine rebuilds and a stale library is never
loaded; the
compiler writes a temporary file that is renamed into place, so processes
that build at once do not read half a library. The flags are the JAX
package's, so the masks of both packages are bit-equal on one machine.

These are host helpers, as in `fidm_tpu`: `load()` and `load_imgload()`
return None when g++ or a system header is missing, or when
`FIDM_TPU_NATIVE` is `0` or `false`, and the callers then take their numpy
and PIL paths (`data/masks.py`, `data/dataset.py`), which is what `fidm_tpu`
does there. `last_error()` says why a library is not loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load", "load_imgload", "native_enabled", "last_error", "BUILD_DIR"]

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIBS = {"native": ("maskgen.cpp", ()), "imgload": ("imgload.cpp", ("-ljpeg", "-lpng"))}

_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
_errors: Dict[str, str] = {}


def native_enabled() -> bool:
    """False when FIDM_TPU_NATIVE is 0 or false."""
    return os.environ.get("FIDM_TPU_NATIVE", "1") not in ("0", "false")


def _cpu_id() -> bytes:
    """The host CPU's model and flags: -march=native code built on one CPU
    may not run on another, so a copy of the tree on another machine
    rebuilds."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return "".join(lines).encode()


def lib_path(name: str) -> Path:
    src, libs = _LIBS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    h.update(_cpu_id())
    h.update((HERE / src).read_bytes())
    return BUILD_DIR / f"libfidm_{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Optional[Path]:
    src, libs = _LIBS[name]
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(HERE / src), *libs],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        _errors[name] = f"g++ could not run: {e}"
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        _errors[name] = f"g++ failed for {src}:\n{proc.stderr[-2000:]}"
        return None
    os.replace(tmp, out)
    return out


def _load(name: str) -> Optional[ctypes.CDLL]:
    if name in _loaded:
        return _loaded[name]
    lib = None
    if not native_enabled():
        _errors[name] = "FIDM_TPU_NATIVE disables the native helpers"
    else:
        path = _build(name)
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                _errors[name] = f"cannot load {path.name}: {e}"
    _loaded[name] = lib
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The mask and normalize library, built on first call; None if it is
    unavailable."""
    if "native" in _loaded:
        return _loaded["native"]
    lib = _load("native")
    if lib is not None:
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in (lib.fidm_brush_mask, lib.fidm_box_mask):
            fn.argtypes = [f32p, ctypes.c_int, ctypes.c_uint64, ctypes.c_float,
                           ctypes.c_float]
            fn.restype = ctypes.c_float
        lib.fidm_normalize_compose.argtypes = [u8p, f32p, f32p, f32p, ctypes.c_int,
                                               ctypes.c_int]
        lib.fidm_normalize_compose.restype = None
    return lib


def load_imgload() -> Optional[ctypes.CDLL]:
    """The image-loading library (libjpeg/libpng decode and the
    Pillow-compatible resize), built on first call; None if it is
    unavailable (no jpeglib.h or png.h, for one)."""
    if "imgload" in _loaded:
        return _loaded["imgload"]
    lib = _load("imgload")
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fidm_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p]
        lib.fidm_load_image.restype = ctypes.c_int
        lib.fidm_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int]
        lib.fidm_load_batch.restype = ctypes.c_int
    return lib


def last_error(name: str = "native") -> Optional[str]:
    """Why library `name` ("native" or "imgload") did not load, or None."""
    return _errors.get(name)
