"""The JAX package's native libraries, built privately for one process.

`fidm_tpu.native.build` compiles `maskgen.cpp` and `imgload.cpp` with g++
straight into paths that every process shares (`fidm_tpu/native/_artifacts/`),
and keeps a failed load as None for the rest of the process. When several
test workers start on a fresh tree, one can load a file that another is still
writing: it gets None, and `fidm_tpu` then quietly takes its numpy masks and
PIL decodes. A parity test that holds the port against `fidm_tpu`'s native
default must not compare against that fallback, so it takes the libraries from
`jax_native_libs`: the JAX package's own build into a directory of this
process, its module globals pointed there for the test and restored after.
"""
import contextlib
import os
import subprocess
import types

import pytest

from fidm_tpu.native import build as jax_native_build


@contextlib.contextmanager
def _g_plus_plus_errors():
    """`fidm_tpu.native.build`'s `subprocess.run` recording why g++ failed:
    `_build` itself swallows the error and returns False."""
    errors = []

    def run(*args, **kw):
        try:
            return subprocess.run(*args, **kw)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(getattr(e, "stderr", None) or e)
            raise

    shim = types.SimpleNamespace(run=run, SubprocessError=subprocess.SubprocessError)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_build, "subprocess", shim)
        yield errors


@contextlib.contextmanager
def jax_native_libs(directory):
    """Both JAX libraries built in `directory` by `fidm_tpu.native.build`'s
    own `load()` and `load_imgload()` (which call `_build` when the library
    is missing); inside the block those two return them, and so do
    `fidm_tpu`'s masks, decodes and datasets, which read the module's globals
    at call time. Yields the two `CDLL`s; restores every global on exit."""
    os.makedirs(directory, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        for attr in ("_LIB", "_IMG_LIB"):
            name = os.path.basename(getattr(jax_native_build, attr))
            mp.setattr(jax_native_build, attr, os.path.join(directory, name))
        for attr, value in (("_lib", None), ("_tried", False), ("_img_lib", None),
                            ("_img_tried", False)):
            mp.setattr(jax_native_build, attr, value)
        with _g_plus_plus_errors() as errors:
            masklib, imglib = jax_native_build.load(), jax_native_build.load_imgload()
        assert masklib is not None, f"fidm_tpu's maskgen library in {directory}: {errors}"
        assert imglib is not None, f"fidm_tpu's imgload library in {directory}: {errors}"
        yield masklib, imglib


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """`jax_native_libs` for a test module, in this worker's base temp."""
    with jax_native_libs(str(tmp_path_factory.getbasetemp() / "jax_native")) as libs:
        yield libs


def decode_in_private_build(barrier, results, index, directory, path, size):
    """One process of the race test in `test_torch_port_native.py`: wait
    for the others, build and load both JAX libraries in `directory`, and
    put (index, the two libraries' paths, `fidm_tpu`'s decode of `path`) on
    `results`, or (index, None, None, the error)."""
    barrier.wait()
    try:
        from fidm_tpu.native import imgload

        with jax_native_libs(directory) as (masklib, imglib):
            out = imgload.decode_resize(path, size, "RGB")
        results.put((index, masklib._name, imglib._name, out))
    except Exception as e:  # the parent reports it
        results.put((index, None, None, repr(e)))
