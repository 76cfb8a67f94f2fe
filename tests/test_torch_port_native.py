"""The port's native data helpers (`fidm_tpu_torch/native`: its own copies of
maskgen.cpp and imgload.cpp, built here with g++) against the JAX package's.

Both packages take their C++ helpers by default, so procedural masks,
`_normalize_compose`, decoded files and dataset items are held bit for bit
against `fidm_tpu`'s defaults; PNG decodes are also held against PIL bit for
bit (JPEG goes through the system libjpeg in both packages). A few cases of
`tests/test_native_fuzz.py`'s corpus run against the port's library, with
guard canaries around the output buffers.
"""
import ctypes
import io
import multiprocessing
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fidm_tpu.data import dataset as jax_dataset
from fidm_tpu.data import masks as jax_masks
from fidm_tpu.native import imgload as jax_imgload
from fidm_tpu_torch.data import InpaintingDataset, load_mask, random_mask
from fidm_tpu_torch.data import dataset as port_dataset
from fidm_tpu_torch.native import build
from fidm_tpu_torch.native.imgload import decode_resize, decode_resize_batch

import _torch_port_native_ref as native_ref
from _torch_port_native_ref import jax_native  # noqa: F401

SIZE = 24


@pytest.fixture(scope="module")
def libs(jax_native):
    """The port's two libraries; `fidm_tpu`'s, which the cases hold them
    against, come from `jax_native`, built for this process."""
    masklib, imglib = build.load(), build.load_imgload()
    assert masklib is not None, build.last_error("native")
    assert imglib is not None, build.last_error("imgload")
    return masklib, imglib


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded 40x30 images as PNG and JPEG, and 3 PNG masks under masks/."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    for i in range(4):
        img = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
        img.save(root / "images" / f"img_{i}.png")
        img.save(root / "images" / f"img_{i}.jpg", "JPEG", quality=90)
    for i in range(3):
        m = np.full((30, 40), 255, np.uint8)
        m[3 + 4 * i: 20 + i, 5: 30 - 2 * i] = 0
        Image.fromarray(m).save(root / "masks" / f"mask_{i}.png")
    return root


@pytest.mark.parametrize("kind", ["box", "brush", "mixed"])
def test_random_mask_default_bit_equal_to_jax(libs, kind):
    """`random_mask` at its default (the C++ rasterizer from the generator's
    `integers(1, 2**63)` draw) equals `fidm_tpu`'s default."""
    for size in (16, 64, 256):
        for seed in range(6):
            ours = random_mask(np.random.default_rng(seed), size, kind=kind)
            ref = jax_masks.random_mask(np.random.default_rng(seed), size, kind=kind)
            assert ours.dtype == np.float32 and ours.shape == (size, size, 1)
            np.testing.assert_array_equal(ours, ref, err_msg=f"{kind} {size} {seed}")


def test_native_masks_deterministic_in_range_and_not_numpy(libs):
    for kind in ("box", "brush"):
        for seed in range(4):
            a = random_mask(np.random.default_rng(seed), 64, (0.1, 0.5), kind=kind)
            b = random_mask(np.random.default_rng(seed), 64, (0.1, 0.5), kind=kind)
            np.testing.assert_array_equal(a, b)
            assert np.isin(a, [0.0, 1.0]).all() and 0.0 < a.mean() <= 0.75
        numpy_path = random_mask(np.random.default_rng(1), 64, kind=kind, use_native=False)
        assert not np.array_equal(random_mask(np.random.default_rng(1), 64, kind=kind),
                                  numpy_path)


def test_normalize_compose_bit_equal_to_jax(libs):
    """The fused C++ normalize equals `fidm_tpu`'s bit for bit, and numpy's
    u8 / 255 * 2 - 1 within one float32 ulp of 1 (the only difference)."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(48, 40, 1)) < 0.4).astype(np.float32)
    image, masked = port_dataset._normalize_compose(u8, mask)
    ref_image, ref_masked = jax_dataset._normalize_compose(u8, mask)
    np.testing.assert_array_equal(image, ref_image)
    np.testing.assert_array_equal(masked, ref_masked)
    numpy_image = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
    assert np.abs(image - numpy_image).max() <= np.spacing(np.float32(1.0))
    np.testing.assert_array_equal(masked, image * (1.0 - mask))


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_decode_matches_jax_and_pil(libs, files, ext, mode):
    for i in range(4):
        path = files / "images" / f"img_{i}.{ext}"
        ours = decode_resize(path, SIZE, mode)
        assert ours is not None and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, jax_imgload.decode_resize(path, SIZE, mode))
        if ext == "png":
            pil = np.asarray(Image.open(path).convert(mode).resize((SIZE, SIZE),
                                                                   Image.BILINEAR))
            np.testing.assert_array_equal(ours, pil)


def test_decode_batch_matches_single_and_jax(libs, files, tmp_path):
    paths = [files / "images" / f"img_{i}.{e}" for i in range(4) for e in ("png", "jpg")]
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n garbage")
    out, ok = decode_resize_batch(paths + [bad], SIZE, "RGB", nthreads=2)
    ref, ref_ok = jax_imgload.decode_resize_batch(paths + [bad], SIZE, "RGB", nthreads=2)
    assert ok.tolist() == ref_ok.tolist() == [True] * len(paths) + [False]
    np.testing.assert_array_equal(out[:-1], ref[:-1])
    for p, row in zip(paths, out):
        np.testing.assert_array_equal(row, decode_resize(p, SIZE, "RGB"))
    gray, _ = decode_resize_batch(paths[:2], SIZE, "L")
    assert gray.shape == (2, SIZE, SIZE)
    for p in (files / "masks").iterdir():
        np.testing.assert_array_equal(load_mask(p, SIZE), jax_masks.load_mask(p, SIZE))


@pytest.mark.parametrize("mode", ["procedural", "serial"])
def test_dataset_items_bit_equal_to_jax_default(libs, files, mode):
    """Items of JPEG and PNG files with procedural or file masks: both
    packages' defaults (native decode, C++ masks and normalize) agree bit
    for bit."""
    mask_dir = None if mode == "procedural" else files / "masks"
    ours = InpaintingDataset(files / "images", mask_dir, "", SIZE, mode, seed=4)
    ref = jax_dataset.InpaintingDataset(files / "images", mask_dir, "", SIZE, mode, seed=4)
    assert len(ours) == len(ref) == 8
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a["mask_path"] == b["mask_path"]
        for key in ("image", "masked_image", "mask"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{i} {key}")


def test_private_jax_builds_in_six_processes_at_once(libs, files, tmp_path):
    """Six processes that start together each build `fidm_tpu`'s two
    libraries in a directory of their own (`jax_native_libs`), load both
    from there and decode one seeded PNG equal to the port's decode: the
    parity cases never load the shared `fidm_tpu/native/_artifacts/` build,
    which test workers starting together race on."""
    n = 6
    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(n), ctx.Queue()
    path = files / "images" / "img_0.png"
    dirs = [tmp_path / f"proc{i}" for i in range(n)]
    procs = [ctx.Process(target=native_ref.decode_in_private_build,
                         args=(barrier, results, i, str(dirs[i]), str(path), SIZE))
             for i in range(n)]
    for p in procs:
        p.start()
    try:
        got = {}
        for _ in range(n):
            i, *rest = results.get(timeout=300)
            got[i] = rest
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    ours = decode_resize(path, SIZE, "RGB")
    assert ours is not None
    for i in range(n):
        masklib, imglib, out = got[i]
        assert masklib is not None, (i, out)
        assert os.path.dirname(masklib) == os.path.dirname(imglib) == str(dirs[i])
        np.testing.assert_array_equal(out, ours, err_msg=str(i))
    assert [p.exitcode for p in procs] == [0] * n


def _png_with_header(width, height):
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    chunk = b"IHDR" + ihdr
    return (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(ihdr)) + chunk
            + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF))


def _jpeg_bytes():
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (29, 37, 3), np.uint8)).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("name,content", [
    ("empty.png", b""),
    ("garbage.jpg", b"\xff\xd8" + bytes(reversed(range(256))) * 8),
    ("zero_w.png", _png_with_header(0, 10)),
    ("bomb.png", _png_with_header(1_000_000, 1_000_000)),
    ("header_only.jpg", _jpeg_bytes()[:64]),
])
def test_malformed_files_fail_cleanly(libs, tmp_path, name, content):
    """rc != 0 and None for each file, the canary around the output intact."""
    _, imglib = libs
    p = tmp_path / name
    p.write_bytes(content)
    buf = np.full(SIZE * SIZE * 3 + 2048, 0xAB, np.uint8)
    view = buf[1024:1024 + SIZE * SIZE * 3]
    rc = imglib.fidm_load_image(str(p).encode(), SIZE, 3,
                                view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert rc != 0
    assert (buf[:1024] == 0xAB).all() and (buf[-1024:] == 0xAB).all()
    assert decode_resize(p, SIZE, "RGB") is None and decode_resize(p, SIZE, "L") is None


@pytest.mark.parametrize("kind", ["box", "brush"])
def test_maskgen_tiny_canvases_no_oob(libs, kind):
    fn = getattr(libs[0], f"fidm_{kind}_mask")
    for size in (1, 2, 3, 4, 5, 8):
        for seed in range(1, 12):
            buf = np.full(size * size + 512, 7.0, np.float32)
            view = buf[256:256 + size * size]
            view[:] = 0.0
            cov = fn(view.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size, seed, 0.05, 0.6)
            assert (buf[:256] == 7.0).all() and (buf[-256:] == 7.0).all(), (size, seed)
            assert np.isin(view, [0.0, 1.0]).all() and 0.0 <= cov <= 1.0, (size, seed)


def test_build_is_keyed_and_can_be_disabled(libs, monkeypatch):
    """The library's name carries a hash of its source and flags; with
    FIDM_TPU_NATIVE=0 nothing loads and the numpy and PIL paths run (the
    numpy masks equal `fidm_tpu`'s numpy path)."""
    for name in ("native", "imgload"):
        path = build.lib_path(name)
        assert path.exists() and path.parent == build.BUILD_DIR
        assert path.name.startswith(f"libfidm_{name}-") and len(path.stem.split("-")[1]) == 16
    monkeypatch.setenv("FIDM_TPU_NATIVE", "0")
    monkeypatch.setattr(build, "_loaded", {})
    assert build.load() is None and build.load_imgload() is None
    assert "FIDM_TPU_NATIVE" in build.last_error("native")
    ours = random_mask(np.random.default_rng(2), 32, kind="brush")
    # the seed draw happens on both paths, so the numpy mask follows it
    rng = np.random.default_rng(2)
    rng.integers(1, 2**63)
    np.testing.assert_array_equal(ours, jax_masks.random_brush_mask(rng, 32))
