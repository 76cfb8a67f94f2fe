"""The port's data modules (masks, packed shards, the inference dataset)
against the JAX package's.

Procedural masks are the same numpy stroke model, so with the same
`np.random.Generator` they are bit-equal to `fidm_tpu`'s numpy path
(`use_native=False`). Dataset items are bit-equal to `fidm_tpu`'s when it
takes its numpy normalize; where it takes its C++ kernel
(native/maskgen.cpp, built here) they are within 1e-6, because the kernel
computes u8 * (2/255) - 1 and numpy u8 / 255 * 2 - 1, which differ in the
last bit of a float32 in [-1, 1]. Both decode files bit-identically (PIL in
the port; in `fidm_tpu` its native loader, which matches PIL, or PIL).
"""
import json

import numpy as np
import pytest
from PIL import Image

import fidm_tpu.native.build as jax_native_build
from fidm_tpu.data import dataset as jax_dataset
from fidm_tpu.data import masks as jax_masks
from fidm_tpu.data import shards as jax_shards
from fidm_tpu_torch.data import (
    DataLoader,
    InpaintingDataset,
    create_inference_dataloader,
    is_packed_dir,
    list_images,
    load_image,
    load_mask,
    mask_from_array,
    pack_dataset,
    random_box_mask,
    random_brush_mask,
    random_mask,
)
from fidm_tpu_torch.data.shards import ShardReader

SIZE = 24


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    """7 RGB images at 32x32 (so loading resizes them to SIZE) and 3 masks
    under masks/test/, as PNG files."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    img_dir, mask_dir = root / "images", root / "masks" / "test"
    img_dir.mkdir()
    mask_dir.mkdir(parents=True)
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i:02d}.png")
    for i in range(3):
        m = np.full((32, 32), 255, np.uint8)
        m[4 + 3 * i: 20 + 2 * i, 6:26 - i] = 0  # black = hole
        Image.fromarray(m).save(mask_dir / f"mask_{i}.png")
    (img_dir / "notes.txt").write_text("not an image")
    return img_dir, root / "masks"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_box_and_brush_masks_bit_equal(seed):
    for size in (16, 64):
        np.testing.assert_array_equal(
            random_box_mask(np.random.default_rng(seed), size),
            jax_masks.random_box_mask(np.random.default_rng(seed), size))
        np.testing.assert_array_equal(
            random_brush_mask(np.random.default_rng(seed), size, (0.1, 0.3)),
            jax_masks.random_brush_mask(np.random.default_rng(seed), size, (0.1, 0.3)))


@pytest.mark.parametrize("kind", ["mixed", "box", "brush"])
def test_random_mask_is_the_numpy_path(kind):
    for seed in range(4):
        ours = random_mask(np.random.default_rng(seed), 32, kind=kind)
        ref = jax_masks.random_mask(np.random.default_rng(seed), 32, kind=kind,
                                    use_native=False)
        assert ours.dtype == np.float32 and ours.shape == (32, 32, 1)
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        random_mask(np.random.default_rng(0), 8, kind="blob")


def test_mask_files_and_arrays(data_tree):
    _, mask_root = data_tree
    gray = np.random.default_rng(1).uniform(size=(8, 8)).astype(np.float32)
    np.testing.assert_array_equal(mask_from_array(gray), jax_masks.mask_from_array(gray))
    for path in list_images(mask_root / "test"):
        np.testing.assert_array_equal(load_mask(path, SIZE), jax_masks.load_mask(path, SIZE))


def test_listing_and_image_loading(data_tree):
    img_dir, _ = data_tree
    images = list_images(img_dir)
    assert images == jax_dataset.list_images(img_dir) and len(images) == 7
    for path in images[:3]:
        ours = load_image(path, SIZE)
        assert ours.dtype == np.float32 and ours.shape == (SIZE, SIZE, 3)
        # fidm_tpu: native decode (bit-identical to PIL), numpy normalize
        np.testing.assert_array_equal(ours, jax_dataset.load_image(path, SIZE))


def test_packed_shards_bit_equal_to_jax(data_tree, tmp_path):
    img_dir, _ = data_tree
    ours = pack_dataset(img_dir, tmp_path / "ours", img_size=SIZE, shard_size=3)
    ref = jax_shards.pack_dataset(img_dir, tmp_path / "ref", img_size=SIZE, shard_size=3)
    assert ours == ref and is_packed_dir(tmp_path / "ours")
    assert not is_packed_dir(img_dir)
    for s in ours["shards"]:
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / s["file"]),
                                      np.load(tmp_path / "ref" / s["file"]))
    reader, jax_reader = ShardReader(tmp_path / "ours"), jax_shards.ShardReader(tmp_path / "ref")
    assert len(reader) == 7 and reader.nbytes() == jax_reader.nbytes()
    for i in range(7):
        np.testing.assert_array_equal(reader.get(i), jax_reader.get(i))
        np.testing.assert_array_equal(reader.get(i, 16), jax_reader.get(i, 16))


def _packed(data_tree, tmp_path):
    img_dir, _ = data_tree
    jax_shards.pack_dataset(img_dir, tmp_path / "packed", img_size=SIZE, shard_size=4)
    return tmp_path / "packed"


def _assert_items_equal(ours, ref, atol):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert list(a) == list(b)
        assert a["image_path"] == b["image_path"] and a["mask_path"] == b["mask_path"]
        np.testing.assert_array_equal(a["mask"], b["mask"])
        for key in ("image", "masked_image"):
            assert a[key].dtype == np.float32 and a[key].shape == (SIZE, SIZE, 3)
            if atol == 0:
                np.testing.assert_array_equal(a[key], b[key])
            else:
                np.testing.assert_allclose(a[key], b[key], atol=atol, rtol=0)


@pytest.mark.parametrize("source", ["png", "packed"])
@pytest.mark.parametrize("mode", ["serial", "ordered", "random"])
def test_dataset_items_match_jax(data_tree, tmp_path, monkeypatch, source, mode):
    img_dir, mask_root = data_tree
    data_dir = img_dir if source == "png" else _packed(data_tree, tmp_path)
    ours = InpaintingDataset(data_dir, mask_root, "test", SIZE, mode, seed=3)
    ref = jax_dataset.InpaintingDataset(data_dir, mask_root, "test", SIZE, mode, seed=3)
    assert [str(m) for m in ours.mask_sequence] == [str(m) for m in ref.mask_sequence]
    assert ours.reader is not None if source == "packed" else ours.reader is None
    # fidm_tpu with its C++ normalize: the last bit differs (see the module doc)
    _assert_items_equal(ours, ref, atol=1e-6)
    # fidm_tpu's numpy normalize, the port's: bit-equal
    monkeypatch.setattr(jax_native_build, "load", lambda: None)
    ref = jax_dataset.InpaintingDataset(data_dir, mask_root, "test", SIZE, mode, seed=3)
    _assert_items_equal(ours, ref, atol=0)


def test_procedural_items(data_tree, monkeypatch):
    """Item i's mask is `random_mask` from a generator seeded with
    seed * 1_000_003 + i. (`fidm_tpu` draws a seed for its C++ rasterizer
    from that generator first, also when the rasterizer is not built, so
    its procedural masks differ from these; its images do not.)"""
    img_dir, _ = data_tree
    monkeypatch.setattr(jax_native_build, "load", lambda: None)
    ours = InpaintingDataset(img_dir, None, "", SIZE, "procedural", seed=5)
    ref = jax_dataset.InpaintingDataset(img_dir, None, "", SIZE, "procedural", seed=5)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        mask = random_mask(np.random.default_rng(5 * 1_000_003 + i), SIZE)
        np.testing.assert_array_equal(a["mask"], mask)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["masked_image"], a["image"] * (1.0 - mask))
        assert a["mask_path"] == b["mask_path"] == f"<procedural:{i}>"
    with pytest.raises(ValueError, match="mask_dir required"):
        InpaintingDataset(img_dir, None, "", SIZE, "serial")


def test_loaders_match_jax(data_tree, monkeypatch):
    img_dir, mask_root = data_tree
    monkeypatch.setattr(jax_native_build, "load", lambda: None)
    ours = create_inference_dataloader(img_dir, mask_root, batch_size=2, img_size=SIZE,
                                       num_samples=5, seed=1)
    ref = jax_dataset.create_inference_dataloader(img_dir, mask_root, batch_size=2,
                                                  img_size=SIZE, num_samples=5, seed=1)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert list(a) == list(b) and a["image_path"] == b["image_path"]
        for key in ("image", "masked_image", "mask"):
            np.testing.assert_array_equal(a[key], b[key])
    ds = InpaintingDataset(img_dir, mask_root, "test", SIZE, "ordered")
    jds = jax_dataset.InpaintingDataset(img_dir, mask_root, "test", SIZE, "ordered")
    for kw in (dict(shuffle=True, drop_last=True, seed=4), dict(shuffle=False)):
        loader, jloader = DataLoader(ds, 3, **kw), jax_dataset.DataLoader(jds, 3, **kw)
        assert len(loader) == len(jloader)
        for _ in range(2):  # two epochs: the shuffle order moves with the epoch
            paths = [b["image_path"] for b in loader]
            assert paths == [b["image_path"] for b in jloader]


def test_packed_directory_written_with_numpy_reads(tmp_path):
    """A packed directory written with numpy alone (no image files), as
    `chip_smoke.py` writes one for calibration, reads at its own size."""
    arr = np.random.default_rng(2).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    np.save(tmp_path / "shard_00000.npy", arr)
    index = {"img_size": SIZE, "num_images": 3,
             "shards": [{"file": "shard_00000.npy", "count": 3}],
             "paths": [f"synthetic_{i}.png" for i in range(3)]}
    (tmp_path / "index.json").write_text(json.dumps(index))
    ds = InpaintingDataset(tmp_path, None, "", SIZE, "procedural", seed=0)
    item = ds[1]
    np.testing.assert_array_equal(item["image"], arr[1].astype(np.float32) / 255.0 * 2.0 - 1.0)
    assert item["mask_path"] == "<procedural:1>"
