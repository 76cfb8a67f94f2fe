"""Inference-side data pipeline (PyTorch port, numpy only).

Counterpart of the inference part of `fidm_tpu/data/dataset.py`:

- `InpaintingDataset`: an image directory (or a packed shard directory, see
  `shards`) paired with masks from a mask directory (`mask_dir/<split>` or
  flat) in serial, random (seeded), ordered (`idx % n_masks`) or procedural
  mode. Images resize to `img_size` and normalise to [-1, 1]; masks follow
  the black = inpaint inversion.
- `DataLoader`: a multi-epoch batcher (shuffle / drop-last / subset) that
  yields dicts of stacked NHWC numpy arrays.
- `create_inpainting_dataloaders`: the training pair, a shuffled train
  loader that drops a ragged last batch and a sequential val loader.
- `create_inference_dataloader`: the test loader with ordered masks.

Image files decode through the native loader (`native/imgload.cpp`, bit-equal
to PIL) and normalize and compose in the fused C++ helper
(`native/maskgen.cpp`), as `fidm_tpu`'s default does, so items are bit-equal
to its items; where a library is not built, or `FIDM_TPU_NATIVE=0`, PIL and
numpy do the same work (bit-equal to `fidm_tpu` there too).

Every item is `{image, masked_image, mask, image_path, mask_path}`,
channel-last.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .masks import load_mask, random_mask

__all__ = [
    "list_images",
    "load_image",
    "InpaintingDataset",
    "DataLoader",
    "create_inpainting_dataloaders",
    "create_inference_dataloader",
]

IMAGE_EXTENSIONS = (".jpg", ".png", ".jpeg", ".bmp", ".tiff")


def list_images(directory) -> List[Path]:
    """Sorted, deduplicated image listing."""
    directory = Path(directory)
    files = [
        p
        for p in directory.iterdir()
        if p.is_file() and p.suffix.lower() in IMAGE_EXTENSIONS
    ]
    return sorted(set(files))


def decode_rgb_u8(path, size: int) -> np.ndarray:
    """uint8 [size, size, 3]: RGB, bilinear resize, through the native
    decoder (bit-equal to PIL), or PIL for an item it cannot decode."""
    from ..native.imgload import decode_resize

    u8 = decode_resize(path, size, "RGB")
    if u8 is not None:
        return u8
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_image(path, size: int) -> np.ndarray:
    """RGB image resized to size x size, float32 NHWC in [-1, 1]."""
    arr = decode_rgb_u8(path, size).astype(np.float32) / 255.0
    return arr * 2.0 - 1.0


def _normalize_compose(u8: np.ndarray, mask: np.ndarray):
    """uint8 HWC -> ([-1,1] image, masked_image), in the fused C++ helper
    when it is built (u8 * (2/255) - 1, which can differ from numpy's
    u8 / 255 * 2 - 1 in the last bit), in numpy otherwise."""
    from ..native.build import load as load_native

    lib = load_native()
    if lib is None:
        image = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
        return image, image * (1.0 - mask)

    import ctypes

    h, w = u8.shape[:2]
    u8 = np.ascontiguousarray(u8)
    m = np.ascontiguousarray(mask[..., 0], np.float32)
    image = np.empty((h, w, 3), np.float32)
    masked = np.empty((h, w, 3), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fidm_normalize_compose(u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               m.ctypes.data_as(f32p), image.ctypes.data_as(f32p),
                               masked.ctypes.data_as(f32p), h, w)
    return image, masked


class InpaintingDataset:
    """Image + mask pairing with serial/random/ordered/procedural masks."""

    def __init__(
        self,
        data_dir,
        mask_dir=None,
        split: str = "train",
        img_size: int = 256,
        mask_mode: str = "serial",  # serial | random | ordered | procedural
        seed: int = 42,
        coverage=(0.05, 0.60),
        invert_mask: bool = True,
    ):
        """invert_mask=True applies the black = inpaint inversion; False
        uses the file as-is with white = 1 = hole."""
        self.img_size = img_size
        self.mask_mode = mask_mode
        self.seed = seed
        self.coverage = coverage
        self.invert_mask = invert_mask
        from .shards import ShardReader, is_packed_dir

        # decoded-mask cache: serial/ordered modes assign the same few mask
        # files to many images (procedural masks are per index and skip it)
        self._mask_cache: Dict[str, np.ndarray] = {}
        self.reader = None
        if is_packed_dir(data_dir):
            self.reader = ShardReader(data_dir)
            self.images = [Path(p) for p in self.reader.paths]
            if self.reader.img_size != img_size:
                print(
                    f"WARNING: packed shards were written at "
                    f"{self.reader.img_size}px but img_size={img_size}: "
                    f"images will be resized twice (pack once per "
                    f"resolution for exact single-resize parity)"
                )
        else:
            self.images = list_images(data_dir)
        if not self.images:
            raise ValueError(f"No images found in {data_dir}")

        self.masks: List[Path] = []
        if mask_mode != "procedural":
            if mask_dir is None:
                raise ValueError("mask_dir required unless mask_mode='procedural'")
            mask_split_dir = Path(mask_dir) / split
            if not mask_split_dir.exists():
                # also accept a flat mask dir
                mask_split_dir = Path(mask_dir)
            self.masks = list_images(mask_split_dir)
            if not self.masks:
                raise ValueError(f"No masks found in {mask_split_dir}")

        if mask_mode in ("serial", "ordered"):
            # the mask list repeated in order over the images; both names
            # give the same sequence
            self.mask_sequence = [
                self.masks[i % len(self.masks)] for i in range(len(self.images))
            ]
        elif mask_mode == "random":
            rng = np.random.default_rng(seed)
            self.mask_sequence = [
                self.masks[rng.integers(0, len(self.masks))]
                for _ in range(len(self.images))
            ]
        elif mask_mode == "procedural":
            self.mask_sequence = [None] * len(self.images)
        else:
            raise ValueError(f"unknown mask_mode: {mask_mode}")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        img_path = self.images[idx]
        mask_path = self.mask_sequence[idx]
        if mask_path is None:
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
            mask = random_mask(rng, self.img_size, self.coverage)
            mask_path = f"<procedural:{idx}>"
        elif (cached := self._mask_cache.get(str(mask_path))) is not None:
            mask = cached
        else:
            if self.invert_mask:
                mask = load_mask(mask_path, self.img_size)
            else:
                from PIL import Image

                m = Image.open(mask_path).convert("L").resize(
                    (self.img_size, self.img_size), Image.BILINEAR
                )
                mask = (np.asarray(m, np.float32) / 255.0)[..., None]
            mask.flags.writeable = False  # shared across items
            self._mask_cache[str(mask_path)] = mask
        if self.reader is not None:
            u8 = self.reader.get(idx, self.img_size)
        else:
            u8 = decode_rgb_u8(img_path, self.img_size)
        image, masked_image = _normalize_compose(u8, mask)
        return {
            "image": image,
            "masked_image": masked_image,
            "mask": mask,
            "image_path": str(img_path),
            "mask_path": str(mask_path),
        }


class DataLoader:
    """Minimal batcher: shuffle, drop_last, stacked numpy dict batches.

    Every array-valued item key is stacked; numeric scalars become 1-D
    arrays; anything else (paths) stays a list.

    `process_local=True` (multi-process training; `training.loop.fit` sets
    it when the process group has more than one rank): every rank computes
    the same global epoch order (seed + epoch) and yields only its rows of
    each global batch (`parallel.multihost.host_local_slice`):
    `batch_size` stays the global batch size, each rank yields
    batch_size / world rows per step, and a ragged tail is dropped. In one
    process it changes nothing."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 subset: Optional[Sequence[int]] = None,
                 process_local: bool = False):
        self.dataset = dataset
        self.process_local = process_local
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.indices = np.asarray(
            subset if subset is not None else np.arange(len(dataset))
        )

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        idx = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        step = self.batch_size
        if self.process_local:
            from ..parallel.multihost import host_local_slice, process_count

            if process_count() > 1:
                idx = host_local_slice(idx, self.batch_size)
                step = self.batch_size // process_count()
        for start in range(0, len(idx), step):
            chunk = idx[start : start + step]
            if (self.drop_last or step != self.batch_size) and len(chunk) < step:
                break
            items = [self.dataset[int(i)] for i in chunk]
            batch = {}
            for k, v0 in items[0].items():
                if isinstance(v0, np.ndarray):
                    batch[k] = np.stack([it[k] for it in items])
                elif isinstance(v0, (int, float, np.integer, np.floating)
                                ) and not isinstance(v0, bool):
                    batch[k] = np.asarray([it[k] for it in items])
                else:
                    batch[k] = [it[k] for it in items]
            yield batch


def create_inpainting_dataloaders(
    train_dir, val_dir, mask_dir, batch_size=4, img_size=256,
    mask_mode="serial", seed=42,
):
    """Train/val loader pair: a shuffled train loader that drops a ragged
    last batch, and a sequential val loader that keeps it in one process and
    drops it when the process group has more than one rank (a meshed eval
    step needs the batch to divide over the ranks)."""
    from ..parallel.multihost import process_count

    train_ds = InpaintingDataset(train_dir, mask_dir, "train", img_size, mask_mode, seed)
    val_ds = InpaintingDataset(val_dir, mask_dir, "val", img_size, mask_mode, seed + 57)
    val_drop = process_count() > 1 and len(val_ds) % batch_size != 0
    return (
        DataLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=seed),
        DataLoader(val_ds, batch_size, shuffle=False, drop_last=val_drop),
    )


def create_inference_dataloader(
    test_dir, mask_dir, batch_size=4, img_size=256, num_samples=None, seed=42,
    mask_mode="ordered",
):
    """Test loader with ordered mask cycling and an optional random subset."""
    ds = InpaintingDataset(test_dir, mask_dir, "test", img_size, mask_mode, seed)
    subset = None
    if num_samples is not None and num_samples < len(ds):
        rng = np.random.default_rng(seed)
        subset = rng.choice(len(ds), size=num_samples, replace=False)
    return DataLoader(ds, batch_size, shuffle=False, subset=subset)
