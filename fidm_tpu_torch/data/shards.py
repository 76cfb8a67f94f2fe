"""Packed uint8 shard format: decode a dataset once, read it many times
(PyTorch port).

Counterpart of `fidm_tpu/data/shards.py`. Images are decoded and bilinearly
resized once, then written as uint8 [N, H, W, 3] `.npy` shards plus an
`index.json`; readers memory-map the shards, so reading an item costs a
memcpy and a numpy normalize instead of an image decode. Reading a packed
directory at its own resolution needs no PIL.

`InpaintingDataset` detects a packed directory (index.json present). The
JAX package's `fidm_tpu.cli.pack_data` writes the same format.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["pack_dataset", "ShardReader", "is_packed_dir", "INDEX_NAME"]

INDEX_NAME = "index.json"


def is_packed_dir(directory) -> bool:
    return Path(directory, INDEX_NAME).is_file()


def pack_dataset(data_dir, out_dir, img_size: int = 256,
                 shard_size: int = 512) -> dict:
    """Decode every image in data_dir to img_size², write uint8 .npy shards.

    Returns the index dict (also written to out_dir/index.json):
    {"img_size", "num_images", "shards": [{"file", "count"}], "paths": [...]}.
    """
    from .dataset import decode_rgb_u8, list_images

    images = list_images(data_dir)
    if not images:
        raise ValueError(f"No images found in {data_dir}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    shards = []
    for s, start in enumerate(range(0, len(images), shard_size)):
        chunk = images[start : start + shard_size]
        arr = np.stack([decode_rgb_u8(p, img_size) for p in chunk])
        fname = f"shard_{s:05d}.npy"
        np.save(out / fname, arr)
        shards.append({"file": fname, "count": len(chunk)})

    index = {
        "img_size": img_size,
        "num_images": len(images),
        "shards": shards,
        "paths": [str(p) for p in images],
    }
    with open(out / INDEX_NAME, "w") as f:
        json.dump(index, f)
    return index


class ShardReader:
    """Memory-mapped random access over a packed directory."""

    def __init__(self, directory):
        self.directory = Path(directory)
        with open(self.directory / INDEX_NAME) as f:
            self.index = json.load(f)
        self.img_size = int(self.index["img_size"])
        self.paths: List[str] = list(self.index["paths"])
        self._mmaps = [
            np.load(self.directory / s["file"], mmap_mode="r")
            for s in self.index["shards"]
        ]
        self._offsets = np.cumsum(
            [0] + [s["count"] for s in self.index["shards"]]
        )

    def __len__(self):
        return int(self.index["num_images"])

    def get(self, idx: int, size: int | None = None) -> np.ndarray:
        """uint8 [size, size, 3]; resizes via PIL only if size differs from
        the packed resolution (the fast path is a pure memmap slice)."""
        s = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        u8 = np.ascontiguousarray(self._mmaps[s][idx - self._offsets[s]])
        if size is not None and size != self.img_size:
            from PIL import Image

            u8 = np.asarray(
                Image.fromarray(u8).resize((size, size), Image.BILINEAR),
                np.uint8,
            )
        return u8

    def nbytes(self) -> int:
        return sum(
            os.path.getsize(self.directory / s["file"])
            for s in self.index["shards"]
        )
