"""Pack an image directory into uint8 memmap shards for fast epochs
(PyTorch port of `fidm_tpu/cli/pack_data.py`; the same flags, the same
format).

One-time decode+resize of the whole dataset into .npy shards + index.json
(`fidm_tpu_torch/data/shards.py`). Any CLI then accepts the packed dir
wherever it accepts an image dir (`--data_dir`, `--calibrate`): the dataset
detects index.json. Packing runs on the host alone.

    python -m fidm_tpu_torch.cli.pack_data --data_dir ffhq/ --out ffhq_packed/ \
        --image_size 256
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pack images into uint8 shards")
    p.add_argument("--data_dir", required=True, help="source image directory")
    p.add_argument("--out", required=True, help="output packed directory")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--shard_size", type=int, default=512,
                   help="images per shard file")
    return p.parse_args(argv)


def main(argv=None):
    from ..data.shards import ShardReader, pack_dataset

    args = parse_args(argv)
    index = pack_dataset(args.data_dir, args.out, img_size=args.image_size,
                         shard_size=args.shard_size)
    reader = ShardReader(args.out)
    report = {
        "out": args.out,
        "num_images": index["num_images"],
        "num_shards": len(index["shards"]),
        "img_size": index["img_size"],
        "bytes": reader.nbytes(),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
