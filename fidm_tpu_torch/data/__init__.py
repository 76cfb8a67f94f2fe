from .dataset import (
    DataLoader,
    InpaintingDataset,
    create_inference_dataloader,
    list_images,
    load_image,
)
from .masks import load_mask, mask_from_array, random_box_mask, random_brush_mask, random_mask
from .shards import ShardReader, is_packed_dir, pack_dataset

__all__ = [
    "DataLoader",
    "InpaintingDataset",
    "ShardReader",
    "create_inference_dataloader",
    "is_packed_dir",
    "list_images",
    "load_image",
    "load_mask",
    "mask_from_array",
    "pack_dataset",
    "random_box_mask",
    "random_brush_mask",
    "random_mask",
]
