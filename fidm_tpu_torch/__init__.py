"""PyTorch / CUDA port of fidm_tpu for NVIDIA Hopper.

Public contract as in fidm_tpu: NHWC float32 images in [-1, 1] and
[B, H, W, 1] masks with 1 = hole. Entry points run on "cuda" unless the
caller names another device, and raise when no GPU is present.
"""
from .pipeline import (
    SAMPLER_PRESETS,
    InpaintingPipeline,
    PipelineConfig,
    create_model_and_schedule,
)

__all__ = [
    "InpaintingPipeline",
    "PipelineConfig",
    "SAMPLER_PRESETS",
    "create_model_and_schedule",
]
