"""Evaluation helpers: image conversion and saving, step timing, traces.
`fidm_tpu/utils/cache.py` (JAX's compilation cache) has no counterpart:
PyTorch runs eagerly and compiles nothing that a cache would keep."""
from .image import save_comparison_grid, save_png, to_uint8
from .profiler import StepTimer, trace

__all__ = ["StepTimer", "save_comparison_grid", "save_png", "to_uint8", "trace"]
