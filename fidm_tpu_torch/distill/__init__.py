"""Few-step students (PyTorch port of `fidm_tpu.distill`): progressive
distillation, and consistency distillation and training."""
from .consistency import (
    consistency_grid,
    consistency_sample,
    consistency_x0,
    make_consistency_step,
)
from .progressive import distill_boundaries, make_distill_step

__all__ = ["consistency_grid", "consistency_sample", "consistency_x0", "distill_boundaries",
           "make_consistency_step", "make_distill_step"]
