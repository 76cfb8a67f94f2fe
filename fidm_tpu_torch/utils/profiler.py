"""Profiling helpers (PyTorch port of `fidm_tpu/utils/profiler.py`).

- `trace(dir)` — context manager around `torch.profiler` that writes a
  TensorBoard-viewable trace (host and, on a GPU, device activity).
- `StepTimer` — per-step wall clock. PyTorch returns before the device has
  finished, so `stop(result)` synchronises the result's CUDA device before it
  reads the clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import List

import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Wait for `result` (a tensor) if it lies on a CUDA device, then
        record the elapsed seconds."""
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, per: int = 1) -> str:
        if not self.times:
            return "no steps timed"
        return (f"{len(self.times)} steps, mean {self.mean/per:.4f}s/item, "
                f"min {min(self.times)/per:.4f}s, max {max(self.times)/per:.4f}s")
