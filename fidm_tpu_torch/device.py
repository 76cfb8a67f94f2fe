"""Device selection for the port's entry points.

Every entry point takes a `device` argument that defaults to "cuda". A CUDA
device that is not there is an error, never a quiet move to the CPU; the
CPU runs only when a caller names it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device
