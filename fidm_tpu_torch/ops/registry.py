"""Per-op switch between a hand-written CUDA kernel and its plain version,
and the kernels' launch counts.

Counterpart of `fidm_tpu/ops/registry.py`. The default follows the tensor:
CUDA tensors launch the kernel, CPU tensors take the plain PyTorch version
(there is no kernel for the CPU). The plain version runs on a CUDA tensor
only inside an explicit `kernel_override(False, op)` block, which is how a
kernel is held against its plain version on the card, with one exception:
the attention backward recomputes the plain version (`ops/attention.py`).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional

import torch

__all__ = ["OPS", "use_kernel", "kernel_override", "LAUNCHES"]

# the ops that have a kernel (ops/attention.py, ops/quantize.py)
OPS = ("attention", "quantize")

_overrides: Dict[str, Optional[bool]] = {}

# op name -> number of kernel launches; each wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES: collections.Counter = collections.Counter()


def _known(op: str) -> str:
    if op not in OPS:
        raise KeyError(f"no kernel is registered for op {op!r}; ops: {OPS}")
    return op


def use_kernel(op: str, device: torch.device) -> bool:
    forced = _overrides.get(_known(op))
    if device.type != "cuda":
        if forced:
            raise RuntimeError(f"{op}: the kernel runs on CUDA tensors only, "
                               f"got a tensor on {device}")
        return False
    return True if forced is None else forced


@contextlib.contextmanager
def kernel_override(value: Optional[bool], op: str):
    """Force the kernel on (True) or off (False) for `op` inside the block,
    then restore what was set before."""
    _known(op)
    prev = _overrides.get(op)
    _overrides[op] = value
    try:
        yield
    finally:
        _overrides[op] = prev
