"""Learning-rate schedules (PyTorch port of `fidm_tpu/training/lr.py`).

Plain functions of the update count, with optax's formulas copied:
`cosine` is optax's `cosine_decay_schedule`, or with warmup its
`warmup_cosine_decay_schedule` (a linear ramp from 0, then the cosine from
the peak to `base_lr * min_lr_ratio`); `step` is its
`piecewise_constant_schedule` (halved at T/3 and 2T/3); `none` is constant.
As in optax, the optimizer evaluates the schedule at the count of updates
made before the current one, so the first update uses lr(0), which is 0
under warmup. Values are float64 on the host.
"""
from __future__ import annotations

import math
from typing import Callable

__all__ = ["make_lr_schedule"]


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine_decay + alpha)

    return schedule


def _linear(init_value: float, end_value: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init_value - end_value) * frac + end_value

    return schedule


def make_lr_schedule(kind: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
                     min_lr_ratio: float = 0.01) -> Callable[[int], float]:
    """lr(count) for 'cosine' | 'step' | 'none'."""
    # short runs can ask for more warmup than total steps; the cosine after
    # the warmup needs at least one step
    warmup_steps = min(warmup_steps, max(total_steps - 1, 0))
    if kind == "cosine":
        if warmup_steps > 0:
            alpha = 0.0 if base_lr == 0.0 else base_lr * min_lr_ratio / base_lr
            warmup = _linear(0.0, base_lr, warmup_steps)
            decay = _cosine(base_lr, total_steps - warmup_steps, alpha)
            return lambda count: (warmup(count) if count < warmup_steps
                                  else decay(count - warmup_steps))
        return _cosine(base_lr, total_steps, min_lr_ratio)
    if kind == "step":
        step_size = max(total_steps // 3, 1)
        boundaries = (step_size, 2 * step_size)

        def schedule(count):
            v = base_lr
            for threshold in boundaries:
                if count >= threshold:
                    v = 0.5 * v
            return v

        return schedule
    if kind == "none":
        return lambda count: base_lr
    raise ValueError(f"unknown scheduler: {kind}")
