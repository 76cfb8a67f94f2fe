"""Dynamic loss scaling (PyTorch port of `fidm_tpu/training/precision.py`).

The port trains with bfloat16 activations and float32 parameters, which
needs no loss scale; this is the grow-after-N-finite-steps /
halve-on-overflow policy for float16 experiments, as functions of a small
state whose scale and counter are device tensors (no host sync).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..device import resolve_device

__all__ = ["LossScaleState", "init_loss_scale", "scale_loss", "unscale_grads"]


class LossScaleState(NamedTuple):
    scale: torch.Tensor          # current multiplier
    growth_counter: torch.Tensor  # consecutive finite steps
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5


def init_loss_scale(initial: float = 2.0**15, growth_interval: int = 2000,
                    device="cuda") -> LossScaleState:
    """The state on `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    return LossScaleState(
        scale=torch.tensor(initial, dtype=torch.float32, device=device),
        growth_counter=torch.tensor(0, dtype=torch.int32, device=device),
        growth_interval=growth_interval,
    )


def scale_loss(state: LossScaleState, loss):
    return loss * state.scale


def unscale_grads(state: LossScaleState, grads: Dict[str, torch.Tensor]
                  ) -> Tuple[LossScaleState, Dict[str, torch.Tensor], torch.Tensor]:
    """Unscale the gradients, detect overflow and update the scale. Returns
    (new_state, unscaled_grads, grads_finite); skip the optimizer update
    when grads_finite is False."""
    inv = 1.0 / state.scale
    grads = {k: g * inv for k, g in grads.items()}
    finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    counter = torch.where(finite, state.growth_counter + 1, torch.zeros_like(state.growth_counter))
    grow = counter >= state.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, state.scale * state.growth_factor, state.scale),
        state.scale * state.backoff_factor,
    )
    new_state = state._replace(scale=new_scale,
                               growth_counter=torch.where(grow, torch.zeros_like(counter),
                                                          counter))
    return new_state, grads, finite
