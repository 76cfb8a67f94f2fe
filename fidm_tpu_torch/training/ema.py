"""Exponential moving average of parameters (PyTorch port of
`fidm_tpu/training/ema.py`): ema <- ema * decay + params * (1 - decay), in
place over the parameter dict."""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["init_ema", "update_ema"]


def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The EMA state: a copy of each parameter (never an alias: the
    optimizer updates the parameters in place)."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """ema <- ema * decay + params * (1 - decay), in place; returns ema_params."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([params[k].detach() for k in keys],
                                                1.0 - decay))
    return ema_params
