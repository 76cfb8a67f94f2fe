"""Classifier-free guidance (Ho & Salimans 2022) for class-conditional
models (PyTorch port of `fidm_tpu/sampling/cfg.py`).

The model is trained with a fraction of its labels dropped to a null token;
at sampling time the conditional and unconditional predictions are
extrapolated:

    eps_guided = eps_uncond + scale * (eps_cond - eps_uncond)

Wrap the label-aware apply function and hand the wrapper to
`inpaint_sample` / `sample`:

    apply = classifier_free(
        lambda x, t, mi, m, y: model(x, t, mi, m, y),
        y=labels, null_label=NUM_CLASSES, scale=3.0)
    out = inpaint_sample(apply, sched, cfg, gt=gt, mask=mask, noise=noise)

Convention: `num_classes = C + 1` embedding rows, index C the null token.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["classifier_free", "drop_labels"]


def classifier_free(apply_fn: Callable, *, y: torch.Tensor, null_label: int,
                    scale: float, guide_channels: int = 3):
    """Wrap a label-aware apply_fn(x, t, *rest, y) into the samplers'
    label-free signature. The conditional and unconditional forwards run as
    one model call on the doubled batch. Only the first `guide_channels`
    output channels (the eps prediction) are extrapolated; the learned
    variance channels come from the conditional half. scale=1 is the
    conditional model, scale=0 the unconditional one."""
    y = torch.as_tensor(y)

    def wrapped(x, t, *rest):
        B = x.shape[0]
        labels = y.to(x.device)
        y2 = torch.cat([labels, torch.full_like(labels, null_label)])
        out = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                       *(torch.cat([a, a]) for a in rest), y2)
        c, u = out[:B], out[B:]
        eps = u[..., :guide_channels] + scale * (
            c[..., :guide_channels] - u[..., :guide_channels])
        if out.shape[-1] > guide_channels:
            return torch.cat([eps, c[..., guide_channels:]], dim=-1)
        return eps

    return wrapped


def drop_labels(generator: torch.Generator, y: torch.Tensor, p: float,
                null_label: int) -> torch.Tensor:
    """Replace each label with the null token with probability p (training),
    from an explicit `torch.Generator` on y's device. The draws are torch's:
    they cannot match the JAX function's threefry bits for the same seed."""
    drop = torch.rand(y.shape, generator=generator, device=y.device) < p
    return torch.where(drop, torch.full_like(y, null_label), y)
