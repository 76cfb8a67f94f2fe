"""Consistency distillation and training: 1-2 step sampling (PyTorch port of
`fidm_tpu/distill/consistency.py`; Song, Dhariwal, Chen & Sutskever,
"Consistency Models", 2023; the pseudo-Huber metric from Song & Dhariwal,
"Improved Techniques for Training Consistency Models", 2023).

A single student whose output at ANY noise level is the trajectory endpoint
x0, so sampling is f(x_T, T), one model evaluation, with an optional
renoise-and-refine ladder. Discrete-time VP formulation: the consistency
function is the student's own x0 prediction under its mean type,
f_theta(x, t) = x0_pred(raw, x, t).

One step (Algorithm 2 of the paper): draw a grid segment t_n+1 > t_n per
sample, noise the data to x_{t_n+1}, take ONE deterministic teacher DDIM
step down to x_hat_{t_n}, and pull f_theta(x_{t_n+1}) toward
f_{theta^-}(x_hat_{t_n}), where theta^- is the EMA target network
(`TrainState.ema_params`), updated after the optimizer with `ema_decay`.
With `teacher_apply=None` the step is consistency TRAINING (Algorithm 3):
x_hat comes from the data with the same noise draw, no teacher at all.

The target network runs the student module at the EMA tensors through
`torch.func.functional_call`, every parameter swapped (biases, GroupNorm
scales and embeddings too), never at the live weights.

Under a mesh the step is `progressive.make_distill_step`'s: this rank's
rows, gradients and loss averaged over the ranks, a student of fsdp shards
gathered for its forward (and its EMA for the target network), the teacher
a module or a `parallel.collectives.ShardedModule`; over the "model" axis
a student of model slices (the target network too, on the EMA's slices) or
this rank's H block (`spatial=True`), the distance's per-sample sums
completed over the axis.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion import gaussian as gd
from ..diffusion.schedules import DiffusionSchedule
from ..training.ema import update_ema
from ..parallel.collectives import full_params, gathered, model_group
from ..training.train_state import _check_spatial, _global_means, _model_axis
from .progressive import (_alpha_sigma, _image_sums, _image_size, _on_device, _step_inputs,
                          _teacher, _update, _x0_from)

__all__ = [
    "consistency_grid",
    "consistency_x0",
    "make_consistency_step",
    "consistency_sample",
]


def consistency_grid(num_timesteps: int, steps: int) -> np.ndarray:
    """`steps`+1 descending timestep boundaries T-1 -> 0 (f is evaluated at
    the first `steps` of them; the last is the renoise target of none)."""
    return np.round(
        np.linspace(num_timesteps - 1, 0, steps + 1)
    ).astype(np.int32)


def consistency_x0(
    sched: DiffusionSchedule, raw, x, t,
    mean_type: gd.ModelMeanType = gd.ModelMeanType.VELOCITY,
    clip_denoised: bool = True,
):
    """The consistency function: the x0 the raw model output implies at t."""
    a, s = _alpha_sigma(sched, t, x.ndim)
    x0 = _x0_from(raw[..., :3], x, a, s, mean_type)
    if clip_denoised:
        x0 = torch.clamp(x0, -1.0, 1.0)
    return x0


class _Bound(nn.Module):
    """`apply_fn(model, *args)` as a module, so that `functional_call` runs
    it at other parameters of `model`."""

    def __init__(self, apply_fn: Callable, model: nn.Module):
        super().__init__()
        self.apply_fn = apply_fn
        self.model = model

    def forward(self, *args):
        return self.apply_fn(self.model, *args)


def _at_params(apply_fn: Callable, model: nn.Module, params: Dict[str, torch.Tensor], *args):
    """apply_fn(model, *args) with every parameter of `model` taken from
    `params` (a dict by parameter name that must name them all)."""
    missing = sorted(set(dict(model.named_parameters())) - set(params))
    if missing:
        raise KeyError(f"the target network lacks parameters {missing[:5]}")
    bound = _Bound(apply_fn, model)
    return torch.func.functional_call(
        bound, {f"model.{k}": v for k, v in params.items()}, args)


def make_consistency_step(
    sched: DiffusionSchedule,
    teacher_apply: Optional[Callable],
    student_apply: Callable,
    *,
    grid_size: int = 40,
    teacher_mean_type: gd.ModelMeanType = gd.ModelMeanType.EPSILON,
    student_mean_type: gd.ModelMeanType = gd.ModelMeanType.VELOCITY,
    ema_decay: float = 0.95,
    loss_metric: str = "huber",
    huber_c: Optional[float] = None,
    clip_denoised: bool = True,
    mesh=None,
    spatial: bool = False,
):
    """Build the consistency train step (distillation or training).

    teacher_apply / student_apply: (module, x, t[B], masked_image, mask) ->
    model output, e.g. `progressive.unet_apply`. The student state must
    carry `ema_params` (the target network theta^-, a copy of the initial
    student: `training.init_ema`); the step updates it in place.

    With `teacher_apply=None` this is consistency TRAINING: the pair
    (x_{t_n+1}, x_{t_n}) is built from the data sample with a SHARED noise
    draw, and `teacher` is ignored (pass None).

    Returns step(state, teacher, batch, draws) -> (state, metrics), as
    `progressive.make_distill_step`'s: the grid segment comes from
    `draws.timesteps(B, grid_size)`, the noise from `draws.noise(shape)`;
    metrics {loss, grad_norm (before the clip)} as device tensors. `mesh`
    and `spatial` as in `make_distill_step`.
    """
    _check_spatial(mesh, spatial)
    bounds_host = consistency_grid(sched.num_timesteps, grid_size)
    cache: Dict = {}

    def teacher_ddim_step(teacher, x, t, t_next, cond):
        nd = x.ndim
        a0, s0 = _alpha_sigma(sched, t, nd)
        a1, s1 = _alpha_sigma(sched, t_next, nd)
        raw = teacher_apply(teacher, x, t, *cond)[..., :3]
        x0 = _x0_from(raw, x, a0, s0, teacher_mean_type)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        eps = (x - a0 * x0) / torch.clamp(s0, min=1e-8)
        return a1 * x0 + s1 * eps

    def distance(pred, target, group):
        err2 = _image_sums((pred - target) ** 2, group)
        if loss_metric == "l2":
            return err2.mean()
        # pseudo-huber; the improved-techniques default c = 0.00054*sqrt(D)
        D = _image_size(pred, group)
        c = huber_c if huber_c is not None else 0.00054 * float(np.sqrt(D))
        return (torch.sqrt(err2 + c * c) - c).mean()

    def step(state, teacher, batch, draws):
        if state.ema_params is None:
            raise ValueError(
                "consistency distillation needs a target network: create the "
                "TrainState with ema_params=init_ema(<initial student params>)")
        device, batch, draws, cond = _step_inputs(state, batch, draws, mesh, spatial)
        group = model_group(mesh) if spatial else None
        boundaries = _on_device(bounds_host, cache, device)
        x_start = batch["image"]
        B = x_start.shape[0]

        n = draws.timesteps(B, grid_size)
        t0 = boundaries[n]        # noisier end of the segment
        t1 = boundaries[n + 1]    # one solver step down

        noise = draws.noise(x_start.shape)
        x_t = gd.q_sample(sched, x_start, t0, noise)

        state.model.train()
        with torch.no_grad():
            if teacher_apply is None:
                # consistency training: the lower-level point reuses the SAME
                # noise, no model evaluation
                x_hat = gd.q_sample(sched, x_start, t1, noise)
            else:
                with _teacher(teacher, mesh, spatial) as teacher_module:
                    x_hat = teacher_ddim_step(teacher_module, x_t, t0, t1, cond)
            # the EMA's fsdp shards whole, its model slices as they are: the
            # target network runs under the student's own model-axis context
            ema = full_params(state.ema_params, state.specs, mesh, model=False)
            with _model_axis(state, mesh, spatial):
                raw_tgt = _at_params(student_apply, state.model, ema, x_hat, t1, *cond)
            del ema
            target = consistency_x0(sched, raw_tgt, x_hat, t1, student_mean_type,
                                    clip_denoised)

        with gathered(state.model, state.params, state.specs, mesh), \
                _model_axis(state, mesh, spatial):
            raw = student_apply(state.model, x_t, t0, *cond)
            pred = consistency_x0(sched, raw, x_t, t0, student_mean_type, clip_denoised)
            loss = distance(pred, target, group)
            grad_norm = _update(state, loss, mesh, spatial)
        update_ema(state.ema_params, state.params, ema_decay)
        return state, {**_global_means({"loss": loss.detach()}, mesh), "grad_norm": grad_norm}

    return step


def consistency_sample(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    num_steps: int,
    shape,
    noise,
    *,
    mean_type: gd.ModelMeanType = gd.ModelMeanType.VELOCITY,
    clip_denoised: bool = True,
    gt=None,
    mask=None,
):
    """Multistep consistency sampling (paper Algorithm 1, VP-discrete).

    apply_fn(x, t[B]) -> raw model output (close over the model and its
    conditioning). num_steps=1 is a single f(x_T) evaluation; more steps
    alternate renoise-to-grid / f. With `gt` [B,H,W,3] and `mask` [B,H,W,1]
    (1 = hole) the known region is injected at every level and blended
    exactly at the end.

    `noise` is the draws' source in place of the JAX key, e.g. a
    `sampling.sampler.GeneratorNoise`: `init(shape)` the initial state, then
    at level i `inject(i, shape)` the known region's noise and `step(i,
    shape)` the renoise (not drawn at the last level, whose x0 is the
    output). The loop runs on the host with no device read-back; call it
    under `torch.no_grad()` unless its gradient is wanted.
    """
    grid = consistency_grid(sched.num_timesteps, num_steps)
    B = shape[0]
    x = noise.init(shape)
    keep = None if gt is None else 1.0 - mask

    def level(i):
        return torch.full((B,), int(grid[i]), dtype=torch.int32, device=x.device)

    for i in range(num_steps):
        t = level(i)
        if gt is not None:
            gt_noised = gd.q_sample(sched, gt, t, noise.inject(i, gt.shape))
            x = mask * x + keep * gt_noised
        raw = apply_fn(x, t)
        x0 = consistency_x0(sched, raw, x, t, mean_type, clip_denoised)
        if i == num_steps - 1:
            x = x0
        else:
            x = gd.q_sample(sched, x0, level(i + 1), noise.step(i, x0.shape))
    if gt is not None:
        x = mask * x + keep * gt  # exact final blend
    return x
