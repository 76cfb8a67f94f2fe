"""Progressive distillation: a student learns two teacher DDIM steps in one
(PyTorch port of `fidm_tpu/distill/progressive.py`; Salimans & Ho,
"Progressive Distillation for Fast Sampling of Diffusion Models", 2022).

Repeating the procedure halves the sampler's step count each round. One
step: draw a coarse segment t0 -> t1 -> t2 of the teacher's grid per
sample, noise the data to x_t0, take two deterministic DDIM steps of the
frozen teacher under `torch.no_grad()`, build the x0 a ONE-step DDIM from
t0 must predict to land on the same point, and fit the student to it with
the truncated-SNR weight max(alpha^2 / sigma^2, 1); then one AdamW update.

Grid convention: `boundaries = round(linspace(T-1, 0, K+1))` gives K teacher
transitions; the student trains on the K/2 coarse transitions
boundaries[2j] -> boundaries[2j+2] via the teacher midpoint boundaries[2j+1].

The teacher and the student are separate modules. The JAX step passes one
parameter tree as both and relies on not donating it; here the optimizer
updates the student's parameters in place, so a shared module would move
the teacher with every step.

Under a mesh each rank takes its rows of the batch and of the global draws,
and the gradients and the loss are averaged over the ranks, as in
`training.make_train_step(mesh=)`; a student state of fsdp shards is
gathered for its forward, and the teacher may be a
`parallel.collectives.ShardedModule`, gathered for its two calls.

Over the mesh's "model" axis, as the train step: a student state of
`parallel.tp_shard_params` slices runs tensor-parallel, and `spatial=True`
takes this rank's block of H rows (its segment index that of its rows, its
noise that block of their draws), the loss's sums completed over the axis
and every gradient summed over it. The teacher is frozen and separate: a
`ShardedModule` whose specs hold model slices (`ShardedModule(teacher,
mesh, params=p, specs=s)` from `tp_shard_params(teacher, mesh)`) runs
tensor-parallel on them, any other teacher whole on every rank of a model
group (on this rank's H block under spatial=True).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch

from ..diffusion import gaussian as gd
from ..diffusion.schedules import DiffusionSchedule
from ..parallel.collectives import gathered, model_group, model_sharded_names, whole
from ..training.train_state import (_check_spatial, _check_specs, _global_means, _mesh_inputs,
                                    _model_axis, _reduce_and_apply)

__all__ = ["distill_boundaries", "make_distill_step", "unet_apply"]


def distill_boundaries(num_timesteps: int, teacher_steps: int) -> np.ndarray:
    """K+1 descending timestep boundaries for a K-step teacher."""
    assert teacher_steps % 2 == 0, "teacher_steps must be even to halve"
    return np.round(
        np.linspace(num_timesteps - 1, 0, teacher_steps + 1)
    ).astype(np.int32)


def unet_apply(model, x, t, masked_image, mask):
    """The apply function of the inpainting UNet: model(x, t, masked_image, mask)."""
    return model(x, t, masked_image, mask)


def _alpha_sigma(sched: DiffusionSchedule, t, nd):
    a = gd.extract(sched.sqrt_alphas_cumprod, t, nd)
    s = gd.extract(sched.sqrt_one_minus_alphas_cumprod, t, nd)
    return a, s


def _x0_from(raw, x, alpha, sigma, mean_type):
    if mean_type == gd.ModelMeanType.EPSILON:
        return (x - sigma * raw) / alpha
    if mean_type == gd.ModelMeanType.VELOCITY:
        return alpha * x - sigma * raw
    if mean_type == gd.ModelMeanType.START_X:
        return raw
    raise NotImplementedError(mean_type)


def _on_device(table: np.ndarray, cache: Dict, device) -> torch.Tensor:
    """`table` as an int64 tensor on `device`, uploaded once per device."""
    if device not in cache:
        cache[device] = torch.as_tensor(table.astype(np.int64), device=device)
    return cache[device]


def _step_inputs(state, batch, draws, mesh=None, spatial: bool = False):
    """The batch on the student's device, the step's draws (the update count
    folded in; this rank's rows under a mesh, and its H block of them under
    `spatial`) and the conditioning pair."""
    device, batch, draws = _mesh_inputs(state, batch, draws, mesh, spatial)
    return device, batch, draws.fold(state.step), (batch["masked_image"], batch["mask"])


def _image_sums(x: torch.Tensor, spatial) -> torch.Tensor:
    """Per-sample sums over H, W and C of an NHWC tensor, completed over the
    blocks of H rows under spatial partitioning (`spatial`: the model
    group, or None)."""
    sums = x.sum(dim=(1, 2, 3))
    return sums if spatial is None else spatial.sum(sums)


def _image_size(x: torch.Tensor, spatial) -> int:
    """H·W·C of the whole image whose (block of) rows `x` holds."""
    return x[0].numel() * (1 if spatial is None else spatial.size)


@contextlib.contextmanager
def _teacher(teacher, mesh, spatial: bool):
    """The frozen teacher's module for its calls (see the module doc):
    gathered whole over the fsdp axis, with its model-axis context."""
    from ..parallel.tp import attach

    specs = getattr(teacher, "specs", None)
    tp = mesh is not None and bool(model_sharded_names(specs))
    if tp and spatial:
        raise ValueError("a teacher of model-axis slices and spatial=True both use the "
                         "mesh's 'model' axis: pass a whole teacher")
    with whole(teacher) as module:
        if spatial:
            ctx = attach(module, mesh, "spatial")
        elif tp:
            ctx = attach(module, mesh, "tp", specs)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            yield module


def _update(state, loss, mesh=None, spatial: bool = False) -> torch.Tensor:
    """The gradients of `loss` for every trained tensor (the gathered
    module's for sharded ones; call it inside `gathered`), averaged over the
    ranks under a mesh, and one optimizer update; returns their global norm
    before the clip."""
    names = list(state.params)
    sharded = set(_check_specs(state, mesh))
    model_params = dict(state.model.named_parameters()) if sharded else {}
    leaves = [model_params[k] if k in sharded else state.params[k] for k in names]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return _reduce_and_apply(state, names, grads, mesh, spatial)


def make_distill_step(
    sched: DiffusionSchedule,
    teacher_apply: Callable,
    student_apply: Callable,
    *,
    teacher_steps: int,
    teacher_mean_type: gd.ModelMeanType = gd.ModelMeanType.EPSILON,
    student_mean_type: gd.ModelMeanType = gd.ModelMeanType.VELOCITY,
    clip_denoised: bool = True,
    mesh=None,
    spatial: bool = False,
):
    """Build the distillation train step.

    teacher_apply / student_apply: (module, x, t[B], masked_image, mask) ->
    model output (NHWC; channels beyond 3 are ignored), e.g. `unet_apply`.

    Returns step(state, teacher, batch, draws) -> (state, metrics), updating
    the student `state` (a `training.TrainState`) in place. `teacher` is the
    frozen teacher module, `batch` = {image, masked_image, mask} (arrays or
    tensors), `draws` an integer seed or a `training.TrainDraws`, into which
    the step folds its update count: the segment index comes from its
    `timesteps(B, K/2)`, the diffusion noise from its `noise(shape)`. The
    metrics {loss, grad_norm (before the clip)} are device tensors.

    `mesh`: every rank calls the step with its rows of the global batch
    (see the module doc); the metrics are then global, the same on every
    rank, and in one rank the step is the unmeshed step bit for bit.
    `spatial=True` (a replicated student state and a `parallel.shard_batch(
    ..., spatial=True)` batch): this rank's block of H rows of its rows.
    """
    _check_spatial(mesh, spatial)
    bounds_host = distill_boundaries(sched.num_timesteps, teacher_steps)
    n_student = teacher_steps // 2
    cache: Dict = {}

    def teacher_ddim_step(teacher, x, t, t_next, cond):
        nd = x.ndim
        a0, s0 = _alpha_sigma(sched, t, nd)
        a1, s1 = _alpha_sigma(sched, t_next, nd)
        raw = teacher_apply(teacher, x, t, *cond)[..., :3]
        x0 = _x0_from(raw, x, a0, s0, teacher_mean_type)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        eps = (x - a0 * x0) / s0
        return a1 * x0 + s1 * eps

    def step(state, teacher, batch, draws):
        device, batch, draws, cond = _step_inputs(state, batch, draws, mesh, spatial)
        group = model_group(mesh) if spatial else None
        boundaries = _on_device(bounds_host, cache, device)
        x_start = batch["image"]
        B = x_start.shape[0]

        # per-sample coarse segment j: t0 -> t1 -> t2
        j = draws.timesteps(B, n_student)
        t0 = boundaries[2 * j]
        t1 = boundaries[2 * j + 1]
        t2 = boundaries[2 * j + 2]

        noise = draws.noise(x_start.shape)
        x_t = gd.q_sample(sched, x_start, t0, noise)

        nd = x_t.ndim
        a0, s0 = _alpha_sigma(sched, t0, nd)
        with torch.no_grad(), _teacher(teacher, mesh, spatial) as teacher_module:
            # frozen teacher: two DDIM steps
            x_mid = teacher_ddim_step(teacher_module, x_t, t0, t1, cond)
            x_two = teacher_ddim_step(teacher_module, x_mid, t1, t2, cond)
            a2, s2 = _alpha_sigma(sched, t2, nd)
            # the x0 a ONE-step DDIM from t0 must predict to land on x_two
            ratio = s2 / torch.clamp(s0, min=1e-8)
            x0_target = (x_two - ratio * x_t) / torch.clamp(a2 - ratio * a0, min=1e-8)
            # truncated-SNR weighting: max(alpha^2/sigma^2, 1)
            w = torch.clamp((a0 / torch.clamp(s0, min=1e-8)) ** 2, min=1.0)

        state.model.train()
        with gathered(state.model, state.params, state.specs, mesh), \
                _model_axis(state, mesh, spatial):
            raw = student_apply(state.model, x_t, t0, *cond)[..., :3]
            x0_s = _x0_from(raw, x_t, a0, s0, student_mean_type)
            sq = w * (x0_s - x0_target) ** 2
            loss = (sq.mean() if group is None
                    else _image_sums(sq, group).mean() / _image_size(sq, group))
            grad_norm = _update(state, loss, mesh, spatial)
        return state, {**_global_means({"loss": loss.detach()}, mesh), "grad_norm": grad_norm}

    return step
