"""Gaussian-diffusion math on the main path (PyTorch port, NHWC).

Counterpart of the main-path subset of `fidm_tpu/diffusion/gaussian.py`:
the mean/variance parameterisations, q(x_t | x_0), the x0 predictions and
the known-region injection. Where the JAX module draws noise from a PRNG
key, these functions take the noise tensor itself.

Masks are [B, H, W, 1]; `gt_keep_mask` is 1 = keep (known), 0 = generate.
"""
from __future__ import annotations

import enum

import torch

from .schedules import DiffusionSchedule

__all__ = [
    "ModelMeanType",
    "ModelVarType",
    "extract",
    "q_sample",
    "predict_xstart_from_eps",
    "predict_xstart_from_xprev",
    "predict_xstart_from_v",
    "split_model_output",
    "apply_inpainting_injection",
]


class ModelMeanType(enum.Enum):
    """What the model predicts; VELOCITY is v = alpha*eps - sigma*x0."""

    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()
    VELOCITY = enum.auto()

    @classmethod
    def from_name(cls, name: str) -> "ModelMeanType":
        return {"epsilon": cls.EPSILON, "xstart": cls.START_X,
                "velocity": cls.VELOCITY, "xprev": cls.PREVIOUS_X}[name]


class ModelVarType(enum.Enum):
    """How variance is parameterized."""

    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep constants for int timesteps `t` [B], shaped
    [B, 1, ..., 1] to broadcast against an ndim-rank tensor."""
    vals = table[t.long()]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample from q(x_t | x_0) with explicit noise."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_xstart_from_eps(sched, x_t, t, eps):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_xstart_from_xprev(sched, x_t, t, xprev):
    nd = x_t.ndim
    return (
        extract(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
        - extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd) * x_t
    )


def predict_xstart_from_v(sched, x_t, t, v):
    """x0 = alpha*x_t - sigma*v (v-parameterization)."""
    nd = x_t.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def split_model_output(model_output, var_type: ModelVarType):
    """Split a 2C-channel NHWC output into (mean part, raw variance part)."""
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        c = model_output.shape[-1] // 2
        return model_output[..., :c], model_output[..., c:]
    return model_output, None


def apply_inpainting_injection(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    gt: torch.Tensor,
    gt_keep_mask: torch.Tensor,
    noise: torch.Tensor,
    *,
    injection_schedule: str = "all",
) -> torch.Tensor:
    """Overwrite known regions of x with ground truth noised to level t.

    The "high"/"low" schedules gate per sample at T//2.
    """
    weighed_gt = q_sample(sched, gt, t, noise)
    injected = gt_keep_mask * weighed_gt + (1.0 - gt_keep_mask) * x
    if injection_schedule == "all":
        return injected
    half = sched.num_timesteps // 2
    if injection_schedule == "high":
        gate = (t >= half).reshape((-1,) + (1,) * (x.ndim - 1))
    elif injection_schedule == "low":
        gate = (t < half).reshape((-1,) + (1,) * (x.ndim - 1))
    else:
        raise ValueError(f"unknown injection_schedule: {injection_schedule}")
    return torch.where(gate, injected, x)
