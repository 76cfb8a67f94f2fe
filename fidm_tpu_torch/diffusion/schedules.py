"""Beta schedules and derived diffusion constants (PyTorch port).

Counterpart of `fidm_tpu/diffusion/schedules.py`. The beta schedules and
timestep grids are the same float64 numpy code, so every host table is
bit-equal to the JAX package's. `DiffusionSchedule` keeps the float64 betas
on the host and float32 copies of every derived table on one torch device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "DiffusionSchedule",
    "ddim_timestep_sequence",
    "timestep_sequence",
]


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Return the named beta schedule as a float64 numpy array.

    - ``linear``: Ho et al. schedule scaled by 1000/T from 1e-4 to 2e-2.
    - ``cosine``: Nichol & Dhariwal alpha-bar cosine with s=0.008.
    - ``quadratic``: beta interpolated along t^2 between the linear endpoints.
    - ``sqrt_linear`` / ``sqrt``: sqrt of a linspace(1e-4, 2e-2).
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if schedule_name == "quadratic":
        scale = 1000 / num_diffusion_timesteps
        beta_start = scale * 0.0001
        beta_end = scale * 0.02
        progression = np.linspace(0, 1, num_diffusion_timesteps, dtype=np.float64) ** 2
        return beta_start + (beta_end - beta_start) * progression
    if schedule_name in ("sqrt_linear", "sqrt"):
        return np.sqrt(np.linspace(0.0001, 0.02, num_diffusion_timesteps, dtype=np.float64))
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas."""
    i = np.arange(num_diffusion_timesteps, dtype=np.float64)
    t1 = i / num_diffusion_timesteps
    t2 = (i + 1) / num_diffusion_timesteps
    ab = np.vectorize(alpha_bar)
    return np.minimum(1.0 - ab(t2) / ab(t1), max_beta)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep constants of the Gaussian diffusion.

    Derived quantities are computed in float64 on the host and stored as
    float32 tensors on `device`; `betas_host` keeps the float64 betas so the
    samplers can rebuild their coefficient tables at full precision.
    """

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    num_timesteps: int
    betas_host: np.ndarray
    name: str = ""

    @classmethod
    def create(cls, schedule_name: str, num_timesteps: int, device="cuda"):
        betas = get_named_beta_schedule(schedule_name, num_timesteps)
        return cls.from_betas(betas, name=schedule_name, device=device)

    @classmethod
    def from_betas(cls, betas: np.ndarray, name: str = "", device="cuda"):
        device = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar_clipped = np.log(np.append(post_var[1], post_var[1:]))
        fixed_large_var = np.append(post_var[1], betas[1:])

        def as_dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            betas=as_dev(betas),
            alphas_cumprod=as_dev(acp),
            alphas_cumprod_prev=as_dev(acp_prev),
            alphas_cumprod_next=as_dev(acp_next),
            sqrt_alphas_cumprod=as_dev(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=as_dev(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=as_dev(post_var),
            posterior_log_variance_clipped=as_dev(post_logvar_clipped),
            posterior_mean_coef1=as_dev(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=as_dev((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            log_betas=as_dev(np.log(betas)),
            fixed_large_variance=as_dev(fixed_large_var),
            fixed_large_log_variance=as_dev(np.log(fixed_large_var)),
            num_timesteps=betas.shape[0],
            betas_host=betas,
            name=name,
        )


def ddim_timestep_sequence(total_timesteps: int, ddim_timesteps: int) -> np.ndarray:
    """Evenly spaced DDIM timestep subset, descending (high noise -> low).

    Stride ``T // K`` from 0, append the final timestep ``T-1`` if not
    already included, then reverse: DDIM-100 on T=1000 is 101 steps
    (999, 990, ..., 10, 0).
    """
    c = total_timesteps // ddim_timesteps
    seq = np.asarray(list(range(0, total_timesteps, c)))
    if seq[-1] != total_timesteps - 1:
        seq = np.append(seq, total_timesteps - 1)
    return seq[::-1].copy()


def timestep_sequence(
    total_timesteps: int,
    num_steps: int,
    spacing: str = "uniform",
    alphas_cumprod: np.ndarray | None = None,
) -> np.ndarray:
    """Descending timestep subset under a named spacing strategy.

    - "uniform": `ddim_timestep_sequence`.
    - "trailing": steps anchored at T-1 with even stride T/K
      (arXiv:2305.08891).
    - "lambda": uniform in half-log-SNR between t=T-1 and t=0; requires
      `alphas_cumprod`.
    - "karras": the rho=7 sigma ramp of arXiv:2206.00364 on the VP noise
      scale, mapped to the nearest discrete timesteps; requires
      `alphas_cumprod`.
    """
    T, K = total_timesteps, num_steps
    if spacing == "uniform":
        return ddim_timestep_sequence(T, K)
    if spacing == "trailing":
        seq = np.round(np.arange(T, 0, -T / K)).astype(np.int64) - 1
        return np.unique(seq)[::-1].copy()
    if spacing in ("lambda", "karras"):
        if alphas_cumprod is None:
            raise ValueError(f"{spacing} spacing requires alphas_cumprod")
        if K > T:
            raise ValueError(f"num_steps {K} > total_timesteps {T}")
        acp = np.asarray(alphas_cumprod, np.float64)
        if spacing == "lambda":
            scale = 0.5 * (np.log(acp) - np.log1p(-acp))
            targets = np.linspace(scale[T - 1], scale[0], K)
        else:
            rho = 7.0
            sigma = np.sqrt((1.0 - acp) / acp)
            ramp = np.linspace(0.0, 1.0, K)
            s_max, s_min = sigma[T - 1], sigma[0]
            targets_sigma = (
                s_max ** (1 / rho) + ramp * (s_min ** (1 / rho) - s_max ** (1 / rho))
            ) ** rho
            scale = -sigma
            targets = -targets_sigma
        idx = np.abs(scale[None, :] - targets[:, None]).argmin(axis=1)
        # nearest-index picks can collide where the scale moves fast; force a
        # strictly descending grid of exactly K steps
        out = np.empty(K, dtype=np.int64)
        prev = T
        for j, i in enumerate(idx):
            i = min(int(i), prev - 1)   # strictly below the previous step
            i = max(i, K - 1 - j)       # leave room for the remaining steps
            out[j] = i
            prev = i
        return out
    raise ValueError(f"unknown spacing: {spacing}")
