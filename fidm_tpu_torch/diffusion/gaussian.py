"""Gaussian-diffusion math (PyTorch port, NHWC).

Counterpart of `fidm_tpu/diffusion/gaussian.py` up to its likelihood terms:
the mean/variance parameterisations, q(x_t | x_0) and the posterior, the
x0/eps/v conversions, p(x_{t-1} | x_t) from a model output, classifier
guidance (`condition_mean`, `condition_score`) and the known-region
injection. Where the JAX module draws noise from a PRNG key, these functions
take the noise tensor itself. The variational-bound terms come with training.
The samplers do not call these functions, as in the JAX package: they step
through the respaced chain's per-step host tables (`sampling/sampler.py`),
whose coefficients are not the full schedule's.

Masks are [B, H, W, 1]; `gt_keep_mask` is 1 = keep (known), 0 = generate.
"""
from __future__ import annotations

import enum
import math
from typing import NamedTuple

import torch

from .schedules import DiffusionSchedule

__all__ = [
    "ModelMeanType",
    "ModelVarType",
    "LossType",
    "extract",
    "q_mean_variance",
    "q_sample",
    "q_posterior_mean_variance",
    "predict_xstart_from_eps",
    "predict_xstart_from_xprev",
    "predict_eps_from_xstart",
    "predict_xstart_from_v",
    "velocity_from_eps_xstart",
    "split_model_output",
    "model_variance",
    "p_mean_variance",
    "PMeanVariance",
    "condition_mean",
    "condition_score",
    "noised_ground_truth",
    "apply_inpainting_injection",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "mean_flat",
    "vb_terms_bpd",
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


class LossType(enum.Enum):
    """Training loss."""

    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep constants for int timesteps `t` [B], shaped
    [B, 1, ..., 1] to broadcast against an ndim-rank tensor."""
    vals = table[t.long()]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """q(x_t | x_0): mean, variance and log-variance."""
    nd = x_start.ndim
    mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample from q(x_t | x_0) with explicit noise."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0): mean, variance and clipped log-variance."""
    nd = x_t.ndim
    posterior_mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    posterior_variance = extract(sched.posterior_variance, t, nd)
    posterior_log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


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


def predict_eps_from_xstart(sched, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def predict_xstart_from_v(sched, x_t, t, v):
    """x0 = alpha*x_t - sigma*v (v-parameterization)."""
    nd = x_t.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def velocity_from_eps_xstart(sched, t, eps, x_start):
    """v = alpha*eps - sigma*x0, the v-prediction target."""
    nd = eps.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * eps
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
    )


def split_model_output(model_output, var_type: ModelVarType):
    """Split a 2C-channel NHWC output into (mean part, raw variance part)."""
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        c = model_output.shape[-1] // 2
        return model_output[..., :c], model_output[..., c:]
    return model_output, None


def model_variance(sched, var_values, x_shape_ndim, t, var_type: ModelVarType):
    """(variance, log_variance) of p(x_{t-1} | x_t) per var_type."""
    nd = x_shape_ndim
    if var_type == ModelVarType.LEARNED:
        return torch.exp(var_values), var_values
    if var_type == ModelVarType.LEARNED_RANGE:
        min_log = extract(sched.posterior_log_variance_clipped, t, nd)
        max_log = extract(sched.log_betas, t, nd)
        frac = (var_values + 1.0) / 2.0
        model_log_variance = frac * max_log + (1.0 - frac) * min_log
        return torch.exp(model_log_variance), model_log_variance
    if var_type == ModelVarType.FIXED_LARGE:
        return (extract(sched.fixed_large_variance, t, nd),
                extract(sched.fixed_large_log_variance, t, nd))
    if var_type == ModelVarType.FIXED_SMALL:
        return (extract(sched.posterior_variance, t, nd),
                extract(sched.posterior_log_variance_clipped, t, nd))
    raise NotImplementedError(var_type)


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(sched: DiffusionSchedule, model_output, x, t, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                    clip_denoised: bool = True) -> PMeanVariance:
    """p(x_{t-1} | x_t) statistics from a model output the caller computed."""
    mean_part, var_values = split_model_output(model_output, var_type)
    variance, log_variance = model_variance(sched, var_values, x.ndim, t, var_type)

    def process_xstart(x0):
        return torch.clamp(x0, -1.0, 1.0) if clip_denoised else x0

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, mean_part))
        mean = mean_part
    else:
        if mean_type == ModelMeanType.START_X:
            x0 = mean_part
        elif mean_type == ModelMeanType.EPSILON:
            x0 = predict_xstart_from_eps(sched, x, t, mean_part)
        elif mean_type == ModelMeanType.VELOCITY:
            x0 = predict_xstart_from_v(sched, x, t, mean_part)
        else:
            raise NotImplementedError(mean_type)
        pred_xstart = process_xstart(x0)
        mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


def condition_mean(pmv: PMeanVariance, gradient) -> PMeanVariance:
    """Shift the posterior mean by variance * grad log p(y | x_t)."""
    return pmv._replace(mean=pmv.mean + pmv.variance * gradient)


def condition_score(sched: DiffusionSchedule, pmv: PMeanVariance, x, t,
                    gradient) -> PMeanVariance:
    """Shift eps by -sqrt(1 - alpha_bar) * grad log p(y | x_t), then re-derive
    x0 and the posterior mean."""
    alpha_bar = extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, pmv.pred_xstart)
    eps = eps - torch.sqrt(1.0 - alpha_bar) * gradient
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return pmv._replace(mean=mean, pred_xstart=pred_xstart)


def noised_ground_truth(sched: DiffusionSchedule, gt, t, noise):
    """GT diffused to level t: `q_sample` with `noise` given explicitly (a
    tensor of gt's shape) or drawn from it (a `torch.Generator` on gt's
    device), where the JAX function draws from a key. The same generator
    state (or the same tensor) reproduces the reference's cached GT noise
    across steps (`gaussian_diffusion.py:85-108`)."""
    if isinstance(noise, torch.Generator):
        noise = torch.randn(gt.shape, generator=noise, device=gt.device, dtype=gt.dtype)
    return q_sample(sched, gt, t, noise)


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


# --------------------------------------------------------------------------
# likelihood terms of the variational bound
# --------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians, elementwise."""
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """Tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretised to the 8-bit bins of [-1, 1]
    (half-width 1/255), with open outer bins at the edges."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min,
                    torch.log(torch.clamp(cdf_delta, min=1e-12))),
    )


def mean_flat(tensor):
    """Mean over all non-batch dims."""
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


def vb_terms_bpd(sched: DiffusionSchedule, model_output, x_start, x_t, t, *,
                 mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                 clip_denoised: bool = True, mean_fn=mean_flat):
    """The variational-bound term in bits per dimension, per sample: the
    decoder NLL at t = 0, the KL to the true posterior elsewhere. Returns
    (term [B], pred_xstart). `mean_fn` takes the mean over the non-batch
    dims (over the whole image, for a block of its rows)."""
    true_mean, _, true_logvar = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_output, x_t, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    kl = mean_fn(normal_kl(true_mean, true_logvar, out.mean, out.log_variance))
    kl = kl / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_fn(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart
