"""Training losses for mask-aware diffusion inpainting (PyTorch port of
`fidm_tpu/diffusion/losses.py`).

The masked, area-normalised MSE over the hole region, optional train-time
injection of correctly noised known pixels into x_t, timestep loss weights
(min-SNR, P2) and the Improved-DDPM hybrid MSE + VLB loss. The JAX function
draws its diffusion and injection noise from a key; this one takes both
tensors from the caller (`training.train_state.TrainDraws` draws them).
Layout NHWC; mask [B, H, W, 1] with 1 = inpaint (hole), 0 = keep.

Under spatial partitioning (`parallel/tp.py`) a rank holds a block of H
rows: `spatial`, its model group, sums a per-sample partial sum over the
blocks (`spatial.sum`), so the masked MSE's sums and hole area, and the VB
terms' means, are the whole image's before anything is divided.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import gaussian as gd
from .schedules import DiffusionSchedule

__all__ = ["training_losses", "masked_mse", "snr_loss_weight"]


def masked_mse(target, prediction, inpaint_mask, sample_weight=None, spatial=None):
    """Area-normalised MSE over the hole region: per sample and channel, the
    spatial sum of the squared error over the hole divided by the hole's
    area (clamped at 1), then the mean over batch and channels.
    `sample_weight` ([B], optional) scales each sample's contribution;
    `spatial` completes a block's sums (see the module doc)."""
    mask_c = inpaint_mask.expand(target.shape)
    mse = (target - prediction) ** 2 * mask_c
    area, err = mask_c.sum(dim=(1, 2), keepdim=True), mse.sum(dim=(1, 2), keepdim=True)
    if spatial is not None:
        area, err = spatial.sum(area), spatial.sum(err)
    mask_area = torch.clamp(area, min=1.0)
    per = err / mask_area
    if sample_weight is not None:
        per = per * sample_weight.reshape((-1,) + (1,) * (per.ndim - 1))
    return per.mean()


def snr_loss_weight(sched: DiffusionSchedule, t: torch.Tensor, mean_type: gd.ModelMeanType,
                    kind: str, gamma: Optional[float] = None, p2_k: float = 1.0) -> torch.Tensor:
    """Per-sample timestep loss weights ([B]) for the masked MSE.

    Both schemes are defined on the x0-space loss and converted to the
    model's parameterisation (eps-mse = SNR · x0-mse, v-mse = (SNR + 1) ·
    x0-mse), so a `kind` weights the same whatever the mean type:

    - "min_snr" (Hang et al. 2023): the x0-space weight min(SNR, gamma),
      gamma 5 by default;
    - "p2" (Choi et al. 2022): 1/(k + SNR)^gamma relative to the eps loss,
      gamma 1 by default.
    """
    if kind == "none":
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)
    if mean_type == gd.ModelMeanType.PREVIOUS_X:
        raise ValueError("snr loss weighting is undefined for xprev models")
    snr = gd.extract(sched.alphas_cumprod / (1.0 - sched.alphas_cumprod), t, 1)
    if kind == "min_snr":
        g = 5.0 if gamma is None else gamma
        w_x0 = torch.clamp(snr, max=g)
    elif kind == "p2":
        g = 1.0 if gamma is None else gamma
        w_x0 = snr / (p2_k + snr) ** g
    else:
        raise ValueError(f"unknown loss_weight kind: {kind!r}")
    if mean_type == gd.ModelMeanType.EPSILON:
        return w_x0 / snr
    if mean_type == gd.ModelMeanType.VELOCITY:
        return w_x0 / (snr + 1.0)
    return w_x0  # START_X


def training_losses(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    inject_noise: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    masked_image: Optional[torch.Tensor] = None,
    loss_type: gd.LossType = gd.LossType.MSE,
    var_type: gd.ModelVarType = gd.ModelVarType.LEARNED_RANGE,
    mean_type: gd.ModelMeanType = gd.ModelMeanType.EPSILON,
    use_injection: bool = True,
    injection_schedule: str = "all",
    vb_weight: float = 0.0,
    loss_weight: str = "none",
    loss_weight_gamma: Optional[float] = None,
    spatial=None,
):
    """The inpainting training loss.

    Args:
      model_fn: (x_t, t, masked_image, mask) -> model output (NHWC, 2C
        channels when the variance is learned).
      x_start: clean images [B, H, W, 3] in [-1, 1].
      t: int timesteps [B].
      noise: the diffusion noise, x_start's shape.
      inject_noise: the injection noise, x_start's shape; needed when the
        known region is injected (`use_injection` with a `masked_image`).
      mask: [B, H, W, 1], 1 = inpaint; all ones by default.
      masked_image: [B, H, W, 3] with the holes zeroed; enables injection.
      vb_weight: > 0 adds `vb_weight` times the VLB term, with the mean
        channels detached (the Improved-DDPM hybrid loss).
      loss_weight: "none" | "min_snr" | "p2", on the MSE term only.
      spatial: under spatial partitioning, the model group whose ranks
        hold the images' blocks of H rows (`parallel.collectives.ModelGroup`:
        `sum` completes a partial sum over the blocks, `size` counts them).

    Returns a dict with "loss", "mse" (and "vb" when it is computed).
    """
    if mask is None:
        mask = torch.ones(x_start.shape[:-1] + (1,), dtype=x_start.dtype,
                          device=x_start.device)

    x_t = gd.q_sample(sched, x_start, t, noise)

    # train-time injection of the known region: the keep region of x_t
    # becomes an independently noised copy of the ground truth
    if use_injection and masked_image is not None:
        if inject_noise is None:
            raise ValueError("injection needs inject_noise")
        x_t = gd.apply_inpainting_injection(
            sched, x_t, t, x_start, 1.0 - mask, inject_noise,
            injection_schedule=injection_schedule)

    vb_kw = {}
    if spatial is not None:
        def block_mean(x):
            return spatial.sum(x.sum(dim=tuple(range(1, x.ndim)))) / (x[0].numel() * spatial.size)

        vb_kw["mean_fn"] = block_mean

    terms = {}
    if loss_type in (gd.LossType.MSE, gd.LossType.RESCALED_MSE):
        model_output = model_fn(x_t, t, masked_image, mask)
        mean_part, var_values = gd.split_model_output(model_output, var_type)

        if mean_type == gd.ModelMeanType.VELOCITY:
            target = gd.velocity_from_eps_xstart(sched, t, noise, x_start)
        elif mean_type == gd.ModelMeanType.PREVIOUS_X:
            # the true posterior mean
            target = gd.q_posterior_mean_variance(sched, x_start, x_t, t)[0]
        else:
            target = {gd.ModelMeanType.EPSILON: noise,
                      gd.ModelMeanType.START_X: x_start}[mean_type]
        weight = (snr_loss_weight(sched, t, mean_type, loss_weight, loss_weight_gamma)
                  if loss_weight != "none" else None)
        terms["mse"] = masked_mse(target, mean_part, mask, sample_weight=weight,
                                  spatial=spatial)
        if loss_type == gd.LossType.RESCALED_MSE:
            terms["mse"] = terms["mse"] * sched.num_timesteps
        terms["loss"] = terms["mse"]

        if vb_weight > 0.0 and var_values is not None:
            # hybrid loss: the variance learns through the VLB, the mean does not
            frozen = torch.cat([mean_part.detach(), var_values], dim=-1)
            vb, _ = gd.vb_terms_bpd(sched, frozen, x_start, x_t, t, mean_type=mean_type,
                                    var_type=var_type, clip_denoised=False, **vb_kw)
            terms["vb"] = vb.mean()
            terms["loss"] = terms["loss"] + vb_weight * terms["vb"]
    elif loss_type.is_vb():
        model_output = model_fn(x_t, t, masked_image, mask)
        vb, _ = gd.vb_terms_bpd(sched, model_output, x_start, x_t, t, mean_type=mean_type,
                                var_type=var_type, clip_denoised=False, **vb_kw)
        terms["vb"] = vb.mean()
        if loss_type == gd.LossType.RESCALED_KL:
            terms["vb"] = terms["vb"] * sched.num_timesteps
        terms["loss"] = terms["vb"]
    else:
        raise NotImplementedError(loss_type)
    return terms
