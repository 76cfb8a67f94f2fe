"""High-level pipeline: model + schedule + sampler presets (PyTorch port).

Counterpart of `fidm_tpu/pipeline.py`: the canonical FFHQ-256 inpainting UNet
on the 1000-step quadratic schedule, sampled with the `ddim-100` preset
(eta 0.9, post-step known-region injection, final blend) by default. The
server (`serving/`, `cli/serve.py`) serves `dpm-25-sde` by default. Presets
with feature caching (`ddim-100-deep` and the other `encoder_cache_period` >
1 presets) get the model's (full, cached) call pair from `inpaint`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from .device import resolve_device
from .diffusion import DiffusionSchedule, ModelMeanType
from .models import InpaintingUNet, UNetConfig, ffhq256_config
from .models.weights import load_adm_checkpoint
from .sampling import GeneratorNoise, SamplerConfig, inpaint_sample

__all__ = [
    "PipelineConfig",
    "InpaintingPipeline",
    "SAMPLER_PRESETS",
    "create_model_and_schedule",
]

# The JAX package's presets under the same names. The ported ones are
# method "ddim", "dpm++2m" and "dpm++2m-sde", with or without feature caching
# (any strength); the others raise NotImplementedError when used.
SAMPLER_PRESETS = {
    "ddpm-1000": SamplerConfig(method="ddpm", num_steps=None, injection=True),
    "ddpm-250": SamplerConfig(method="ddpm", num_steps=250, injection=True),
    "ddpm-100": SamplerConfig(method="ddpm", num_steps=100, injection=True),
    "ddim-30": SamplerConfig(method="ddim", num_steps=30, eta=0.9, injection=True),
    "ddim-50-eta0.75": SamplerConfig(method="ddim", num_steps=50, eta=0.75,
                                     injection=True),
    "ddim-50": SamplerConfig(method="ddim", num_steps=50, eta=0.9, injection=True),
    # the flagship: DDIM-100 (101 steps, 999 ... 10, 0), eta 0.9
    "ddim-100": SamplerConfig(method="ddim", num_steps=100, eta=0.9,
                              injection=True),
    "ddim-100-deep": SamplerConfig(method="ddim", num_steps=100, eta=0.9,
                                   injection=True, encoder_cache_period=3,
                                   cache_branch=2, encoder_cache_tail=10),
    "ddim-100-turbo": SamplerConfig(method="ddim", num_steps=100, eta=0.9,
                                    injection=True, encoder_cache_period=3,
                                    cache_branch=1),
    "ddim-100-det": SamplerConfig(method="ddim", num_steps=100, eta=0.0,
                                  injection=True),
    "ddim-20-fast": SamplerConfig(method="ddim", num_steps=20, eta=0.9,
                                  injection=True, encoder_cache_period=2,
                                  cache_branch=1, encoder_cache_tail=4),
    # DPM-Solver++(2M), ported
    "dpm-25": SamplerConfig(method="dpm++2m", num_steps=25, injection=True),
    "dpm-20": SamplerConfig(method="dpm++2m", num_steps=20, injection=True),
    # its SDE variant, ported: the server's default (26 model evaluations)
    "dpm-25-sde": SamplerConfig(method="dpm++2m-sde", num_steps=25,
                                injection=True),
    "dpm-20-fast": SamplerConfig(method="dpm++2m", num_steps=20,
                                 injection=True, encoder_cache_period=2,
                                 cache_branch=1, encoder_cache_tail=4),
    "dpm3-20": SamplerConfig(method="dpm++3m", num_steps=20, injection=True),
    "dpm3-12": SamplerConfig(method="dpm++3m", num_steps=12, injection=True),
    "unipc-20": SamplerConfig(method="unipc", num_steps=20, injection=True),
    "unipc-10": SamplerConfig(method="unipc", num_steps=10, injection=True),
    "consistency-2": SamplerConfig(method="consistency", num_steps=2,
                                   injection=True,
                                   mean_type=ModelMeanType.VELOCITY),
    "consistency-1": SamplerConfig(method="consistency", num_steps=1,
                                   injection=True,
                                   mean_type=ModelMeanType.VELOCITY),
    "repaint-250": SamplerConfig(method="repaint", num_steps=250,
                                 jump_length=10, jump_n_sample=10,
                                 injection=True),
    "repaint-100-light": SamplerConfig(method="repaint", num_steps=100,
                                       jump_length=5, jump_n_sample=3,
                                       injection=True),
}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = dataclasses.field(default_factory=ffhq256_config)
    schedule: str = "quadratic"
    num_timesteps: int = 1000
    sampler: SamplerConfig = dataclasses.field(
        default_factory=lambda: SAMPLER_PRESETS["ddim-100"]
    )
    # feed the model float timesteps scaled to [0, 1000) regardless of T
    rescale_timesteps: bool = False


def create_model_and_schedule(
    config: Optional[PipelineConfig] = None,
    *,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device="cuda",
):
    """Build (model, schedule) on `device`: the model from an ADM `.pt`
    checkpoint, else randomly initialised from `seed` (ADM's init, with the
    output convs of every block zero-initialised)."""
    config = config or PipelineConfig()
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = InpaintingUNet(config.unet)
    if checkpoint is not None:
        model.load_state_dict(load_adm_checkpoint(checkpoint, config.unet), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    sched = DiffusionSchedule.create(config.schedule, config.num_timesteps, device=device)
    return model, sched


class InpaintingPipeline:
    """Model, schedule and sampler config bound into one inpainting call."""

    def __init__(self, model: InpaintingUNet, sched: DiffusionSchedule,
                 config: PipelineConfig):
        self.model = model
        self.sched = sched
        self.config = config
        self.device = next(model.parameters()).device

    @classmethod
    def create(cls, config: Optional[PipelineConfig] = None,
               checkpoint: Optional[str] = None, seed: int = 0, device="cuda"):
        config = config or PipelineConfig()
        model, sched = create_model_and_schedule(
            config, checkpoint=checkpoint, seed=seed, device=device)
        return cls(model, sched, config)

    def _apply(self, x, t, masked_image, mask, **cache_kw):
        if self.config.rescale_timesteps:
            t = t.float() * (1000.0 / self.config.num_timesteps)
        return self.model(x, t, masked_image, mask, **cache_kw)

    def _cache_apply(self, cfg: SamplerConfig):
        """The sampler's (full_fn, cached_fn) pair for `cfg`, or None when it
        runs no feature cache (period <= 1, or output reuse, which carries
        the previous output and needs no cache-capable model). Branch 0 is
        encoder mode."""
        if cfg.encoder_cache_period <= 1 or cfg.cache_branch == -1:
            return None
        depth = cfg.cache_branch or None

        def full_fn(x, t, masked_image, mask):
            return self._apply(x, t, masked_image, mask, return_cache=True, cache_depth=depth)

        def cached_fn(x, t, masked_image, mask, cache):
            return self._apply(x, t, masked_image, mask, cache=cache, cache_depth=depth)

        return full_fn, cached_fn

    def _validate_cache_cfg(self, cfg: SamplerConfig):
        """A cache option that would be silently ignored (period <= 1) or a
        branch out of range raises here, before any step runs."""
        if cfg.cache_keysteps is not None and cfg.encoder_cache_period <= 1:
            raise ValueError(
                f"cache_keysteps={cfg.cache_keysteps} has no effect with "
                f"encoder_cache_period={cfg.encoder_cache_period}; set "
                "encoder_cache_period > 1 (it enables caching; the explicit "
                "grid then replaces the periodic gate)")
        if cfg.cache_branch:
            if cfg.encoder_cache_period <= 1:
                raise ValueError(
                    f"cache_branch={cfg.cache_branch} has no effect with "
                    f"encoder_cache_period={cfg.encoder_cache_period}; set "
                    "encoder_cache_period > 1 (or drop cache_branch)")
            n_levels = len(self.config.unet.channel_mult)
            if cfg.cache_branch != -1 and not 1 <= cfg.cache_branch < n_levels:
                raise ValueError(
                    f"cache_branch must be -1 (output reuse) or in "
                    f"[1, {n_levels - 1}] for "
                    f"channel_mult={self.config.unet.channel_mult}; got "
                    f"{cfg.cache_branch}")

    def inpaint(self, gt, mask, seed: Union[int, Sequence[int]],
                sampler: Optional[SamplerConfig] = None, *,
                strength: Optional[float] = None, noise=None):
        """Inpaint a batch: gt [B,H,W,3] in [-1,1], mask [B,H,W,1] (1 = hole),
        as numpy arrays or tensors. Returns a [B,H,W,3] tensor on the
        pipeline's device (float32, or uint8 per the sampler's output_dtype).

        The noise comes from `GeneratorNoise(seed)`: `seed` is one int for the
        whole batch, or B ints, one per row (row i then equals the batch-1 run
        with seed i). `noise` replaces it with any source of the same three
        draws (see `inpaint_sample`).

        `strength` < 1 overrides the preset's and switches to refinement
        (SDEdit): only the last round(strength * K) steps run, starting from
        `gt` noised to that level, so gt's hole must carry the content to
        harmonize."""
        cfg = sampler or self.config.sampler
        if strength is not None:
            cfg = dataclasses.replace(cfg, strength=strength)
        self._validate_cache_cfg(cfg)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if gt.ndim != 4 or gt.shape[-1] != 3:
            raise ValueError(f"gt must be [B,H,W,3], got {tuple(gt.shape)}")
        if mask.shape[-1] != 1 or mask.shape[:-1] != gt.shape[:-1]:
            raise ValueError(
                f"mask must be [B,H,W,1] matching gt spatial dims; got "
                f"mask {tuple(mask.shape)} vs gt {tuple(gt.shape)}")
        if noise is None:
            noise = GeneratorNoise(seed, self.device)
        with torch.inference_mode():
            return inpaint_sample(self._apply, self.sched, cfg, gt=gt, mask=mask,
                                  noise=noise, cache_apply=self._cache_apply(cfg))
