"""High-level pipeline: model + schedule + sampler presets (PyTorch port).

Counterpart of `fidm_tpu/pipeline.py`: the canonical FFHQ-256 inpainting UNet
on the 1000-step quadratic schedule, sampled with the `ddim-100` preset
(eta 0.9, post-step known-region injection, final blend) by default; every
preset of `SAMPLER_PRESETS` runs. The server (`serving/`, `cli/serve.py`)
serves `dpm-25-sde` by default. Presets with feature caching (`ddim-100-deep`
and the other `encoder_cache_period` > 1 presets) get the model's (full,
cached) call pair from `inpaint`.

Warm programs: `compile_batch` builds a `SamplingProgram` for one (batch,
SamplerConfig, seed layout), a CUDA graph of one whole `inpaint_sample` call on
a CUDA pipeline (`sampling/program.py`); `install_program` registers it, and
`inpaint` without `cond_fn` prefers an installed program whose (shape, config,
seed layout) matches exactly, as the JAX pipeline prefers its AOT executables.
Everything else runs eagerly. `serving/aot.py` keeps a directory of them.

Under a mesh (`parallel.create_mesh`, one process per rank; every rank makes
the same call) `inpaint` takes the same whole batch on every rank, runs the
model on this rank's rows only, with their noise cut from the whole batch's
draws, and all-gathers the result, so every rank returns the one-process
call's output. `fsdp_params` keeps the model's large tensors as this rank's
shards between calls (ZeRO-3), gathered for each call. `compile_batch` builds
the meshed call's program, whose noise buffers hold this rank's cut of the
whole batch's draws (on CUDA an NCCL group's collectives captured in its
graph); the program cache (`serving/aot.py`) refuses a mesh, as the JAX
package's does.

Over the mesh's "model" axis (`parallel/tp.py`): `tp_params` keeps this
rank's Megatron slices of the model (with `fsdp_params`, fsdp shards of the
rest) and the ranks of a model group run their slices of the same rows with
those rows' noise; `shard_spatial` keeps the model whole and gives each rank
of a model group its block of H rows of those rows, with that block of
their noise (a `cond_fn` is still called on their whole images). Either way every rank returns the whole batch, and the known
pixels are exactly `gt`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch

from .device import resolve_device
from .diffusion import DiffusionSchedule, ModelMeanType
from .models import InpaintingUNet, UNetConfig, ffhq256_config
from .models.weights import load_adm_checkpoint
from .sampling import GeneratorNoise, SamplerConfig, inpaint_sample
from .sampling.program import SamplingProgram
from .sampling.sampler import _method_tables

__all__ = [
    "PipelineConfig",
    "InpaintingPipeline",
    "SAMPLER_PRESETS",
    "create_model_and_schedule",
]

# The JAX package's presets under the same names.
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
    # DPM-Solver++(2M)
    "dpm-25": SamplerConfig(method="dpm++2m", num_steps=25, injection=True),
    "dpm-20": SamplerConfig(method="dpm++2m", num_steps=20, injection=True),
    # its SDE variant: the server's default (26 model evaluations)
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


def _whole_image_guidance(cond_fn, axis, block):
    """`cond_fn` for a rank that holds `block` of H rows under spatial
    partitioning: it is called, as the JAX package's is, with the whole
    image of the rank's rows (every rank's block gathered over `axis`, a
    leaf that requires grad) at `t`, and this rank's block of its gradient
    is kept. Every rank of the group computes the same gradient, so no
    result depends on which rank's copy a block comes from."""
    from .parallel.collectives import gather_h

    def guided(x, t):
        whole = gather_h(x.detach(), axis, dim=1).requires_grad_(True)
        return block.of(cond_fn(whole, t))

    return guided


class InpaintingPipeline:
    """Model, schedule and sampler config bound into one inpainting call;
    with `mesh`, sharded over the ranks (see the module doc)."""

    def __init__(self, model: InpaintingUNet, sched: DiffusionSchedule,
                 config: PipelineConfig, mesh=None, fsdp_params: bool = False,
                 fsdp_min_size: int = 2**18, tp_params: bool = False,
                 shard_spatial: bool = False):
        self.model = model
        self.sched = sched
        self.config = config
        self.mesh = mesh
        self.device = next(model.parameters()).device
        if tp_params and shard_spatial:
            raise ValueError(
                "tp_params and shard_spatial both use the mesh's 'model' "
                "axis — pick one latency-scaling layout")
        if tp_params or shard_spatial:
            from .parallel.mesh import axis_size

            if mesh is None or axis_size(mesh, "model") <= 1:
                raise ValueError(
                    "tp_params/shard_spatial need a mesh with a 'model' axis "
                    "(parallel.create_mesh(model=k))")
        self.shard_spatial = shard_spatial
        self._sharded = None
        # the model's placements over the model axis (tp_params), else None
        self._tp_specs = None
        if mesh is not None and tp_params:
            from .parallel.collectives import ShardedModule, sharded_names
            from .parallel.tp import tp_shard_params

            params, self._tp_specs = tp_shard_params(
                model, mesh, fsdp_min_size=fsdp_min_size if fsdp_params else None)
            if sharded_names(self._tp_specs):
                self._sharded = ShardedModule(model, mesh, params=params, specs=self._tp_specs)
        elif mesh is not None and fsdp_params:
            from .parallel.collectives import ShardedModule

            self._sharded = ShardedModule(model, mesh, fsdp_min_size)
        # installed programs by ((B, S, S, 3), SamplerConfig, per-row seeds)
        self._programs: Dict[tuple, SamplingProgram] = {}

    @classmethod
    def create(cls, config: Optional[PipelineConfig] = None,
               checkpoint: Optional[str] = None, seed: int = 0, device="cuda", mesh=None,
               fsdp_params: bool = False, fsdp_min_size: int = 2**18,
               tp_params: bool = False, shard_spatial: bool = False):
        config = config or PipelineConfig()
        model, sched = create_model_and_schedule(
            config, checkpoint=checkpoint, seed=seed, device=device)
        return cls(model, sched, config, mesh=mesh, fsdp_params=fsdp_params,
                   fsdp_min_size=fsdp_min_size, tp_params=tp_params,
                   shard_spatial=shard_spatial)

    def cast_params(self, dtype=torch.bfloat16):
        """Cast the model's floating parameters and buffers to `dtype` for
        inference (half the weight bytes in bf16). GroupNorm statistics, the
        softmax and the final conv keep their float32 arithmetic: each layer
        upcasts what it computes in float32 (`models/layers.py`). Drops every
        installed program, whose graph holds the old parameters' addresses
        and dtypes. Returns self."""
        self.model.to(dtype)
        if self._sharded is not None:
            self._sharded.params = {k: v.to(dtype) if v.is_floating_point() else v
                                    for k, v in self._sharded.params.items()}
        self._programs.clear()
        return self

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
                sampler: Optional[SamplerConfig] = None, *, cond_fn=None,
                strength: Optional[float] = None, noise=None):
        """Inpaint a batch: gt [B,H,W,3] in [-1,1], mask [B,H,W,1] (1 = hole),
        as numpy arrays or tensors. Returns a [B,H,W,3] tensor on the
        pipeline's device (float32, or uint8 per the sampler's output_dtype).

        The noise comes from `GeneratorNoise(seed)`: `seed` is one int for the
        whole batch, or B ints, one per row (row i then equals the batch-1 run
        with seed i). `noise` replaces it with any source of the same three
        draws (see `inpaint_sample`).

        `cond_fn(x, t) -> grad log p(y | x_t)` enables classifier guidance
        (ddim, ddpm and repaint presets). It is called with autograd on, on a
        copy of x that requires grad, so it may take `torch.autograd.grad` of
        a classifier; the call then runs under `torch.no_grad()`, where
        otherwise it runs under `torch.inference_mode()`.

        Without `cond_fn`, a program installed for this (shape, sampler, seed
        layout) runs the call (see `compile_batch`); a `noise` that is a
        `GeneratorNoise` counts as its seed. Its output is the eager call's bit
        for bit.

        `strength` < 1 overrides the preset's and switches to refinement
        (SDEdit): only the last round(strength * K) steps run, starting from
        `gt` noised to that level, so gt's hole must carry the content to
        harmonize.

        With the sampler's `trajectory_every` > 0 the call returns
        `(images, trajectory)` (see `inpaint_sample`)."""
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
        if cond_fn is None and type(noise) is GeneratorNoise:
            program = self._programs.get((tuple(gt.shape), cfg, noise.seeds is not None))
            if program is not None:
                return program(gt, mask, noise.seed if noise.seeds is None else noise.seeds)
        if self.mesh is not None:
            return self._inpaint_meshed(gt, mask, self._rank_noise(noise, gt.shape), cfg,
                                        cond_fn)
        # a cond_fn may take a gradient, which inference tensors cannot give
        with torch.no_grad() if cond_fn is not None else torch.inference_mode():
            return inpaint_sample(self._apply, self.sched, cfg, gt=gt, mask=mask,
                                  noise=noise, cache_apply=self._cache_apply(cfg),
                                  cond_fn=cond_fn)

    def _rank_part(self, shape):
        """(rows, block) of a meshed call on a whole batch of `shape`
        [B, H, W, C]: this rank's Rows, and under shard_spatial its HBlock of
        H rows (else None)."""
        from .parallel.collectives import HBlock, Rows
        from .parallel.mesh import axis_size, batch_index, model_rank, row_ranks

        B, H, W = shape[0], shape[1], row_ranks(self.mesh)
        if B % W:
            raise ValueError(f"batch {B} does not divide over the {W} ranks of the mesh")
        b, i = B // W, batch_index(self.mesh)
        rows, block = Rows(i * b, (i + 1) * b, B), None
        if self.shard_spatial:
            from .parallel.tp import check_spatial

            k, m = axis_size(self.mesh, "model"), model_rank(self.mesh)
            check_spatial(H, k, len(self.config.unet.channel_mult))
            block = HBlock(m * H // k, (m + 1) * H // k, H)
        return rows, block

    def _rank_noise(self, noise, shape):
        """This rank's cut of the whole batch's draws of `noise`: its rows
        (`RowNoise`) and under shard_spatial its block of H rows of them
        (`SpatialNoise`)."""
        from .parallel.collectives import RowNoise, SpatialNoise

        rows, block = self._rank_part(shape)
        noise = RowNoise(noise, rows)
        return noise if block is None else SpatialNoise(noise, block)

    def _inpaint_meshed(self, gt, mask, noise, cfg, cond_fn, device_tables=None):
        """This rank's rows of the whole batch (under shard_spatial its block
        of their H rows, a `cond_fn` still seeing their whole images), with
        `noise` this rank's cut of the whole batch's draws (`_rank_noise`),
        then every rank's part gathered: the whole batch on every rank."""
        from .parallel.collectives import gather_h, gather_rows, model_group, whole

        rows, block = self._rank_part(gt.shape)
        gt, mask = rows.of(gt), rows.of(mask)
        if block is not None:
            ax = model_group(self.mesh)
            gt, mask = block.of(gt), block.of(mask)
            if cond_fn is not None:
                cond_fn = _whole_image_guidance(cond_fn, ax, block)
        with torch.no_grad() if cond_fn is not None else torch.inference_mode(), \
                whole(self._sharded if self._sharded is not None else self.model) as model:
            with self._model_axis(model):
                out = inpaint_sample(self._apply, self.sched, cfg, gt=gt, mask=mask,
                                     noise=noise, cache_apply=self._cache_apply(cfg),
                                     cond_fn=cond_fn, device_tables=device_tables)
            images, frames = out if isinstance(out, tuple) else (out, None)
            if block is not None:  # the blocks of H rows: axis 1, or 2 of the frames
                images = gather_h(images, ax, dim=1)
                frames = None if frames is None else gather_h(frames, ax, dim=2)
            images = gather_rows(images, self.mesh)
            if frames is None:
                return images
            # (images, frames): the frames' batch is axis 1
            return images, gather_rows(frames.transpose(0, 1), self.mesh).transpose(0, 1)

    def _model_axis(self, model):
        """The model-axis context of a meshed call (`tp.attach`), or none."""
        from .parallel.tp import attach

        if self.shard_spatial:
            return attach(model, self.mesh, "spatial")
        if self._tp_specs is not None:
            return attach(model, self.mesh, "tp", self._tp_specs)
        return contextlib.nullcontext()

    def example_inputs(self, batch: int, batched_key: bool = False):
        """(gt, mask, seed) for a batch-`batch` program: float32 zeros
        [batch, S, S, 3] and [batch, S, S, 1] on the pipeline's device, and
        seed 0, or `batched_key` per-row seeds 0..batch-1 (the serving
        layer's layout)."""
        S = self.config.unet.image_size
        gt = torch.zeros((batch, S, S, 3), device=self.device)
        mask = torch.zeros((batch, S, S, 1), device=self.device)
        return gt, mask, list(range(batch)) if batched_key else 0

    def compile_batch(self, batch: int, sampler: Optional[SamplerConfig] = None,
                      batched_key: bool = False) -> SamplingProgram:
        """The sampling program of one batch size (`sampling/program.py`): on
        a CUDA pipeline a captured CUDA graph of one `inpaint_sample` call,
        after one eager run on a side stream; a failed capture raises. On a
        CPU pipeline the same program without the graph. Install it with
        `install_program`, or persist it with `serving.aot.save_programs`.

        Under a mesh (every rank builds it, and calls it, with the same
        arguments) the program is the meshed call's: it takes the whole
        batch, keeps this rank's rows (under shard_spatial its block of H
        rows of them), fills its noise buffers with this rank's cut of the
        whole batch's draws, runs, gathers, and returns the whole batch. On
        CUDA the graph captures the collectives too, which only NCCL's can
        be: a CUDA pipeline over another backend raises here. Under
        fsdp_params the gather of the whole parameters is captured with the
        rest, so the graph's pool keeps them whole between replays."""
        cfg = sampler or self.config.sampler
        self._validate_cache_cfg(cfg)
        gt, _, seed = self.example_inputs(batch, batched_key)
        cache_apply = self._cache_apply(cfg)
        rank_noise = None
        if self.mesh is not None:
            import torch.distributed as dist

            if self.device.type == "cuda" and dist.get_backend() != "nccl":
                raise ValueError(
                    f"compile_batch: a CUDA graph captures NCCL collectives only, and this "
                    f"mesh runs over {dist.get_backend()!r}: call inpaint eagerly")
            shape = tuple(gt.shape)

            def rank_noise(noise):
                return self._rank_noise(noise, shape)

            def run(gt, mask, noise, device_tables):
                return self._inpaint_meshed(gt, mask, noise, cfg, None, device_tables)
        else:
            def run(gt, mask, noise, device_tables):
                return inpaint_sample(self._apply, self.sched, cfg, gt=gt, mask=mask,
                                      noise=noise, cache_apply=cache_apply,
                                      device_tables=device_tables)

        return SamplingProgram(run, _method_tables(self.sched, cfg), gt.shape, self.device,
                               batched_key, seed, rank_noise)

    def install_program(self, batch: int, cfg: SamplerConfig, program: SamplingProgram,
                        batched_key: bool = False):
        """Register a program for exact-shape dispatch: `inpaint` prefers it.
        `batched_key` must be the layout it was built for (per-row seeds, or
        one seed)."""
        S = self.config.unet.image_size
        self._programs[((batch, S, S, 3), cfg, batched_key)] = program

    def installed_program(self, batch: int, cfg: SamplerConfig,
                          batched_key: bool = False) -> Optional[SamplingProgram]:
        """The program `inpaint` would run for this batch, config and seed
        layout, or None."""
        S = self.config.unet.image_size
        return self._programs.get(((batch, S, S, 3), cfg, batched_key))

    def uninstall_program(self, batch: int, cfg: SamplerConfig,
                          batched_key: bool = False) -> bool:
        """Drop an installed program (e.g. one that failed to run); later
        calls run eagerly. Returns whether one was installed."""
        S = self.config.unet.image_size
        return self._programs.pop(((batch, S, S, 3), cfg, batched_key), None) is not None
