"""Cached sampling trajectories, and the cached presets in the pipeline and the
server, against the JAX package's.

Trajectories: both samplers run one cheap cache-aware model with a
`cache_apply` pair built as the JAX pipeline's `_make_jit` builds it, and the
port is fed the very noise the JAX sampler draws (`JaxKeyNoise`), so the runs
differ only by float32 rounding. The pipeline cases run the four-level
float32 UNet of `test_torch_port_cache.py` on perturbed JAX parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu import pipeline as jax_pipeline
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu_torch import SAMPLER_PRESETS
from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler
from fidm_tpu_torch.serving import InpaintingServer

from _torch_port_cache_common import (  # noqa: F401
    JCFG4,
    jax_variables,
    pipe,
    _same_outcome,
    _cache_model,
    _traj_inputs,
)
from _torch_port_common import JaxKeyNoise, one_torch_thread  # noqa: F401


CACHED_PRESETS = ("ddim-100-deep", "ddim-100-turbo", "ddim-20-fast", "dpm-20-fast")


def _cache_apply(apply, cfg):
    """The (full_fn, cached_fn) pair as the JAX pipeline's `_make_jit` builds
    it: none for period <= 1 or output reuse, branch 0 is encoder mode."""
    if cfg.encoder_cache_period <= 1 or cfg.cache_branch == -1:
        return None
    depth = cfg.cache_branch or None
    return (lambda x, t, mi, m: apply(x, t, mi, m, return_cache=True, cache_depth=depth),
            lambda x, t, mi, m, cache: apply(x, t, mi, m, cache=cache, cache_depth=depth))


CACHED_TRAJECTORIES = {
    "ddim-b0": dict(method="ddim", encoder_cache_period=3, cache_branch=0),
    "ddim-b1": dict(method="ddim", encoder_cache_period=3, cache_branch=1),
    "ddim-b2": dict(method="ddim", encoder_cache_period=3, cache_branch=2),
    "ddim-b3": dict(method="ddim", encoder_cache_period=3, cache_branch=3),
    "ddim-output-reuse": dict(method="ddim", encoder_cache_period=3, cache_branch=-1),
    "ddim-b2-tail": dict(method="ddim", encoder_cache_period=3, cache_branch=2,
                         encoder_cache_tail=3),
    "ddim-b1-keysteps": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                             cache_keysteps=(0, 3, 4, 8)),
    "ddim-b1-pre": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                        injection_point="pre"),
    "dpm++2m-b1": dict(method="dpm++2m", encoder_cache_period=2, cache_branch=1,
                       encoder_cache_tail=2),
    "dpm++2m-sde-b1": dict(method="dpm++2m-sde", encoder_cache_period=2, cache_branch=1),
    "ddim-b1-refine": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                           strength=0.5),
    "dpm++2m-sde-output-reuse": dict(method="dpm++2m-sde", encoder_cache_period=2,
                                     cache_branch=-1),
}


@pytest.mark.parametrize("name", list(CACHED_TRAJECTORIES))
def test_cached_trajectory_matches_jax(name):
    gt, mask = _traj_inputs(0)
    kw = dict(num_steps=9, eta=0.9, injection=True, **CACHED_TRAJECTORIES[name])
    key = jax.random.PRNGKey(3)
    jcfg, pcfg = JaxSamplerConfig(**kw), SamplerConfig(**kw)
    ref = np.asarray(jax_inpaint_sample(
        _cache_model(jnp), JaxSchedule.create("quadratic", 1000), jcfg,
        gt=jnp.asarray(gt), mask=jnp.asarray(mask), key=key,
        cache_apply=_cache_apply(_cache_model(jnp), jcfg)))
    out = inpaint_sample(
        _cache_model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"), pcfg,
        gt=torch.from_numpy(gt), mask=torch.from_numpy(mask), noise=JaxKeyNoise(key),
        cache_apply=_cache_apply(_cache_model(torch), pcfg))
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.1  # the run did something
    # the tolerance of the uncached trajectories (test_torch_port_dpm_trajectory)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out.numpy()[~hole], gt[~hole])
    # and the cache mattered: the exact run (period 1) lands elsewhere
    exact = inpaint_sample(
        _cache_model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        dataclasses.replace(pcfg, encoder_cache_period=1, cache_branch=0, cache_keysteps=None),
        gt=torch.from_numpy(gt), mask=torch.from_numpy(mask), noise=JaxKeyNoise(key))
    assert np.abs(exact.numpy() - out.numpy())[hole].max() > 1e-3


@pytest.mark.parametrize("kw", [
    dict(cache_keysteps=(0, 2)),
    dict(encoder_cache_period=2, cache_branch=1),
    dict(encoder_cache_period=2, cache_branch=-1, cache_keysteps=(1, 3)),
], ids=["keysteps-without-period", "no-cache-apply", "keysteps-without-step-0"])
def test_sampler_refuses_what_the_jax_sampler_refuses(kw):
    """Both samplers, called directly with no cache pair, raise the same
    ValueError for each config."""
    gt, mask = _traj_inputs(1)

    def ref():
        jax_inpaint_sample(_cache_model(jnp), JaxSchedule.create("linear", 50),
                           JaxSamplerConfig(num_steps=5, **kw), gt=jnp.asarray(gt),
                           mask=jnp.asarray(mask), key=jax.random.PRNGKey(0))

    def ours():
        inpaint_sample(_cache_model(torch), DiffusionSchedule.create("linear", 50, device="cpu"),
                       SamplerConfig(num_steps=5, **kw), gt=torch.from_numpy(gt),
                       mask=torch.from_numpy(mask), noise=port_sampler.GeneratorNoise(0, "cpu"))

    with pytest.raises(ValueError):  # the JAX sampler refuses it
        ref()
    _same_outcome(ours, ref)


@pytest.mark.parametrize("name", CACHED_PRESETS)
def test_cached_presets_run_in_the_pipeline(pipe, name, monkeypatch):
    """The four cached presets run through `inpaint`, with a full forward on
    each key step of the keymask and a cached one (the preset's branch) on
    each other step."""
    cfg = SAMPLER_PRESETS[name]
    calls = []
    forward = pipe.model.forward

    def counted(*a, cache=None, return_cache=False, cache_depth=None):
        calls.append(("cached" if cache is not None else "full", cache_depth))
        return forward(*a, cache=cache, return_cache=return_cache, cache_depth=cache_depth)

    monkeypatch.setattr(pipe.model, "forward", counted)
    gt, mask = _traj_inputs(7, (1, 32, 32, 3))
    out = pipe.inpaint(gt, mask, 0, sampler=cfg)
    tables = (port_sampler._ddim_tables if cfg.method == "ddim"
              else port_sampler._dpm_tables)(pipe.sched, cfg)
    is_key = port_sampler._cache_keymask(cfg, len(tables["t"]))
    assert (len(is_key), int(is_key.sum())) == {
        "ddim-100-deep": (101, 41), "ddim-100-turbo": (101, 34),
        "ddim-20-fast": (21, 13), "dpm-20-fast": (21, 13)}[name]
    assert calls == [("full" if k else "cached", cfg.cache_branch) for k in is_key]
    hole = mask[..., 0] > 0.5
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
    np.testing.assert_array_equal(out.numpy()[~hole], gt[~hole])


def test_pipeline_cached_preset_matches_jax(pipe, jax_variables):
    """The slice as a whole: the UNet on the same weights, inputs and noise
    through the JAX pipeline and the port, DDIM with DeepCache branch 2 and
    an exact tail, as `ddim-100-deep` at fewer steps."""
    gt, mask = _traj_inputs(4, (2, 32, 32, 3))
    sampler = dict(method="ddim", num_steps=6, eta=0.9, injection=True,
                   encoder_cache_period=3, cache_branch=2, encoder_cache_tail=2)
    key = jax.random.PRNGKey(8)
    ref_pipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG4), jax.tree_util.tree_map(jnp.asarray, jax_variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG4, sampler=JaxSamplerConfig(**sampler)))
    ref = np.asarray(ref_pipe.inpaint(jnp.asarray(gt), jnp.asarray(mask), key))
    out = pipe.inpaint(gt, mask, 0, SamplerConfig(**sampler), noise=JaxKeyNoise(key)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.05  # the model reaches the hole
    # float32 UNets whose sums run in another order; the bound of the
    # uncached pipeline tests
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(out[~hole], gt[~hole])


def test_server_answers_cached_presets(pipe):
    """`cli.serve --presets` takes the cached presets; a request to each is
    answered, and the reply equals the pipeline's batch-1 run at its seed."""
    presets = serve_cli.build_presets(serve_cli.parse_args(
        ["--presets", "ddim-20-fast", "dpm-20-fast"]))
    assert list(presets) == ["ddim-20-fast", "dpm-20-fast"]
    gt, mask = _traj_inputs(9, (1, 32, 32, 3))
    server = InpaintingServer(pipe, batch_size=1, presets=presets)
    try:
        replies = {name: server.submit(gt[0], mask[0], seed=11, preset=name).result(timeout=120)
                   for name in presets}
    finally:
        server.close()
    for name, reply in replies.items():
        ref = pipe.inpaint(gt, mask, [11], sampler=presets[name]).numpy()[0]
        np.testing.assert_array_equal(reply, ref)
    assert not np.array_equal(replies["ddim-20-fast"], replies["dpm-20-fast"])
