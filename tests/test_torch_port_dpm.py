"""The port's DPM-Solver++(2M) samplers, refinement and per-row seeds against
the JAX package.

Tables: `_dpm_tables` is the same float64 numpy code on both sides and must be
bit-equal. Trajectories: both samplers run one model function on the same
numpy inputs, and the port is fed the very noise the JAX sampler draws from
its key (`JaxKeyNoise`), a single key or a batched [B, 2] one, so the two runs
differ only by float32 rounding. Per-row seeds: row i of a batched run is
bit-equal to the batch-1 run with seed i.

The trajectories are in `test_torch_port_dpm_trajectory.py`, the per-row seeds
and the pipeline in `test_torch_port_dpm_seeds.py`: port test files hold at
most 25 cases (ROADMAP.md).
"""
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.sampling import GeneratorNoise, SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_common import stub_model as _model
from _torch_port_dpm_common import SHAPE, _inputs


METHODS = ("dpm++2m", "dpm++2m-sde")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [20, 25])
@pytest.mark.parametrize("spacing", ["uniform", "lambda"])
def test_dpm_tables_bit_equal(method, k, spacing):
    kw = dict(method=method, num_steps=k, time_spacing=spacing)
    ours = port_sampler._dpm_tables(DiffusionSchedule.create("quadratic", 1000, device="cpu"),
                                    SamplerConfig(**kw))
    ref = jax_sampler._dpm_tables(JaxSchedule.create("quadratic", 1000), JaxSamplerConfig(**kw))
    assert set(ours) == set(ref)
    assert ("sde_noise" in ours) == (method == "dpm++2m-sde")
    for name in ref:
        assert ours[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("strength", [1.0, 0.3])
def test_dpm_tables_bit_equal_on_explicit_grid(method, strength):
    """A student's explicit timestep grid (`cli.serve --timesteps`), whole
    and truncated by refinement."""
    kw = dict(method=method, num_steps=None, strength=strength,
              timesteps=(999, 874, 749, 624, 499, 374, 249, 124, 0))
    ours = port_sampler._dpm_tables(DiffusionSchedule.create("linear", 1000, device="cpu"),
                                    SamplerConfig(**kw))
    ref = jax_sampler._dpm_tables(JaxSchedule.create("linear", 1000), JaxSamplerConfig(**kw))
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


def test_dpm25_sde_grid_is_26_steps():
    """The server's default preset makes 26 model evaluations."""
    tables = port_sampler._dpm_tables(
        DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        SamplerConfig(method="dpm++2m-sde", num_steps=25, injection=True))
    assert len(tables["t"]) == 26 and tables["t"][0] == 999 and tables["t"][-1] == 0
    assert tables["sde_noise"][-1] == 0 and (tables["sde_noise"][:-1] > 0).all()


def test_refinement_starts_from_the_noised_clean_image():
    """strength < 1 with x_init: the first model call sees x_init q-sampled
    to the truncated grid's first timestep with the init draw."""
    gt, mask = _inputs(1)
    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    cfg = SamplerConfig(method="dpm++2m-sde", num_steps=25, strength=0.3)
    x_init = torch.from_numpy(np.flip(gt, 1).copy())
    seen = []

    def apply_fn(x, t, masked_image, m):
        seen.append((x.clone(), t.clone()))
        return torch.zeros(x.shape[:-1] + (6,))

    inpaint_sample(apply_fn, sched, cfg, gt=torch.from_numpy(gt), mask=torch.from_numpy(mask),
                   noise=GeneratorNoise(5, "cpu"), x_init=x_init)
    tables = port_sampler._dpm_tables(sched, cfg)
    assert len(seen) == len(tables["t"]) == round(0.3 * 26)
    a0 = np.cumprod(1.0 - sched.betas_host)[tables["t"][0]]
    expect = (np.float32(np.sqrt(a0)) * x_init
              + np.float32(np.sqrt(1 - a0)) * GeneratorNoise(5, "cpu").init(SHAPE))
    assert torch.equal(seen[0][0], expect)
    assert (seen[0][1] == int(tables["t"][0])).all()


def test_dpm_refuses_what_the_jax_sampler_refuses():
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    with pytest.raises(ValueError, match="guidance"):
        inpaint_sample(_model(torch), sched, SamplerConfig(method="dpm++2m-sde", num_steps=5),
                       gt=gt, mask=mask, noise=GeneratorNoise(0, "cpu"),
                       cond_fn=lambda x, t: x)
    with pytest.raises(ValueError, match="strength"):
        inpaint_sample(_model(torch), sched, SamplerConfig(method="dpm++2m", num_steps=5,
                                                           strength=0.0),
                       gt=gt, mask=mask, noise=GeneratorNoise(0, "cpu"))
