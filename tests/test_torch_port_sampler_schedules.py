"""The port's float64 host tables against the JAX package's: beta schedules,
timestep grids, the DDIM-100 grid and coefficient tables, and the schedule's
device tables. The same numpy code runs on both sides, so they are bit-equal.
"""
import numpy as np
import pytest

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import schedules as jax_schedules
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import schedules as port_schedules
from fidm_tpu_torch.sampling import SamplerConfig
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["linear", "cosine", "quadratic", "sqrt_linear"])
def test_beta_schedules_bit_equal(name):
    np.testing.assert_array_equal(port_schedules.get_named_beta_schedule(name, 1000),
                                  jax_schedules.get_named_beta_schedule(name, 1000))


@pytest.mark.parametrize("spacing", ["uniform", "trailing", "lambda", "karras"])
def test_timestep_grids_bit_equal(spacing):
    acp = np.cumprod(1.0 - jax_schedules.get_named_beta_schedule("quadratic", 1000))
    for k in (10, 25, 100):
        np.testing.assert_array_equal(
            port_schedules.timestep_sequence(1000, k, spacing, alphas_cumprod=acp),
            jax_schedules.timestep_sequence(1000, k, spacing, alphas_cumprod=acp))


def test_ddim100_grid_is_101_steps():
    seq = port_schedules.ddim_timestep_sequence(1000, 100)
    assert len(seq) == 101
    assert seq[0] == 999 and seq[1] == 990 and seq[-2] == 10 and seq[-1] == 0


def test_schedule_device_tables_equal():
    """float32 copies of the same float64 numbers on both sides."""
    ours = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    ref = JaxSchedule.create("quadratic", 1000)
    np.testing.assert_array_equal(ours.betas_host, ref.betas_host)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
              "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2", "log_betas", "fixed_large_variance",
              "fixed_large_log_variance"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("schedule", ["all", "high"])
def test_ddim100_tables_bit_equal(schedule):
    """The flagship preset (DDIM-100, eta 0.9): every float64 table."""
    ours = port_sampler._ddim_tables(
        DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        SamplerConfig(num_steps=100, eta=0.9, injection_schedule=schedule))
    ref = jax_sampler._ddim_tables(
        JaxSchedule.create("quadratic", 1000),
        JaxSamplerConfig(num_steps=100, eta=0.9, injection_schedule=schedule))
    assert set(ours) == set(ref)
    assert len(ours["t"]) == 101
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
