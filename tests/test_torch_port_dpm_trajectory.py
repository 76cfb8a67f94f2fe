"""DPM-Solver++(2M) inpainting trajectories of the port against the JAX
sampler's: both run one model function on the same numpy inputs, and the port
is fed the very noise the JAX sampler draws from its key (`JaxKeyNoise`), a
single key or a batched [B, 2] one, so the two runs differ only by float32
rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.serving.server import _request_keys
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample

from _torch_port_common import JaxKeyNoise, one_torch_thread  # noqa: F401
from _torch_port_common import stub_model as _model
from _torch_port_dpm_common import SHAPE, _inputs


TRAJECTORIES = [
    # method, injection, strength, x_init, batched key
    ("dpm++2m", True, 1.0, False, False),
    ("dpm++2m", False, 1.0, False, False),
    ("dpm++2m-sde", True, 1.0, False, False),
    ("dpm++2m-sde", False, 1.0, False, False),
    ("dpm++2m-sde", True, 1.0, True, False),
    ("dpm++2m", True, 0.4, False, False),
    ("dpm++2m", True, 0.4, True, False),
    ("dpm++2m-sde", True, 0.4, False, False),
    ("dpm++2m-sde", True, 0.4, True, False),
    ("ddim", True, 0.4, True, False),
    ("dpm++2m-sde", True, 1.0, False, True),
    ("dpm++2m-sde", True, 0.4, True, True),
    ("dpm++2m", True, 1.0, False, True),
]


@pytest.mark.parametrize("method,injection,strength,with_init,batched", TRAJECTORIES)
def test_trajectory_matches_jax(method, injection, strength, with_init, batched):
    gt, mask = _inputs(0)
    x_init = np.clip(gt + 0.3 * np.random.default_rng(9).standard_normal(SHAPE), -1, 1)
    x_init = x_init.astype(np.float32) if with_init else None
    kw = dict(method=method, num_steps=10, eta=0.9, injection=injection, strength=strength)
    key = _request_keys([11, 4242]) if batched else jax.random.PRNGKey(3)
    ref = np.asarray(jax_inpaint_sample(
        _model(jnp), JaxSchedule.create("quadratic", 1000), JaxSamplerConfig(**kw),
        gt=jnp.asarray(gt), mask=jnp.asarray(mask), key=jnp.asarray(key),
        x_init=None if x_init is None else jnp.asarray(x_init)))
    out = inpaint_sample(
        _model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        SamplerConfig(**kw), gt=torch.from_numpy(gt), mask=torch.from_numpy(mask),
        noise=JaxKeyNoise(jnp.asarray(key)),
        x_init=None if x_init is None else torch.from_numpy(x_init))
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.1  # the run did something
    # float32 on both sides, rounding differently in the last bit (tanh, the
    # means); the 2M extrapolation (1 + c) D_i - c D_{i-1} and the x0
    # prediction's division by sqrt(alpha_bar) (~160x at t=999) amplify that
    # before the clip to [-1, 1]. The DDIM trajectories hold 1e-5; 2e-5 here
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out.numpy()[~hole], gt[~hole])
