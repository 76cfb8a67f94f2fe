"""Shared pieces of the training-loss tests (`test_torch_port_losses*.py`): the
tolerance, the schedules of both packages, seeded arrays, and one
`training_losses` call on both sides with the same draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import gaussian as jax_gd
from fidm_tpu.diffusion import losses as jax_losses
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import gaussian as port_gd
from fidm_tpu_torch.diffusion import losses as port_losses

from _torch_port_common import stub_model


SHAPE = (3, 8, 8, 3)
MEAN_TYPES = ["EPSILON", "START_X", "VELOCITY", "PREVIOUS_X"]
# float32 on both sides, the same formulas in the same order; the
# exp/log/tanh of the two libraries differ in the last bits
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def scheds():
    return (JaxSchedule.create("quadratic", 1000),
            DiffusionSchedule.create("quadratic", 1000, device="cpu"))


def _arrays(seed, n, shape=SHAPE, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **(tol or TOL))


# ------------------------------------------------------------ training_losses


def _loss_inputs(seed, t=(0, 499, 731)):
    x0, = _arrays(seed, 1, scale=0.5)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[:, 2:6, 3:8] = 1.0
    mask[2] = 0.0
    mask[2, :4] = 1.0
    t = np.array(t, np.int32)
    key = jax.random.PRNGKey(seed)
    noise_key, inject_key = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_key, SHAPE, jnp.float32))
    inject = np.asarray(jax.random.normal(inject_key, SHAPE, jnp.float32))
    return x0, mask, t, key, noise, inject


def _both(scheds, seed, t=(0, 499, 731), **kw):
    """(port terms, JAX terms) of `training_losses` on the stub model, the
    port fed the noise JAX draws from its key."""
    jsched, psched = scheds
    x0, mask, t, key, noise, inject = _loss_inputs(seed, t)
    masked = x0 * (1 - mask)
    jkw = {k: (jax_gd.ModelMeanType[v] if k == "mean_type" else
               jax_gd.LossType[v] if k == "loss_type" else v) for k, v in kw.items()}
    pkw = {k: (port_gd.ModelMeanType[v] if k == "mean_type" else
               port_gd.LossType[v] if k == "loss_type" else v) for k, v in kw.items()}
    ref = jax_losses.training_losses(jsched, stub_model(jnp), x0, t, key, mask=mask,
                                     masked_image=masked, **jkw)
    ours = port_losses.training_losses(
        psched, stub_model(torch), torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), inject_noise=torch.from_numpy(inject),
        mask=torch.from_numpy(mask), masked_image=torch.from_numpy(masked), **pkw)
    return ours, ref
