"""The port's Gaussian diffusion conversions against the JAX package's: x0 and
eps conversions, the q distributions, and `p_mean_variance` (with guidance)
for every mean and variance type, on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import gaussian as jax_gaussian
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import gaussian as port_gaussian

from _torch_port_common import one_torch_thread  # noqa: F401


SHAPE = (2, 8, 8, 3)


@pytest.mark.parametrize("name", ["q_sample", "predict_xstart_from_eps",
                                  "predict_xstart_from_xprev", "predict_xstart_from_v",
                                  "predict_eps_from_xstart", "velocity_from_eps_xstart"])
def test_gaussian_conversions_match_jax(name):
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([3, 871], np.int32)
    # velocity_from_eps_xstart takes (t, eps, x_start); the others (x, t, y)
    args = (t, x, y) if name == "velocity_from_eps_xstart" else (x, t, y)
    ref = getattr(jax_gaussian, name)(JaxSchedule.create("quadratic", 1000), *args)
    ours = getattr(port_gaussian, name)(DiffusionSchedule.create("quadratic", 1000, device="cpu"),
                                        *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["q_mean_variance", "q_posterior_mean_variance"])
def test_q_distributions_match_jax(name):
    """mean, variance and log-variance of q(x_t | x_0) and of the posterior."""
    rng = np.random.default_rng(7)
    x0, xt = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0, 642], np.int32)
    args = (x0, t) if name == "q_mean_variance" else (x0, xt, t)
    ref = getattr(jax_gaussian, name)(JaxSchedule.create("linear", 1000), *args)
    ours = getattr(port_gaussian, name)(DiffusionSchedule.create("linear", 1000, device="cpu"),
                                        *(torch.from_numpy(a) for a in args))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == np.shape(r)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("var_type", ["LEARNED", "LEARNED_RANGE", "FIXED_SMALL", "FIXED_LARGE"])
@pytest.mark.parametrize("mean_type", ["EPSILON", "START_X", "VELOCITY", "PREVIOUS_X"])
def test_p_mean_variance_and_guidance_match_jax(mean_type, var_type):
    """p(x_{t-1} | x_t) from one model output under every mean and variance
    type, then both classifier-guidance shifts of it. The learned types get
    a 6-channel output (LEARNED_RANGE's variance part in [-1, 1]); the
    LEARNED and FIXED_LARGE cases leave x0 unclipped."""
    rng = np.random.default_rng(8)
    learned = var_type.startswith("LEARNED")
    x, grad = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    out = rng.standard_normal(SHAPE).astype(np.float32)
    if learned:
        var = (rng.uniform(-1, 1, SHAPE) if var_type == "LEARNED_RANGE"
               else rng.uniform(-9, -2, SHAPE)).astype(np.float32)
        out = np.concatenate([out, var], axis=-1)
    t = np.array([5, 730], np.int32)
    clip = var_type not in ("LEARNED", "FIXED_LARGE")
    jsched = JaxSchedule.create("quadratic", 1000)
    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    ref = jax_gaussian.p_mean_variance(
        jsched, out, x, t, mean_type=jax_gaussian.ModelMeanType[mean_type],
        var_type=jax_gaussian.ModelVarType[var_type], clip_denoised=clip)
    tx, tt, tg = (torch.from_numpy(a) for a in (x, t, grad))
    ours = port_gaussian.p_mean_variance(
        sched, torch.from_numpy(out), tx, tt,
        mean_type=port_gaussian.ModelMeanType[mean_type],
        var_type=port_gaussian.ModelVarType[var_type], clip_denoised=clip)
    assert isinstance(ours, port_gaussian.PMeanVariance)
    guided = {"condition_mean": (port_gaussian.condition_mean(ours, tg),
                                 jax_gaussian.condition_mean(ref, grad)),
              "condition_score": (port_gaussian.condition_score(sched, ours, tx, tt, tg),
                                  jax_gaussian.condition_score(jsched, ref, x, t, grad))}
    for label, (o, r) in [("p_mean_variance", (ours, ref)), *guided.items()]:
        for f in port_gaussian.PMeanVariance._fields:
            a, b = getattr(o, f).numpy(), np.asarray(getattr(r, f))
            assert a.shape == b.shape, (label, f)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f"{label}.{f}")
