"""The port's schedules and DDIM inpainting sampler against the JAX package's.

Host tables: the float64 beta schedules, timestep grids and DDIM coefficient
tables are the same numpy code on both sides and must be bit-equal.
Trajectories: both samplers run one model function on the same numpy inputs,
and the port is fed the very noise the JAX sampler draws from its key
(`_key_split`, `_key_normal`, `_key_fold`, `_gt_noise`), so the two runs
differ only by float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import gaussian as jax_gaussian
from fidm_tpu.diffusion import schedules as jax_schedules
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import gaussian as port_gaussian
from fidm_tpu_torch.diffusion import schedules as port_schedules
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import JaxKeyNoise, to_torch

SHAPE = (2, 8, 8, 3)


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


@pytest.mark.parametrize("name", ["q_sample", "predict_xstart_from_eps",
                                  "predict_xstart_from_xprev", "predict_xstart_from_v"])
def test_gaussian_conversions_match_jax(name):
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([3, 871], np.int32)
    ref = getattr(jax_gaussian, name)(JaxSchedule.create("quadratic", 1000), x, t, y)
    ours = getattr(port_gaussian, name)(DiffusionSchedule.create("quadratic", 1000, device="cpu"),
                                        *(torch.from_numpy(a) for a in (x, t, y)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule", ["all", "high", "low"])
def test_injection_matches_jax(schedule):
    rng = np.random.default_rng(5)
    x, gt = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    keep = (rng.uniform(size=SHAPE[:-1] + (1,)) > 0.5).astype(np.float32)
    t = np.array([100, 700], np.int32)
    key = jax.random.PRNGKey(6)
    ref = jax_gaussian.apply_inpainting_injection(
        JaxSchedule.create("linear", 1000), x, t, gt, keep, key,
        injection_schedule=schedule)
    noise = to_torch(jax.random.normal(key, SHAPE, jnp.float32))
    ours = port_gaussian.apply_inpainting_injection(
        DiffusionSchedule.create("linear", 1000, device="cpu"),
        *(torch.from_numpy(a) for a in (x, t, gt, keep)), noise, injection_schedule=schedule)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    v = np.arange(12, dtype=np.float32).reshape(1, 1, 2, 6)
    mean, var = port_gaussian.split_model_output(
        torch.from_numpy(v), port_gaussian.ModelVarType.LEARNED_RANGE)
    ref_mean, ref_var = jax_gaussian.split_model_output(
        v, jax_gaussian.ModelVarType.LEARNED_RANGE)
    np.testing.assert_array_equal(mean.numpy(), ref_mean)
    np.testing.assert_array_equal(var.numpy(), ref_var)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    return gt, mask


def _model(xp):
    """A cheap nonlinear stand-in for the UNet, written once for numpy-like
    `xp` (jnp or torch): 6 output channels, the last 3 (variance) unused.
    The image mean mixes pixels, so the known region's injected noise
    reaches the hole, as it does through the UNet."""

    def apply_fn(x, t, masked_image, mask):
        tt = t.astype(xp.float32) if xp is jnp else t.float()
        mean = (x.mean(axis=(1, 2), keepdims=True) if xp is jnp
                else x.mean(dim=(1, 2), keepdim=True))
        h = xp.tanh(0.7 * x + 2.0 * mean - 0.4 * masked_image + 0.3 * mask
                    + (tt / 1000.0)[:, None, None, None])
        cat = xp.concatenate if xp is jnp else torch.cat
        return cat([h, 0.1 * x], -1)

    return apply_fn


@pytest.mark.parametrize("eta,injection,point,schedule", [
    (0.0, True, "post", "all"),
    (0.9, True, "post", "all"),
    (0.0, False, "post", "all"),
    (0.9, False, "post", "all"),
    (0.9, True, "pre", "all"),
    (0.9, True, "post", "high"),
])
def test_ddim_trajectory_matches_jax(eta, injection, point, schedule):
    gt, mask = _inputs(0)
    kw = dict(method="ddim", num_steps=10, eta=eta, injection=injection,
              injection_point=point, injection_schedule=schedule)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_inpaint_sample(
        _model(jnp), JaxSchedule.create("quadratic", 1000), JaxSamplerConfig(**kw),
        gt=jnp.asarray(gt), mask=jnp.asarray(mask), key=key))
    out = inpaint_sample(
        _model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        SamplerConfig(**kw), gt=torch.from_numpy(gt), mask=torch.from_numpy(mask),
        noise=JaxKeyNoise(key))
    assert np.abs(ref).max() > 0.5  # the run did something
    # float32 on both sides; tanh and the sums round differently in the last
    # bit, and dividing by sqrt(alpha_bar) at t=999 (~160x) amplifies that
    # before the clip to [-1, 1]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    keep = mask[..., 0] < 0.5
    np.testing.assert_array_equal(out.numpy()[keep], gt[keep])


def test_uint8_output_is_clamp_then_truncate():
    x = np.linspace(-1.2, 1.2, 97, dtype=np.float32).reshape(1, 97, 1, 1)
    cfg = dict(output_dtype="uint8")
    ours = port_sampler._finalize_output(torch.from_numpy(x), SamplerConfig(**cfg))
    ref = jax_sampler._finalize_output(jnp.asarray(x), JaxSamplerConfig(**cfg))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [
    dict(method="ddpm"), dict(method="dpm++3m"), dict(method="repaint"),
    dict(method="unipc"), dict(trajectory_every=2),
])
def test_unported_options_raise(kw):
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(NotImplementedError):
        inpaint_sample(_model(torch), DiffusionSchedule.create("linear", 50, device="cpu"),
                       SamplerConfig(num_steps=5, **kw), gt=gt, mask=mask,
                       noise=port_sampler.GeneratorNoise(0, "cpu"))


def test_cond_fn_raises():
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(NotImplementedError):
        inpaint_sample(_model(torch), DiffusionSchedule.create("linear", 50, device="cpu"),
                       SamplerConfig(num_steps=5), gt=gt, mask=mask,
                       noise=port_sampler.GeneratorNoise(0, "cpu"),
                       cond_fn=lambda x, t: x)


def test_generator_noise_is_keyed_not_ordered():
    """The same seed and index give the same draw in any call order; the
    injection draw is keyed by timestep, not by call."""
    a, b = port_sampler.GeneratorNoise(7, "cpu"), port_sampler.GeneratorNoise(7, "cpu")
    first = a.inject(990, SHAPE)
    b.step(0, SHAPE), b.init(SHAPE)
    assert torch.equal(b.inject(990, SHAPE), first)
    assert not torch.equal(a.inject(980, SHAPE), first)
    assert not torch.equal(a.step(990, SHAPE), first)
    assert not torch.equal(port_sampler.GeneratorNoise(8, "cpu").inject(990, SHAPE), first)
