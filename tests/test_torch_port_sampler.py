"""The port's schedules and DDIM inpainting sampler against the JAX package's.

Host tables: the float64 beta schedules, timestep grids and DDIM coefficient
tables are the same numpy code on both sides and must be bit-equal.
Trajectories: both samplers run one model function on the same numpy inputs,
and the port is fed the very noise the JAX sampler draws from its key
(`_key_split`, `_key_normal`, `_key_fold`, `_gt_noise`), so the two runs
differ only by float32 rounding.

The host tables are in `test_torch_port_sampler_schedules.py`, the Gaussian
conversions in `test_torch_port_sampler_gaussian.py`: port test files hold at
most 25 cases (ROADMAP.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import gaussian as jax_gaussian
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import gaussian as port_gaussian
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import JaxKeyNoise, one_torch_thread, to_torch  # noqa: F401
from _torch_port_common import stub_model as _model


SHAPE = (2, 8, 8, 3)


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
    """The methods and the option that raised NotImplementedError before the
    rest of sampling was ported now run (their parity with JAX:
    test_torch_port_methods): the model is called once per row of the
    method's host table that evaluates it, at that row's timestep, and the
    output keeps the contract, finite, in [-1, 1], known pixels equal to gt,
    the hole filled; trajectory_every=2 gives (K-1)//2 + 1 frames whose last
    is the output in the hole."""
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    cfg = SamplerConfig(num_steps=5, **kw)
    if cfg.method == "repaint":  # jumps within the 6 levels
        cfg = dataclasses.replace(cfg, jump_length=2, jump_n_sample=2)
    calls = []

    def counted(x, t, masked_image, m):
        calls.append(int(t[0]))
        return _model(torch)(x, t, masked_image, m)

    out = inpaint_sample(counted, sched, cfg, gt=gt, mask=mask,
                         noise=port_sampler.GeneratorNoise(0, "cpu"))
    tables = port_sampler._method_tables(sched, cfg)
    runs = tables.get("is_denoise", np.ones(len(tables["t"]), np.int32)) > 0
    assert calls == [int(t) for t in tables["t"][runs]]
    if cfg.trajectory_every:
        out, traj = out
        K = len(tables["t"])
        assert traj.shape == ((K - 1) // 2 + 1,) + tuple(gt.shape)
        hole = mask[..., 0] > 0.5
        assert torch.equal(traj[-1][hole], out[hole])
    keep = mask[..., 0] < 0.5
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
    assert torch.equal(out[keep], gt[keep])
    assert (out[~keep] - gt[~keep]).abs().mean() > 0.1


def test_cond_fn_raises():
    """Classifier guidance, which raised NotImplementedError before it was
    ported, now runs with DDIM (its parity with JAX:
    test_torch_port_guidance): cond_fn is called once per step on the model's
    input at the step's timestep, and moves the hole."""
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    cfg = SamplerConfig(num_steps=5)
    seen, guided = [], []

    def recorded(x, t, masked_image, m):
        seen.append((x.clone(), t.clone()))
        return _model(torch)(x, t, masked_image, m)

    def cond_fn(x, t):
        guided.append((x.detach().clone(), t.clone()))
        return 0.5 - x

    out = inpaint_sample(recorded, sched, cfg, gt=gt, mask=mask,
                         noise=port_sampler.GeneratorNoise(0, "cpu"), cond_fn=cond_fn)
    plain = inpaint_sample(_model(torch), sched, cfg, gt=gt, mask=mask,
                           noise=port_sampler.GeneratorNoise(0, "cpu"))
    assert len(guided) == len(seen) == len(port_sampler._ddim_tables(sched, cfg)["t"])
    for (x, t), (gx, gt_) in zip(seen, guided):
        assert torch.equal(x, gx) and torch.equal(t, gt_)
    keep = mask[..., 0] < 0.5
    assert torch.equal(out[keep], gt[keep])
    assert (out[~keep] - plain[~keep]).abs().max() > 1e-2


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
