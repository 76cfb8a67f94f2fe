"""The port's DDPM, DPM-Solver++(3M), UniPC, RePaint and consistency
samplers, its unconditional `sample()` and its trajectories, against the JAX
package.

Tables: the same float64 numpy code on both sides, bit-equal. Trajectories:
both samplers run one model function on the same numpy inputs, and the port
is fed the very noise the JAX sampler draws from its key (`JaxKeyNoise`,
`JaxKeyNoise2` for `sample()`), so the runs differ only by float32 rounding:
a closed-form stand-in for the UNet (2e-5), then the small UNet with the JAX
weights carried across (2e-4), the 9-channel inpainting model and the
3-channel base model. Torch runs on one intra-op thread here.

The tables are in `test_torch_port_methods_tables.py`: port test files hold at
most 25 cases (ROADMAP.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import UNet as JaxUNet
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.sampling import sample as jax_sample
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import InpaintingUNet, UNet, UNetConfig
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample, sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import (  # noqa: F401
    JaxKeyNoise,
    JaxKeyNoise2,
    SMALL,
    drawn_jax_variables,
    one_torch_thread,
    stub_base_model,
    stub_model,
)
from _torch_port_methods_common import _configs, _schedules


SHAPE = (2, 8, 8, 3)


# ------------------------------------------------- trajectories, stub model


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    lo, hi = shape[1] // 4, 3 * shape[1] // 4
    mask[:, lo:hi, lo - 1:hi - 1] = 1.0
    return gt, mask


INPAINT = [
    dict(method="ddpm", num_steps=8, time_spacing="trailing", injection_point="pre",
         mean_type="PREVIOUS_X", var_type="FIXED_SMALL", strength=0.5, x_init=True),
    dict(method="dpm++3m", num_steps=20),
    dict(method="unipc", num_steps=10, unipc_order=3, unipc_corrector=False,
         time_spacing="lambda"),
    dict(method="consistency", num_steps=2, mean_type="VELOCITY"),
    dict(method="repaint", num_steps=10, jump_length=3, jump_n_sample=3,
         injection_schedule="high", var_type="FIXED_LARGE", batched=True),
]


@pytest.mark.parametrize("kw", INPAINT, ids=lambda kw: kw["method"])
def test_inpaint_trajectory_matches_jax(kw):
    """Each new method's inpainting loop on the T = 50 linear schedule, fed
    JAX's draws: a single key or per-row keys, post- or pre-injection,
    refinement from a clean x_init, the mean and variance types."""
    kw = dict(kw)
    batched, with_init = kw.pop("batched", False), kw.pop("x_init", False)
    gt, mask = _inputs(0)
    x_init = np.clip(np.flip(gt, 1) + 0.1, -1, 1).astype(np.float32) if with_init else None
    key = (jax.random.split(jax.random.PRNGKey(3), SHAPE[0]) if batched
           else jax.random.PRNGKey(3))
    jcfg, pcfg = _configs(injection=True, **kw)
    jsched, psched = _schedules("linear", 50)

    def model(xp):  # a fixed variance: the model outputs the 3 eps channels
        f = stub_model(xp)
        return f if "var_type" not in kw else lambda *a: f(*a)[..., :3]

    ref = np.asarray(jax_inpaint_sample(
        model(jnp), jsched, jcfg, gt=jnp.asarray(gt), mask=jnp.asarray(mask), key=key,
        x_init=None if x_init is None else jnp.asarray(x_init)))
    out = inpaint_sample(
        model(torch), psched, pcfg, gt=torch.from_numpy(gt),
        mask=torch.from_numpy(mask), noise=JaxKeyNoise(key),
        x_init=None if x_init is None else torch.from_numpy(x_init)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.1  # the run did something
    # float32 on both sides rounding differently in the last bit, amplified
    # by the x0 prediction's division by sqrt(alpha_bar): the DPM bound
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out[~hole], gt[~hole])


SAMPLE = [
    dict(method="ddim", num_steps=10, eta=0.9),
    dict(method="ddpm", num_steps=10, var_type="LEARNED"),
    dict(method="dpm++3m", num_steps=12),
    dict(method="unipc", num_steps=10, unipc_order=3),
    dict(method="consistency", num_steps=3, mean_type="START_X"),
    dict(method="repaint", num_steps=8, jump_length=2, jump_n_sample=2),
]


@pytest.mark.parametrize("kw", SAMPLE, ids=lambda kw: kw["method"])
def test_sample_matches_jax(kw):
    """The unconditional sampler, every method, with trajectory frames every
    third step (DDIM's update is the library's, not the inpainting loop's)."""
    key = jax.random.PRNGKey(4)
    jcfg, pcfg = _configs(trajectory_every=3, **kw)
    jsched, psched = _schedules("linear", 50)
    ref, ref_traj = jax_sample(stub_base_model(jnp), jsched, jcfg, shape=SHAPE, key=key)
    out, traj = sample(stub_base_model(torch), psched, pcfg, shape=SHAPE,
                       noise=JaxKeyNoise2(key))
    assert traj.shape == ref_traj.shape and traj.dtype == torch.float32
    assert np.abs(np.asarray(ref)).max() > 0.3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(traj[-1].numpy(), out.numpy())


def test_sample_ddim_differs_from_inpainting_ddim():
    """`sample()`'s DDIM re-derives eps from the clipped x0, the inpainting
    loop keeps the raw eps: with clipping active the two differ, and each
    equals its JAX counterpart (the test above, and test_torch_port_sampler)."""
    cfg = SamplerConfig(method="ddim", num_steps=10, eta=0.0, injection=False,
                        final_blend=False)
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    noise = port_sampler.GeneratorNoise(1, "cpu")
    gt = torch.zeros(SHAPE)
    a = sample(stub_base_model(torch), sched, cfg, shape=SHAPE, noise=noise)
    b = inpaint_sample(lambda x, t, mi, m: stub_base_model(torch)(x, t), sched, cfg,
                       gt=gt, mask=torch.ones(SHAPE[:-1] + (1,)), noise=noise)
    assert (a - b).abs().max() > 1e-3


def test_trajectory_frames_and_steps():
    """N = (K-1)//k + 1 frames, the state after steps k-1, 2k-1, ... and the
    last, before the final blend; the images are finalized, the frames stay
    float32."""
    gt, mask = (torch.from_numpy(a) for a in _inputs(2))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    seen = []
    base = SamplerConfig(method="ddpm", num_steps=7, injection=True)

    def record(x, t, mi, m):
        seen.append(x.clone())
        return stub_model(torch)(x, t, mi, m)

    out = inpaint_sample(record, sched, base, gt=gt, mask=mask,
                         noise=port_sampler.GeneratorNoise(3, "cpu"))
    states = seen[1:]  # the state after step i is the input of step i + 1
    K = len(seen)
    assert K == len(port_sampler._ddpm_tables(sched, base)["t"]) == 8
    for k in (1, 2, 3, 8, 9):
        cfg = dataclasses.replace(base, trajectory_every=k, output_dtype="uint8")
        img, traj = inpaint_sample(stub_model(torch), sched, cfg, gt=gt, mask=mask,
                                   noise=port_sampler.GeneratorNoise(3, "cpu"))
        steps = [i for i in range(K) if (i + 1) % k == 0 or i == K - 1]
        assert traj.shape == (len(steps),) + tuple(gt.shape) == ((K - 1) // k + 1,) + gt.shape
        assert img.dtype == torch.uint8 and traj.dtype == torch.float32
        for n, i in enumerate(steps[:-1]):
            assert torch.equal(traj[n], states[i]), (k, i)
        hole = mask[..., 0] > 0.5
        assert torch.equal(traj[-1][hole], out[hole])  # the pre-blend last state


# ---------------------------------------------------- through the small UNet


@pytest.fixture(scope="module")
def inpainting_weights():
    """The small 9-channel UNet in both packages, on the same numpy-drawn
    weights."""
    s = SMALL["image_size"]
    jcfg = JaxUNetConfig(**SMALL, dtype=jnp.float32)
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
    v = drawn_jax_variables(JaxInpaintingUNet, jcfg, 6, *dummy)
    model = InpaintingUNet(UNetConfig(**SMALL, dtype=torch.float32)).eval()
    model.load_state_dict(state_dict_from_jax(v, model.config), strict=True)
    return JaxInpaintingUNet(jcfg), jax.tree_util.tree_map(jnp.asarray, v), model


def test_inpaint_through_unet_matches_jax(inpainting_weights):
    """The 9-channel model, respaced DDPM with learned-range variance."""
    jmodel, variables, model = inpainting_weights
    gt, mask = _inputs(5, (2, 16, 16, 3))
    key = jax.random.PRNGKey(8)
    jcfg, pcfg = _configs(method="ddpm", num_steps=6, injection=True)
    jsched, psched = _schedules()
    ref = np.asarray(jax.jit(lambda g, m: jax_inpaint_sample(
        lambda x, t, mi, mm: jmodel.apply(variables, x, t, mi, mm), jsched, jcfg,
        gt=g, mask=m, key=key))(jnp.asarray(gt), jnp.asarray(mask)))
    with torch.inference_mode():
        out = inpaint_sample(model, psched, pcfg, gt=torch.from_numpy(gt),
                             mask=torch.from_numpy(mask), noise=JaxKeyNoise(key)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.05  # the model reaches the hole
    # float32 UNets whose sums run in another order (test_torch_port_unet):
    # the DDIM and DPM pipeline tests' bound
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_sample_through_base_unet_matches_jax():
    """`sample()` on the 3-channel base UNet (6 output channels, learned
    range variance), UniPC with its trajectory."""
    s = SMALL["image_size"]
    base = dict(SMALL, in_channels=3)
    jcfg = JaxUNetConfig(**base, dtype=jnp.float32)
    v = drawn_jax_variables(JaxUNet, jcfg, 7, np.zeros((1, s, s, 3), np.float32),
                            np.zeros((1,), np.int32))
    model = UNet(UNetConfig(**base, dtype=torch.float32)).eval()
    model.load_state_dict(state_dict_from_jax(v, model.config), strict=True)
    variables = jax.tree_util.tree_map(jnp.asarray, v)
    key = jax.random.PRNGKey(9)
    jscfg, pscfg = _configs(method="unipc", num_steps=5, trajectory_every=2)
    jsched, psched = _schedules("linear", 1000)
    ref, ref_traj = jax.jit(lambda k: jax_sample(
        lambda x, t: JaxUNet(jcfg).apply(variables, x, t), jsched, jscfg,
        shape=(2, s, s, 3), key=k))(key)
    with torch.inference_mode():
        out, traj = sample(model, psched, pscfg, shape=(2, s, s, 3), noise=JaxKeyNoise2(key))
    assert np.abs(np.asarray(ref)).max() > 0.3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=2e-4, rtol=0)


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("method", ["repaint", "consistency"])
def test_strength_refused_for_repaint_and_consistency(method):
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    cfg = SamplerConfig(method=method, num_steps=4, strength=0.5)
    with pytest.raises(ValueError, match="strength < 1 is defined for ddim/ddpm/dpm"):
        inpaint_sample(stub_model(torch), sched, cfg, gt=gt, mask=mask,
                       noise=port_sampler.GeneratorNoise(0, "cpu"))
    with pytest.raises(ValueError, match="strength < 1 is defined for ddim/ddpm/dpm"):
        sample(stub_base_model(torch), sched, cfg, shape=SHAPE, x_init=gt,
               noise=port_sampler.GeneratorNoise(0, "cpu"))


def test_repaint_refuses_feature_caching_and_runs_no_model_on_renoise_rows():
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    cfg = SamplerConfig(method="repaint", num_steps=6, jump_length=2, jump_n_sample=3)
    with pytest.raises(ValueError, match="encoder_cache_period"):
        inpaint_sample(stub_model(torch), sched,
                       dataclasses.replace(cfg, encoder_cache_period=2, cache_branch=-1),
                       gt=gt, mask=mask, noise=port_sampler.GeneratorNoise(0, "cpu"))
    calls = []

    def counted(x, t, mi, m):
        calls.append(int(t[0]))
        return stub_model(torch)(x, t, mi, m)

    inpaint_sample(counted, sched, cfg, gt=gt, mask=mask,
                   noise=port_sampler.GeneratorNoise(0, "cpu"))
    tables = port_sampler._repaint_tables(sched, cfg)
    assert calls == [int(t) for t in tables["t"][tables["is_denoise"] > 0]]
    assert len(calls) < len(tables["t"])
