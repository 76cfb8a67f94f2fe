"""The port's DPM-Solver++(2M) samplers, refinement and per-row seeds against
the JAX package.

Tables: `_dpm_tables` is the same float64 numpy code on both sides and must be
bit-equal. Trajectories: both samplers run one model function on the same
numpy inputs, and the port is fed the very noise the JAX sampler draws from
its key (`JaxKeyNoise`), a single key or a batched [B, 2] one, so the two runs
differ only by float32 rounding. Per-row seeds: row i of a batched run is
bit-equal to the batch-1 run with seed i.
"""
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
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu.serving.server import _request_keys
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import GeneratorNoise, SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import JCFG, PCFG, JaxKeyNoise, perturbed_jax_variables
from _torch_port_common import stub_model as _model

SHAPE = (2, 8, 8, 3)
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


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    return gt, mask


def _rowwise_model(x, t, masked_image, mask):
    """A stand-in whose every output element depends on its own pixel only,
    so that a batch's rows cannot differ from batch-1 runs by the order of a
    reduction."""
    h = torch.tanh(0.7 * x - 0.4 * masked_image + 0.3 * mask
                   + (t.float() / 1000.0)[:, None, None, None])
    return torch.cat([h, 0.1 * x], -1)


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


@pytest.mark.parametrize("stream,index", [(0, 0), (1, 7), (2, 990)])
def test_single_seed_stream_is_unchanged(stream, index):
    """One int seed keeps the stream of the earlier slices: draw (stream,
    index) is torch.randn of the whole shape from a Generator seeded by
    SeedSequence([seed, stream, index])."""
    shape = (2, 4, 4, 3)
    noise = GeneratorNoise(5, "cpu")
    got = (noise.init, lambda s: noise.step(index, s), lambda s: noise.inject(index, s))[stream](shape)
    state = np.random.SeedSequence([5, stream, index]).generate_state(1, np.uint64)[0]
    assert torch.equal(got, torch.randn(shape, generator=torch.Generator().manual_seed(int(state))))


@pytest.mark.parametrize("stream", ["init", "step", "inject"])
def test_per_row_draws_equal_batch1_draws(stream):
    seeds = [5, 77, 2**32 - 1]
    shape = (3, 4, 4, 3)
    draw = lambda noise, s: (noise.init(s) if stream == "init" else
                             getattr(noise, stream)(990, s))
    rows = draw(GeneratorNoise(seeds, "cpu"), shape)
    for i, seed in enumerate(seeds):
        assert torch.equal(rows[i:i + 1], draw(GeneratorNoise(seed, "cpu"), (1,) + shape[1:]))
    assert not torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("method", ["ddim", "dpm++2m-sde"])
def test_per_row_seed_runs_equal_batch1_runs(method):
    """The serving determinism contract: row i of a batch-3 run is bit-equal
    to the batch-1 run with seed i."""
    gt, mask = _inputs(2, (3, 8, 8, 3))
    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    cfg = SamplerConfig(method=method, num_steps=10, eta=0.9)
    seeds = [5, 77, 901]
    run = lambda sl, s: inpaint_sample(_rowwise_model, sched, cfg, gt=torch.from_numpy(gt[sl]),
                                       mask=torch.from_numpy(mask[sl]),
                                       noise=GeneratorNoise(s, "cpu"))
    batched = run(slice(None), seeds)
    for i, seed in enumerate(seeds):
        assert torch.equal(batched[i:i + 1], run(slice(i, i + 1), seed))
    hole = mask[0, ..., 0] > 0.5
    assert not torch.equal(batched[0][hole], batched[1][hole])


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables()


@pytest.fixture(scope="module")
def pipe(jax_variables):
    p = InpaintingPipeline.create(PipelineConfig(unet=PCFG), device="cpu")
    p.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    return p


def test_one_element_seed_sequence_equals_int_seed(pipe):
    gt, mask = _inputs(3, (1, 16, 16, 3))
    cfg = SamplerConfig(method="dpm++2m-sde", num_steps=4)
    assert torch.equal(pipe.inpaint(gt, mask, [7], sampler=cfg),
                       pipe.inpaint(gt, mask, 7, sampler=cfg))


def test_seed_sequence_length_mismatch_raises(pipe):
    gt, mask = _inputs(3, (2, 16, 16, 3))
    with pytest.raises(ValueError, match="seed batch 3 != input batch 2"):
        pipe.inpaint(gt, mask, [1, 2, 3], sampler=SamplerConfig(method="dpm++2m-sde",
                                                               num_steps=4))
    with pytest.raises(ValueError, match="non-negative"):
        pipe.inpaint(gt, mask, [1, -2])


@pytest.mark.parametrize("strength", [None, 0.5])
def test_pipeline_dpm_sde_matches_jax(pipe, jax_variables, strength):
    """The slice as a whole: the UNet on the same weights, inputs and noise
    through the JAX pipeline and the port, DPM-Solver++(2M) SDE with
    post-step injection, whole and as refinement (the pipeline's
    `strength` overriding the preset's)."""
    gt, mask = _inputs(4, (2, 16, 16, 3))
    sampler = dict(method="dpm++2m-sde", num_steps=6, injection=True)
    key = jax.random.PRNGKey(8)
    ref_pipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG), jax.tree_util.tree_map(jnp.asarray, jax_variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG, sampler=JaxSamplerConfig(**sampler)))
    ref = np.asarray(ref_pipe.inpaint(jnp.asarray(gt), jnp.asarray(mask), key,
                                      strength=strength))
    out = pipe.inpaint(gt, mask, 0, SamplerConfig(**sampler), strength=strength,
                       noise=JaxKeyNoise(key)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.05  # the model reaches the hole
    # float32 UNets whose sums run in another order (test_torch_port_unet);
    # the same bound as the DDIM pipeline test
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(out[~hole], gt[~hole])
