"""Per-row seeds of the port's samplers and pipeline: row i of a batched run is
bit-equal to the batch-1 run with seed i, a one-element seed sequence is the
integer seed, and the pipeline's DPM-Solver++(2M) SDE run matches the JAX
pipeline's on the same UNet weights and noise.
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
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import GeneratorNoise, SamplerConfig, inpaint_sample

from _torch_port_common import (  # noqa: F401
    JCFG,
    JaxKeyNoise,
    PCFG,
    one_torch_thread,
    perturbed_jax_variables,
)
from _torch_port_dpm_common import _inputs


def _rowwise_model(x, t, masked_image, mask):
    """A stand-in whose every output element depends on its own pixel only,
    so that a batch's rows cannot differ from batch-1 runs by the order of a
    reduction."""
    h = torch.tanh(0.7 * x - 0.4 * masked_image + 0.3 * mask
                   + (t.float() / 1000.0)[:, None, None, None])
    return torch.cat([h, 0.1 * x], -1)


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
