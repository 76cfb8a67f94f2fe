"""The pipeline's program API, `cast_params` and `split_decoder_skips` of the
port against the JAX package.

- Programs (`compile_batch`, `install_program`, dispatch in `inpaint`): on the
  CPU a program runs the eager call over its static buffers, the path that
  fills and reads them on the card too; it must give the eager call's output
  bit for bit for every kind of sampler, and row i of a per-row-seed program
  the batch-1 run with seed i.
- `cast_params(torch.bfloat16)` against the JAX pipeline's `cast_params`:
  the cast weights bit-equal, one bf16 forward within a stated bound.
- `UNetConfig.split_decoder_skips` against the JAX split forward on the
  same perturbed weights (float32, 1e-5), against the port's concatenating
  forward, and with the feature cache and remat.

Torch and BLAS run one thread here: the test run shares the CPU between its
workers. The JAX forwards compile once per module.

`cast_params` and `split_decoder_skips` are in
`test_torch_port_pipeline_api_params.py`: port test files hold at most 25
cases (ROADMAP.md).
"""
import dataclasses

import pytest
import torch

from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import SamplerConfig

from _torch_port_common import JCFG, PCFG, one_torch_thread  # noqa: F401
from _torch_port_pipeline_api_common import (  # noqa: F401
    S,
    DDIM,
    jax_variables,
    _inputs,
    _jax_pipeline,
)


# every kind of call a program may hold: each method family, the feature
# cache (DeepCache branch and output reuse), repaint's revisited injection
# draws, a trajectory (a tuple output), refinement, uint8 output
SAMPLERS = {
    "ddim": DDIM,
    "dpm++2m-sde": SamplerConfig(method="dpm++2m-sde", num_steps=5, injection=True),
    "unipc": SamplerConfig(method="unipc", num_steps=4, injection=True),
    "ddpm": SamplerConfig(method="ddpm", num_steps=4, injection=True),
    "deepcache": SamplerConfig(method="ddim", num_steps=8, eta=0.9, injection=True,
                               encoder_cache_period=2, cache_branch=1, encoder_cache_tail=2),
    "output_reuse": SamplerConfig(method="dpm++2m", num_steps=6, injection=True,
                                  encoder_cache_period=2, cache_branch=-1),
    "repaint": SamplerConfig(method="repaint", num_steps=4, jump_length=2, jump_n_sample=2,
                             injection=True),
    "trajectory": dataclasses.replace(DDIM, trajectory_every=2),
    "refine": dataclasses.replace(DDIM, strength=0.5),
    "uint8": dataclasses.replace(DDIM, output_dtype="uint8"),
}


@pytest.fixture(scope="module")
def pipe(jax_variables):
    config = PipelineConfig(unet=PCFG, schedule="linear", num_timesteps=50, sampler=DDIM)
    p = InpaintingPipeline.create(config, device="cpu")
    p.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    return p


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


# ------------------------------------------------------------------ programs


@pytest.mark.parametrize("batched", [False, True], ids=["one_seed", "per_row_seeds"])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_program_call_is_the_eager_call(pipe, name, batched):
    """An installed program takes `inpaint`'s call and gives the eager
    output bit for bit; uninstalled, the call runs eagerly again."""
    cfg = SAMPLERS[name]
    _, _, gt, mask = _inputs(1)
    seed = [3, 11] if batched else 3
    ref = pipe.inpaint(gt, mask, seed, sampler=cfg)
    program = pipe.compile_batch(2, cfg, batched_key=batched)
    pipe.install_program(2, cfg, program, batched_key=batched)
    try:
        assert pipe.installed_program(2, cfg, batched) is program
        calls = []
        run = program._run
        program._run = lambda noise: calls.append(1) or run(noise)
        out = pipe.inpaint(gt, mask, seed, sampler=cfg)
        assert calls == [1]
        assert _equal(out, ref)
        # a second call refills every buffer: another seed, another image
        other = pipe.inpaint(gt, mask, [4, 12] if batched else 4, sampler=cfg)
        assert calls == [1, 1]
        images = other[0] if isinstance(other, tuple) else other
        assert not torch.equal(images, ref[0] if isinstance(ref, tuple) else ref)
    finally:
        assert pipe.uninstall_program(2, cfg, batched_key=batched)
    assert pipe.installed_program(2, cfg, batched) is None
    assert not pipe.uninstall_program(2, cfg, batched_key=batched)


def test_dispatch_takes_exact_matches_only(pipe):
    """Another batch, seed layout, sampler or a `cond_fn` runs eagerly; a
    `GeneratorNoise` passed as `noise` counts as its seed, any other noise
    source runs eagerly."""
    from fidm_tpu_torch.sampling import GeneratorNoise

    _, _, gt, mask = _inputs(2)
    program = pipe.compile_batch(2, DDIM)
    calls = []
    run = program._run
    program._run = lambda noise: calls.append(1) or run(noise)
    pipe.install_program(2, DDIM, program)
    try:
        pipe.inpaint(gt[:1], mask[:1], 0)
        pipe.inpaint(gt, mask, [0, 1])
        pipe.inpaint(gt, mask, 0, sampler=dataclasses.replace(DDIM, eta=0.5))
        pipe.inpaint(gt, mask, 0, cond_fn=lambda x, t: torch.zeros_like(x))
        pipe.inpaint(gt, mask, 0, noise=_Noise(GeneratorNoise(0, "cpu")))
        assert calls == []
        via_noise = pipe.inpaint(gt, mask, 0, noise=GeneratorNoise(5, "cpu"))
        assert calls == [1]
        assert torch.equal(via_noise, pipe.inpaint(gt, mask, 5))
    finally:
        pipe.uninstall_program(2, DDIM)
    with pytest.raises(ValueError, match="one seed"):
        program(torch.from_numpy(gt), torch.from_numpy(mask), [0, 1])


class _Noise:
    """A noise source that is not a GeneratorNoise, with its draws."""

    def __init__(self, noise):
        self.init, self.step, self.inject = noise.init, noise.step, noise.inject


def test_program_per_row_seeds_equal_batch1_runs():
    """The program's RNG contract: row i of a per-row-seed program is
    bit-equal to the batch-1 run with seed i. ADM's zero-initialised output
    convs make the model's output 0 at any batch size, so that the rows
    depend on their seeds' noise alone (as tests/test_torch_port_serving.py's
    zero pipeline)."""
    config = PipelineConfig(unet=PCFG, schedule="linear", num_timesteps=50,
                            sampler=SAMPLERS["dpm++2m-sde"])
    zero = InpaintingPipeline.create(config, device="cpu")
    _, _, gt, mask = _inputs(3, b=3)
    seeds = [5, 77, 2**32 - 1]
    zero.install_program(3, config.sampler, zero.compile_batch(3, batched_key=True),
                         batched_key=True)
    rows = zero.inpaint(gt, mask, seeds)
    for i, seed in enumerate(seeds):
        assert torch.equal(rows[i:i + 1], zero.inpaint(gt[i:i + 1], mask[i:i + 1], [seed]))
    hole = torch.from_numpy(mask[0, ..., 0] > 0.5)
    assert not torch.equal(rows[0][hole], rows[1][hole])


def test_program_holds_its_draws_and_launch_counts(pipe):
    """One buffer per draw the call makes (DDIM with injection: the initial
    state, the noise of every step with a nonzero gate, the injection noise
    of every injected level), no graph and no launches on the CPU."""
    from fidm_tpu_torch.sampling.sampler import _ddim_tables

    program = pipe.compile_batch(2, DDIM)
    tables = _ddim_tables(pipe.sched, DDIM)
    injected = {int(t) for t, g in zip(tables["inject_t"], tables["inject_gate"]) if g > 0}
    expect = 1 + int((tables["noise_gate"] > 0).sum()) + len(injected)
    assert len(program.draws) == expect
    assert {s for s, _ in program.draws} == {0, 1, 2}
    assert all(b.shape == (2, S, S, 3) for b in program.draws.values())
    assert program.graph is None and not program.launches
    assert program.static_bytes >= expect * 2 * S * S * 3 * 4


# ------------------------------------------------------- example_inputs, cast


@pytest.mark.parametrize("batched", [False, True], ids=["one_seed", "per_row_seeds"])
def test_example_inputs_match_jax(jax_variables, pipe, batched):
    jax_pipe = _jax_pipeline(jax_variables, JCFG)
    jgt, jmask, jkey = jax_pipe.example_inputs(3, batched_key=batched)
    gt, mask, seed = pipe.example_inputs(3, batched_key=batched)
    assert tuple(gt.shape) == jgt.shape and tuple(mask.shape) == jmask.shape
    assert gt.dtype == torch.float32 and str(jgt.dtype) == "float32"
    assert gt.device == mask.device == pipe.device
    # JAX: one key, or a [B, 2] row of keys; the port: one seed, or B seeds
    assert (jkey.shape == (3, 2)) == batched == isinstance(seed, list)
    if batched:
        assert seed == [0, 1, 2]
