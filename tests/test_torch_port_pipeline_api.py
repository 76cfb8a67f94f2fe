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
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu import InpaintingPipeline as JaxPipeline
from fidm_tpu import PipelineConfig as JaxPipelineConfig
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models import InpaintingUNet
from fidm_tpu_torch.models.layers import ResBlock
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import SamplerConfig

from _torch_port_common import JCFG, PCFG, SMALL, drawn_jax_variables

S = SMALL["image_size"]
DDIM = SamplerConfig(method="ddim", num_steps=5, eta=0.9, injection=True)
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX model's variables drawn from numpy (no init compile): every
    output conv nonzero."""
    dummy = (np.zeros((1, S, S, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, S, S, 3), np.float32), np.zeros((1, S, S, 1), np.float32))
    return drawn_jax_variables(JaxInpaintingUNet, JCFG, 0, *dummy)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, S, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, S, S, 3)).astype(np.float32)
    mask = np.zeros((b, S, S, 1), np.float32)
    mask[:, 4:12, 3:10] = 1.0
    t = np.array([7, 640, 300][:b], np.int32)
    return x, t, gt, mask


def _port_model(jax_variables, cfg=PCFG):
    model = InpaintingUNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    return model


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


def _jax_pipeline(variables, jcfg):
    return JaxPipeline(JaxInpaintingUNet(jcfg), jax.tree_util.tree_map(jnp.asarray, variables),
                       JaxSchedule.create("linear", 50), JaxPipelineConfig(unet=jcfg))


# One bf16 forward of the cast model, port against JAX, max abs over max
# |JAX|: both take the same bf16 weights and round activations to bf16, with
# sums in another order (XLA's and oneDNN's) and GroupNorm's normalisation in
# float32 in the port, in bf16 in JAX; this 16² model read 2.4e-2 in a CPU
# run. The bound is twice that, the bf16 bound of the port's other forward
# tests (5e-2).
CAST_FORWARD_TOL = 5e-2


def test_cast_params_matches_jax(jax_variables):
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    config = PipelineConfig(unet=dataclasses.replace(PCFG, dtype=torch.bfloat16),
                            schedule="linear",
                            num_timesteps=50, sampler=DDIM)
    port = InpaintingPipeline.create(config, device="cpu")
    port.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    port.install_program(2, DDIM, port.compile_batch(2))
    assert port.cast_params(torch.bfloat16) is port
    assert port.installed_program(2, DDIM) is None  # every program dropped
    jax_pipe = _jax_pipeline(jax_variables, jcfg).cast_params(jnp.bfloat16)
    jax_cast = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                      jax_pipe.variables)
    ours = port.model.state_dict()
    assert all(t.dtype == torch.bfloat16 for t in ours.values())
    for key, ref in state_dict_from_jax(jax_cast, PCFG).items():
        assert torch.equal(ours[key].float(), ref), key

    x, t, gt, mask = _inputs(4)
    masked = gt * (1.0 - mask)
    want = np.asarray(jax.jit(jax_pipe.model.apply)(jax_pipe.variables, x, t, masked, mask),
                      np.float32)
    with torch.no_grad():
        got = port.model(*(torch.from_numpy(a) for a in (x, t, masked, mask))).numpy()
    assert got.dtype == np.float32  # the final conv stays float32
    assert np.abs(got - want).max() / np.abs(want).max() <= CAST_FORWARD_TOL
    # a cast pipeline still samples, eagerly and through a new program
    eager = port.inpaint(gt, mask, 1)
    port.install_program(2, DDIM, port.compile_batch(2))
    assert torch.equal(port.inpaint(gt, mask, 1), eager)
    keep = torch.from_numpy(mask[..., 0] < 0.5)
    assert torch.equal(eager[keep], torch.from_numpy(gt)[keep])


# ---------------------------------------------------------- split decoder skips


@pytest.fixture(scope="module")
def split_outputs(jax_variables):
    """The JAX split forward, and the port's split and concatenating
    forwards, in float32 on the same inputs."""
    x, t, gt, mask = _inputs(2)
    masked = gt * (1.0 - mask)
    jcfg = dataclasses.replace(JCFG, split_decoder_skips=True)
    with jax.default_matmul_precision("highest"):
        jax_split = np.asarray(JaxInpaintingUNet(jcfg).apply(jax_variables, x, t, masked, mask))
    outs = {}
    for split in (False, True):
        model = _port_model(jax_variables, dataclasses.replace(PCFG, split_decoder_skips=split))
        with torch.no_grad():
            outs[split] = model(*(torch.from_numpy(a) for a in (x, t, masked, mask))).numpy()
    return jax_split, outs[True], outs[False]


def test_split_decoder_skips_matches_jax(split_outputs):
    """float32, 1e-5: the same one-pass statistics and half-kernel sums,
    in another order."""
    jax_split, split, _ = split_outputs
    assert np.abs(split - jax_split).max() <= 1e-5


def test_split_decoder_skips_matches_concat_path(split_outputs):
    """The concatenation-free decoder computes the concatenating one's
    function: float32 sums in another order (1e-5 of outputs near 1)."""
    _, split, concat = split_outputs
    assert np.abs(split - concat).max() <= 1e-5
    assert not np.array_equal(split, concat)  # the split path really ran


def test_split_decoder_skips_bf16_close(jax_variables):
    """bf16 activations: the split path normalises each half in bf16 where
    GroupNorm32 does it in float32; 5e-2, the JAX package's own bound
    (tests/test_unet.py)."""
    x, t, gt, mask = _inputs(5)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    cfg = dataclasses.replace(PCFG, dtype=torch.bfloat16)
    with torch.no_grad():
        a, b = (_port_model(jax_variables, dataclasses.replace(cfg, split_decoder_skips=s))(*args)
                for s in (False, True))
    assert (a - b).abs().max().item() <= 5e-2


def test_split_decoder_skips_keeps_the_state_dict(jax_variables):
    """The same modules either way: identical keys and shapes, and either
    model loads the other's state dict with strict=True."""
    on = InpaintingUNet(dataclasses.replace(PCFG, split_decoder_skips=True))
    off = InpaintingUNet(PCFG)
    assert {k: v.shape for k, v in on.state_dict().items()} == {
        k: v.shape for k, v in off.state_dict().items()}
    on.load_state_dict(off.state_dict(), strict=True)
    off.load_state_dict(on.state_dict(), strict=True)


def test_split_skip_rules(jax_variables):
    """Plain blocks only; an identity residual takes the concatenation, so
    its output is the concatenating call's bit for bit."""
    torch.manual_seed(0)
    up = ResBlock(32, 64, 32, up=True)
    h, skip, emb = torch.randn(1, 16, 4, 4), torch.randn(1, 16, 4, 4), torch.randn(1, 64)
    with pytest.raises(ValueError, match="plain blocks"):
        up(h, emb, skip=skip)
    same = ResBlock(32, 64, 32)
    with torch.no_grad():
        assert torch.equal(same(h, emb, skip=skip), same(torch.cat([h, skip], 1), emb))


@pytest.mark.parametrize("depth", [None, 1], ids=["encoder", "branch1"])
def test_split_decoder_skips_with_the_feature_cache(jax_variables, depth):
    """Key and cached calls of the split model: the key call's output is its
    plain forward's, and a cached call at the key call's (x, t) gives it bit
    for bit; both within float32 reassociation of the concatenating model's."""
    x, t, gt, mask = _inputs(6)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    split = _port_model(jax_variables, dataclasses.replace(PCFG, split_decoder_skips=True))
    concat = _port_model(jax_variables)
    with torch.no_grad():
        plain = split(*args)
        key_out, cache = split(*args, return_cache=True, cache_depth=depth)
        cached = split(*args, cache=cache, cache_depth=depth)
        ref_key, ref_cache = concat(*args, return_cache=True, cache_depth=depth)
        ref_cached = concat(*args, cache=ref_cache, cache_depth=depth)
    assert torch.equal(key_out, plain) and torch.equal(cached, plain)
    assert (key_out - ref_key).abs().max().item() <= 1e-5
    assert (cached - ref_cached).abs().max().item() <= 1e-5


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_split_decoder_skips_under_remat(jax_variables, policy):
    """Remat of the split model recomputes the same function: loss and every
    gradient bit-equal to the split model without remat."""
    x, t, gt, mask = _inputs(7)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(PCFG, split_decoder_skips=True, remat=remat,
                                  remat_policy=policy)
        model = _port_model(jax_variables, cfg).train()
        loss = model(*args).square().mean()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
