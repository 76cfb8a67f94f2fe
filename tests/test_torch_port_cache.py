"""The port's feature caching (encoder reuse, DeepCache deep-trunk reuse and
output reuse) against the JAX package's.

UNet: a four-level float32 model, so that branches 1, 2 and 3 are all valid
and branch 3's cached call runs attention; JAX parameters with every leaf
perturbed go through `state_dict_from_jax`. The port's cache is NCHW, JAX's
NHWC: the tests permute one into the other. Trajectories: both samplers run
one cheap cache-aware model with a `cache_apply` pair built as the JAX
pipeline's `_make_jit` builds it, and the port is fed the very noise the JAX
sampler draws (`JaxKeyNoise`), so the runs differ only by float32 rounding.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu import pipeline as jax_pipeline
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import UNetConfig
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler
from fidm_tpu_torch.serving import InpaintingServer

from _torch_port_common import JaxKeyNoise, perturbed_jax_variables

FOUR = dict(image_size=32, in_channels=9, model_channels=32, out_channels=6,
            num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 1, 2, 2),
            num_heads=4, num_head_channels=32)
JCFG4 = JaxUNetConfig(**FOUR, dtype=jnp.float32)
PCFG4 = UNetConfig(**FOUR, dtype=torch.float32)
MODES = [None, 1, 2, 3]
MODE_IDS = ["encoder", "b1", "b2", "b3"]
CACHED_PRESETS = ("ddim-100-deep", "ddim-100-turbo", "ddim-20-fast", "dpm-20-fast")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny, and the test run shares the CPU between its
    workers, where torch's default pool of one thread per core spins against
    the other workers (a 101-step preset took 125 s instead of 18): one
    intra-op thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables(JCFG4)


@pytest.fixture(scope="module")
def pipe(jax_variables):
    p = InpaintingPipeline.create(PipelineConfig(unet=PCFG4), device="cpu")
    p.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG4), strict=True)
    return p


def _unet_inputs(seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 8:24, 6:20] = 1.0
    t = np.array([7, 640][:b], np.int32)
    return x, t, gt * (1.0 - mask), mask


def _flat(cache, depth):
    """The cache's tensors in order: (h_mid, *skips) or the one trunk feature."""
    return [cache[0], *cache[1]] if depth is None else [cache]


def _to_port_cache(jax_cache, depth):
    nchw = [torch.from_numpy(np.array(a)).permute(0, 3, 1, 2) for a in _flat(jax_cache, depth)]
    return (nchw[0], tuple(nchw[1:])) if depth is None else nchw[0]


def _jax_apply(variables, *args, **kw):
    return jax.jit(functools.partial(JaxInpaintingUNet(JCFG4).apply, **kw))(variables, *args)


# float32 on both sides, conv sums in another order: the model outputs (about
# 2 at most) hold 1e-5. The published features reach about 10, where one
# float32 ulp is about 1e-6, so their bound is 1e-5 of the tensor's largest
# magnitude.
def _close_features(ours, ref, tol=1e-5):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(ours) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


@pytest.mark.parametrize("depth", MODES, ids=MODE_IDS)
def test_published_cache_matches_jax(pipe, jax_variables, depth):
    x, t, mi, m = _unet_inputs(2)
    ref_out, ref_cache = _jax_apply(jax_variables, x, t, mi, m, return_cache=True,
                                    cache_depth=depth)
    with torch.no_grad():
        out, cache = pipe.model(*(torch.from_numpy(a) for a in (x, t, mi, m)),
                                return_cache=True, cache_depth=depth)
    ours, ref = _flat(cache, depth), _flat(ref_cache, depth)
    assert len(ours) == len(ref) == (9 if depth is None else 1)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and a.permute(0, 2, 3, 1).shape == b.shape
        _close_features(a.permute(0, 2, 3, 1).numpy(), b)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=0)


@pytest.mark.parametrize("depth", MODES, ids=MODE_IDS)
def test_cached_forward_on_jax_cache_matches_jax(pipe, jax_variables, depth):
    """JAX's cache from a key call, then a cached call at other timesteps and
    another x on both sides."""
    x, t, mi, m = _unet_inputs(3)
    _, jax_cache = _jax_apply(jax_variables, x, t, mi, m, return_cache=True, cache_depth=depth)
    x2 = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    t2 = np.array([300, 20], np.int32)
    ref = _jax_apply(jax_variables, x2, t2, mi, m, cache=jax_cache, cache_depth=depth)
    with torch.no_grad():
        out = pipe.model(*(torch.from_numpy(a) for a in (x2, t2, mi, m)),
                         cache=_to_port_cache(jax_cache, depth), cache_depth=depth)
    assert np.abs(np.asarray(ref)).max() > 0.1  # the perturbed output convs are live
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("depth", MODES, ids=MODE_IDS)
def test_cached_forward_at_the_key_inputs_is_the_plain_forward(pipe, depth):
    """The same kernels on the same tensors: a key call and a cached call at
    its (x, t) give the plain forward bit for bit; a second cached call on
    the same cache too (the decoder does not consume the stored skips)."""
    args = [torch.from_numpy(a) for a in _unet_inputs(5)]
    with torch.no_grad():
        plain = pipe.model(*args)
        key, cache = pipe.model(*args, return_cache=True, cache_depth=depth)
        first = pipe.model(*args, cache=cache, cache_depth=depth)
        second = pipe.model(*args, cache=cache, cache_depth=depth)
    assert torch.equal(key, plain) and torch.equal(first, plain) and torch.equal(second, plain)
    if depth is None:
        assert len(cache[1]) == len(pipe.model.input_blocks) == 8


@pytest.mark.parametrize("depth", [0, 4, -1])
def test_bad_cache_depth_raises(pipe, jax_variables, depth):
    args = _unet_inputs(6)
    with pytest.raises(ValueError, match=r"cache_depth must be in \[1, 3\]"):
        pipe.model(*(torch.from_numpy(a) for a in args), return_cache=True, cache_depth=depth)
    with pytest.raises(ValueError, match=r"cache_depth must be in \[1, 3\]"):
        JaxInpaintingUNet(JCFG4).apply(jax_variables, *args, return_cache=True,
                                       cache_depth=depth)


def _same_outcome(ours, ref):
    """ours() and ref() return equal values, or raise ValueError with the same
    message."""
    try:
        expect = ref()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours()
        assert str(got.value) == str(e)
        return
    got = ours()
    assert got == expect if isinstance(expect, tuple) else np.array_equal(got, expect)


@pytest.mark.parametrize("K", [1, 10, 21, 101])
@pytest.mark.parametrize("period,tail,keysteps", [
    (2, 0, None), (3, 10, None), (2, 4, None), (3, 0, None), (5, 200, None),
    (2, 0, (0, 3, 7, 9)), (3, 0, (0,)), (2, 0, (1, 2)), (2, 0, (0, 5, 5)),
    (2, 0, (0, 20)), (2, 0, ()), (2, 0, (0, 4, 2)),
])
def test_keymask_matches_jax(K, period, tail, keysteps):
    kw = dict(encoder_cache_period=period, encoder_cache_tail=tail, cache_keysteps=keysteps)
    _same_outcome(lambda: port_sampler._cache_keymask(SamplerConfig(**kw), K),
                  lambda: jax_sampler._cache_keymask(JaxSamplerConfig(**kw), K))


@pytest.mark.parametrize("K,n_key,center,power", [
    (101, 41, 0.5, 1.2), (101, 17, 1.0, 2.0), (21, 13, 0.0, 0.7), (10, 10, 0.3, 1.0),
    (101, 1, 0.5, 1.2), (10, 0, 0.5, 1.2), (10, 11, 0.5, 1.2), (10, 3, 1.5, 1.2),
    (10, 3, 0.5, 0.0),
])
def test_nonuniform_keysteps_matches_jax(K, n_key, center, power):
    kw = dict(center=center, power=power)
    _same_outcome(lambda: port_sampler.nonuniform_keysteps(K, n_key, **kw),
                  lambda: jax_sampler.nonuniform_keysteps(K, n_key, **kw))


@pytest.mark.parametrize("spec", ["0,3,7,12", " 17@1.0:2.0 ", "9@0.5", "5@0.2:0.8", "30@0.5"])
def test_keysteps_from_spec_matches_jax(spec):
    _same_outcome(lambda: port_sampler.keysteps_from_spec(spec, 21),
                  lambda: jax_sampler.keysteps_from_spec(spec, 21))


def _cache_model(xp):
    """A cheap cache-aware stand-in for the UNet: the "trunk" feature mixes
    pixels (the image mean) and depends on the cache depth, so that each
    branch and each key grid gives its own trajectory; a cached call reuses
    the trunk and recomputes the rest from the fresh x and t."""
    torch_side = xp is torch

    def apply(x, t, masked_image, mask, cache=None, return_cache=False, cache_depth=None):
        tt = t.float() if torch_side else t.astype(jnp.float32)
        if cache is None:
            mean = (x.mean(dim=(1, 2), keepdim=True) if torch_side
                    else x.mean(axis=(1, 2), keepdims=True))
            scale = 1.0 if cache_depth is None else 1.0 + 0.25 * cache_depth
            trunk = xp.tanh(scale * (0.7 * x + 2.0 * mean) - 0.4 * masked_image + 0.3 * mask)
        else:
            trunk = cache
        h = xp.tanh(trunk + 0.2 * x + (tt / 1000.0)[:, None, None, None])
        out = (torch.cat if torch_side else jnp.concatenate)([h, 0.1 * x], -1)
        return (out, trunk) if return_cache else out

    return apply


def _cache_apply(apply, cfg):
    """The (full_fn, cached_fn) pair as the JAX pipeline's `_make_jit` builds
    it: none for period <= 1 or output reuse, branch 0 is encoder mode."""
    if cfg.encoder_cache_period <= 1 or cfg.cache_branch == -1:
        return None
    depth = cfg.cache_branch or None
    return (lambda x, t, mi, m: apply(x, t, mi, m, return_cache=True, cache_depth=depth),
            lambda x, t, mi, m, cache: apply(x, t, mi, m, cache=cache, cache_depth=depth))


def _traj_inputs(seed, shape=(2, 8, 8, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    return gt, mask


CACHED_TRAJECTORIES = {
    "ddim-b0": dict(method="ddim", encoder_cache_period=3, cache_branch=0),
    "ddim-b1": dict(method="ddim", encoder_cache_period=3, cache_branch=1),
    "ddim-b2": dict(method="ddim", encoder_cache_period=3, cache_branch=2),
    "ddim-b3": dict(method="ddim", encoder_cache_period=3, cache_branch=3),
    "ddim-output-reuse": dict(method="ddim", encoder_cache_period=3, cache_branch=-1),
    "ddim-b2-tail": dict(method="ddim", encoder_cache_period=3, cache_branch=2,
                         encoder_cache_tail=3),
    "ddim-b1-keysteps": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                             cache_keysteps=(0, 3, 4, 8)),
    "ddim-b1-pre": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                        injection_point="pre"),
    "dpm++2m-b1": dict(method="dpm++2m", encoder_cache_period=2, cache_branch=1,
                       encoder_cache_tail=2),
    "dpm++2m-sde-b1": dict(method="dpm++2m-sde", encoder_cache_period=2, cache_branch=1),
    "ddim-b1-refine": dict(method="ddim", encoder_cache_period=2, cache_branch=1,
                           strength=0.5),
    "dpm++2m-sde-output-reuse": dict(method="dpm++2m-sde", encoder_cache_period=2,
                                     cache_branch=-1),
}


@pytest.mark.parametrize("name", list(CACHED_TRAJECTORIES))
def test_cached_trajectory_matches_jax(name):
    gt, mask = _traj_inputs(0)
    kw = dict(num_steps=9, eta=0.9, injection=True, **CACHED_TRAJECTORIES[name])
    key = jax.random.PRNGKey(3)
    jcfg, pcfg = JaxSamplerConfig(**kw), SamplerConfig(**kw)
    ref = np.asarray(jax_inpaint_sample(
        _cache_model(jnp), JaxSchedule.create("quadratic", 1000), jcfg,
        gt=jnp.asarray(gt), mask=jnp.asarray(mask), key=key,
        cache_apply=_cache_apply(_cache_model(jnp), jcfg)))
    out = inpaint_sample(
        _cache_model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"), pcfg,
        gt=torch.from_numpy(gt), mask=torch.from_numpy(mask), noise=JaxKeyNoise(key),
        cache_apply=_cache_apply(_cache_model(torch), pcfg))
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.1  # the run did something
    # the tolerance of the uncached trajectories (test_torch_port_dpm)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out.numpy()[~hole], gt[~hole])
    # and the cache mattered: the exact run (period 1) lands elsewhere
    exact = inpaint_sample(
        _cache_model(torch), DiffusionSchedule.create("quadratic", 1000, device="cpu"),
        dataclasses.replace(pcfg, encoder_cache_period=1, cache_branch=0, cache_keysteps=None),
        gt=torch.from_numpy(gt), mask=torch.from_numpy(mask), noise=JaxKeyNoise(key))
    assert np.abs(exact.numpy() - out.numpy())[hole].max() > 1e-3


@pytest.mark.parametrize("branch", [0, 2, -1])
def test_model_calls_follow_the_keymask(branch):
    """Key steps call full_fn (or, for output reuse, the model), the others
    cached_fn (or nothing); each cached call gets the last key step's cache."""
    gt, mask = (torch.from_numpy(a) for a in _traj_inputs(1))
    cfg = SamplerConfig(num_steps=20, eta=0.9, encoder_cache_period=3, cache_branch=branch,
                        encoder_cache_tail=4)
    calls = []
    model = _cache_model(torch)

    def apply_fn(*a):
        calls.append(("apply", None))
        return model(*a)

    def full_fn(x, t, mi, m):
        out, cache = model(x, t, mi, m, return_cache=True)
        calls.append(("full", cache))
        return out, cache

    def cached_fn(x, t, mi, m, cache):
        calls.append(("cached", cache))
        return model(x, t, mi, m, cache=cache)

    inpaint_sample(apply_fn, DiffusionSchedule.create("linear", 100, device="cpu"), cfg,
                   gt=gt, mask=mask, noise=port_sampler.GeneratorNoise(0, "cpu"),
                   cache_apply=(full_fn, cached_fn))
    is_key = port_sampler._cache_keymask(cfg, 21)
    assert is_key.sum() == 10  # steps 0, 3, ..., 15 and the tail 17-20
    if branch == -1:
        assert [c[0] for c in calls] == ["apply"] * int(is_key.sum())
        return
    assert [c[0] for c in calls] == ["full" if k else "cached" for k in is_key]
    last = None
    for kind, cache in calls:
        if kind == "full":
            last = cache
        else:
            assert cache is last


@pytest.mark.parametrize("kw", [
    dict(cache_keysteps=(0, 2)),
    dict(encoder_cache_period=2, cache_branch=1),
    dict(encoder_cache_period=2, cache_branch=-1, cache_keysteps=(1, 3)),
], ids=["keysteps-without-period", "no-cache-apply", "keysteps-without-step-0"])
def test_sampler_refuses_what_the_jax_sampler_refuses(kw):
    """Both samplers, called directly with no cache pair, raise the same
    ValueError for each config."""
    gt, mask = _traj_inputs(1)

    def ref():
        jax_inpaint_sample(_cache_model(jnp), JaxSchedule.create("linear", 50),
                           JaxSamplerConfig(num_steps=5, **kw), gt=jnp.asarray(gt),
                           mask=jnp.asarray(mask), key=jax.random.PRNGKey(0))

    def ours():
        inpaint_sample(_cache_model(torch), DiffusionSchedule.create("linear", 50, device="cpu"),
                       SamplerConfig(num_steps=5, **kw), gt=torch.from_numpy(gt),
                       mask=torch.from_numpy(mask), noise=port_sampler.GeneratorNoise(0, "cpu"))

    with pytest.raises(ValueError):  # the JAX sampler refuses it
        ref()
    _same_outcome(ours, ref)


VALIDATION = [
    dict(cache_keysteps=(0, 2)),
    dict(cache_branch=1),
    dict(cache_branch=-1),
    dict(encoder_cache_period=2, cache_branch=4),
    dict(encoder_cache_period=2, cache_branch=-2),
    dict(encoder_cache_period=2, cache_branch=3),
    dict(encoder_cache_period=2, cache_branch=-1),
    dict(encoder_cache_period=2, cache_keysteps=(0, 2)),
    dict(encoder_cache_period=1),
]


@pytest.mark.parametrize("kw", VALIDATION)
def test_validate_cache_cfg_matches_jax(pipe, jax_variables, kw):
    jpipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG4), jax_variables, JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG4))

    def ref():
        jpipe._validate_cache_cfg(JaxSamplerConfig(num_steps=4, **kw))
        return ()

    def ours():
        pipe._validate_cache_cfg(SamplerConfig(num_steps=4, **kw))
        return ()

    _same_outcome(ours, ref)
    try:
        ref()
    except ValueError:
        gt, mask = _traj_inputs(2, (1, 32, 32, 3))
        with pytest.raises(ValueError):  # inpaint validates before any step
            pipe.inpaint(gt, mask, 0, SamplerConfig(num_steps=4, **kw))


@pytest.mark.parametrize("name", CACHED_PRESETS)
def test_cached_presets_run_in_the_pipeline(pipe, name, monkeypatch):
    """The four cached presets run through `inpaint`, with a full forward on
    each key step of the keymask and a cached one (the preset's branch) on
    each other step."""
    cfg = SAMPLER_PRESETS[name]
    calls = []
    forward = pipe.model.forward

    def counted(*a, cache=None, return_cache=False, cache_depth=None):
        calls.append(("cached" if cache is not None else "full", cache_depth))
        return forward(*a, cache=cache, return_cache=return_cache, cache_depth=cache_depth)

    monkeypatch.setattr(pipe.model, "forward", counted)
    gt, mask = _traj_inputs(7, (1, 32, 32, 3))
    out = pipe.inpaint(gt, mask, 0, sampler=cfg)
    tables = (port_sampler._ddim_tables if cfg.method == "ddim"
              else port_sampler._dpm_tables)(pipe.sched, cfg)
    is_key = port_sampler._cache_keymask(cfg, len(tables["t"]))
    assert (len(is_key), int(is_key.sum())) == {
        "ddim-100-deep": (101, 41), "ddim-100-turbo": (101, 34),
        "ddim-20-fast": (21, 13), "dpm-20-fast": (21, 13)}[name]
    assert calls == [("full" if k else "cached", cfg.cache_branch) for k in is_key]
    hole = mask[..., 0] > 0.5
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
    np.testing.assert_array_equal(out.numpy()[~hole], gt[~hole])


def test_pipeline_cached_preset_matches_jax(pipe, jax_variables):
    """The slice as a whole: the UNet on the same weights, inputs and noise
    through the JAX pipeline and the port, DDIM with DeepCache branch 2 and
    an exact tail, as `ddim-100-deep` at fewer steps."""
    gt, mask = _traj_inputs(4, (2, 32, 32, 3))
    sampler = dict(method="ddim", num_steps=6, eta=0.9, injection=True,
                   encoder_cache_period=3, cache_branch=2, encoder_cache_tail=2)
    key = jax.random.PRNGKey(8)
    ref_pipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG4), jax.tree_util.tree_map(jnp.asarray, jax_variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG4, sampler=JaxSamplerConfig(**sampler)))
    ref = np.asarray(ref_pipe.inpaint(jnp.asarray(gt), jnp.asarray(mask), key))
    out = pipe.inpaint(gt, mask, 0, SamplerConfig(**sampler), noise=JaxKeyNoise(key)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole] - gt[hole]).mean() > 0.05  # the model reaches the hole
    # float32 UNets whose sums run in another order; the bound of the
    # uncached pipeline tests
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(out[~hole], gt[~hole])


def test_server_answers_cached_presets(pipe):
    """`cli.serve --presets` takes the cached presets; a request to each is
    answered, and the reply equals the pipeline's batch-1 run at its seed."""
    presets = serve_cli.build_presets(serve_cli.parse_args(
        ["--presets", "ddim-20-fast", "dpm-20-fast"]))
    assert list(presets) == ["ddim-20-fast", "dpm-20-fast"]
    gt, mask = _traj_inputs(9, (1, 32, 32, 3))
    server = InpaintingServer(pipe, batch_size=1, presets=presets)
    try:
        replies = {name: server.submit(gt[0], mask[0], seed=11, preset=name).result(timeout=120)
                   for name in presets}
    finally:
        server.close()
    for name, reply in replies.items():
        ref = pipe.inpaint(gt, mask, [11], sampler=presets[name]).numpy()[0]
        np.testing.assert_array_equal(reply, ref)
    assert not np.array_equal(replies["ddim-20-fast"], replies["dpm-20-fast"])
