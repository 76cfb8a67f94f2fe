"""The port's feature caching (encoder reuse, DeepCache deep-trunk reuse and
output reuse) against the JAX package's.

UNet: a four-level float32 model, so that branches 1, 2 and 3 are all valid
and branch 3's cached call runs attention; JAX parameters with every leaf
perturbed go through `state_dict_from_jax`. The port's cache is NCHW, JAX's
NHWC: the tests permute one into the other. This file holds the UNet's cached
forwards and the pipeline's validation of a cache config. The trajectories and
the cached presets are in `test_torch_port_cache_pipeline.py`, the key grids
in `test_torch_port_cache_keymask*.py` and `test_torch_port_cache_keysteps.py`:
port test files hold at most 25 cases (ROADMAP.md).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from fidm_tpu import pipeline as jax_pipeline
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu_torch.sampling import SamplerConfig

from _torch_port_cache_common import (  # noqa: F401
    JCFG4,
    jax_variables,
    pipe,
    _same_outcome,
    _traj_inputs,
)
from _torch_port_common import one_torch_thread  # noqa: F401


MODES = [None, 1, 2, 3]
MODE_IDS = ["encoder", "b1", "b2", "b3"]


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
