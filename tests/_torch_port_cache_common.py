"""Shared pieces of the feature-caching tests (`test_torch_port_cache*.py`): the
four-level float32 UNet configuration in both packages, its perturbed JAX
parameters and the port's pipeline on them, trajectory inputs, a cheap
cache-aware stand-in for the UNet written once for both packages, and the
check that two calls agree or raise alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models import UNetConfig
from fidm_tpu_torch.models.weights import state_dict_from_jax

from _torch_port_common import perturbed_jax_variables


FOUR = dict(image_size=32, in_channels=9, model_channels=32, out_channels=6,
            num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 1, 2, 2),
            num_heads=4, num_head_channels=32)
JCFG4 = JaxUNetConfig(**FOUR, dtype=jnp.float32)
PCFG4 = UNetConfig(**FOUR, dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables(JCFG4)


@pytest.fixture(scope="module")
def pipe(jax_variables):
    p = InpaintingPipeline.create(PipelineConfig(unet=PCFG4), device="cpu")
    p.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG4), strict=True)
    return p


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


def _traj_inputs(seed, shape=(2, 8, 8, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    return gt, mask
