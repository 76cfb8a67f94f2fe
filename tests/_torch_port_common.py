"""Shared pieces of the tests that hold `fidm_tpu_torch` against `fidm_tpu`.

A small float32 UNet configuration in both packages, the JAX package's
parameters for it with every leaf perturbed (so that the zero-initialised
output convs do not make the output identically 0), and a noise source that
replays the JAX sampler's key draws for the port's sampler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.models import UNetConfig

SMALL = dict(image_size=16, in_channels=9, model_channels=32, out_channels=6,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
             resblock_updown=True)
JCFG = JaxUNetConfig(**SMALL, dtype=jnp.float32)
PCFG = UNetConfig(**SMALL, dtype=torch.float32)


def perturbed_jax_variables(cfg=JCFG, seed=0, scale=0.05):
    """`InpaintingUNet(cfg).init` parameters as numpy arrays, each leaf
    shifted by `scale` times a standard normal draw."""
    s = cfg.image_size
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
    variables = jax.jit(JaxInpaintingUNet(cfg).init)(jax.random.PRNGKey(seed), *dummy)
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        variables)


def to_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


class JaxKeyNoise:
    """The three draws the JAX sampler makes from one key, as torch tensors:
    the initial state, the per-step noise by step index, and the injection
    noise by target timestep."""

    def __init__(self, key):
        self.init_key, self.step_key, self.inject_key = jax_sampler._key_split(key, 3)

    def init(self, shape):
        return to_torch(jax_sampler._key_normal(self.init_key, shape, jnp.float32))

    def step(self, index, shape):
        return to_torch(jax_sampler._key_normal(
            jax_sampler._key_fold(self.step_key, index), shape, jnp.float32))

    def inject(self, timestep, shape):
        return to_torch(jax_sampler._gt_noise(self.inject_key, timestep, shape, jnp.float32))
