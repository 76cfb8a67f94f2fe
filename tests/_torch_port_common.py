"""Shared pieces of the tests that hold `fidm_tpu_torch` against `fidm_tpu`.

A small float32 UNet configuration in both packages, the JAX package's
parameters for it with every leaf perturbed (so that the zero-initialised
output convs do not make the output identically 0), or drawn from numpy
without compiling the JAX init, noise sources that replay the JAX samplers'
key draws for the port's samplers, a closed-form stand-in for the UNet
written once for both packages, and the fixture that pins a test module to
one torch and one BLAS thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for the module that imports
    this fixture. The models here are tiny, and the test run shares the CPU
    between its workers, where torch's default pool of one thread per core
    spins against the other workers (a 101-step cached preset took 125 s
    instead of 18)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


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


def drawn_jax_variables(module, cfg, seed, *args):
    """`module(cfg).init`'s variable tree (from `jax.eval_shape`, which
    compiles nothing) filled from numpy draws: kernels normal over
    sqrt(fan-in), norm scales 1 + 0.05·normal, the rest 0.05·normal. `args`
    are the init's dummy inputs after the key."""
    shapes = jax.eval_shape(module(cfg).init, jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return (1 + 0.05 * z) if name == "scale" else 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


class JaxKeyNoise2:
    """The two draws of the JAX unconditional sampler (`sample`): the
    initial state and the per-step noise by step index."""

    def __init__(self, key):
        self.init_key, self.step_key = jax_sampler._key_split(key, 2)

    def init(self, shape):
        return to_torch(jax_sampler._key_normal(self.init_key, shape, jnp.float32))

    def step(self, index, shape):
        return to_torch(jax_sampler._key_normal(
            jax_sampler._key_fold(self.step_key, index), shape, jnp.float32))


def stub_model(xp):
    """A cheap nonlinear stand-in for the inpainting UNet, written once for
    numpy-like `xp` (jnp or torch): 6 output channels, the last 3 a learned
    variance. The image mean mixes pixels, so the known region's injected
    noise reaches the hole, as it does through the UNet."""

    def apply_fn(x, t, masked_image, mask):
        tt = t.astype(xp.float32) if xp is jnp else t.float()
        mean = (x.mean(axis=(1, 2), keepdims=True) if xp is jnp
                else x.mean(dim=(1, 2), keepdim=True))
        h = xp.tanh(0.7 * x + 2.0 * mean - 0.4 * masked_image + 0.3 * mask
                    + (tt / 1000.0)[:, None, None, None])
        cat = xp.concatenate if xp is jnp else torch.cat
        return cat([h, 0.1 * x], -1)

    return apply_fn


def stub_base_model(xp):
    """`stub_model` as an unconditional model, apply_fn(x, t)."""
    f = stub_model(xp)
    return lambda x, t: f(x, t, 0.5 * x, 0.0 * x[..., :1] + 1.0)
