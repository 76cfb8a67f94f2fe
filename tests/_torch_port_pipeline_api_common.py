"""Shared pieces of the pipeline API tests (`test_torch_port_pipeline_api*.py`):
the small UNet's perturbed JAX parameters and pipeline inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fidm_tpu import InpaintingPipeline as JaxPipeline
from fidm_tpu import PipelineConfig as JaxPipelineConfig
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu_torch.sampling import SamplerConfig

from _torch_port_common import JCFG, SMALL, drawn_jax_variables


S = SMALL["image_size"]
DDIM = SamplerConfig(method="ddim", num_steps=5, eta=0.9, injection=True)


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


def _jax_pipeline(variables, jcfg):
    return JaxPipeline(JaxInpaintingUNet(jcfg), jax.tree_util.tree_map(jnp.asarray, variables),
                       JaxSchedule.create("linear", 50), JaxPipelineConfig(unet=jcfg))
