"""The port's key-step mask (`_cache_keymask`) against the JAX sampler's, on
grids of 1 and 10 steps (21 and 101 are in `test_torch_port_cache_keymask_2.py`):
both give the same mask or raise the same ValueError.
"""
import pytest

from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.sampling import SamplerConfig
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_cache_common import _same_outcome
from _torch_port_common import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("period,tail,keysteps", [
    (2, 0, None), (3, 10, None), (2, 4, None), (3, 0, None), (5, 200, None),
    (2, 0, (0, 3, 7, 9)), (3, 0, (0,)), (2, 0, (1, 2)), (2, 0, (0, 5, 5)),
    (2, 0, (0, 20)), (2, 0, ()), (2, 0, (0, 4, 2)),
])
def test_keymask_matches_jax(K, period, tail, keysteps):
    kw = dict(encoder_cache_period=period, encoder_cache_tail=tail, cache_keysteps=keysteps)
    _same_outcome(lambda: port_sampler._cache_keymask(SamplerConfig(**kw), K),
                  lambda: jax_sampler._cache_keymask(JaxSamplerConfig(**kw), K))
