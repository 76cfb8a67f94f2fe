"""The port's key-step grids (`nonuniform_keysteps`, `keysteps_from_spec`)
against the JAX sampler's, and the order of full and cached model calls that
the key-step mask gives a sampling run.
"""
import pytest
import torch

from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.sampling import SamplerConfig, inpaint_sample
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_cache_common import _same_outcome, _cache_model, _traj_inputs
from _torch_port_common import one_torch_thread  # noqa: F401


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
