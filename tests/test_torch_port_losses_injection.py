"""The port's `training_losses` against the JAX package's, eagerly, for every
injection schedule and hybrid weight, on the same numpy inputs and the noise
JAX draws from its key.
"""
import pytest

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_losses_common import scheds, _close, _both  # noqa: F401


@pytest.mark.parametrize("schedule", ["all", "high", "low", "off"])
@pytest.mark.parametrize("vb_weight", [0.0, 0.5], ids=["mse", "hybrid"])
def test_training_losses_match_jax_per_injection_schedule(scheds, schedule, vb_weight):
    kw = dict(vb_weight=vb_weight)
    if schedule == "off":
        kw["use_injection"] = False
    else:
        kw["injection_schedule"] = schedule
    ours, ref = _both(scheds, 10, **kw)
    assert set(ours) == set(ref) == ({"loss", "mse", "vb"} if vb_weight else {"loss", "mse"})
    for k in ref:
        _close(ours[k], ref[k], rtol=1e-5, atol=1e-6)
