"""The port's training losses against the JAX package's, eagerly, on the same
numpy inputs and draws.

The likelihood terms of the variational bound (`gaussian.py`), the masked
MSE, the SNR loss weights for every mean type and kind, and
`training_losses` for every loss type, injection schedule and hybrid
weight. JAX's `training_losses` splits its key into the diffusion and the
injection noise; the port takes both tensors, so the test draws them from
the same split and hands them over. The model is the closed-form
`stub_model`, or a fixed output whose gradient both sides take (the hybrid
loss detaches exactly the mean channels). No JAX model is compiled. Torch
runs on one intra-op thread here.

`training_losses` is in `test_torch_port_losses_training.py` and
`test_torch_port_losses_injection.py`: port test files hold at most 25 cases
(ROADMAP.md).
"""
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import gaussian as jax_gd
from fidm_tpu.diffusion import losses as jax_losses
from fidm_tpu_torch.diffusion import gaussian as port_gd
from fidm_tpu_torch.diffusion import losses as port_losses

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_losses_common import SHAPE, MEAN_TYPES, scheds, _arrays, _close  # noqa: F401


# ------------------------------------------------------------ likelihood terms


def test_normal_kl_matches_jax():
    m1, l1, m2, l2 = _arrays(0, 4, scale=0.7)
    _close(port_gd.normal_kl(*map(torch.from_numpy, (m1, l1, m2, l2))),
           jax_gd.normal_kl(m1, l1, m2, l2))


def test_approx_standard_normal_cdf_matches_jax():
    (x,) = _arrays(1, 1, scale=2.0)
    _close(port_gd.approx_standard_normal_cdf(torch.from_numpy(x)),
           jax_gd.approx_standard_normal_cdf(x))


def test_discretized_gaussian_log_likelihood_matches_jax():
    """Both edge bins (x < -0.999, x > 0.999) and the interior, on pixel
    values of the 8-bit grid, each within 2.5 scales of its mean. The
    interior's log takes the difference of two CDFs: farther out, where a
    bin holds less than about 1e-4 of the mass, float32 cancellation alone
    moves it by more than the two libraries' last-bit tanh differences
    (0.1 at the tails here), on both sides alike."""
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 256, SHAPE) / 127.5 - 1.0).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    log_scales = rng.uniform(-1.5, 0.5, SHAPE).astype(np.float32)
    z = np.clip(rng.standard_normal(SHAPE), -2.5, 2.5)
    means = (x - np.exp(log_scales) * z).astype(np.float32)
    ours = port_gd.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(means), log_scales=torch.from_numpy(log_scales))
    ref = jax_gd.discretized_gaussian_log_likelihood(x, means=means, log_scales=log_scales)
    _close(ours, ref, rtol=1e-4, atol=2e-3)


def test_mean_flat_matches_jax():
    (x,) = _arrays(4, 1)
    _close(port_gd.mean_flat(torch.from_numpy(x)), jax_gd.mean_flat(x))


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_vb_terms_bpd_matches_jax(scheds, mean_type):
    """The decoder NLL at t = 0, the KL elsewhere; learned-range variance."""
    jsched, psched = scheds
    out, x0, xt = _arrays(5, 3, shape=SHAPE[:-1] + (6,))[0], *_arrays(6, 2)
    out = np.tanh(out)
    t = np.array([0, 17, 803], np.int32)
    ref, ref_x0 = jax_gd.vb_terms_bpd(jsched, out, x0, xt, t,
                                      mean_type=jax_gd.ModelMeanType[mean_type])
    ours, ours_x0 = port_gd.vb_terms_bpd(psched, *map(torch.from_numpy, (out, x0, xt, t)),
                                         mean_type=port_gd.ModelMeanType[mean_type])
    _close(ours, ref, rtol=1e-4, atol=1e-5)
    _close(ours_x0, ref_x0, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ masked MSE, SNR


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "sample_weight"])
def test_masked_mse_matches_jax(weighted):
    """A hole per sample of another area, and one sample with no hole at
    all (its area clamps at 1)."""
    target, pred = _arrays(7, 2)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[0, 2:6, 1:7] = 1.0
    mask[1, :3] = 1.0
    w = np.array([0.5, 2.0, 1.5], np.float32) if weighted else None
    ours = port_losses.masked_mse(torch.from_numpy(target), torch.from_numpy(pred),
                                  torch.from_numpy(mask),
                                  None if w is None else torch.from_numpy(w))
    _close(ours, jax_losses.masked_mse(target, pred, mask, w))


@pytest.mark.parametrize("kind", ["none", "min_snr", "p2"])
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_snr_loss_weight_matches_jax(scheds, mean_type, kind):
    jsched, psched = scheds
    t = np.array([0, 5, 250, 999], np.int32)
    args = (jax_gd.ModelMeanType[mean_type], kind)
    pargs = (port_gd.ModelMeanType[mean_type], kind)
    if mean_type == "PREVIOUS_X" and kind != "none":
        for fn, sched, a, tt in ((jax_losses.snr_loss_weight, jsched, args, t),
                                 (port_losses.snr_loss_weight, psched, pargs,
                                  torch.from_numpy(t))):
            with pytest.raises(ValueError, match="xprev"):
                fn(sched, tt, *a)
        return
    ours = port_losses.snr_loss_weight(psched, torch.from_numpy(t), *pargs)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (4,)
    _close(ours, jax_losses.snr_loss_weight(jsched, t, *args), rtol=1e-5, atol=0)


def test_snr_loss_weight_gamma_and_unknown_kind(scheds):
    jsched, psched = scheds
    t = np.array([3, 400], np.int32)
    for kind, gamma in (("min_snr", 2.0), ("p2", 0.5)):
        _close(port_losses.snr_loss_weight(psched, torch.from_numpy(t),
                                           port_gd.ModelMeanType.EPSILON, kind, gamma),
               jax_losses.snr_loss_weight(jsched, t, jax_gd.ModelMeanType.EPSILON, kind, gamma),
               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="unknown loss_weight"):
        port_losses.snr_loss_weight(psched, torch.from_numpy(t),
                                    port_gd.ModelMeanType.EPSILON, "huber")
