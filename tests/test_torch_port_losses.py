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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import gaussian as jax_gd
from fidm_tpu.diffusion import losses as jax_losses
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.diffusion import gaussian as port_gd
from fidm_tpu_torch.diffusion import losses as port_losses

from _torch_port_common import stub_model, to_torch

SHAPE = (3, 8, 8, 3)
MEAN_TYPES = ["EPSILON", "START_X", "VELOCITY", "PREVIOUS_X"]
# float32 on both sides, the same formulas in the same order; the
# exp/log/tanh of the two libraries differ in the last bits
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module: the test
    run shares the CPU between its workers."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scheds():
    return (JaxSchedule.create("quadratic", 1000),
            DiffusionSchedule.create("quadratic", 1000, device="cpu"))


def _arrays(seed, n, shape=SHAPE, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **(tol or TOL))


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


# ------------------------------------------------------------ training_losses


def _loss_inputs(seed, t=(0, 499, 731)):
    x0, = _arrays(seed, 1, scale=0.5)
    mask = np.zeros(SHAPE[:-1] + (1,), np.float32)
    mask[:, 2:6, 3:8] = 1.0
    mask[2] = 0.0
    mask[2, :4] = 1.0
    t = np.array(t, np.int32)
    key = jax.random.PRNGKey(seed)
    noise_key, inject_key = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_key, SHAPE, jnp.float32))
    inject = np.asarray(jax.random.normal(inject_key, SHAPE, jnp.float32))
    return x0, mask, t, key, noise, inject


def _both(scheds, seed, t=(0, 499, 731), **kw):
    """(port terms, JAX terms) of `training_losses` on the stub model, the
    port fed the noise JAX draws from its key."""
    jsched, psched = scheds
    x0, mask, t, key, noise, inject = _loss_inputs(seed, t)
    masked = x0 * (1 - mask)
    jkw = {k: (jax_gd.ModelMeanType[v] if k == "mean_type" else
               jax_gd.LossType[v] if k == "loss_type" else v) for k, v in kw.items()}
    pkw = {k: (port_gd.ModelMeanType[v] if k == "mean_type" else
               port_gd.LossType[v] if k == "loss_type" else v) for k, v in kw.items()}
    ref = jax_losses.training_losses(jsched, stub_model(jnp), x0, t, key, mask=mask,
                                     masked_image=masked, **jkw)
    ours = port_losses.training_losses(
        psched, stub_model(torch), torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), inject_noise=torch.from_numpy(inject),
        mask=torch.from_numpy(mask), masked_image=torch.from_numpy(masked), **pkw)
    return ours, ref


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


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
@pytest.mark.parametrize("loss_type", ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"])
def test_training_losses_match_jax_per_loss_and_mean_type(scheds, loss_type, mean_type):
    """At t >= 1, where the VLB term is the KL: at t = 0 it is the decoder
    NLL, whose float32 tails the stub's random means reach (its t = 0 case
    on moderate inputs: test_vb_terms_bpd_matches_jax)."""
    ours, ref = _both(scheds, 11, t=(1, 499, 731), loss_type=loss_type, mean_type=mean_type)
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["min_snr", "p2"])
def test_training_losses_match_jax_with_loss_weights(scheds, kind):
    ours, ref = _both(scheds, 12, loss_weight=kind, loss_weight_gamma=3.0)
    _close(ours["loss"], ref["loss"], rtol=1e-5, atol=1e-6)


def test_hybrid_gradient_detaches_only_the_mean_channels(scheds):
    """d(loss)/d(model output) of the hybrid loss against jax.grad: the VLB
    reaches the variance channels only, the MSE the mean channels only."""
    jsched, psched = scheds
    x0, mask, t, key, noise, inject = _loss_inputs(13)
    out = np.tanh(_arrays(14, 1, shape=SHAPE[:-1] + (6,))[0])

    def jax_loss(o):
        return jax_losses.training_losses(jsched, lambda *a: o, x0, t, key, mask=mask,
                                          masked_image=x0 * (1 - mask), vb_weight=0.7)["loss"]

    ref = jax.jit(jax.grad(jax_loss))(out)
    o = torch.from_numpy(out).requires_grad_()
    loss = port_losses.training_losses(
        psched, lambda *a: o, torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), inject_noise=torch.from_numpy(inject),
        mask=torch.from_numpy(mask), masked_image=torch.from_numpy(x0 * (1 - mask)),
        vb_weight=0.7)["loss"]
    (ours,) = torch.autograd.grad(loss, o)
    # XLA fuses the jitted gradient's float32 arithmetic in its own order
    _close(ours, ref, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(ref)).max()))
    # the MSE alone gives the mean channels' gradient: the VLB adds nothing there
    mse = port_losses.training_losses(
        psched, lambda *a: o, torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), inject_noise=torch.from_numpy(inject),
        mask=torch.from_numpy(mask), masked_image=torch.from_numpy(x0 * (1 - mask)))["loss"]
    (mse_grad,) = torch.autograd.grad(mse, o)
    torch.testing.assert_close(ours[..., :3], mse_grad[..., :3], rtol=0, atol=0)
    assert ours[..., 3:].abs().max() > 0


def test_training_losses_default_mask_and_missing_inject_noise(scheds):
    """Without a mask the hole is the whole image; injection without its
    noise is an error, not a silent skip."""
    jsched, psched = scheds
    x0, _, t, key, noise, _ = _loss_inputs(15)

    def unmasked(xp):  # the stub without a masked image: 0.5 x in its place
        f = stub_model(xp)
        return lambda x, tt, masked_image, mask: f(x, tt, 0.5 * x, mask)

    ref = jax_losses.training_losses(jsched, unmasked(jnp), x0, t, key)
    ours = port_losses.training_losses(psched, unmasked(torch), torch.from_numpy(x0),
                                       torch.from_numpy(t), torch.from_numpy(noise))
    _close(ours["loss"], ref["loss"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="inject_noise"):
        port_losses.training_losses(psched, stub_model(torch), torch.from_numpy(x0),
                                    torch.from_numpy(t), torch.from_numpy(noise),
                                    masked_image=to_torch(x0))
