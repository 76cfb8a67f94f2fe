"""The port's `training_losses` against the JAX package's, eagerly, for every
loss and mean type, with loss weights, the hybrid loss's gradient and the
defaults. JAX's `training_losses` splits its key into the diffusion and the
injection noise; the port takes both tensors, so the test draws them from the
same split and hands them over. The model is the closed-form `stub_model`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import losses as jax_losses
from fidm_tpu_torch.diffusion import losses as port_losses

from _torch_port_common import one_torch_thread, stub_model, to_torch  # noqa: F401
from _torch_port_losses_common import (  # noqa: F401
    SHAPE,
    MEAN_TYPES,
    scheds,
    _arrays,
    _close,
    _loss_inputs,
    _both,
)


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
