"""The port's classifier guidance (`cond_fn`) and classifier-free guidance
(`sampling.cfg`) against the JAX package.

`cond_fn` runs through the inpainting sampler with ddim, ddpm and repaint
and through `sample()` with its own DDIM step, on a closed-form stand-in for
the UNet, fed JAX's draws (within 2e-5, the stub bound of
test_torch_port_methods); the other five methods refuse it as JAX does; a `cond_fn` that takes a real autograd gradient runs through
`InpaintingPipeline.inpaint`. `classifier_free` is held against JAX's on a
small class-conditional UNet with the same weights. Torch runs on one
intra-op thread here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu.sampling import classifier_free as jax_classifier_free
from fidm_tpu.sampling import inpaint_sample as jax_inpaint_sample
from fidm_tpu.sampling import sample as jax_sample
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import InpaintingUNet, UNetConfig
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import (
    GeneratorNoise,
    SamplerConfig,
    classifier_free,
    drop_labels,
    inpaint_sample,
    sample,
)

from _torch_port_common import (
    PCFG,
    SMALL,
    JaxKeyNoise,
    JaxKeyNoise2,
    drawn_jax_variables,
    stub_base_model,
    stub_model,
)

SHAPE = (2, 8, 8, 3)


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


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    lo, hi = shape[1] // 4, 3 * shape[1] // 4
    mask[:, lo:hi, lo:hi] = 1.0
    return gt, mask


def _cond_fn(xp):
    """A closed-form grad log p(y | x_t): a pull toward a pattern whose
    strength depends on t, so that the timesteps passed matter."""
    def cond_fn(x, t):
        tt = t.astype(xp.float32) if xp is jnp else t.float()
        return (0.3 - 0.5 * x) * (1.0 + tt / 50.0)[:, None, None, None]
    return cond_fn


@pytest.mark.parametrize("entry,kw", [
    ("inpaint", dict(method="ddim", num_steps=8, eta=0.9)),
    ("inpaint", dict(method="ddpm", num_steps=8)),
    ("inpaint", dict(method="repaint", num_steps=6, jump_length=2, jump_n_sample=2)),
    # sample()'s DDIM step is its own; its ddpm and repaint steps are the
    # inpainting loop's
    ("sample", dict(method="ddim", num_steps=8, eta=0.9)),
], ids=["inpaint-ddim", "inpaint-ddpm", "inpaint-repaint", "sample-ddim"])
def test_cond_fn_matches_jax(entry, kw):
    gt, mask = _inputs(0)
    key = jax.random.PRNGKey(2)
    jsched = JaxSchedule.create("linear", 50)
    psched = DiffusionSchedule.create("linear", 50, device="cpu")
    if entry == "inpaint":
        ref = np.asarray(jax_inpaint_sample(
            stub_model(jnp), jsched, JaxSamplerConfig(**kw), gt=jnp.asarray(gt),
            mask=jnp.asarray(mask), key=key, cond_fn=_cond_fn(jnp)))
        unguided = inpaint_sample(stub_model(torch), psched, SamplerConfig(**kw),
                                  gt=torch.from_numpy(gt), mask=torch.from_numpy(mask),
                                  noise=JaxKeyNoise(key)).numpy()
        out = inpaint_sample(stub_model(torch), psched, SamplerConfig(**kw),
                             gt=torch.from_numpy(gt), mask=torch.from_numpy(mask),
                             noise=JaxKeyNoise(key), cond_fn=_cond_fn(torch)).numpy()
    else:
        ref = np.asarray(jax_sample(stub_base_model(jnp), jsched, JaxSamplerConfig(**kw),
                                    shape=SHAPE, key=key, cond_fn=_cond_fn(jnp)))
        unguided = sample(stub_base_model(torch), psched, SamplerConfig(**kw), shape=SHAPE,
                          noise=JaxKeyNoise2(key)).numpy()
        out = sample(stub_base_model(torch), psched, SamplerConfig(**kw), shape=SHAPE,
                     noise=JaxKeyNoise2(key), cond_fn=_cond_fn(torch)).numpy()
    assert np.abs(out - unguided).max() > 1e-2  # the guidance moved the image
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("method", ["dpm++2m", "dpm++2m-sde", "dpm++3m", "unipc",
                                    "consistency"])
def test_cond_fn_refused_for_the_other_methods(method):
    gt, mask = (torch.from_numpy(a) for a in _inputs(1))
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    cfg = SamplerConfig(method=method, num_steps=4)
    with pytest.raises(ValueError, match="defined for ddim/ddpm/repaint"):
        inpaint_sample(stub_model(torch), sched, cfg, gt=gt, mask=mask,
                       noise=GeneratorNoise(0, "cpu"), cond_fn=_cond_fn(torch))
    with pytest.raises(ValueError, match="defined for ddim/ddpm/repaint"):
        sample(stub_base_model(torch), sched, cfg, shape=SHAPE,
               noise=GeneratorNoise(0, "cpu"), cond_fn=_cond_fn(torch))


def test_autograd_cond_fn_through_the_pipeline():
    """A cond_fn that differentiates a small function of x with
    `torch.autograd.grad` runs through `InpaintingPipeline.inpaint` (which
    then samples under no_grad, not inference_mode) and equals the same
    gradient in closed form."""
    p = InpaintingPipeline.create(PipelineConfig(unet=PCFG), device="cpu")
    for m in p.model.modules():  # the zero-initialised output convs
        if isinstance(m, torch.nn.Conv2d) and not m.weight.any():
            torch.nn.init.normal_(m.weight, std=0.02)
    gt, mask = _inputs(3, (2, 16, 16, 3))
    cfg = SamplerConfig(method="ddpm", num_steps=4, injection=True)
    target = torch.linspace(-0.5, 0.5, 16)[None, :, None, None]

    def autograd_cond_fn(x, t):
        logp = -((x - target) ** 2).sum() * (1.0 + t.float().mean() / 1000.0)
        return torch.autograd.grad(logp, x)[0]

    def closed_form(x, t):
        return -2.0 * (x - target) * (1.0 + t.float().mean() / 1000.0)

    out = p.inpaint(gt, mask, 7, sampler=cfg, cond_fn=autograd_cond_fn)
    ref = p.inpaint(gt, mask, 7, sampler=cfg, cond_fn=closed_form)
    plain = p.inpaint(gt, mask, 7, sampler=cfg)
    assert not out.requires_grad
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert (out - plain).abs().max() > 1e-2
    keep = mask[..., 0] < 0.5
    np.testing.assert_array_equal(out.numpy()[keep], gt[keep])


def test_classifier_free_matches_jax():
    """One guided call (the batch doubled into one model call) of the small
    UNet with 5 classes, the null label 4, at scale 3, on the same weights."""
    s = SMALL["image_size"]
    jcfg = JaxUNetConfig(**SMALL, num_classes=5, dtype=jnp.float32)
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32),
             np.zeros((1,), np.int32))
    v = drawn_jax_variables(JaxInpaintingUNet, jcfg, 3, *dummy)
    model = InpaintingUNet(UNetConfig(**SMALL, num_classes=5, dtype=torch.float32)).eval()
    model.load_state_dict(state_dict_from_jax(v, model.config), strict=True)
    variables = jax.tree_util.tree_map(jnp.asarray, v)
    jmodel = JaxInpaintingUNet(jcfg)
    gt, mask = _inputs(4, (2, s, s, 3))
    x = np.random.default_rng(5).standard_normal(gt.shape).astype(np.float32)
    t = np.array([700, 30], np.int32)
    y = np.array([1, 3], np.int32)
    ref = jax.jit(jax_classifier_free(
        lambda x, t, mi, m, yy: jmodel.apply(variables, x, t, mi, m, yy),
        y=y, null_label=4, scale=3.0))(x, t, gt * (1 - mask), mask)
    calls = []

    def apply(x, t, mi, m, yy):
        calls.append(yy.clone())
        return model(x, t, mi, m, yy)

    with torch.inference_mode():
        out = classifier_free(apply, y=torch.from_numpy(y), null_label=4, scale=3.0)(
            *(torch.from_numpy(a) for a in (x, t, gt * (1 - mask), mask)))
    assert len(calls) == 1 and calls[0].tolist() == [1, 3, 4, 4]
    assert out.shape == (2, s, s, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_drop_labels():
    y = torch.arange(64) % 7
    g = torch.Generator().manual_seed(0)
    assert torch.equal(drop_labels(g, y, 0.0, 7), y)
    assert torch.equal(drop_labels(g, y, 1.0, 7), torch.full_like(y, 7))
    half = drop_labels(torch.Generator().manual_seed(1), y, 0.5, 7)
    assert 0 < int((half == 7).sum()) < 64
    assert torch.equal(half, drop_labels(torch.Generator().manual_seed(1), y, 0.5, 7))
