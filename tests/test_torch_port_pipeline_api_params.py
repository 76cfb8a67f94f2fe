"""`cast_params` and `UNetConfig.split_decoder_skips` of the port against the
JAX package.

- `cast_params(torch.bfloat16)` against the JAX pipeline's `cast_params`:
  the cast weights bit-equal, one bf16 forward within a stated bound.
- `UNetConfig.split_decoder_skips` against the JAX split forward on the
  same perturbed weights (float32, 1e-5), against the port's concatenating
  forward, and with the feature cache and remat.

Torch and BLAS run one thread here: the test run shares the CPU between its
workers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models import InpaintingUNet
from fidm_tpu_torch.models.layers import ResBlock
from fidm_tpu_torch.models.weights import state_dict_from_jax

from _torch_port_common import JCFG, PCFG, one_torch_thread  # noqa: F401
from _torch_port_pipeline_api_common import (  # noqa: F401
    DDIM,
    jax_variables,
    _inputs,
    _jax_pipeline,
)


def _port_model(jax_variables, cfg=PCFG):
    model = InpaintingUNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    return model


# One bf16 forward of the cast model, port against JAX, max abs over max
# |JAX|: both take the same bf16 weights and round activations to bf16, with
# sums in another order (XLA's and oneDNN's) and GroupNorm's normalisation in
# float32 in the port, in bf16 in JAX; this 16² model read 2.4e-2 in a CPU
# run. The bound is twice that, the bf16 bound of the port's other forward
# tests (5e-2).
CAST_FORWARD_TOL = 5e-2


def test_cast_params_matches_jax(jax_variables):
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    config = PipelineConfig(unet=dataclasses.replace(PCFG, dtype=torch.bfloat16),
                            schedule="linear",
                            num_timesteps=50, sampler=DDIM)
    port = InpaintingPipeline.create(config, device="cpu")
    port.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    port.install_program(2, DDIM, port.compile_batch(2))
    assert port.cast_params(torch.bfloat16) is port
    assert port.installed_program(2, DDIM) is None  # every program dropped
    jax_pipe = _jax_pipeline(jax_variables, jcfg).cast_params(jnp.bfloat16)
    jax_cast = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                      jax_pipe.variables)
    ours = port.model.state_dict()
    assert all(t.dtype == torch.bfloat16 for t in ours.values())
    for key, ref in state_dict_from_jax(jax_cast, PCFG).items():
        assert torch.equal(ours[key].float(), ref), key

    x, t, gt, mask = _inputs(4)
    masked = gt * (1.0 - mask)
    want = np.asarray(jax.jit(jax_pipe.model.apply)(jax_pipe.variables, x, t, masked, mask),
                      np.float32)
    with torch.no_grad():
        got = port.model(*(torch.from_numpy(a) for a in (x, t, masked, mask))).numpy()
    assert got.dtype == np.float32  # the final conv stays float32
    assert np.abs(got - want).max() / np.abs(want).max() <= CAST_FORWARD_TOL
    # a cast pipeline still samples, eagerly and through a new program
    eager = port.inpaint(gt, mask, 1)
    port.install_program(2, DDIM, port.compile_batch(2))
    assert torch.equal(port.inpaint(gt, mask, 1), eager)
    keep = torch.from_numpy(mask[..., 0] < 0.5)
    assert torch.equal(eager[keep], torch.from_numpy(gt)[keep])


# ---------------------------------------------------------- split decoder skips


@pytest.fixture(scope="module")
def split_outputs(jax_variables):
    """The JAX split forward, and the port's split and concatenating
    forwards, in float32 on the same inputs."""
    x, t, gt, mask = _inputs(2)
    masked = gt * (1.0 - mask)
    jcfg = dataclasses.replace(JCFG, split_decoder_skips=True)
    with jax.default_matmul_precision("highest"):
        jax_split = np.asarray(JaxInpaintingUNet(jcfg).apply(jax_variables, x, t, masked, mask))
    outs = {}
    for split in (False, True):
        model = _port_model(jax_variables, dataclasses.replace(PCFG, split_decoder_skips=split))
        with torch.no_grad():
            outs[split] = model(*(torch.from_numpy(a) for a in (x, t, masked, mask))).numpy()
    return jax_split, outs[True], outs[False]


def test_split_decoder_skips_matches_jax(split_outputs):
    """float32, 1e-5: the same one-pass statistics and half-kernel sums,
    in another order."""
    jax_split, split, _ = split_outputs
    assert np.abs(split - jax_split).max() <= 1e-5


def test_split_decoder_skips_matches_concat_path(split_outputs):
    """The concatenation-free decoder computes the concatenating one's
    function: float32 sums in another order (1e-5 of outputs near 1)."""
    _, split, concat = split_outputs
    assert np.abs(split - concat).max() <= 1e-5
    assert not np.array_equal(split, concat)  # the split path really ran


def test_split_decoder_skips_bf16_close(jax_variables):
    """bf16 activations: the split path normalises each half in bf16 where
    GroupNorm32 does it in float32; 5e-2, the JAX package's own bound
    (tests/test_unet.py)."""
    x, t, gt, mask = _inputs(5)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    cfg = dataclasses.replace(PCFG, dtype=torch.bfloat16)
    with torch.no_grad():
        a, b = (_port_model(jax_variables, dataclasses.replace(cfg, split_decoder_skips=s))(*args)
                for s in (False, True))
    assert (a - b).abs().max().item() <= 5e-2


def test_split_decoder_skips_keeps_the_state_dict(jax_variables):
    """The same modules either way: identical keys and shapes, and either
    model loads the other's state dict with strict=True."""
    on = InpaintingUNet(dataclasses.replace(PCFG, split_decoder_skips=True))
    off = InpaintingUNet(PCFG)
    assert {k: v.shape for k, v in on.state_dict().items()} == {
        k: v.shape for k, v in off.state_dict().items()}
    on.load_state_dict(off.state_dict(), strict=True)
    off.load_state_dict(on.state_dict(), strict=True)


def test_split_skip_rules(jax_variables):
    """Plain blocks only; an identity residual takes the concatenation, so
    its output is the concatenating call's bit for bit."""
    torch.manual_seed(0)
    up = ResBlock(32, 64, 32, up=True)
    h, skip, emb = torch.randn(1, 16, 4, 4), torch.randn(1, 16, 4, 4), torch.randn(1, 64)
    with pytest.raises(ValueError, match="plain blocks"):
        up(h, emb, skip=skip)
    same = ResBlock(32, 64, 32)
    with torch.no_grad():
        assert torch.equal(same(h, emb, skip=skip), same(torch.cat([h, skip], 1), emb))


@pytest.mark.parametrize("depth", [None, 1], ids=["encoder", "branch1"])
def test_split_decoder_skips_with_the_feature_cache(jax_variables, depth):
    """Key and cached calls of the split model: the key call's output is its
    plain forward's, and a cached call at the key call's (x, t) gives it bit
    for bit; both within float32 reassociation of the concatenating model's."""
    x, t, gt, mask = _inputs(6)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    split = _port_model(jax_variables, dataclasses.replace(PCFG, split_decoder_skips=True))
    concat = _port_model(jax_variables)
    with torch.no_grad():
        plain = split(*args)
        key_out, cache = split(*args, return_cache=True, cache_depth=depth)
        cached = split(*args, cache=cache, cache_depth=depth)
        ref_key, ref_cache = concat(*args, return_cache=True, cache_depth=depth)
        ref_cached = concat(*args, cache=ref_cache, cache_depth=depth)
    assert torch.equal(key_out, plain) and torch.equal(cached, plain)
    assert (key_out - ref_key).abs().max().item() <= 1e-5
    assert (cached - ref_cached).abs().max().item() <= 1e-5


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_split_decoder_skips_under_remat(jax_variables, policy):
    """Remat of the split model recomputes the same function: loss and every
    gradient bit-equal to the split model without remat."""
    x, t, gt, mask = _inputs(7)
    args = [torch.from_numpy(a) for a in (x, t, gt * (1.0 - mask), mask)]
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(PCFG, split_decoder_skips=True, remat=remat,
                                  remat_policy=policy)
        model = _port_model(jax_variables, cfg).train()
        loss = model(*args).square().mean()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
