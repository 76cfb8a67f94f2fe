"""The port's UNet against the JAX package's, and how weights cross over.

JAX `InpaintingUNet` parameters (every leaf perturbed, so that the
zero-initialised output convs do not make the output identically 0) go
through `state_dict_from_jax` into the port; both forwards run in float32 on
the CPU on the same numpy inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import ffhq256_config as jax_ffhq256_config
from fidm_tpu.models import torch_import
from fidm_tpu.models.torch_import import export_state_dict, save_torch_checkpoint
from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
from fidm_tpu_torch.models import weights
from fidm_tpu_torch.models.layers import AttentionBlock
from fidm_tpu_torch.models.weights import load_adm_checkpoint, state_dict_from_jax

from _torch_port_common import JCFG, PCFG, perturbed_jax_variables


def _inputs(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 4:12, 3:10] = 1.0
    t = np.array([7, 640][:b], np.int32)
    return x, t, gt * (1.0 - mask), mask


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables()


def _port_model(sd, cfg=PCFG):
    model = InpaintingUNet(cfg).eval()
    model.load_state_dict(sd, strict=True)
    return model


# the second configuration takes the other branch of every block choice:
# additive timestep embedding, conv Down/Upsample, two res blocks per level
OTHER = dict(use_scale_shift_norm=False, resblock_updown=False, num_res_blocks=2)


@pytest.mark.parametrize("other", [False, True], ids=["ffhq_blocks", "other_blocks"])
def test_forward_matches_jax_f32(jax_variables, other):
    jcfg, pcfg = JCFG, PCFG
    if other:
        jcfg, pcfg = (dataclasses.replace(c, **OTHER) for c in (JCFG, PCFG))
        jax_variables = perturbed_jax_variables(jcfg)
    x, t, mi, m = _inputs(2)
    ref = np.asarray(jax.jit(JaxInpaintingUNet(jcfg).apply)(jax_variables, x, t, mi, m))
    model = _port_model(state_dict_from_jax(jax_variables, pcfg), pcfg)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, mi, m)))
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 6)
    assert np.abs(ref).max() > 0.1  # the perturbed output convs are live
    # f32 on both sides; conv and matmul sums run in another order. The
    # worst element stays within 2e-4 of the output's largest magnitude.
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-4, err


def test_bf16_activations_keep_f32_output(jax_variables):
    """The dtype policy: bf16 activations, f32 params and f32 output conv.
    Against the f32 model only bf16 rounding separates the two."""
    x, t, mi, m = (torch.from_numpy(a) for a in _inputs(3))
    sd = state_dict_from_jax(jax_variables, PCFG)
    f32 = _port_model(sd)
    bf16 = _port_model(sd, dataclasses.replace(PCFG, dtype=torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with torch.no_grad():
        ref, out = f32(x, t, mi, m), bf16(x, t, mi, m)
    assert out.dtype == torch.float32
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err < 5e-2, err


def test_export_state_dict_loads_strict(jax_variables):
    """The JAX package's ADM-key export loads into the port unchanged."""
    sd = export_state_dict(jax_variables, JCFG)
    model = InpaintingUNet(PCFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    ours = state_dict_from_jax(jax_variables, PCFG)
    assert set(ours) == set(sd) == set(model.state_dict())
    for k in sd:
        np.testing.assert_array_equal(ours[k].numpy(), sd[k])


def test_adm_checkpoint_widens_3_to_9_channels(jax_variables, tmp_path):
    """A 3-channel ADM checkpoint loads into the 9-channel model: RGB
    weights into input channels 0-2, zeros in 3-8."""
    cfg3 = dataclasses.replace(JCFG, in_channels=3)
    base = {k: v for k, v in jax_variables["params"]["base"].items()}
    base["in_0_conv"] = dict(base["in_0_conv"],
                             kernel=base["in_0_conv"]["kernel"][:, :, :3])
    path = str(tmp_path / "adm.pt")
    save_torch_checkpoint(path, {"params": base}, cfg3)
    sd = load_adm_checkpoint(path, PCFG)
    model = _port_model(sd)
    w = model.input_blocks[0][0].weight.detach().numpy()
    assert w.shape == (32, 9, 3, 3)
    np.testing.assert_array_equal(w[:, 3:], 0.0)
    np.testing.assert_array_equal(
        w[:, :3], np.asarray(base["in_0_conv"]["kernel"]).transpose(3, 2, 0, 1))


def test_parameter_names_are_adm_keys():
    keys = set(InpaintingUNet(PCFG).state_dict())
    for k in ("time_embed.0.weight", "time_embed.2.bias", "input_blocks.0.0.weight",
              "input_blocks.1.0.in_layers.2.weight", "input_blocks.2.0.out_layers.3.weight",
              "input_blocks.3.0.skip_connection.weight", "input_blocks.3.1.qkv.weight",
              "middle_block.1.proj_out.weight", "output_blocks.2.0.emb_layers.1.weight",
              "output_blocks.1.2.in_layers.0.weight", "out.2.weight"):
        assert k in keys, k


def test_config_defaults_match_jax():
    """`UNetConfig()` is the canonical FFHQ-256 model in both packages, with
    every field of the JAX config (remat and remat_policy came with
    training, split_decoder_skips with the warm program cache); only the
    dtype's type differs."""
    jax_only = {"dtype"}
    ours, ref = dataclasses.asdict(ffhq256_config()), dataclasses.asdict(jax_ffhq256_config())
    assert {k: v for k, v in ref.items() if k not in jax_only} == {
        k: v for k, v in ours.items() if k != "dtype"}
    assert ffhq256_config().dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["small", "ffhq256", "no_updown"])
def test_key_map_matches_jax(name):
    over = dict(resblock_updown=False, num_res_blocks=2, attention_resolutions=(1, 2))
    jcfg, pcfg = {"small": (JCFG, PCFG),
                  "ffhq256": (jax_ffhq256_config(), ffhq256_config()),
                  "no_updown": (dataclasses.replace(JCFG, **over),
                                dataclasses.replace(PCFG, **over))}[name]
    assert weights.torch_key_map(pcfg) == torch_import.torch_key_map(jcfg)
    with torch.device("meta"):
        keys = set(InpaintingUNet(pcfg).state_dict())
    mapped = {f"{prefix}.{leaf}" for _, prefix, _ in weights.torch_key_map(pcfg)
              for leaf in ("weight", "bias")}
    assert keys <= mapped and {k for k in mapped if k.endswith(".weight")} <= keys


def test_ffhq256_attention_sites():
    """The main path's attention: four blocks per forward, 8 heads of 64 on
    512 channels (16x16 in input_blocks.9, output_blocks.2 and .3; 8x8 in
    the middle block)."""
    with torch.device("meta"):
        model = InpaintingUNet(ffhq256_config())
    sites = {n: m for n, m in model.named_modules() if isinstance(m, AttentionBlock)}
    assert sorted(sites) == ["input_blocks.9.1", "middle_block.1",
                             "output_blocks.2.1", "output_blocks.3.1"]
    for m in sites.values():
        assert m.heads == 8 and m.qkv.in_channels == 512


def test_ffhq256_parameter_count_matches_jax():
    s = 256
    shapes = jax.eval_shape(
        JaxInpaintingUNet(jax_ffhq256_config()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, s, s, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 1)))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        n_port = sum(p.numel() for p in InpaintingUNet(ffhq256_config()).parameters())
    assert n_port == n_jax
