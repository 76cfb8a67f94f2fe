"""The port's calibrated quantization against the JAX package's.

The clipping search is the JAX package's numpy code, so given the same
activation moments the trees must be bit-equal. The moments themselves come
from a forward pass in each framework: the port records them at
`layers.conv` / `layers.linear`, JAX with a Flax method interceptor. In
float32 on the same weights and inputs they differ only by the order of the
sums in the convolutions and means (rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models.torch_import import convert_state_dict, export_state_dict
from fidm_tpu.quant import calibrate as jax_calibrate
from fidm_tpu_torch.models import InpaintingUNet
from fidm_tpu_torch.models import layers as port_layers
from fidm_tpu_torch.models.weights import (
    flax_module_paths,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from fidm_tpu_torch.quant import calibrate as port_calibrate

from _torch_port_common import JCFG, PCFG, perturbed_jax_variables


def _batches(n_batches=2, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    s = JCFG.image_size
    out = []
    for _ in range(n_batches):
        x = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
        t = rng.integers(0, 1000, (batch,)).astype(np.int32)
        mask = (rng.uniform(size=(batch, s, s, 1)) < 0.3).astype(np.float32)
        masked = (rng.uniform(-1, 1, (batch, s, s, 3)) * (1 - mask)).astype(np.float32)
        out.append((x, t, masked, mask))
    return out


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables(JCFG, seed=4)


@pytest.fixture(scope="module")
def moments(jax_variables):
    """(JAX moments, port moments) on the same batches and weights."""
    batches = _batches()
    with jax.default_matmul_precision("highest"):
        ref = jax_calibrate.collect_input_moments(
            JaxInpaintingUNet(JCFG), jax_variables,
            [tuple(jnp.asarray(a) for a in b) for b in batches])
    model = InpaintingUNet(PCFG)
    model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    model.eval()
    out = port_calibrate.collect_input_moments(
        model, [tuple(torch.from_numpy(a) for a in b) for b in batches])
    return ref, out


def test_moments_match_jax(moments):
    ref, out = moments
    assert set(out) == set(ref)
    for path, h in ref.items():
        assert out[path].dtype == np.float32 and out[path].shape == h.shape, path
        np.testing.assert_allclose(out[path], h, rtol=1e-5, atol=0, err_msg=str(path))


def test_every_layer_has_moments(moments):
    """Every conv and dense layer runs in a forward, so every Flax path of
    the key map is there."""
    _, out = moments
    model = InpaintingUNet(PCFG)
    assert set(out) == set(flax_module_paths(model, PCFG).values())
    assert ("base", "in_0_conv") in out and ("base", "mid_attn", "qkv") in out


def test_capture_is_off_outside_the_block(moments):
    assert port_layers._capture is None
    seen = []
    with port_layers.capture_inputs(lambda m, x, d: seen.append(d)):
        port_layers.linear(torch.nn.Linear(4, 2), torch.ones(3, 4))
        assert port_layers._capture is not None
    assert seen == [-1] and port_layers._capture is None


@pytest.mark.parametrize("shape,with_h", [((3, 3, 32, 64), True), ((64, 128), True),
                                          ((128, 96), False), ((1, 1, 48, 32), True)])
def test_calibrated_tensor_bit_equal(shape, with_h):
    rng = np.random.default_rng(1)
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    w.reshape(-1, shape[-1])[0] *= 20.0  # an outlier row, so clipping pays
    h = rng.uniform(0.01, 2.0, shape[-2]).astype(np.float32) if with_h else None
    ref = jax_calibrate.quantize_tensor_calibrated(w, h)
    out = port_calibrate.quantize_tensor_calibrated(torch.from_numpy(w), h)
    np.testing.assert_array_equal(out["q"], ref["q"])
    np.testing.assert_array_equal(out["scale"], ref["scale"])
    assert port_calibrate.DEFAULT_GRID == jax_calibrate.DEFAULT_GRID


def test_calibrated_tree_bit_equal_given_the_same_moments(jax_variables, moments):
    ref_moments, _ = moments
    jax_tree = {"base": convert_state_dict(export_state_dict(jax_variables, JCFG), JCFG)}
    tree = jax_tree_from_state_dict(state_dict_from_jax(jax_variables, PCFG), PCFG)
    ref = jax_calibrate.quantize_params_calibrated(jax_tree, ref_moments)
    out = port_calibrate.quantize_params_calibrated(tree, ref_moments)

    def walk(a, b, path=()):
        assert list(a) == list(b), path
        for k in a:
            if isinstance(a[k], dict) and set(a[k]) != {"q", "scale"}:
                walk(a[k], b[k], path + (k,))
            elif isinstance(a[k], dict):
                np.testing.assert_array_equal(b[k]["q"], a[k]["q"])
                np.testing.assert_array_equal(b[k]["scale"], a[k]["scale"])
                walk.n += 1
            else:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))

    walk.n = 0
    walk(ref, out)
    assert walk.n > 5
