"""The port's quantize CLI against the JAX package's, in both directions.

Both CLIs read one ADM `.pt` (written by `fidm_tpu`'s exporter) of the 32²
model that the flags can express. On the CPU both round every kernel to
nearest, so the `.npz` files must hold the same entries, in the same order,
with bit-equal arrays, and the reports must agree. A JAX-written `.npz` then
drives the port's model: its forward on the dequantized weights is held
against JAX's at 2e-4 of the output's max (float32 on both sides, the sums
in another order, as in test_torch_port_unet.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fidm_tpu.cli import quantize as jax_cli
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import ffhq256_config as jax_ffhq256_config
from fidm_tpu.models.torch_import import save_torch_checkpoint
from fidm_tpu.quant import dequantize_params as jax_dequantize_params
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.cli import quantize as port_cli
from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
from fidm_tpu_torch.quant import load_quantized_state_dict

from _torch_port_common import perturbed_jax_variables

SHAPE = dict(image_size=32, model_channels=32, channel_mult=(1, 2), num_heads=2,
             num_head_channels=16, attention_resolutions=(2,))
FLAGS = ["--image_size", "32", "--model_channels", "32", "--channel_mult", "1", "2",
         "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
         "--min_size", "512"]
JCFG32 = jax_ffhq256_config(**SHAPE, dtype=jnp.float32)
PCFG32 = ffhq256_config(**SHAPE, dtype=torch.float32)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_cli")
    variables = perturbed_jax_variables(JCFG32, seed=5)
    path = str(root / "model.pt")
    save_torch_checkpoint(path, variables, JCFG32)
    return path


@pytest.fixture(scope="module")
def npz_pair(checkpoint, tmp_path_factory):
    """(JAX report, JAX .npz, port report, port .npz) for one checkpoint."""
    root = tmp_path_factory.mktemp("quant_out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FIDM_NO_COMPILATION_CACHE", "1")
        jax_report = jax_cli.main(["--checkpoint", checkpoint, "--out",
                                   str(root / "jax.npz"), *FLAGS])
    port_report = port_cli.main(["--checkpoint", checkpoint, "--out", str(root / "port.npz"),
                                 *FLAGS, "--device", "cpu"])
    return jax_report, str(root / "jax.npz"), port_report, str(root / "port.npz")


def test_port_npz_bit_equal_to_jax_npz(npz_pair):
    jax_report, jax_npz, port_report, port_npz = npz_pair
    assert port_report == jax_report
    assert jax_report["tensors_quantized"] > 10 and not jax_report["calibrated"]
    with np.load(jax_npz) as ref, np.load(port_npz) as ours:
        assert ours.files == ref.files
        assert any(k.endswith(".__q__") for k in ours.files)
        assert "base/in_0_conv/kernel.__q__" in ours.files  # [3,3,9,32] > min_size
        for key in ref.files:
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_each_package_reads_the_others_npz(npz_pair):
    _, jax_npz, _, port_npz = npz_pair
    ours = port_cli.load_quantized(jax_npz)
    ref = jax_cli.load_quantized(port_npz)

    def walk(a, b):
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))

    walk(ours, ref)


def _inputs(seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 8:24, 6:20] = 1.0
    return x, np.array([3, 810][:b], np.int32), gt * (1.0 - mask), mask


def test_jax_npz_drives_the_port_model(npz_pair):
    _, jax_npz, _, _ = npz_pair
    x, t, masked, mask = _inputs(0)
    params = jax_dequantize_params(jax_cli.load_quantized(jax_npz))
    ref = np.asarray(jax.jit(JaxInpaintingUNet(JCFG32).apply)(
        {"params": params}, x, t, masked, mask))
    model = InpaintingUNet(PCFG32).eval()
    model.load_state_dict(load_quantized_state_dict(jax_npz, PCFG32), strict=True)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, masked, mask))).numpy()
    assert np.abs(ref).max() > 0.1
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 2e-4, err


def test_calibrated_cli_on_cpu(checkpoint, npz_pair, tmp_path):
    """--calibrate over a directory of PNGs: calibrated scales for the same
    tensors, and the `.npz` loads into a pipeline with strict=True."""
    rng = np.random.default_rng(1)
    img_dir = tmp_path / "calib"
    img_dir.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
    out = str(tmp_path / "calibrated.npz")
    report = port_cli.main(["--checkpoint", checkpoint, "--out", out, *FLAGS,
                            "--calibrate", str(img_dir), "--calib_samples", "3",
                            "--calib_batch", "2", "--diffusion_steps", "100",
                            "--device", "cpu"])
    jax_report, _, _, port_npz = npz_pair
    assert report["calibrated"]
    assert report["tensors_quantized"] == jax_report["tensors_quantized"]
    assert report["bytes_after"] == jax_report["bytes_after"]
    with np.load(out) as cal, np.load(port_npz) as absmax:
        assert cal.files == absmax.files
        # clipping (alpha < 1) shrinks some scales below absmax, never above
        for key in cal.files:
            if key.endswith(".__scale__"):
                assert (cal[key] <= absmax[key]).all(), key
        assert any((cal[k] < absmax[k]).any() for k in cal.files if k.endswith(".__scale__"))
    pipe = InpaintingPipeline.create(PipelineConfig(unet=PCFG32), device="cpu")
    pipe.model.load_state_dict(load_quantized_state_dict(out, PCFG32), strict=True)


def test_cli_defaults_to_cuda(checkpoint, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--checkpoint", checkpoint, "--out", str(tmp_path / "x.npz"), *FLAGS])
    assert port_cli.parse_args(["--checkpoint", "a", "--out", "b"]).device == "cuda"
