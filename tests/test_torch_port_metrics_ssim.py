"""The port's SSIM and PSNR, over the whole image and over the hole region,
against the JAX package's, on the same numpy inputs from a seed. Each
tolerance is stated beside its test.
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_metrics_common import _images, _mask


# the modules (each package's `metrics.ssim` attribute is the function)
jax_ssim = importlib.import_module("fidm_tpu.metrics.ssim")
port_ssim = importlib.import_module("fidm_tpu_torch.metrics.ssim")


# ----------------------------------------------------------------- SSIM / PSNR
# float32 on both sides; the 11x11 window means are sums in another order
# (avg_pool2d against XLA's convolution). SSIM lies in [-1, 1]: 2e-6
# absolute (measured up to about 3e-7). PSNR is in dB (10-40 here), where
# one float32 ulp of the log is about 2e-6: 2e-5 absolute.
SSIM_TOL = 2e-6
PSNR_TOL = 2e-5
MASKS = ["box", "brush", "empty", "border"]


@pytest.mark.parametrize("win", [7, 11])
def test_ssim_matches_jax(win):
    a, b = _images(0, 2, 48)
    ref = np.asarray(jax_ssim.ssim(a, b, win_size=win))
    ours = port_ssim.ssim(a, b, win_size=win)
    assert ours.dtype == torch.float32 and ours.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=SSIM_TOL, rtol=0)


@pytest.mark.parametrize("win", [7, 11])
@pytest.mark.parametrize("kind", MASKS)
def test_masked_ssim_matches_jax(kind, win):
    a, b = _images(1, 2, 48)
    m = _mask(kind)
    ref = np.asarray(jax_ssim.masked_ssim(a, b, m, win_size=win))
    ours = port_ssim.masked_ssim(a, b, m, win_size=win).numpy()
    np.testing.assert_allclose(ours, ref, atol=SSIM_TOL, rtol=0)
    if kind in ("empty", "border"):  # no centred window in the hole: 0
        assert np.all(ours == 0.0) and np.all(ref == 0.0)


def test_psnr_matches_jax():
    a, b = _images(2, 2, 48)
    np.testing.assert_allclose(port_ssim.psnr(a, b).numpy(), np.asarray(jax_ssim.psnr(a, b)),
                               atol=PSNR_TOL, rtol=0)
    # identical images: the 1e-12 floor on the mse, 120 dB
    np.testing.assert_allclose(port_ssim.psnr(a, a).numpy(), np.asarray(jax_ssim.psnr(a, a)),
                               atol=PSNR_TOL, rtol=0)


@pytest.mark.parametrize("kind", MASKS)
def test_masked_psnr_matches_jax(kind):
    a, b = _images(3, 2, 48)
    m = _mask(kind)
    np.testing.assert_allclose(port_ssim.masked_psnr(a, b, m).numpy(),
                               np.asarray(jax_ssim.masked_psnr(a, b, m)), atol=PSNR_TOL, rtol=0)


@pytest.mark.parametrize("win", [1, 4, 10])
def test_ssim_rejects_what_jax_rejects(win):
    a, b = _images(4, 1, 24)
    with pytest.raises(ValueError, match="win_size must be odd"):
        jax_ssim.ssim(a, b, win_size=win)
    with pytest.raises(ValueError, match="win_size must be odd"):
        port_ssim.ssim(a, b, win_size=win)


def test_ssim_default_window_and_tensor_inputs():
    assert port_ssim.DEFAULT_WIN_SIZE == jax_ssim.DEFAULT_WIN_SIZE == 11
    a, b = _images(5, 2, 32)
    from_numpy = port_ssim.ssim(a, b)
    from_tensor = port_ssim.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(from_numpy, from_tensor)
