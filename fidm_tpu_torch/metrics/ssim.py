"""SSIM and PSNR (PyTorch port of `fidm_tpu/metrics/ssim.py`).

The reference computes SSIM per image with `skimage.metrics
.structural_similarity(win_size=11, channel_axis=2, data_range=1.0)`
(`test_inpainting_better.py:127-149`): the Wang et al. SSIM with a uniform
11x11 window, K1=0.01, K2=0.03, unbiased covariance, no gaussian weighting.
Here it is a batched function of NHWC images (numpy arrays or tensors, on
any device; the result is a float32 tensor on the input's device). The
window filter is a valid-mode mean (`F.avg_pool2d` with stride 1, which
on the GPU is an ATen kernel, never a TF32 convolution).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim", "psnr", "masked_ssim", "masked_psnr", "DEFAULT_WIN_SIZE"]

# the default window everywhere (skimage's structural_similarity default);
# consumers needing the centred-window border radius should derive it as
# (DEFAULT_WIN_SIZE - 1) // 2 instead of hard-coding 5
DEFAULT_WIN_SIZE = 11


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _ssim_map(img1, img2, win_size: int, data_range: float) -> torch.Tensor:
    """SSIM at every valid window position, NCHW [B, C, H-win+1, W-win+1]."""
    if win_size < 3 or win_size % 2 == 0:
        raise ValueError(
            f"win_size must be odd and >= 3 (got {win_size}): the unbiased "
            "covariance normalization divides by win_size^2 - 1")
    x = _f32(img1).permute(0, 3, 1, 2)
    y = _f32(img2, x.device).permute(0, 3, 1, 2)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    # skimage uses unbiased (ddof=1) covariance normalization
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)

    def filt(a):
        return F.avg_pool2d(a, win_size, stride=1)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    return (A1 * A2) / (B1 * B2)


def ssim(img1, img2, *, win_size: int = DEFAULT_WIN_SIZE,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM per batch element. img1/img2: [B,H,W,C] in [0, data_range]."""
    # the valid-mode map equals skimage's full map cropped by (win_size-1)//2
    return _ssim_map(img1, img2, win_size, data_range).mean(dim=(1, 2, 3))


def masked_ssim(img1, img2, mask, *, win_size: int = DEFAULT_WIN_SIZE,
                data_range: float = 1.0) -> torch.Tensor:
    """SSIM averaged over window positions centred in the mask (hole).

    mask: [B,H,W,1], 1 = hole. Images with an empty mask return 0 (no hole
    to score). Hole pixels within (win_size-1)//2 of the image border have no
    centred window and are excluded; a hole lying entirely in that border
    band scores 0."""
    s = _ssim_map(img1, img2, win_size, data_range)
    r = (win_size - 1) // 2
    m = _f32(mask, s.device)
    H, W = m.shape[1], m.shape[2]
    w = m[:, r:H - r, r:W - r, :].permute(0, 3, 1, 2)
    num = (s * w).sum(dim=(1, 2, 3))
    den = w.sum(dim=(1, 2, 3)) * s.shape[1]
    return num / torch.clamp(den, min=1.0)


def masked_psnr(img1, img2, mask, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over mask (hole) pixels only. mask: [B,H,W,1], 1 = hole."""
    x = _f32(img1)
    d = (x - _f32(img2, x.device)) ** 2
    m = _f32(mask, x.device)
    mse = (d * m).sum(dim=(1, 2, 3)) / torch.clamp(
        m.sum(dim=(1, 2, 3)) * d.shape[-1], min=1.0)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def psnr(img1, img2, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio per batch element, NHWC."""
    x = _f32(img1)
    mse = torch.mean((x - _f32(img2, x.device)) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
