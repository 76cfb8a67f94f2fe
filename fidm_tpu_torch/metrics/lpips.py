"""LPIPS (AlexNet backbone) in PyTorch, with torch-weight import (port of
`fidm_tpu/metrics/lpips.py`).

The reference uses `lpips.LPIPS(net='alex')` batched on GPU
(`test_inpainting_better.py:120-125,239-264`). This is the same computation:
AlexNet conv features at the five ReLU taps, channel-unit-normalization
(eps outside the sqrt), learned 1x1 linear heads, spatial mean, layer sum.
Weights import from the standard torch checkpoints (torchvision AlexNet
`features.*` + lpips `lin*.model.1.weight`) supplied locally by the user; no
pretrained default ships.

Without weights, `LPIPS(weights=None)` uses seeded random filters, the same
numpy draws as the JAX package's: a *proxy* perceptual distance for
tests/relative comparisons only. The forwards run in full float32
(`full_float32`) on `device` ("cuda" by default; raises without a GPU).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .inception import full_float32

__all__ = ["LPIPS", "convert_torch_lpips_weights"]

# AlexNet feature config: (out_ch, kernel, stride, pad), ReLU taps after each
_ALEX = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # maxpool after taps 0 and 1

# lpips input scaling constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def convert_torch_lpips_weights(alexnet_sd: Dict, lpips_sd: Dict) -> Dict:
    """Torch state dicts -> the weight dict {"convs": [{"kernel": HWIO,
    "bias"}], "lins": [[C]]}, as in the JAX package.

    alexnet_sd: torchvision AlexNet (keys `features.{0,3,6,8,10}.weight/bias`)
    lpips_sd: lpips LPIPS(net='alex') (keys `lin{0..4}.model.1.weight`)
    """
    conv_idx = [0, 3, 6, 8, 10]
    convs = []
    for i in conv_idx:
        w = np.asarray(alexnet_sd[f"features.{i}.weight"])  # OIHW
        b = np.asarray(alexnet_sd[f"features.{i}.bias"])
        convs.append({"kernel": w.transpose(2, 3, 1, 0), "bias": b})
    lins = []
    for i in range(5):
        w = np.asarray(lpips_sd[f"lin{i}.model.1.weight"])  # [1, C, 1, 1]
        lins.append(w[0, :, 0, 0])
    return {"convs": convs, "lins": lins}


def _unit(a):
    """lpips `normalize_tensor`: a / (||a||_c + eps), eps OUTSIDE the sqrt."""
    return a / (torch.sqrt(torch.sum(a**2, dim=1, keepdim=True)) + 1e-10)


class LPIPS:
    def __init__(self, weights: Optional[Dict] = None, seed: int = 0, device="cuda"):
        if weights is None:
            rng = np.random.default_rng(seed)
            weights = {"convs": [], "lins": []}
            in_ch = 3
            for out_ch, k, s, p in _ALEX:
                fan = in_ch * k * k
                weights["convs"].append({
                    "kernel": (rng.standard_normal((k, k, in_ch, out_ch))
                               / np.sqrt(fan)).astype(np.float32),
                    "bias": np.zeros(out_ch, np.float32),
                })
                weights["lins"].append(
                    np.full(out_ch, 1.0 / out_ch, np.float32)
                )
                in_ch = out_ch
            self.is_proxy = True
        else:
            self.is_proxy = False
        self.weights = weights
        self.device = resolve_device(device)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        self._convs = [(dev(np.asarray(c["kernel"]).transpose(3, 2, 0, 1)), dev(c["bias"]))
                       for c in weights["convs"]]
        self._lins = [dev(lin).view(1, -1, 1, 1) for lin in weights["lins"]]
        self._shift = dev(_SHIFT).view(1, 3, 1, 1)
        self._scale = dev(_SCALE).view(1, 3, 1, 1)

    def _features(self, x):
        """x: NCHW in [-1,1] -> list of 5 NCHW feature maps."""
        h = (x - self._shift) / self._scale
        taps = []
        for i, ((out_ch, k, s, p), (w, b)) in enumerate(zip(_ALEX, self._convs)):
            h = F.relu(F.conv2d(h, w, b, stride=s, padding=p))
            taps.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, stride=2)
        return taps

    def _pair(self, img1, img2):
        x = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(img2, dtype=torch.float32, device=self.device)
        return (self._features(x.permute(0, 3, 1, 2)),
                self._features(y.permute(0, 3, 1, 2)))

    def __call__(self, img1, img2) -> np.ndarray:
        """Perceptual distance per batch element; inputs [-1,1] NHWC."""
        with torch.inference_mode(), full_float32():
            fx, fy = self._pair(img1, img2)
            total = 0.0
            for a, b, lin in zip(fx, fy, self._lins):
                d = (_unit(a) - _unit(b)) ** 2
                # learned linear head (1x1 conv, no clamp at inference),
                # then spatial mean
                total = total + (d * lin).sum(1).mean((1, 2))
            return total.cpu().numpy()

    def masked(self, img1, img2, mask) -> np.ndarray:
        """Hole-region perceptual distance: the per-tap spatial mean is
        weighted by `mask` ([B,H,W,1], 1 = hole) resized to each tap's
        grid (bilinear with antialiasing, as `jax.image.resize` "linear"
        does). mask == 1 everywhere reproduces `__call__`."""
        with torch.inference_mode(), full_float32():
            fx, fy = self._pair(img1, img2)
            m = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            m = m.permute(0, 3, 1, 2)
            total = 0.0
            for a, b, lin in zip(fx, fy, self._lins):
                d = ((_unit(a) - _unit(b)) ** 2 * lin).sum(1)  # [B, h, w]
                mk = F.interpolate(m, size=a.shape[2:], mode="bilinear",
                                   align_corners=False, antialias=True)[:, 0]
                total = total + (d * mk).sum((1, 2)) / torch.clamp(mk.sum((1, 2)), min=1e-6)
            return total.cpu().numpy()

    @classmethod
    def from_torch_files(cls, alexnet_path: str, lpips_path: str, device="cuda") -> "LPIPS":
        device = resolve_device(device)
        alex = torch.load(alexnet_path, map_location="cpu", weights_only=False)
        lin = torch.load(lpips_path, map_location="cpu", weights_only=False)

        def to_np(sd):
            return {k: v.detach().numpy() if hasattr(v, "detach") else v
                    for k, v in sd.items()}

        return cls(convert_torch_lpips_weights(to_np(alex), to_np(lin)), device=device)
