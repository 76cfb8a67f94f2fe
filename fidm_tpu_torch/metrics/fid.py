"""FID: activation statistics + Frechet distance, with pluggable features
(PyTorch port of `fidm_tpu/metrics/fid.py`).

The reference shells out to `pytorch_fid` over saved PNG directories with
InceptionV3 pool3 features (`test_inpainting_better.py:151-223`). Here the
statistics are float64 numpy on the host (mean/covariance, the Frechet
distance via scipy sqrtm with the standard eps-regularized retry, KID), the
same code as the JAX package's, and the feature extractor is pluggable:

- `InceptionFeatureExtractor` (from `.inception`, re-exported here) — the
  real FID instrument, fed `pt_inception-2015-12-05`-layout torch weights
  the user supplies locally; no pretrained default ships.
- `RandomConvFeatureExtractor` — a seeded random-projection CNN producing a
  *proxy* FID for pipeline tests and relative comparisons only (NOT
  comparable to published FID numbers). Its weights are drawn with numpy
  from `seed`; JAX draws its own from threefry, which torch cannot
  reproduce, so a proxy FID compares only with another from this package
  (or from weights carried across: `weights=`).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .inception import InceptionFeatureExtractor, full_float32

__all__ = [
    "compute_statistics",
    "frechet_distance",
    "fid_from_features",
    "polynomial_mmd2",
    "kid_from_features",
    "fid_between_image_sets",
    "InceptionFeatureExtractor",
    "RandomConvFeatureExtractor",
]


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix in float64."""
    f = np.asarray(features, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the FID formula).

    ||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the standard
    eps-on-diagonal retry when the matrix sqrt is numerically singular.
    """
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    def _sqrtm(a):
        # scipy >= 1.16 deprecates disp= and returns the array alone;
        # older versions return (sqrtm, errest) with disp=False
        res = linalg.sqrtm(a)
        return res[0] if isinstance(res, tuple) else res

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, s1 = compute_statistics(real)
    mu2, s2 = compute_statistics(fake)
    return frechet_distance(mu1, s1, mu2, s2)


def polynomial_mmd2(f_real: np.ndarray, f_fake: np.ndarray,
                    degree: int = 3, gamma: Optional[float] = None,
                    coef0: float = 1.0) -> float:
    """Unbiased MMD² with the KID polynomial kernel
    k(x, y) = (gamma x·y + coef0)^degree (Bińkowski et al. 2018,
    arXiv:1801.01401; gamma defaults to 1/dim as in the paper)."""
    X = np.asarray(f_real, np.float64)
    Y = np.asarray(f_fake, np.float64)
    if len(X) < 2 or len(Y) < 2:
        raise ValueError("MMD needs at least 2 samples per set")
    g = gamma if gamma is not None else 1.0 / X.shape[1]
    k_xx = (g * (X @ X.T) + coef0) ** degree
    k_yy = (g * (Y @ Y.T) + coef0) ** degree
    k_xy = (g * (X @ Y.T) + coef0) ** degree
    m, n = len(X), len(Y)
    term_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    term_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    return float(term_xx + term_yy - 2.0 * k_xy.mean())


def kid_from_features(real: np.ndarray, fake: np.ndarray,
                      n_subsets: int = 100, max_subset_size: int = 1000,
                      seed: int = 0) -> Tuple[float, float]:
    """Kernel Inception Distance: (mean, std) of the unbiased polynomial
    MMD² over random subsets — the torch-fidelity / tf-gan protocol.

    The estimator is unbiased, so it stays meaningful at the small sample
    counts where FID's 2048x2048 covariance estimate is badly biased.
    Deterministic for a given seed."""
    real = np.asarray(real)
    fake = np.asarray(fake)
    m = min(len(real), max_subset_size)
    n = min(len(fake), max_subset_size)
    if m == len(real) and n == len(fake):
        # every "subset" would be a permutation of the full sets and the
        # estimator is permutation-invariant: one exact computation; the
        # subset-variance statistic is undefined (0.0) at this sample count
        return polynomial_mmd2(real, fake), 0.0
    rng = np.random.default_rng(seed)
    vals = [
        polynomial_mmd2(real[rng.choice(len(real), m, replace=False)],
                        fake[rng.choice(len(fake), n, replace=False)])
        for _ in range(n_subsets)
    ]
    v = np.asarray(vals, np.float64)
    return float(v.mean()), float(v.std())


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after), the odd
    pixel after (256 -> 128 with k=3, s=2 pads 0 before and 1 after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class RandomConvFeatureExtractor:
    """Seeded random CNN features — a PROXY metric for pipeline testing.

    Three 3x3 stride-2 "SAME" convs with relu (32, 64, `dim` channels), then
    a spatial mean. Distances are meaningful only relative to other runs of
    this extractor with the same weights; they are NOT comparable to
    InceptionV3 FID. The weights are numpy draws from `seed` (scaled 0.3,
    0.15, 0.1 like the JAX package's threefry draws), or `weights`: three
    HWIO arrays, e.g. the JAX extractor's `w1, w2, w3` carried across.
    Runs on `device` ("cuda" by default; raises without a GPU)."""

    def __init__(self, dim: int = 256, seed: int = 0, image_size: int = 256, *,
                 weights: Optional[Sequence] = None, device="cuda"):
        if weights is None:
            rng = np.random.default_rng(seed)
            weights = [rng.standard_normal(shape) * scale for shape, scale in
                       (((3, 3, 3, 32), 0.3), ((3, 3, 32, 64), 0.15),
                        ((3, 3, 64, dim), 0.1))]
        self.weights = tuple(np.asarray(w, np.float32) for w in weights)  # HWIO
        self.dim = self.weights[-1].shape[-1]
        self.device = resolve_device(device)
        self._oihw = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
                      .to(self.device) for w in self.weights]

    def __call__(self, images01) -> np.ndarray:
        """[B,H,W,3] in [0,1] (numpy or a tensor) -> float32 [B, dim]."""
        x = torch.as_tensor(images01, dtype=torch.float32, device=self.device)
        h = x.permute(0, 3, 1, 2) * 2.0 - 1.0
        with torch.inference_mode(), full_float32():
            for w in self._oihw:
                top, bottom = _same_pad(h.shape[2], 3, 2)
                left, right = _same_pad(h.shape[3], 3, 2)
                h = F.relu(F.conv2d(F.pad(h, (left, right, top, bottom)), w, stride=2))
            return h.mean(dim=(2, 3)).cpu().numpy()


def fid_between_image_sets(
    real_images01: Iterable[np.ndarray],
    fake_images01: Iterable[np.ndarray],
    extractor: Optional[Callable] = None,
    batch_size: int = 32,
    device="cuda",
) -> float:
    """FID between two iterables of [B,H,W,3] image arrays in [0,1]; the
    default extractor is the proxy, on `device`."""
    extractor = extractor or RandomConvFeatureExtractor(device=device)

    def feats(batches):
        out = []
        for b in batches:
            b = np.asarray(b)
            for i in range(0, len(b), batch_size):
                out.append(extractor(b[i : i + batch_size]))
        return np.concatenate(out, axis=0)

    return fid_from_features(feats(real_images01), feats(fake_images01))
