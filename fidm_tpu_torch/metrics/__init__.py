"""Quality metrics of the eval harness (PyTorch port of `fidm_tpu.metrics`):
SSIM/PSNR and their hole-region variants, FID with InceptionV3 pool3
features or the proxy extractor, KID, and LPIPS."""
from .fid import (
    InceptionFeatureExtractor,
    RandomConvFeatureExtractor,
    compute_statistics,
    fid_between_image_sets,
    fid_from_features,
    frechet_distance,
    kid_from_features,
    polynomial_mmd2,
)
from .inception import convert_torch_inception_weights
from .lpips import LPIPS
from .ssim import masked_psnr, masked_ssim, psnr, ssim

__all__ = [
    "InceptionFeatureExtractor",
    "LPIPS",
    "RandomConvFeatureExtractor",
    "compute_statistics",
    "convert_torch_inception_weights",
    "fid_between_image_sets",
    "fid_from_features",
    "frechet_distance",
    "kid_from_features",
    "masked_psnr",
    "masked_ssim",
    "polynomial_mmd2",
    "psnr",
    "ssim",
]
