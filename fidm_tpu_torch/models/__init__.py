from .unet import InpaintingUNet, UNet, UNetConfig, ffhq256_config

__all__ = ["InpaintingUNet", "UNet", "UNetConfig", "ffhq256_config"]
