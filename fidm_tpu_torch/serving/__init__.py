"""The batched inpainting HTTP server (PyTorch port of `fidm_tpu.serving`,
without its AOT program cache)."""
from .server import (
    DeadlineExceededError,
    InpaintingServer,
    ServerOverloadedError,
    serve,
)

__all__ = ["InpaintingServer", "serve", "ServerOverloadedError",
           "DeadlineExceededError"]
