"""The batched inpainting HTTP server and its warm program cache (PyTorch
port of `fidm_tpu.serving`; `aot` keeps manifests of CUDA-graph programs,
not executables: see its docstring)."""
from .server import (
    DeadlineExceededError,
    InpaintingServer,
    ServerOverloadedError,
    serve,
)

__all__ = ["InpaintingServer", "serve", "ServerOverloadedError",
           "DeadlineExceededError"]
