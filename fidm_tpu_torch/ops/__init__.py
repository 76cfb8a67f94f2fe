from .attention import qkv_attention
from .quantize import stochastic_quantize
from .registry import LAUNCHES, OPS, kernel_override, use_kernel

__all__ = ["LAUNCHES", "OPS", "kernel_override", "qkv_attention", "stochastic_quantize",
           "use_kernel"]
