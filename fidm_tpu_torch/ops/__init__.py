from .attention import qkv_attention
from .registry import LAUNCHES, kernel_override, use_kernel

__all__ = ["LAUNCHES", "kernel_override", "qkv_attention", "use_kernel"]
