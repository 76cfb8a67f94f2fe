"""Spatial self-attention over [B, H, S, D]: a CUDA kernel and its plain version.

Counterpart of `fidm_tpu/ops/attention.py`. q and k are each pre-scaled by
D^-0.25, the softmax runs in float32 whatever the activation dtype, and the
result comes back in the input dtype.

- `_attention_reference` is the plain PyTorch version, step for step the JAX
  `_attention_reference`: in bf16 it scales and multiplies in bf16 and casts
  the f32 softmax back to bf16.
- `csrc/attention.cu` holds the kernels (they replace the Pallas
  `_attention_kernel`): for bf16 a flash kernel whose two products run on the
  tensor cores, which multiplies q.k exactly in f32, keeps the softmax in f32
  and rounds only the unnormalised P to bf16 for P.v; for float32 a kernel on
  the CUDA cores, all f32. In bf16 the kernel and the plain version therefore
  differ by bf16 rounding, as the JAX einsum and Pallas paths do (atol 2e-2 in
  tests/test_ops.py). The kernels read q, k and v as strided views, so the
  q/k/v chunks of one qkv projection go in without a copy.

`qkv_attention` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors (see `registry`). Its backward recomputes through the
plain version, as the JAX custom VJP does.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import build
from .registry import LAUNCHES, use_kernel

__all__ = ["qkv_attention"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# per-dtype launch counts beside the op's own, one kernel each
_VARIANTS = {torch.float32: "attention.f32", torch.bfloat16: "attention.bf16"}
_HEAD_DIMS = (32, 64, 128)


def _attention_reference(q, k, v):
    """Plain version, the exact reference semantics."""
    ch = q.shape[-1]
    # 1/sqrt(sqrt(D)) in float32, rounded to the input dtype; a CPU scalar,
    # so a CUDA caller does not wait for a host-to-device copy
    scale = (1.0 / torch.sqrt(torch.sqrt(
        torch.tensor(ch, dtype=torch.float32)))).to(q.dtype)
    weight = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
    weight = torch.softmax(weight.float(), dim=-1).to(q.dtype)
    return torch.matmul(weight, v)


# The launch's 19 integers (see `fidm_attention_fwd` in csrc/attention.cu) go
# in one int64 buffer: ctypes converts one argument in a fraction of a
# microsecond, and nineteen of them cost more than the kernel at S=64.
_PARAMS = struct.Struct("=19q")
_fn = None  # the kernel's C entry point, resolved at first use
# The bf16 kernel's blocks hold 64 query rows in 1 or 2 key groups of 4 warps
# (`launch_mma_d` in csrc/attention.cu).
KEY_GROUPS = (1, 2)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("attention").fidm_attention_fwd
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _key_groups(bh: int, s: int, sms: int) -> int:
    """The bf16 kernel's key groups for B*H = bh and S = s on a card of `sms`
    streaming multiprocessors: two where 64-row blocks make fewer than two
    per SM and there are at least two key tiles of 64 to share (the main
    path's S=256 on an H100, PERF.md), else one."""
    return 2 if bh * -(-s // 64) < 2 * sms and s > 64 else 1


def _row_strides(t: torch.Tensor, name: str):
    """The (b, h, s) strides, in elements, of a [B, H, S, D] view that the
    kernel reads as it is: D contiguous and every row start 16-byte aligned
    (a stride along a dimension of size 1 is never used). Raises ValueError
    for any other view; nothing is copied."""
    b, h, s, _ = t.shape
    sb, sh, ss, sd = t.stride()
    e = t.element_size()
    if sd != 1 or (t.data_ptr() | (b > 1) * sb * e | (h > 1) * sh * e
                   | (s > 1) * ss * e) & 15:
        raise ValueError(
            f"attention kernel reads rows of {name} in place: its last dimension must "
            f"be contiguous and every row start 16-byte aligned, got strides "
            f"{t.stride()} of {t.dtype} at address {t.data_ptr()} (offset "
            f"{t.data_ptr() % 16} mod 16)")
    return sb, sh, ss


def _attention_cuda(q, k, v, key_groups=None):
    """Launch the CUDA kernel on the current stream: the bf16 tensor-core
    kernel for bfloat16, the CUDA-core kernel for float32. q, k, v may be
    strided views (see `_row_strides`); the output is contiguous.
    `key_groups`, one of `KEY_GROUPS`, overrides `_key_groups`' choice."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be CUDA tensors on one device")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {dtype}, {k.dtype}, {v.dtype}")
    shape = q.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = shape
    if d not in _HEAD_DIMS or s < 1 or b * h < 1:
        raise ValueError(f"attention kernel takes D in {_HEAD_DIMS} and S >= 1, "
                         f"got {tuple(shape)}")
    strides = (*_row_strides(q, "q"), *_row_strides(k, "k"), *_row_strides(v, "v"))
    device = q.get_device()
    if key_groups is None:
        key_groups = _key_groups(b * h, s, _sm_count(device))
    fn = _kernel()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    params = _PARAMS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          b, h, s, d, _DTYPE_CODES[dtype], key_groups, *strides)
    # the current stream's raw handle, without building a torch.cuda.Stream
    # object; the device context is entered only when q is on another device
    if device == torch.cuda.current_device():
        err = fn(params, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(params, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES["attention"] += 1
    LAUNCHES[_VARIANTS[dtype]] += 1
    return out


def _attention_forward(q, k, v):
    if use_kernel("attention", q.device):
        return _attention_cuda(q, k, v)
    return _attention_reference(q, k, v)


class _Attention(torch.autograd.Function):
    """Kernel (or plain) forward; the backward recomputes the plain version
    and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
            out = _attention_reference(q, k, v)
            return torch.autograd.grad(out, (q, k, v), grad_out)


def qkv_attention(q, k, v):
    """Multi-head attention over [B, H, S, D] tensors."""
    return _Attention.apply(q, k, v)
