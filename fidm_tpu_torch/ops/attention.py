"""Spatial self-attention over [B, H, S, D]: a CUDA kernel and its plain version.

Counterpart of `fidm_tpu/ops/attention.py`. q and k are each pre-scaled by
D^-0.25, the softmax runs in float32 whatever the activation dtype, and the
result comes back in the input dtype.

- `_attention_reference` is the plain PyTorch version, step for step the JAX
  `_attention_reference`: in bf16 it scales and multiplies in bf16 and casts
  the f32 softmax back to bf16.
- `csrc/attention.cu` is the kernel (it replaces the Pallas
  `_attention_kernel`); it keeps q.k, the softmax and P.v in f32. In bf16 the
  two therefore differ by bf16 rounding, as the JAX einsum and Pallas paths
  do (atol 2e-2 in tests/test_ops.py).

`qkv_attention` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors (see `registry`). Its backward recomputes through the
plain version, as the JAX custom VJP does.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .registry import LAUNCHES, use_kernel

__all__ = ["qkv_attention"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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


def _load_kernel() -> ctypes.CDLL:
    lib = build.load("attention")
    fn = lib.fidm_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _attention_cuda(q, k, v):
    """Launch the CUDA kernel on the current stream."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be CUDA tensors on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if d not in _HEAD_DIMS or s < 1 or b * h < 1:
        raise ValueError(f"attention kernel takes D in {_HEAD_DIMS} and S >= 1, "
                         f"got {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k, v")
    fn = _load_kernel().fidm_attention_fwd
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, s, d, _DTYPE_CODES[q.dtype], float(d) ** -0.25, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES["attention"] += 1
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
