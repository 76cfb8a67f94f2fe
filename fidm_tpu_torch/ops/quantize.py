"""Per-column int8 quantization with stochastic rounding: a CUDA kernel and
its plain version.

Counterpart of the Pallas `_quantize_pallas` in `fidm_tpu/quant/int8.py`.
For a float32 [N, C] matrix (a weight reshaped to [rows, out channels]):

    scale = max(column absmax, 1e-8) / 127
    q     = clip(floor(x / scale + u), -127, 127) as int8

with u uniform on [0, 1) from 24 random bits. The TPU drew them from its
hardware generator, which nothing else reproduces; the port draws them from
Philox4x32-10 keyed by (seed, 0), the counter being the element's flat index
/ 4 and the output lane its flat index % 4.

- `_quantize_stochastic_reference` is the plain PyTorch version. Its Philox
  is a transcription in int64 arithmetic masked to 32 bits (the 32x32->64
  multiply in 16-bit halves, so nothing overflows), so on the card it agrees
  with the kernel bit for bit.
- `csrc/quantize.cu` is the kernel.

`stochastic_quantize` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors (see `registry`).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build
from .registry import LAUNCHES, use_kernel

__all__ = ["stochastic_quantize", "column_scales", "philox4x32_10"]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MAX_ROWS = 65535 * 256  # grid rows of the absmax pass x rows per block


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * b, for a 32-bit
    constant a and int64 b holding 32-bit values: b is split in 16-bit halves
    so that no partial product reaches 2^63."""
    x = a * (b & 0xFFFF)        # < 2^48
    y = a * (b >> 16)           # < 2^48; a * b = y * 2^16 + x
    lo = (x + ((y & 0xFFFF) << 16)) & _MASK32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr: Sequence[torch.Tensor], key: Sequence[int]):
    """Philox4x32 with 10 rounds (Random123). `ctr`: four int64 tensors of
    32-bit words, `key`: two 32-bit ints. Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(n: int, seed: int, device) -> torch.Tensor:
    """u in [0, 1) for flat indices 0 .. n-1, float32: the top 24 bits of
    Philox lane index % 4 at counter index // 4, times 2^-24."""
    k = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(k)
    words = philox4x32_10((k & _MASK32, k >> 32, zero, zero), (seed, 0))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def column_scales(x2d: torch.Tensor) -> torch.Tensor:
    """[1, C] float32 scales, max(column absmax, 1e-8) / 127. The divisor is
    a tensor, not a Python number: on CUDA, PyTorch turns division by a
    number into multiplication by its reciprocal, which rounds differently."""
    absmax = x2d.abs().amax(dim=0, keepdim=True).clamp_min(1e-8)
    return absmax / torch.full_like(absmax, 127.0)


def _quantize_stochastic_reference(x2d: torch.Tensor, seed: int):
    """Plain version: (int8 [N, C] values, float32 [1, C] scales)."""
    n, c = x2d.shape
    scales = column_scales(x2d)
    u = _uniform24(n * c, seed, x2d.device).reshape(n, c)
    values = torch.floor(x2d / scales + u).clamp_(-127, 127).to(torch.int8)
    return values, scales


def _load_kernel() -> ctypes.CDLL:
    lib = build.load("quantize")
    fn = lib.fidm_quantize_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_uint32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _quantize_cuda(x2d: torch.Tensor, seed: int):
    """Launch the CUDA kernel on the current stream."""
    if not x2d.is_cuda:
        raise ValueError("the quantize kernel takes a CUDA tensor")
    if x2d.dtype != torch.float32 or x2d.ndim != 2:
        raise TypeError(f"the quantize kernel takes a float32 [N, C] matrix, got "
                        f"{x2d.dtype} {tuple(x2d.shape)}")
    n, c = x2d.shape
    if not (1 <= n <= _MAX_ROWS and c >= 1):
        raise ValueError(f"the quantize kernel takes 1 <= N <= {_MAX_ROWS} and C >= 1, "
                         f"got {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("the quantize kernel takes a contiguous matrix")
    if x2d.data_ptr() % 16:
        x2d = x2d.clone()  # a fresh allocation is aligned for 16-byte loads
    fn = _load_kernel().fidm_quantize_int8
    values = torch.empty((n, c), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((1, c), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2d.data_ptr(), values.data_ptr(), scales.data_ptr(), n, c,
                 seed & 0xFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    LAUNCHES["quantize"] += 1
    return values, scales


def stochastic_quantize(x2d: torch.Tensor, seed: int):
    """Per-column int8 with stochastic rounding of a float32 [N, C] matrix:
    (int8 [N, C] values, float32 [1, C] scales)."""
    if use_kernel("quantize", x2d.device):
        return _quantize_cuda(x2d, seed)
    return _quantize_stochastic_reference(x2d, seed)
