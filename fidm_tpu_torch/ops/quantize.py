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
- `csrc/quantize.cu` is the kernel: one launch that reads x once. One
  thread-block cluster of at most 8 CTAs per strip of 32 or 16 columns, its
  CTAs splitting the strip's rows; each CTA holds its rows in shared memory,
  the cluster reduces the column maxima through distributed shared memory,
  and each CTA rounds what it holds. `quantize_geometry` picks the strip
  width, the cluster size and the rows each CTA holds from the shape and the
  card. The kernel takes C % 4 == 0 (a float4 must not straddle two rows);
  the wrapper raises on the rest.

`stochastic_quantize` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors (see `registry`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import Sequence, Tuple

import torch

from . import build
from .registry import LAUNCHES, use_kernel

__all__ = ["stochastic_quantize", "column_scales", "philox4x32_10", "quantize_geometry",
           "QuantizeGeometry"]

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# The kernel's constants (csrc/quantize.cu): 512 threads a CTA, each owning
# one float4 column group of a strip of 32 or 16 columns (a 128- or 64-byte
# piece of a row), so that a CTA covers THREADS // (strip // 4) rows per
# step; a CTA holds at most TILE_BYTES of its rows in shared memory and
# streams the rest; clusters of at most 8 CTAs (the portable limit).
THREADS = 512
STRIPS = (32, 16)
TILE_BYTES = 28 * THREADS * 16
MAX_CLUSTER = 8
_MAX_STRIPS = 65535  # strips are the grid's y dimension


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


@dataclasses.dataclass(frozen=True)
class QuantizeGeometry:
    """The kernel's launch for one [N, C] matrix: C is cut into `strips`
    strips of `strip` columns, one cluster of `cluster` CTAs each; CTA k of
    a cluster takes rows [k * rows_per_cta, (k + 1) * rows_per_cta) of its
    strip, holds the first `hold_rows` of them in `smem_bytes` of dynamic
    shared memory and streams the rest."""
    strip: int
    strips: int
    cluster: int
    rows_per_cta: int
    hold_rows: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.strips * self.cluster

    @property
    def row_step(self) -> int:
        """Rows a CTA's threads cover in one step."""
        return THREADS // (self.strip // 4)


def _make_geometry(n: int, c: int, strip: int, cluster: int, tile_bytes: int):
    rows = -(-n // cluster)
    hold = min(rows, tile_bytes // (strip * 4))
    return QuantizeGeometry(strip, -(-c // strip), cluster, rows, hold, hold * strip * 4)


def quantize_geometry(n: int, c: int, smem_per_block: int, static_smem: int,
                      max_clusters: Sequence[int]) -> QuantizeGeometry:
    """The launch for an [n, c] matrix on a card whose blocks may take
    `smem_per_block` bytes of shared memory (`static_smem` of them the
    kernel's own) and which holds `max_clusters[k - 1]` clusters of k CTAs
    at once (cudaOccupancyMaxActiveClusters; the kernel runs one CTA per SM).

    Among the strip widths and cluster sizes whose clusters all run at once,
    it takes the one with the fewest steps a thread makes over its rows (the
    arithmetic sets the time once the card is full), then the widest strip
    (the longest pieces of a row read together), then the smallest cluster.
    Where nothing runs in one wave (more than `max_clusters[0]` strips of 16
    columns), 32-column strips of one CTA each run in waves."""
    tile = min(TILE_BYTES, smem_per_block - static_smem)
    combos = [_make_geometry(n, c, strip, k, tile) for strip in STRIPS
              for k in range(1, MAX_CLUSTER + 1) if -(-c // strip) <= max_clusters[k - 1]]
    if not combos:
        return _make_geometry(n, c, STRIPS[0], 1, tile)
    return min(combos, key=lambda g: (-(-g.rows_per_cta // g.row_step), -g.strip, g.cluster))


# The launch's 10 integers (the `Launch` struct in csrc/quantize.cu) go in one
# int64 buffer: ctypes converts each argument anew on every call.
_PARAMS = struct.Struct("=10q")
_fn = None  # the kernel's C entry point, resolved at first use


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("quantize").fidm_quantize_int8
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _card(device: int) -> Tuple[int, int, Tuple[int, ...]]:
    """(shared memory a block may opt into, the kernel's static shared
    memory, how many clusters of 1 .. MAX_CLUSTER CTAs fit at once) of CUDA
    device `device`. One CTA of the kernel fills an SM's registers, so the
    cluster counts do not depend on the shared memory it takes."""
    lib = build.load("quantize")
    limits = (ctypes.c_int * 2)()
    counts = []
    with torch.cuda.device(device):
        err = lib.fidm_quantize_device_limits(device, limits)
        rows = TILE_BYTES // (STRIPS[0] * 4)
        for k in range(1, MAX_CLUSTER + 1):
            if err == 0:
                out = ctypes.c_int(0)
                err = lib.fidm_quantize_max_active_clusters(
                    _PARAMS.pack(0, 0, 0, k * rows, STRIPS[0], 0, STRIPS[0], k, rows, rows),
                    ctypes.byref(out))
                counts.append(out.value)
    if err != 0:
        raise RuntimeError(f"quantize kernel: device query failed: cudaError {err}")
    return limits[0], limits[1], tuple(counts)


@functools.lru_cache(maxsize=1024)
def _geometry(n: int, c: int, device: int) -> QuantizeGeometry:
    return quantize_geometry(n, c, *_card(device))


def max_active_clusters(cluster: int, device: int) -> int:
    """How many clusters of `cluster` CTAs of the kernel device `device`
    holds at once (cudaOccupancyMaxActiveClusters)."""
    return _card(device)[2][cluster - 1]


def _launch(x2d: torch.Tensor, seed: int, geo: QuantizeGeometry):
    """Enqueue the kernel on the current stream for a checked, aligned
    matrix with launch `geo` (the kernel checks it too and returns a
    cudaError if it does not cover the matrix)."""
    n, c = x2d.shape
    device = x2d.get_device()
    values = torch.empty((n, c), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((1, c), dtype=torch.float32, device=x2d.device)
    params = _PARAMS.pack(x2d.data_ptr(), values.data_ptr(), scales.data_ptr(), n, c,
                          seed & _MASK32, geo.strip, geo.cluster, geo.rows_per_cta,
                          geo.hold_rows)
    fn = _kernel()
    if device == torch.cuda.current_device():
        err = fn(params, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(params, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    LAUNCHES["quantize"] += 1
    return values, scales


def _quantize_cuda(x2d: torch.Tensor, seed: int):
    """Launch the CUDA kernel on the current stream."""
    if not x2d.is_cuda:
        raise ValueError("the quantize kernel takes a CUDA tensor")
    if x2d.dtype != torch.float32 or x2d.ndim != 2:
        raise TypeError(f"the quantize kernel takes a float32 [N, C] matrix, got "
                        f"{x2d.dtype} {tuple(x2d.shape)}")
    n, c = x2d.shape
    if not (n >= 1 and 4 <= c <= _MAX_STRIPS * STRIPS[-1] and c % 4 == 0):
        raise ValueError(f"the quantize kernel takes N >= 1 and C a multiple of 4 up to "
                         f"{_MAX_STRIPS * STRIPS[-1]}, got {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("the quantize kernel takes a contiguous matrix")
    if x2d.data_ptr() % 16:
        x2d = x2d.clone()  # a fresh allocation is aligned for 16-byte loads
    return _launch(x2d, seed, _geometry(n, c, x2d.get_device()))


def stochastic_quantize(x2d: torch.Tensor, seed: int):
    """Per-column int8 with stochastic rounding of a float32 [N, C] matrix:
    (int8 [N, C] values, float32 [1, C] scales)."""
    if use_kernel("quantize", x2d.device):
        return _quantize_cuda(x2d, seed)
    return _quantize_stochastic_reference(x2d, seed)
