"""Shared pieces of the int8 quantization tests (`test_torch_port_quant*.py`):
seeded weights, the leaves of a quantized tree, and the quantize kernel's
geometry on an H100 with the weight shapes of the full-width UNet that reach
the kernel, and an emulation of the kernel's arithmetic block by block.
"""
import numpy as np
import torch

from fidm_tpu_torch.models.weights import jax_tree_from_state_dict
from fidm_tpu_torch.ops import quantize as port_ops


def _weights(shape, seed, scale=0.05):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _leaves(tree, prefix=()):
    """(path, leaf) in the tree's order; a quantized leaf is one entry."""
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            yield from _leaves(v, p)
        else:
            yield p, v


# --- the CUDA kernel's decomposition (csrc/quantize.cu), on the CPU ---------

# cudaOccupancyMaxActiveClusters for the kernel on an H100 SXM (132 SMs), by
# cluster size 1..8, as `chip_smoke.py` prints them: the clusters of each
# size that the card's GPCs hold at once.
H100_MAX_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
H100_SMEM_PER_BLOCK = 232448
KERNEL_STATIC_SMEM = 2304


def _ffhq256_dispatched_shapes():
    """The [rows, out] views of the FFHQ-256 UNet's weights that go through
    the kernel: 114 of the 116 quantized, in tree order."""
    from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config

    cfg = ffhq256_config()
    with torch.device("meta"):
        model = InpaintingUNet(cfg)
    tree = jax_tree_from_state_dict(model.state_dict(), cfg)
    shapes = [(v.numel() // v.shape[-1], v.shape[-1]) for p, v in _leaves(tree)
              if p[-1] == "kernel" and v.ndim >= 2 and v.numel() >= 4096]
    assert len(shapes) == 116
    return [s for s in shapes if s[0] % 8 == 0 and s[1] % 128 == 0]


FFHQ256_SHAPES = sorted(set(_ffhq256_dispatched_shapes()))
# the geometry's edges: one row, one step of rows, rows not a multiple of a
# step, one strip, a ragged last strip, and a tall matrix whose CTAs cannot
# hold all their rows
EDGE_SHAPES = [(8, 128), (1, 128), (1, 4), (1000, 128), (100, 200), (257, 36), (32768, 256)]


def _geometry(n, c):
    return port_ops.quantize_geometry(n, c, H100_SMEM_PER_BLOCK, KERNEL_STATIC_SMEM,
                                      H100_MAX_CLUSTERS)


def _emulate_kernel(x: torch.Tensor, seed: int, g) -> tuple:
    """The kernel's arithmetic, block by block: per-CTA column maxima, the
    cluster's maximum of them, then each CTA's rows (held, then streamed)
    rounded with the Philox draws of their flat indices, clipped before the
    floor as the kernel does."""
    n, c = x.shape
    values = torch.empty((n, c), dtype=torch.int8)
    scales = torch.empty((1, c), dtype=torch.float32)
    for s in range(g.strips):
        c0, c1 = s * g.strip, min(c, (s + 1) * g.strip)
        blocks = [(k * g.rows_per_cta, min(n, (k + 1) * g.rows_per_cta))
                  for k in range(g.cluster)]
        partial = [x[r0:r1, c0:c1].abs().amax(dim=0) if r1 > r0
                   else torch.zeros(c1 - c0) for r0, r1 in blocks]
        absmax = torch.stack(partial).amax(dim=0).clamp_min(1e-8)
        scale = absmax / torch.full_like(absmax, 127.0)
        scales[0, c0:c1] = scale
        for r0, r1 in blocks:
            parts = ((r0, min(r1, r0 + g.hold_rows)), (r0 + g.hold_rows, r1))
            for a, b in parts:
                if b <= a:
                    continue
                rows = torch.arange(a, b, dtype=torch.int64)[:, None]
                cols = torch.arange(c0, c1, 4, dtype=torch.int64)[None, :]
                ctr = (rows * c + cols) // 4  # one Philox call per float4
                zero = torch.zeros_like(ctr)
                words = port_ops.philox4x32_10((ctr & 0xFFFFFFFF, ctr >> 32, zero, zero),
                                               (seed, 0))
                bits = torch.stack(words, dim=-1).reshape(b - a, c1 - c0)
                u = (bits >> 8).to(torch.float32) * 2.0 ** -24
                v = (x[a:b, c0:c1] / scale + u).clamp(-127, 127)
                values[a:b, c0:c1] = torch.floor(v).to(torch.int8)
    return values, scales
