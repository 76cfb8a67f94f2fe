"""The int8 quantize kernel's launch geometry and block decomposition
(`csrc/quantize.cu`), on the CPU, at the geometry's edges: one row, rows not
a multiple of a step, a ragged last strip, a tall matrix whose CTAs stream
part of their rows. The decomposition, emulated block by block, is bit-equal
to the plain stochastic quantize.
"""
import pytest
import torch

from fidm_tpu_torch.ops import quantize as port_ops

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_quant_common import (
    _weights,
    H100_MAX_CLUSTERS,
    H100_SMEM_PER_BLOCK,
    KERNEL_STATIC_SMEM,
    EDGE_SHAPES,
    _geometry,
    _emulate_kernel,
)


@pytest.mark.parametrize("n,c", EDGE_SHAPES)
def test_geometry_covers_every_element_once_within_the_card(n, c):
    g = _geometry(n, c)
    assert g.strip in port_ops.STRIPS
    assert (g.strips - 1) * g.strip < c <= g.strips * g.strip
    # the CTAs of a cluster split the strip's rows without overlap or gap
    starts = [k * g.rows_per_cta for k in range(g.cluster)]
    ends = [min(n, s + g.rows_per_cta) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e2 == s1 for e2, s1 in zip(ends, starts[1:]) if s1 < n)
    assert sum(max(0, e - s) for s, e in zip(starts, ends)) == n
    # each CTA's threads: column group t % groups, rows t // groups + step * k
    groups = g.strip // 4
    rows_seen = sorted({t // groups + g.row_step * k for t in range(g.row_step * groups)
                        for k in range(-(-g.rows_per_cta // g.row_step))})
    assert rows_seen[:g.rows_per_cta] == list(range(g.rows_per_cta))
    # shared memory, cluster size, one wave
    assert 1 <= g.hold_rows <= g.rows_per_cta
    assert g.smem_bytes == g.hold_rows * g.strip * 4
    assert g.smem_bytes <= min(port_ops.TILE_BYTES, H100_SMEM_PER_BLOCK - KERNEL_STATIC_SMEM)
    assert 1 <= g.cluster <= port_ops.MAX_CLUSTER == 8
    assert g.strips <= H100_MAX_CLUSTERS[g.cluster - 1]


@pytest.mark.parametrize("n,c", EDGE_SHAPES[:-1] + [(3000, 256)])
def test_kernel_decomposition_is_bit_equal_to_plain(n, c):
    """Seeds 1 and 2^32 - 1 (the key's top bit set)."""
    x = torch.from_numpy(_weights((n, c), n + c))
    x[0, 0] = 0.0
    g = _geometry(n, c)
    if (n, c) == (3000, 256):  # CTAs that stream part of their rows
        g = port_ops._make_geometry(n, c, 32, 2, 1000 * 32 * 4)
        assert g.hold_rows < g.rows_per_cta
    for seed in (1, 2 ** 32 - 1):
        values, scales = _emulate_kernel(x, seed, g)
        ref_values, ref_scales = port_ops._quantize_stochastic_reference(x, seed)
        assert torch.equal(scales, ref_scales)
        assert torch.equal(values, ref_values)
