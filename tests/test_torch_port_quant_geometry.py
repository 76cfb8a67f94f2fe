"""The int8 quantize kernel's launch geometry (`csrc/quantize.cu`), on the CPU,
for each distinct weight shape of the full-width FFHQ-256 UNet that goes
through the kernel: the clusters' CTAs cover every element once, within the
H100's shared memory and cluster limits. The edge shapes are in
`test_torch_port_quant_edges.py`.
"""
import pytest

from fidm_tpu_torch.ops import quantize as port_ops

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_quant_common import (
    H100_MAX_CLUSTERS,
    H100_SMEM_PER_BLOCK,
    KERNEL_STATIC_SMEM,
    FFHQ256_SHAPES,
    _geometry,
)


@pytest.mark.parametrize("n,c", FFHQ256_SHAPES)
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
