"""The int8 quantize kernel's block decomposition (`csrc/quantize.cu`),
emulated block by block on the CPU, is bit-equal to the plain stochastic
quantize for each distinct weight shape of the full-width FFHQ-256 UNet that
goes through the kernel. The edge shapes are in `test_torch_port_quant_edges.py`.
"""
import pytest
import torch

from fidm_tpu_torch.ops import quantize as port_ops

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_quant_common import _weights, FFHQ256_SHAPES, _geometry, _emulate_kernel


@pytest.mark.parametrize("n,c", FFHQ256_SHAPES)
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
