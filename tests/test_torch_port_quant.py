"""The port's int8 weight quantization against the JAX package's.

On the CPU both packages round to nearest (JAX takes its XLA path there, the
port its plain torch path), so values and scales must be bit-equal. The
stochastic-rounding plain version, which the CUDA kernel matches bit for bit
on the card (`test_torch_port_cuda.py`), draws Philox bits that the TPU's
generator does not give, so it is held to the properties the TPU kernel has:
the same scales, one of the two neighbouring integers, determinism per seed
and no bias.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.models.torch_import import convert_state_dict, export_state_dict
from fidm_tpu.quant import dequantize_params as jax_dequantize_params
from fidm_tpu.quant import quantize_params as jax_quantize_params
from fidm_tpu.quant import quantize_tensor as jax_quantize_tensor
from fidm_tpu.quant import quantized_size_bytes as jax_size_bytes
from fidm_tpu_torch.models.weights import jax_tree_from_state_dict, state_dict_from_jax
from fidm_tpu_torch.ops import LAUNCHES, kernel_override, stochastic_quantize
from fidm_tpu_torch.ops import quantize as port_ops
from fidm_tpu_torch.quant import (
    dequantize_params,
    quantize_params,
    quantize_tensor,
    quantized_size_bytes,
)

from _torch_port_common import JCFG, PCFG, perturbed_jax_variables


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and the test run shares the CPU between
    its workers, where torch's default pool of one thread per core spins
    against the other workers (alone on an 8-core CPU this module took 176 s
    of CPU in 63 s, and 80 s in 67 s on one thread): one intra-op thread for
    this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables(JCFG, seed=3)


# the full-width UNet's [rows, out] views: a 3x3 conv, the two that are
# always rounded to nearest (in_0_conv, out_conv), conv kernels in HWIO
@pytest.mark.parametrize("shape", [(1152, 128), (81, 128), (1152, 6), (3, 3, 64, 128),
                                   (3, 3, 128, 6), (1, 1, 96, 32)])
def test_nearest_rounding_bit_equal_to_jax(shape):
    x = _weights(shape, 0)
    x[0, ..., 0] = 0.0  # an all-but-one-zero column and exact ties are fine
    ref = jax_quantize_tensor(jnp.asarray(x))
    out = quantize_tensor(torch.from_numpy(x))
    assert out["q"].dtype == torch.int8 and out["q"].shape == shape
    assert out["scale"].dtype == torch.float32 and out["scale"].shape == (shape[-1],)
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))


def test_zero_column_takes_the_floor_scale():
    x = np.zeros((16, 128), np.float32)
    out = quantize_tensor(torch.from_numpy(x))
    ref = jax_quantize_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))
    assert not out["q"].any()


@pytest.mark.parametrize("shape", [(1152, 128), (64, 256), (100, 200)])
def test_stochastic_scales_bit_equal_to_jax(shape):
    x = _weights(shape, 1)
    _, scales = port_ops._quantize_stochastic_reference(torch.from_numpy(x), 7)
    ref = jax_quantize_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(scales[0].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_stochastic_values_are_a_neighbouring_integer(seed):
    x = torch.from_numpy(_weights((96, 128), 2))
    x[3, :5] = torch.tensor([1e-9, -1e-9, 0.0, 2.0, -2.0])  # column maxima and near-zeros
    values, scales = port_ops._quantize_stochastic_reference(x, seed)
    assert values.dtype == torch.int8 and scales.shape == (1, 128)
    low = torch.floor(x / scales).clamp(-127, 127)
    high = (torch.floor(x / scales) + 1).clamp(-127, 127)
    v = values.float()
    assert bool(((v == low) | (v == high)).all())
    assert v.abs().max().item() <= 127


def test_stochastic_is_deterministic_per_seed_and_differs_across_seeds():
    x = torch.from_numpy(_weights((64, 128), 3))
    a = port_ops._quantize_stochastic_reference(x, 11)[0]
    b = port_ops._quantize_stochastic_reference(x, 11)[0]
    c = port_ops._quantize_stochastic_reference(x, 12)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # roughly half the elements round the other way under another seed
    assert 0.2 < (a != c).float().mean().item() < 0.8


def test_stochastic_rounding_is_unbiased():
    """E[q] = x / scale: each draw's error q - x/scale lies in (-1, 1] with
    variance at most 1/4, so the mean of n draws has a standard deviation
    of at most 0.5 / sqrt(n). The bounds are 6 of those: over all elements
    and 256 seeds (n = 2,097,152), and per element over the seeds (n = 256).
    Rounding to nearest fails the per-element bound."""
    x = torch.from_numpy(_weights((64, 128), 4))
    seeds = 256
    err = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(seeds):
        values, scales = port_ops._quantize_stochastic_reference(x, seed)
        err += (values.double() - x.double() / scales.double())
    mean = err / seeds
    assert abs(mean.mean().item()) <= 6 * 0.5 / np.sqrt(seeds * x.numel())
    assert mean.abs().max().item() <= 6 * 0.5 / np.sqrt(seeds)
    nearest = quantize_tensor(x)
    nearest_err = nearest["q"].double() - x.double() / nearest["scale"].double()
    assert nearest_err.abs().max().item() > 6 * 0.5 / np.sqrt(seeds)


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = port_ops.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in words) == expected


def test_uniform_draws_follow_the_counter_layout():
    """Element i takes lane i % 4 of counter i // 4, top 24 bits."""
    u = port_ops._uniform24(10, 5, "cpu")
    k = torch.arange(3, dtype=torch.int64)
    zero = torch.zeros_like(k)
    words = port_ops.philox4x32_10((k, zero, zero, zero), (5, 0))
    for i in range(10):
        assert u[i].item() == (int(words[i % 4][i // 4]) >> 8) / 2 ** 24
    assert 0.0 <= u.min().item() and u.max().item() < 1.0


def test_cpu_dispatch_takes_plain_versions_and_counts_no_launch():
    x = torch.from_numpy(_weights((64, 128), 5))
    before = LAUNCHES["quantize"]
    v, s = stochastic_quantize(x, 3)
    ref_v, ref_s = port_ops._quantize_stochastic_reference(x, 3)
    assert torch.equal(v, ref_v) and torch.equal(s, ref_s)
    # quantize_tensor on the CPU rounds to nearest, as JAX does without Pallas
    q = quantize_tensor(x, seed=3)
    assert torch.equal(q["q"], torch.round(x / q["scale"]).to(torch.int8))
    assert LAUNCHES["quantize"] == before


def test_forcing_kernel_on_cpu_raises():
    x = torch.from_numpy(_weights((64, 128), 6))
    with kernel_override(True, "quantize"):
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            quantize_tensor(x)
    with pytest.raises(ValueError, match="CUDA"):
        port_ops._quantize_cuda(x, 0)
    with pytest.raises(KeyError):
        with kernel_override(False, "no-such-op"):
            pass


def test_tree_matches_jax_paths_values_and_order(jax_variables):
    """The tree as both CLIs load a checkpoint: same paths in the same order
    (which fixes the seeds), the same tensors quantized, bit-equal values."""
    jax_tree = {"base": convert_state_dict(export_state_dict(jax_variables, JCFG), JCFG)}
    tree = jax_tree_from_state_dict(state_dict_from_jax(jax_variables, PCFG), PCFG)
    assert [p for p, _ in _leaves(tree)] == [p for p, _ in _leaves(jax_tree)]

    ref = jax_quantize_params(jax_tree)
    out = quantize_params(tree)
    ref_leaves, out_leaves = list(_leaves(ref)), list(_leaves(out))
    assert [p for p, _ in out_leaves] == [p for p, _ in ref_leaves]
    n_quantized = 0
    for (path, a), (_, b) in zip(ref_leaves, out_leaves):
        if isinstance(a, dict):
            n_quantized += 1
            assert isinstance(b, dict), path
            np.testing.assert_array_equal(b["q"].numpy(), np.asarray(a["q"]))
            np.testing.assert_array_equal(b["scale"].numpy(), np.asarray(a["scale"]))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert n_quantized > 10
    assert quantized_size_bytes(out) == jax_size_bytes(ref)
    assert quantized_size_bytes(tree) == jax_size_bytes(jax_tree)

    deq, ref_deq = dequantize_params(out), jax_dequantize_params(ref)
    for (path, a), (_, b) in zip(_leaves(ref_deq), _leaves(deq)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))


def test_seeds_follow_tree_order():
    """The k-th quantized tensor takes seed + k (`fidm_tpu/quant/int8.py`):
    with the plain stochastic version standing in for the kernel, each
    quantized leaf equals that version at its seed."""
    tree = {"a": {"kernel": torch.from_numpy(_weights((8, 128), 7)),
                  "bias": torch.zeros(128)},
            "b": {"kernel": torch.from_numpy(_weights((3, 3, 8, 128), 8))}}
    seen = []

    def fake(x2d, seed):
        seen.append(seed)
        return port_ops._quantize_stochastic_reference(x2d, seed)

    with pytest.MonkeyPatch.context() as mp:
        from fidm_tpu_torch.quant import int8 as port_int8

        mp.setattr(port_int8, "use_kernel", lambda op, device: True)
        mp.setattr(port_int8, "stochastic_quantize", fake)
        out = quantize_params(tree, min_size=512, seed=10)
    assert seen == [11, 12]
    ref = port_ops._quantize_stochastic_reference(tree["b"]["kernel"].reshape(-1, 128), 12)[0]
    assert torch.equal(out["b"]["kernel"]["q"].reshape(-1, 128), ref)
    assert torch.equal(out["a"]["bias"], tree["a"]["bias"])


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


def test_the_full_width_model_dispatches_114_weights():
    assert len(_ffhq256_dispatched_shapes()) == 114
    assert len(FFHQ256_SHAPES) == 25


@pytest.mark.parametrize("n,c", FFHQ256_SHAPES + EDGE_SHAPES)
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


def test_geometry_streams_only_what_no_cluster_can_hold():
    for n, c in FFHQ256_SHAPES:
        g = _geometry(n, c)
        assert g.hold_rows == g.rows_per_cta, (n, c)
    for n in (24576, 32768):
        tall = _geometry(n, 256)
        assert tall.hold_rows < tall.rows_per_cta
    # with room for more clusters (16 of 8 CTAs), the first is held whole
    roomy = port_ops.quantize_geometry(24576, 256, H100_SMEM_PER_BLOCK, KERNEL_STATIC_SMEM,
                                       [1024] * port_ops.MAX_CLUSTER)
    assert roomy.hold_rows == roomy.rows_per_cta


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


@pytest.mark.parametrize("n,c", FFHQ256_SHAPES + EDGE_SHAPES[:-1] + [(3000, 256)])
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

