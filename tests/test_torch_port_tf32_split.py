"""The arithmetic of the float32 attention kernels (3xTF32), emulated on the CPU.

`csrc/attention.cu`'s float32 kernels run both products on the tensor cores
as TF32: each operand is split as x = hi + lo, hi = tf32(x) and lo = tf32(x -
hi) (`cvt.rna`: 10 mantissa bits, to nearest, ties away from zero), and a b
is taken as al bh + ah bl + ah bh, in k-steps of 8 products. The tensor
cores' adder truncates, which over a long chain of products drifts past the
gate, so each kernel starts its chains from zero within a tile (the mma.sync
kernel every two k-steps of q k^T and every k-step of P v, the wgmma kernel
per tile, its large and small products apart) and adds them to the running
sums in f32; this emulation rounds each step to nearest, with the mma.sync
kernel's chains. Their softmax walks the keys in tiles of 64 with a running
max and sum, and applies s4^2 log2(e) (s4 = D^-1/4 in f32) to the unscaled
scores inside exp2. The CUDA kernels run only on the card
(`test_torch_port_cuda.py`); this file holds the same arithmetic, written
out in numpy, against `fidm_tpu`'s `_attention_reference` in full float32,
and shows that one TF32 product would miss the 1e-5 gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.ops.attention import _attention_reference
from fidm_tpu_torch.ops import attention as port_attention

KEY_TILE = 64  # keys per shared-memory tile of the kernel
K_STEP = 8     # the k of mma.m16n8k8
QK_CHAIN = 16  # columns of d per chain of q k^T products
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread and one BLAS thread for this module, as the
    other port test files pin them under the test run's parallel workers."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def tf32_rna(x):
    """`cvt.rna.tf32.f32`: the low 13 mantissa bits rounded off, to nearest,
    ties away from zero (a carry into the exponent rounds up a binade)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna((x - hi).astype(np.float32))


def chain(a, b, passes):
    """a b for a [..., M, K] and b [..., K, N] in TF32 from zero, 8-long
    k-steps: three products of the split operands each, or one of the
    rounded ones. Each TF32 product is exact in f32; each product's sum is
    rounded once."""
    c = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for j in range(0, a.shape[-1], K_STEP):
        ah, al = split(a[..., j:j + K_STEP])
        bh, bl = split(b[..., j:j + K_STEP, :])
        terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
        for x, y in terms:
            c = (c + np.matmul(x.astype(np.float64), y.astype(np.float64))).astype(np.float32)
    return c


def kernel_emulation(q, k, v, passes=3):
    """The kernel's function on [BH, S, D] float32 arrays."""
    bh, s, d = q.shape
    s4 = np.float32(1) / np.sqrt(np.sqrt(np.float32(d)))
    scale_log2 = np.float32(np.float64(s4) * np.float64(s4) * LOG2E)
    m_run = np.full((bh, s, 1), -np.inf, np.float32)
    l_run = np.zeros((bh, s, 1), np.float32)
    acc = np.zeros((bh, s, d), np.float32)
    for k0 in range(0, s, KEY_TILE):
        kt, vt = k[:, k0:k0 + KEY_TILE], v[:, k0:k0 + KEY_TILE]
        scores = np.zeros((bh, s, kt.shape[1]), np.float32)
        for j in range(0, d, QK_CHAIN):
            scores += chain(q[..., j:j + QK_CHAIN],
                            kt[..., j:j + QK_CHAIN].transpose(0, 2, 1), passes)
        m_new = np.maximum(m_run, scores.max(-1, keepdims=True))
        alpha = np.exp2((m_run - m_new) * scale_log2)
        p = np.exp2(scores * scale_log2 - m_new * scale_log2).astype(np.float32)
        l_run = (l_run * alpha + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        acc = (acc * alpha).astype(np.float32)
        for j in range(0, kt.shape[1], K_STEP):
            acc += chain(p[..., j:j + K_STEP], vt[:, j:j + K_STEP], passes)
        m_run = m_new
    return (acc / l_run).astype(np.float32)


def _inputs(s, d, seed, wide):
    """randn q, k, v at [1, 2, S, D]; `wide`: q and k scaled by sqrt(8), so
    that the largest |logit| is about 45, and v's rows by powers of two from
    2^-6 to 2^6."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 2, s, d)).astype(np.float32) for _ in range(3))
    if wide:
        q, k = q * np.float32(np.sqrt(8)), k * np.float32(np.sqrt(8))
        v = v * np.exp2(rng.integers(-6, 7, (1, 2, s, 1))).astype(np.float32)
    return q, k, v


def _reference(q, k, v):
    with jax.default_matmul_precision("highest"):
        return np.asarray(_attention_reference(*(jnp.asarray(a) for a in (q, k, v))))


# the float32 gate of the kernel against its plain version: 1e-5 absolute on
# randn inputs, 1e-5 of max|v| on the wide ones
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("s,d", [(64, 64), (256, 64), (257, 128), (1024, 64)])
def test_3xtf32_holds_the_float32_gate(s, d, wide):
    q, k, v = _inputs(s, d, s + d, wide)
    ref = _reference(q, k, v)
    flat = [a.reshape(2, s, d) for a in (q, k, v)]
    tol = 1e-5 * (np.abs(v).max() if wide else 1.0)
    err3 = np.abs(kernel_emulation(*flat).reshape(ref.shape) - ref).max()
    assert err3 <= tol
    if s <= 256:  # one TF32 product misses the gate by 10-100x
        err1 = np.abs(kernel_emulation(*flat, passes=1).reshape(ref.shape) - ref).max()
        assert err1 > 10 * tol


def test_tf32_rounding_is_rna():
    """Round to nearest at bit 13, ties away from zero, for both signs."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    cases = [(one + ulp / 2, one + ulp),              # a tie: away from zero
             (one + ulp / 2 - np.float32(2 ** -23), one),
             (-(one + ulp / 2), -(one + ulp)),
             (one + ulp * 3 / 4, one + ulp),
             (np.float32(3.0), np.float32(3.0))]
    for x, want in cases:
        assert tf32_rna(np.float32(x)) == want, x
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo = split(x)
    assert np.all(tf32_rna(hi) == hi) and np.all(tf32_rna(lo) == lo)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x - hi - lo) <= np.abs(x) * 2.0 ** -22)


# (B*H, S, SMs) -> tiling: the main path's two shapes on an H100 SXM, S >=
# 1024, one key tile, a single head at S=4096, the edge of the rule, and a
# card with fewer SMs
@pytest.mark.parametrize("bh,s,sms,code", [
    (32, 256, 132, 1), (32, 64, 132, 1), (32, 1024, 132, 2), (32, 4096, 132, 2),
    (1, 1, 132, 1), (1, 4096, 132, 1), (132, 128, 132, 2), (131, 128, 132, 1),
    (32, 256, 60, 2)])
def test_f32_tiling_rule(bh, s, sms, code):
    assert port_attention._f32_tiling(bh, s, sms) == code
    assert code in port_attention.F32_TILINGS
