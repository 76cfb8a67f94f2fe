"""The port's attention op against the JAX package's, and its CUDA kernel.

On the CPU the port's `qkv_attention` takes its plain version; it is held
against `fidm_tpu.ops.attention._attention_reference` and the Pallas kernel
in interpret mode, on the same numpy-seeded inputs. The CUDA kernel itself is
tested on the card by `test_torch_port_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.ops.attention import _attention_pallas, _attention_reference
from fidm_tpu_torch.ops import LAUNCHES, kernel_override, qkv_attention, use_kernel
from fidm_tpu_torch.ops import attention as port_attention


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 2, 16, 8), (1, 3, 100, 32), (2, 4, 64, 64)])
def test_plain_matches_jax_reference_f32(shape):
    q, k, v = _qkv(shape, 0)
    ref = np.asarray(_attention_reference(*(jnp.asarray(a) for a in (q, k, v))))
    out = qkv_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    # f32 on both sides; the sums differ only in order
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_plain_matches_pallas_interpret_d64():
    q, k, v = _qkv((2, 4, 64, 64), 1)
    pal = np.asarray(_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                       interpret=True))
    out = qkv_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), pal, atol=1e-5)


def test_plain_bf16_rounds_like_jax_reference():
    """bf16: both plain versions scale, multiply and cast the softmax in
    bf16; CPU matmul accumulation order differs, so allow a few bf16 ulps."""
    q, k, v = _qkv((1, 2, 64, 64), 2)
    ref = np.asarray(_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    out = qkv_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_grads_match_plain_version():
    """The autograd.Function's backward (recompute through the plain
    version) gives the plain version's own gradients."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 2, 16, 64), 3))
    cot = torch.from_numpy(_qkv((2, 2, 16, 64), 4)[0])
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    (qkv_attention(*a) * cot).sum().backward()
    (port_attention._attention_reference(*b) * cot).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-6)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    before = LAUNCHES["attention"]
    q = torch.zeros(1, 1, 8, 32)
    assert not use_kernel("attention", q.device)
    qkv_attention(q, q, q)
    assert LAUNCHES["attention"] == before


def test_forcing_kernel_on_cpu_raises():
    q = torch.zeros(1, 1, 8, 32)
    with kernel_override(True, "attention"):
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            qkv_attention(q, q, q)
    assert not use_kernel("attention", q.device)  # override restored


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attention._attention_cuda(q, q, q)
