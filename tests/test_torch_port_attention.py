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


def _attention_block_pair(c, head_channels, seed):
    """fidm_tpu's AttentionBlock with numpy-seeded parameters, and the port's
    with the same ones."""
    from fidm_tpu.models.layers import AttentionBlock as JaxAttentionBlock
    from fidm_tpu_torch.models.layers import AttentionBlock

    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    params = {"norm": {"GroupNorm_0": {"scale": 1 + draw(c), "bias": draw(c)}},
              "qkv": {"kernel": draw(c, 3 * c), "bias": draw(3 * c)},
              "proj": {"kernel": draw(c, c), "bias": draw(c)}}
    jax_block = JaxAttentionBlock(num_head_channels=head_channels)
    block = AttentionBlock(c, num_head_channels=head_channels)
    gn, qkv, proj = params["norm"]["GroupNorm_0"], params["qkv"], params["proj"]
    block.load_state_dict({
        "norm.weight": torch.from_numpy(gn["scale"]), "norm.bias": torch.from_numpy(gn["bias"]),
        "qkv.weight": torch.from_numpy(qkv["kernel"].T[..., None].copy()),
        "qkv.bias": torch.from_numpy(qkv["bias"]),
        "proj_out.weight": torch.from_numpy(proj["kernel"].T[..., None].copy()),
        "proj_out.bias": torch.from_numpy(proj["bias"])})
    return jax_block, {"params": params}, block


@pytest.mark.parametrize("c,head_channels,hw", [(64, 32, 8), (128, 64, 4)])
def test_attention_block_matches_jax_layer(c, head_channels, hw):
    """The port's block, which hands the op strided q/k/v views of one qkv
    projection, against `fidm_tpu`'s layer on the same parameters."""
    jax_block, variables, block = _attention_block_pair(c, head_channels, seed=c + hw)
    x = np.random.default_rng(1).standard_normal((2, hw, hw, c)).astype(np.float32)
    ref = np.asarray(jax_block.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # f32 on both sides; the sums differ only in order
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_attention_block_passes_views_the_kernel_reads_in_place(monkeypatch):
    """q, k, v reach the op as non-contiguous views of the qkv projection
    (no copy), and the kernel's layout check takes them as they are."""
    from fidm_tpu_torch.models import layers

    seen = []

    def spy(q, k, v):
        seen.append((q, k, v))
        return port_attention._attention_reference(q, k, v)

    monkeypatch.setattr(layers, "qkv_attention", spy)
    for dtype in (torch.float32, torch.bfloat16):
        block = layers.AttentionBlock(64, num_head_channels=32)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, 64, 4, 4)).astype(np.float32)).to(dtype)
        with torch.no_grad():
            block(x)  # float32 parameters, activations in dtype
        q, k, v = seen.pop()
        assert q.shape == (2, 2, 16, 32) and q.dtype == dtype
        assert not any(a.is_contiguous() for a in (q, k, v))
        base = q.untyped_storage().data_ptr()
        assert k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr() == base
        assert k.data_ptr() - q.data_ptr() == 64 * q.element_size()
        for a in (q, k, v):
            assert port_attention._row_strides(a, "q") == (16 * 192, 32, 192)


def test_row_strides_accepts_aligned_views_and_rejects_the_rest():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 3, 5, 64, dtype=dtype)
        assert port_attention._row_strides(x, "q") == (960, 320, 64)
        # heads split out of a [B, S, 3C] projection, C = 128
        qkv = torch.zeros(2, 5, 3 * 128, dtype=dtype)
        for a in qkv.chunk(3, dim=-1):
            view = a.reshape(2, 5, 4, 32).transpose(1, 2)
            assert port_attention._row_strides(view, "k") == (5 * 384, 32, 384)
        # a permuted contiguous tensor: D still contiguous
        y = torch.zeros(2, 5, 3, 64, dtype=dtype).transpose(1, 2)
        assert port_attention._row_strides(y, "v") == (960, 64, 192)
        # D not contiguous
        with pytest.raises(ValueError, match="16-byte aligned"):
            port_attention._row_strides(x.transpose(2, 3), "q")
        # a start one element past an aligned address
        flat = torch.zeros(1 + 2 * 3 * 5 * 64, dtype=dtype)
        with pytest.raises(ValueError, match="offset"):
            port_attention._row_strides(flat[1:].view(2, 3, 5, 64), "q")
        # rows 102 elements apart: an s-stride that is not a multiple of 16 bytes
        odd = torch.zeros(2, 5, 102, dtype=dtype)[..., :32].reshape(2, 5, 1, 32)
        with pytest.raises(ValueError, match="strides"):
            port_attention._row_strides(odd.transpose(1, 2), "k")
    # a size-1 dimension's stride is never used, so it is not checked
    one = torch.zeros(1, 1, 7, 64, dtype=torch.bfloat16).as_strided((1, 1, 7, 64),
                                                                      (3, 5, 64, 1))
    assert port_attention._row_strides(one, "q") == (3, 5, 64)


# (B*H, S, SMs) -> key groups: the main path's two shapes on an H100 SXM (132
# SMs), then S >= 1024, grids at the edge of the rule, one key tile, and
# cards with fewer SMs
@pytest.mark.parametrize("bh,s,sms,groups", [
    (32, 256, 132, 2), (32, 64, 132, 1), (32, 100, 132, 2),
    (32, 1024, 132, 1), (32, 4096, 132, 1), (32, 512, 132, 2),
    (66, 256, 132, 1), (65, 256, 132, 2), (132, 128, 132, 1),
    (1, 1, 132, 1), (32, 256, 114, 2), (32, 256, 60, 1)])
def test_bf16_tiling_fills_the_card(bh, s, sms, groups):
    assert port_attention._key_groups(bh, s, sms) == groups
    assert groups in port_attention.KEY_GROUPS
