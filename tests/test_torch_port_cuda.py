"""The port's CUDA kernels on the card: each against its plain version, its
wrapper's checks, and a small pipeline through it.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports no JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models import UNetConfig
from fidm_tpu_torch.models.layers import AttentionBlock
from fidm_tpu_torch.ops import LAUNCHES, kernel_override, qkv_attention
from fidm_tpu_torch.ops import attention as port_attention
from fidm_tpu_torch.ops import quantize as port_quantize
from fidm_tpu_torch.quant import quantize_tensor
from fidm_tpu_torch.sampling import GeneratorNoise, SamplerConfig
from fidm_tpu_torch.sampling.sampler import _dpm_tables
from fidm_tpu_torch.serving import InpaintingServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


# f32: the sums run in another order. bf16: the plain version rounds
# q*scale, k*scale, the logits and the softmax to bf16, the kernel keeps f32
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 15, 64, 65, 100, 256, 257, 1024, 4096])
def test_kernel_matches_plain(cuda, s, d, dtype, atol):
    q, k, v = _qkv((2, 8, s, d), 5, dtype, cuda)
    before = LAUNCHES["attention"]
    out = qkv_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    with kernel_override(False, "attention"):
        ref = qkv_attention(q, k, v)
    assert LAUNCHES["attention"] == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= atol


# The bf16 kernel against the plain version run in float32 on the same bf16
# inputs. The kernel rounds only P (unnormalised, <= 1) and its output to
# bf16: the output's rounding is at most 2^-8 of its magnitude, and P's adds
# at most a few 1e-3 beyond it. The bf16 plain version, which also rounds
# q*scale, k*scale and the logits, moves about 1e-2 on such inputs
# (chip_smoke.py phase 2 prints both beside each other).
BF16_F32_RTOL = 2.0 ** -8
BF16_F32_ATOL = 3e-3


@pytest.mark.parametrize("s,d", [(15, 32), (64, 64), (256, 64), (257, 128), (1024, 64),
                                 (4096, 64)])
def test_bf16_kernel_keeps_float32(cuda, s, d):
    q, k, v = _qkv((2, 8, s, d), 8, torch.bfloat16, cuda)
    out = port_attention._attention_cuda(q, k, v).float()
    ref = port_attention._attention_reference(q.float(), k.float(), v.float())
    with kernel_override(False, "attention"):
        plain = qkv_attention(q, k, v).float()
    err = (out - ref).abs()
    assert (err - BF16_F32_RTOL * ref.abs()).max().item() <= BF16_F32_ATOL
    assert err.max().item() <= (plain - ref).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(100, 32), (256, 64), (64, 128)])
def test_strided_views_match_contiguous_bit_for_bit(cuda, s, d, dtype):
    """The q/k/v chunks of one [B, S, 3C] projection, heads split out, as the
    UNet's AttentionBlock passes them, against their contiguous copies."""
    b, h = 2, 4
    rng = np.random.default_rng(s + d)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, dtype)
    q, k, v = (a.reshape(b, s, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out = port_attention._attention_cuda(q, k, v)
    ref = port_attention._attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    assert out.is_contiguous() and torch.equal(out, ref)
    # a permuted contiguous tensor ([B, S, H, D] read as [B, H, S, D]) too
    p = torch.randn(b, s, h, d, device=cuda).to(dtype).transpose(1, 2)
    assert torch.equal(port_attention._attention_cuda(p, k, v),
                       port_attention._attention_cuda(p.contiguous(), k, v))


def test_misaligned_view_raises(cuda):
    flat = torch.zeros(1 + 2 * 4 * 64 * 64, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(2, 4, 64, 64)  # 2 bytes past an aligned address
    k = torch.zeros(2, 4, 64, 64, device=cuda, dtype=torch.bfloat16)
    before = LAUNCHES["attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_attention._attention_cuda(q, k, k)
    odd = torch.zeros(2, 64, 4 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    odd = odd[..., :256].reshape(2, 64, 4, 64).transpose(1, 2)  # s-stride 260 x 2 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_attention._attention_cuda(k, odd, k)
    assert LAUNCHES["attention"] == before


@pytest.mark.parametrize("s,d", [(1, 64), (64, 64), (100, 32), (256, 64), (257, 128),
                                 (1024, 64)])
def test_bf16_tilings_agree(cuda, s, d):
    """Every key-group count the kernel is built for, whatever `_key_groups`
    picks: two key groups sum P v in another order and round P against each
    group's own running max, so each is held to the float32 bound of
    `test_bf16_kernel_keeps_float32`."""
    q, k, v = _qkv((2, 8, s, d), 9, torch.bfloat16, cuda)
    ref = port_attention._attention_reference(q.float(), k.float(), v.float())
    before = {n: LAUNCHES[n] for n in ("attention.bf16", "attention.f32")}
    for groups in port_attention.KEY_GROUPS:
        out = port_attention._attention_cuda(q, k, v, groups)
        err = (out.float() - ref).abs() - BF16_F32_RTOL * ref.abs()
        assert err.max().item() <= BF16_F32_ATOL, groups
    assert LAUNCHES["attention.bf16"] == (before["attention.bf16"]
                                          + len(port_attention.KEY_GROUPS))
    assert LAUNCHES["attention.f32"] == before["attention.f32"]
    with pytest.raises(RuntimeError, match="cudaError"):
        port_attention._attention_cuda(q, k, v, 3)


def test_backward_recomputes_plain(cuda):
    q, k, v = (a.requires_grad_() for a in _qkv((1, 2, 64, 64), 6, torch.float32, cuda))
    qkv_attention(q, k, v).sum().backward()
    grads = [a.grad.clone() for a in (q, k, v)]
    for a in (q, k, v):
        a.grad = None
    port_attention._attention_reference(q, k, v).sum().backward()
    for g, a in zip(grads, (q, k, v)):
        torch.testing.assert_close(g, a.grad, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 16, 64), 7, torch.float32, cuda)
    with pytest.raises(TypeError):
        port_attention._attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        port_attention._attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        port_attention._attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                       v[..., :48].contiguous())
    with pytest.raises(ValueError):
        port_attention._attention_cuda(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):
        port_attention._attention_cuda(q, k[:, :, :8], v)


def test_small_pipeline_runs_through_the_kernel(cuda):
    cfg = PipelineConfig(
        unet=UNetConfig(image_size=32, model_channels=64, channel_mult=(1, 2),
                        attention_resolutions=(2,), num_head_channels=64),
        sampler=SamplerConfig(method="ddim", num_steps=10, eta=0.9, injection=True))
    pipe = InpaintingPipeline.create(cfg, seed=0, device="cuda")
    n_attn = sum(isinstance(m, AttentionBlock) for m in pipe.model.modules())
    rng = np.random.default_rng(0)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 8:24] = 1.0
    before = LAUNCHES["attention"]
    out = pipe.inpaint(gt, mask, 0)
    assert LAUNCHES["attention"] - before == n_attn * 11
    again = pipe.inpaint(gt, mask, 0)
    keep = torch.from_numpy(mask[..., 0] < 0.5).cuda()
    assert torch.isfinite(out).all()
    assert torch.equal(out[keep], torch.from_numpy(gt).cuda()[keep])
    assert torch.equal(out, again)
    uint8 = pipe.inpaint(gt, mask, 0, sampler=dataclasses.replace(cfg.sampler,
                                                                  output_dtype="uint8"))
    assert uint8.dtype == torch.uint8 and uint8.is_cuda


@pytest.mark.parametrize("stream", ["init", "step", "inject"])
def test_per_row_seed_draws_on_the_card(cuda, stream):
    """Row i of a draw with per-row seeds is bit-equal to the batch-1 draw of
    seed i on the card too."""
    seeds, shape = [3, 99, 2**32 - 1, 7], (4, 64, 64, 3)
    draw = lambda noise, s: noise.init(s) if stream == "init" else getattr(noise, stream)(17, s)
    rows = draw(GeneratorNoise(seeds, cuda), shape)
    for i, seed in enumerate(seeds):
        assert torch.equal(rows[i:i + 1], draw(GeneratorNoise(seed, cuda), (1,) + shape[1:]))


def test_small_server_on_the_card(cuda):
    """The dispatcher on a small CUDA pipeline with DPM-Solver++(2M) SDE:
    one batch of three, the kernel launched per attention block and step, known
    pixels kept, and a replay alone bit-equal to the pipeline at batch 1."""
    sampler = SamplerConfig(method="dpm++2m-sde", num_steps=6, injection=True)
    cfg = PipelineConfig(
        unet=UNetConfig(image_size=32, model_channels=64, channel_mult=(1, 2),
                        attention_resolutions=(2,), num_head_channels=64), sampler=sampler)
    pipe = InpaintingPipeline.create(cfg, seed=0, device="cuda")
    n_attn = sum(isinstance(m, AttentionBlock) for m in pipe.model.modules())
    n_steps = len(_dpm_tables(pipe.sched, sampler)["t"])  # 8: the 6-step grid's
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((32, 32, 1), np.float32)
    mask[8:24, 8:24] = 1.0
    server = InpaintingServer(pipe, batch_size=4, max_wait_ms=300, adaptive_wait=False)
    try:
        before = LAUNCHES["attention"]
        futs = [server.submit(im, mask, seed=10 + i) for i, im in enumerate(images)]
        outs = [f.result(timeout=120) for f in futs]
        assert server.stats_snapshot()["batches_by_size"][4] == 1
        assert LAUNCHES["attention"] - before == n_attn * n_steps
        alone = server.submit(images[1], mask, seed=11).result(timeout=120)
    finally:
        server.close()
    keep = mask[..., 0] < 0.5
    for im, out in zip(images, outs):
        assert np.isfinite(out).all() and np.array_equal(out[keep], im[keep])
    ref = pipe.inpaint(images[1:2], mask[None], [11]).cpu().numpy()[0]
    assert np.array_equal(alone, ref)


def _weights(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32)).to(device)


# tile-aligned shapes of the FFHQ-256 UNet, a tall one beyond what a cluster
# holds in shared memory (its CTAs stream part of their rows), the geometry's
# edges (N=8, N=1, N not a multiple of the rows a CTA covers in one step) and
# ragged ones the kernel takes too; tolerance 0: kernel and plain version
# draw the same Philox bits and divide in IEEE float32
@pytest.mark.parametrize("n,c", [(9216, 512), (4608, 512), (512, 1536), (1152, 128),
                                 (100, 200), (32768, 256), (8, 128), (1, 128), (1000, 128),
                                 (1, 4), (3, 8), (257, 36)])
@pytest.mark.parametrize("seed", [1, 2 ** 32 - 1])
def test_quantize_kernel_matches_plain_bit_for_bit(cuda, n, c, seed):
    x = _weights((n, c), n + c, cuda)
    before = LAUNCHES["quantize"]
    values, scales = port_quantize.stochastic_quantize(x, seed)
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == before + 1
    assert values.dtype == torch.int8 and values.shape == (n, c)
    assert scales.dtype == torch.float32 and scales.shape == (1, c)
    with kernel_override(False, "quantize"):
        ref_values, ref_scales = port_quantize.stochastic_quantize(x, seed)
    assert LAUNCHES["quantize"] == before + 1
    assert torch.equal(scales, ref_scales)
    assert torch.equal(values, ref_values)


def test_quantize_kernel_takes_an_unaligned_view(cuda):
    flat = _weights((1 + 16 * 128,), 9, cuda)
    x = flat[1:].view(16, 128)  # contiguous, 4 bytes past an aligned address
    values, scales = port_quantize._quantize_cuda(x, 3)
    ref_values, ref_scales = port_quantize._quantize_stochastic_reference(x, 3)
    assert torch.equal(values, ref_values) and torch.equal(scales, ref_scales)


def test_quantize_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _weights((16, 128), 10, cuda)
    with pytest.raises(TypeError):
        port_quantize._quantize_cuda(x.double(), 0)
    with pytest.raises(TypeError):
        port_quantize._quantize_cuda(x.reshape(2, 8, 128), 0)
    with pytest.raises(ValueError):
        port_quantize._quantize_cuda(x.t(), 0)
    with pytest.raises(ValueError):
        port_quantize._quantize_cuda(x[:0], 0)


# geometries the wrapper does not pick at these shapes: every strip width and
# cluster size, CTAs that stream most of their rows (room for `tile_rows`
# rows), CTAs left without rows, ragged last strips
@pytest.mark.parametrize("n,c,strip,cluster,tile_rows", [
    (1000, 128, 32, 1, 64), (1000, 128, 16, 2, 128), (1000, 96, 16, 4, 256),
    (4608, 512, 32, 8, 64), (300, 256, 16, 8, 64), (9, 128, 16, 8, 64),
    (5000, 64, 32, 4, 1152), (3000, 40, 16, 3, 1024), (20000, 64, 32, 2, 1600),
    (4608, 512, 32, 5, 640), (1000, 200, 32, 3, 128), (70, 32, 16, 7, 64)])
def test_quantize_kernel_geometries_match_plain(cuda, n, c, strip, cluster, tile_rows):
    x = _weights((n, c), n * c, cuda)
    geo = port_quantize._make_geometry(n, c, strip, cluster, tile_rows * strip * 4)
    assert port_quantize.max_active_clusters(cluster, x.get_device()) >= 1
    values, scales = port_quantize._launch(x, 5, geo)
    ref_values, ref_scales = port_quantize._quantize_stochastic_reference(x, 5)
    assert torch.equal(scales, ref_scales)
    assert torch.equal(values, ref_values)
    bad = dataclasses.replace(geo, rows_per_cta=(n - 1) // cluster)  # misses the last row
    with pytest.raises(RuntimeError, match="cudaError"):
        port_quantize._launch(x, 5, bad)


@pytest.mark.parametrize("n,c", [(1, 1), (3, 5), (257, 33), (16, 130)])
def test_quantize_wrapper_refuses_c_not_a_multiple_of_4(cuda, n, c):
    """A float4 of the kernel must not straddle two rows; the dispatch
    (C % 128 == 0) never sends such a matrix."""
    x = _weights((n, c), 12, cuda)
    before = LAUNCHES["quantize"]
    with pytest.raises(ValueError, match="multiple of 4"):
        port_quantize._quantize_cuda(x, 0)
    assert LAUNCHES["quantize"] == before


def test_quantize_tensor_dispatch_on_the_card(cuda):
    """The JAX rule: the kernel for [N, C] with N % 8 == 0 and C % 128 == 0,
    nearest rounding (bit-equal to the CPU's) for the rest and inside
    kernel_override(False)."""
    for shape, kernel in (((3, 3, 128, 128), True), ((81, 128), False), ((1152, 6), False)):
        w = _weights(shape, 11, cuda)
        before = LAUNCHES["quantize"]
        out = quantize_tensor(w, seed=5)
        assert LAUNCHES["quantize"] == before + kernel, shape
        cpu = quantize_tensor(w.cpu(), seed=5)
        assert torch.equal(out["scale"].cpu(), cpu["scale"])
        if kernel:
            ref = port_quantize._quantize_stochastic_reference(w.reshape(-1, shape[-1]), 5)[0]
            assert torch.equal(out["q"].reshape(-1, shape[-1]), ref)
            with kernel_override(False, "quantize"):
                nearest = quantize_tensor(w, seed=5)
            assert LAUNCHES["quantize"] == before + 1
            assert torch.equal(nearest["q"].cpu(), cpu["q"])
        else:
            assert torch.equal(out["q"].cpu(), cpu["q"])
