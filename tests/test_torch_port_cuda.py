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
from fidm_tpu_torch.sampling.sampler import _dpm_tables, _method_tables
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


# The f32 kernel (3xTF32 products, each to about 2^-22) against the plain
# version run in float64 on the same inputs: the gate of the float32 plain
# version, which itself lies within 1e-6 of float64 here.
@pytest.mark.parametrize("s,d", [(1, 64), (15, 32), (64, 64), (100, 128), (256, 64),
                                 (257, 128), (1024, 64), (4096, 32)])
def test_f32_kernel_matches_float64(cuda, s, d):
    q, k, v = _qkv((2, 8, s, d), 10, torch.float32, cuda)
    out = port_attention._attention_cuda(q, k, v)
    ref64 = port_attention._attention_reference(q.double(), k.double(), v.double())
    assert (out.double() - ref64).abs().max().item() <= 1e-5


# Logits up to about 45 (q and k scaled by sqrt(8)) and v's rows across
# binades 2^-6 to 2^6: the split's lo term and the max subtraction carry the
# result. Held to 1e-5 of max|v| against the plain version in float32 and in
# float64 (the float32 plain version is itself a few 1e-6 of max|v| off
# float64 here). q and k rows are not scaled by binades: at logits near 1e5
# the float32 plain version is 1e-4 off float64.
@pytest.mark.parametrize("s,d", [(64, 64), (256, 64), (257, 128), (1024, 64), (1024, 32)])
def test_f32_kernel_wide_range(cuda, s, d):
    rng = np.random.default_rng(s * d)
    q, k, v = (rng.standard_normal((2, 8, s, d)).astype(np.float32) for _ in range(3))
    q, k = q * np.float32(np.sqrt(8)), k * np.float32(np.sqrt(8))
    v = v * np.exp2(rng.integers(-6, 7, (2, 8, s, 1))).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    tol = 1e-5 * v.abs().max().item()
    out = port_attention._attention_cuda(q, k, v)
    ref = port_attention._attention_reference(q, k, v)
    ref64 = port_attention._attention_reference(q.double(), k.double(), v.double())
    assert (out - ref).abs().max().item() <= tol
    assert (out.double() - ref64).abs().max().item() <= tol


@pytest.mark.parametrize("s,d", [(1, 64), (64, 64), (100, 32), (256, 64), (257, 128),
                                 (1024, 64), (4096, 128)])
def test_f32_tilings_agree(cuda, s, d):
    """Both tilings of the f32 kernel of this D (wgmma for D <= 64, mma.sync
    at D=128), whatever `_f32_tiling` picks, within 1e-5 of the plain
    version; any other tiling raises."""
    q, k, v = _qkv((2, 8, s, d), 11, torch.float32, cuda)
    ref = port_attention._attention_reference(q, k, v)
    before = {n: LAUNCHES[n] for n in ("attention.bf16", "attention.f32")}
    codes = port_attention.F32_TILINGS
    for code in codes:
        out = port_attention._attention_cuda(q, k, v, code)
        assert (out - ref).abs().max().item() <= 1e-5, code
    assert LAUNCHES["attention.f32"] == before["attention.f32"] + len(codes)
    assert LAUNCHES["attention.bf16"] == before["attention.bf16"]
    for code in (0, 3):
        with pytest.raises(RuntimeError, match="cudaError"):
            port_attention._attention_cuda(q, k, v, code)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_launches_no_kernel(cuda, dtype):
    """Under autograd the forward launches the kernel once; the backward
    recomputes the plain version (the one place it runs on the card outside
    kernel_override) and launches nothing: its gradients are the plain
    version's autograd, bit for bit, on the same inputs."""
    q, k, v = (a.requires_grad_() for a in _qkv((2, 4, 256, 64), 13, dtype, cuda))
    up = _qkv((2, 4, 256, 64), 14, dtype, cuda)[0]
    before = LAUNCHES["attention"]
    out = qkv_attention(q, k, v)
    assert LAUNCHES["attention"] == before + 1
    grads = torch.autograd.grad(out, (q, k, v), up)
    assert LAUNCHES["attention"] == before + 1
    refs = [a.detach().requires_grad_() for a in (q, k, v)]
    ref_grads = torch.autograd.grad(port_attention._attention_reference(*refs), refs, up)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_small_train_step_on_the_card(cuda):
    """A bf16 train step of a small UNet: the kernel once per attention block
    in the forward, none in the backward, and the same loss and gradient
    norm (to bf16 rounding of the forward) as with the plain attention; the
    remat policies give the same step, with the forward launched again."""
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.training import (TrainState, make_lr_schedule, make_optimizer,
                                         make_train_step)

    cfg = UNetConfig(image_size=32, model_channels=64, channel_mult=(1, 2),
                     attention_resolutions=(2,), num_head_channels=64)
    torch.manual_seed(0)
    model = InpaintingUNet(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model = model.to(cuda)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 8:24] = 1.0
    batch = {"image": img, "masked_image": img * (1 - mask), "mask": mask}
    step = make_train_step(DiffusionSchedule.create("quadratic", 1000, device="cuda"))

    def one(policy="none", plain=False):
        model.load_state_dict(base)
        model.config = dataclasses.replace(cfg, remat=policy != "none",
                                           remat_policy=policy if policy != "none" else "full")
        state = TrainState.create(model, dict(model.named_parameters()),
                                  make_optimizer(make_lr_schedule("none", 1e-4, 1)))
        before = LAUNCHES["attention"]
        if plain:
            with kernel_override(False, "attention"):
                _, m = step(state, batch, 3)
        else:
            _, m = step(state, batch, 3)
        return {k: v.item() for k, v in m.items()}, LAUNCHES["attention"] - before

    kernel, launches = one()
    assert launches == n_attn and np.isfinite(kernel["loss"])
    plain, plain_launches = one(plain=True)
    assert plain_launches == 0
    for key in ("loss", "grad_norm"):
        assert abs(kernel[key] - plain[key]) <= 5e-2 * abs(plain[key]), key
    for policy in ("full", "convs"):
        m, launches = one(policy)
        assert launches == 2 * n_attn, policy
        for key in ("loss", "grad_norm"):
            assert abs(m[key] - kernel[key]) <= 1e-3 * abs(kernel[key]), (policy, key)
    model.config = cfg


@pytest.mark.parametrize("kind,forwards", [("progressive", 3), ("consistency", 3),
                                           ("consistency-training", 2)])
def test_small_distill_step_on_the_card(cuda, kind, forwards):
    """A distillation step of a small UNet of each kind: the kernel once per
    attention block in each forward (teacher, target network, student), none
    in the backward; the loss and gradient norm within 5e-2 of the step with
    the plain attention (chip_smoke.py [12]'s bound); the frozen teacher
    unmoved; the target network's forward bit-equal to a module holding the
    EMA tensors."""
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.consistency import _at_params
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.training import TrainState, init_ema, make_lr_schedule, make_optimizer

    cfg = UNetConfig(image_size=32, model_channels=64, channel_mult=(1, 2),
                     attention_resolutions=(2,), num_head_channels=64)
    torch.manual_seed(0)
    model = InpaintingUNet(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    base = {k: v.clone() for k, v in model.state_dict().items()}
    teacher = InpaintingUNet(cfg)
    teacher.load_state_dict(base)
    teacher = teacher.to(cuda).requires_grad_(False)
    model = model.to(cuda)
    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 8:24] = 1.0
    batch = {"image": img, "masked_image": img * (1 - mask), "mask": mask}
    sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
    if kind == "progressive":
        step = make_distill_step(sched, unet_apply, unet_apply, teacher_steps=8)
    else:
        step = make_consistency_step(sched, unet_apply if kind == "consistency" else None,
                                     unet_apply, grid_size=20)
        teacher = teacher if kind == "consistency" else None

    def one(plain=False):
        model.load_state_dict(base)
        params = dict(model.named_parameters())
        state = TrainState.create(model, params, make_optimizer(make_lr_schedule("none", 1e-4, 1)),
                                  ema_params=None if kind == "progressive" else init_ema(params))
        before = LAUNCHES["attention"]
        if plain:
            with kernel_override(False, "attention"):
                state, m = step(state, teacher, batch, 3)
        else:
            state, m = step(state, teacher, batch, 3)
        return {k: v.item() for k, v in m.items()}, LAUNCHES["attention"] - before, state

    kernel, launches, _ = one()
    assert launches == forwards * n_attn and np.isfinite(kernel["loss"])
    plain, plain_launches, state = one(plain=True)
    assert plain_launches == 0
    for key in ("loss", "grad_norm"):
        assert abs(kernel[key] - plain[key]) <= 5e-2 * abs(plain[key]), key
    if teacher is not None:
        assert all(torch.equal(p.cpu(), base[k]) for k, p in teacher.state_dict().items())
    if state.ema_params is not None:
        target = InpaintingUNet(cfg).to(cuda)
        target.load_state_dict(state.ema_params)
        x, mi, m = (torch.from_numpy(batch[k]).to(cuda) for k in ("image", "masked_image", "mask"))
        t = torch.tensor([10, 600], device=cuda)
        with torch.inference_mode():
            assert torch.equal(_at_params(unet_apply, model, state.ema_params, x, t, mi, m),
                               target(x, t, mi, m))


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


def _small_pipeline(sampler, seed=0):
    """A small CUDA pipeline with its zero-initialised output convs re-drawn,
    so that the output depends on every block."""
    cfg = PipelineConfig(
        unet=UNetConfig(image_size=32, model_channels=64, channel_mult=(1, 2),
                        attention_resolutions=(2,), num_head_channels=64), sampler=sampler)
    pipe = InpaintingPipeline.create(cfg, seed=seed, device="cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        for m in pipe.model.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and not m.weight.any():
                m.reset_parameters()
    rng = np.random.default_rng(2)
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)).cuda()
    mask = torch.zeros((2, 32, 32, 1), device="cuda")
    mask[:, 8:24, 8:24] = 1.0
    return pipe, gt, mask


@pytest.mark.parametrize("seed", [0, [3, 99]], ids=["one_seed", "per_row_seeds"])
@pytest.mark.parametrize("sampler", [
    SamplerConfig(method="ddim", num_steps=6, eta=0.9, injection=True),
    SamplerConfig(method="dpm++2m-sde", num_steps=6, injection=True)], ids=["ddim", "dpm_sde"])
def test_program_replays_the_eager_call(cuda, sampler, seed):
    """A small program on the card: `compile_batch` captures a
    torch.cuda.CUDAGraph; each replay, through `inpaint`, is bit-equal to
    the eager call and adds the capture's recorded launches to LAUNCHES (the
    capture itself adds none); a second replay returns new tensors."""
    pipe, gt, mask = _small_pipeline(sampler)
    n_attn = sum(isinstance(m, AttentionBlock) for m in pipe.model.modules())
    per_call = n_attn * len(_method_tables(pipe.sched, sampler)["t"])
    batched = not isinstance(seed, int)
    ref = pipe.inpaint(gt, mask, seed)
    before = LAUNCHES["attention"]
    program = pipe.compile_batch(2, batched_key=batched)
    assert LAUNCHES["attention"] - before == per_call  # the recording run alone
    assert isinstance(program.graph, torch.cuda.CUDAGraph)
    assert program.launches["attention"] == per_call
    pipe.install_program(2, sampler, program, batched_key=batched)
    before = LAUNCHES["attention"]
    out = pipe.inpaint(gt, mask, seed)
    assert LAUNCHES["attention"] - before == per_call
    again = pipe.inpaint(gt, mask, seed)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(again, ref)
    assert out.data_ptr() != again.data_ptr() != program.out.data_ptr()
    keep = mask[..., 0] < 0.5
    assert torch.equal(out[keep], gt[keep])


def test_cast_params_recaptures(cuda):
    """`cast_params` drops the installed program, whose graph holds the
    float32 parameters' addresses: the next call runs eagerly on the bf16
    parameters, and a program captured after the cast replays that call."""
    sampler = SamplerConfig(method="ddim", num_steps=6, eta=0.9, injection=True)
    pipe, gt, mask = _small_pipeline(sampler)
    pipe.install_program(2, sampler, pipe.compile_batch(2))
    f32 = pipe.inpaint(gt, mask, 5)
    pipe.cast_params(torch.bfloat16)
    assert pipe.installed_program(2, sampler) is None
    assert all(p.dtype == torch.bfloat16 for p in pipe.model.parameters())
    eager = pipe.inpaint(gt, mask, 5)
    assert not torch.equal(eager, f32)
    program = pipe.compile_batch(2)
    assert isinstance(program.graph, torch.cuda.CUDAGraph)
    pipe.install_program(2, sampler, program)
    assert torch.equal(pipe.inpaint(gt, mask, 5), eager)


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


@pytest.mark.parametrize("masked", [False, True])
def test_one_rank_nccl_mesh_step_is_the_unmeshed_step(cuda, masked):
    """A train step under a one-rank NCCL mesh equals the unmeshed step bit
    for bit, with the attention kernel launched 4 times per forward (a
    width-64-head config: 3 attention blocks at 16² and the middle one);
    also with the biases frozen by a param_mask."""
    import socket

    import torch.distributed as dist

    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.parallel import create_mesh, shard_batch
    from fidm_tpu_torch.training import TrainState, make_optimizer, make_train_step

    cfg = UNetConfig(image_size=32, in_channels=9, model_channels=64, out_channels=6,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=1, num_head_channels=64, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((0.5 * rng.standard_normal((4, 32, 32, 3))).astype(np.float32))
    mask = torch.zeros(4, 32, 32, 1)
    mask[:, 8:24, 4:20] = 1.0
    batch = {"image": img, "masked_image": img * (1 - mask), "mask": mask}
    sched = DiffusionSchedule.create("quadratic", 1000, device=cuda)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = create_mesh(data=1, fsdp=1)
        runs = []
        for m in (None, mesh):
            torch.manual_seed(0)
            model = InpaintingUNet(cfg).to(cuda)
            params = dict(model.named_parameters())
            mask = {k: not k.endswith(".bias") for k in params} if masked else None
            state = TrainState.create(model, params,
                                      make_optimizer(lambda c: 1e-4, param_mask=mask))
            step = make_train_step(sched, mesh=m)
            before = LAUNCHES["attention"]
            metrics = [step(state, batch if m is None else shard_batch(batch, m), 3)[1]
                       for _ in range(2)]
            torch.cuda.synchronize()
            runs.append((metrics, [p.detach().clone() for p in model.parameters()],
                         LAUNCHES["attention"] - before))
    finally:
        dist.destroy_process_group()
    (m0, p0, n0), (m1, p1, n1) = runs
    assert n0 == n1 == 2 * 4  # two steps, one forward each
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_one_rank_mesh_program_on_the_card(cuda, backend):
    """A meshed pipeline's program in a one-rank group: over NCCL a CUDA
    graph whose replay, through `inpaint`, is the meshed eager call and the
    unmeshed call bit for bit, with and without fsdp_params; over gloo on
    CUDA tensors `compile_batch` raises (a graph captures NCCL collectives
    only) and the eager call still runs."""
    import socket

    import torch.distributed as dist

    from fidm_tpu_torch.parallel import create_mesh

    sampler = SamplerConfig(method="ddim", num_steps=6, eta=0.9, injection=True)
    plain, gt, mask = _small_pipeline(sampler)
    ref = plain.inpaint(gt, mask, 4)
    n_attn = sum(isinstance(m, AttentionBlock) for m in plain.model.modules())
    per_call = n_attn * len(_method_tables(plain.sched, sampler)["t"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = create_mesh(data=1, fsdp=1)
        for kw in (dict(), dict(fsdp_params=True, fsdp_min_size=1024)):
            pipe = InpaintingPipeline(plain.model, plain.sched, plain.config, mesh=mesh, **kw)
            eager = pipe.inpaint(gt, mask, 4)
            assert torch.equal(eager, ref)
            if backend == "gloo":
                with pytest.raises(ValueError, match="NCCL collectives only"):
                    pipe.compile_batch(2)
                continue
            program = pipe.compile_batch(2)
            assert isinstance(program.graph, torch.cuda.CUDAGraph)
            pipe.install_program(2, sampler, program)
            before = LAUNCHES["attention"]
            out = pipe.inpaint(gt, mask, 4)
            torch.cuda.synchronize()
            assert LAUNCHES["attention"] - before == per_call
            assert torch.equal(out, eager)
    finally:
        dist.destroy_process_group()


def test_native_normalize_matches_numpy_on_card_inputs(cuda):
    """The C++ normalize and compose against numpy on a 256² batch of 4, as
    the tensors the card receives: equal but for the last bit."""
    from fidm_tpu_torch.data import random_mask
    from fidm_tpu_torch.data.dataset import _normalize_compose
    from fidm_tpu_torch.native import build

    assert build.load() is not None, build.last_error("native")
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    masks = np.stack([random_mask(np.random.default_rng(i), 256) for i in range(4)])
    native = [_normalize_compose(u, m) for u, m in zip(u8, masks)]
    image = torch.from_numpy(np.stack([n[0] for n in native])).to(cuda)
    masked = torch.from_numpy(np.stack([n[1] for n in native])).to(cuda)
    ref = torch.from_numpy(u8).to(cuda).float() / 255.0 * 2.0 - 1.0
    assert (image - ref).abs().max().item() <= float(np.spacing(np.float32(1.0)))
    assert torch.equal(masked, image * (1.0 - torch.from_numpy(masks).to(cuda)))


def _model_axis_rank(rank, port, mode, out_dir):
    """One of two gloo ranks on the card (NCCL refuses two ranks on one
    device): a TP or spatial forward and train step of a small bf16 model
    with 64-wide heads, against the unmeshed calls on the same card."""
    import torch.distributed as dist

    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.parallel import create_mesh, shard_batch, shard_params, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import full_params, gather_h, model_group
    from fidm_tpu_torch.parallel.tp import attach
    from fidm_tpu_torch.training import TrainState, make_train_step
    from fidm_tpu_torch.training.train_state import Optimizer

    class Recording(Optimizer):  # keeps the reduced gradients of its first update
        def update(self, grads, state, params, *args):
            if not hasattr(self, "grads"):
                self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return super().update(grads, state, params, *args)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = create_mesh(model=2)
    ax = model_group(mesh)
    cfg = UNetConfig(image_size=32, in_channels=9, model_channels=64, out_channels=6,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=2, num_head_channels=64, dtype=torch.float32)

    def model():
        torch.manual_seed(0)
        m = InpaintingUNet(cfg)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn_like(p))
        return m.to("cuda")

    rng = np.random.default_rng(0)
    img = torch.from_numpy((0.5 * rng.standard_normal((2, 32, 32, 3))).astype(np.float32))
    mask = torch.zeros(2, 32, 32, 1)
    mask[:, 8:24, 4:20] = 1.0
    batch = {k: v.cuda() for k, v in
             {"image": img, "masked_image": img * (1 - mask), "mask": mask}.items()}
    t = torch.tensor([300, 700], device="cuda")
    ref_model = model()
    with torch.no_grad():
        ref = ref_model(batch["image"], t, batch["masked_image"], batch["mask"])
    sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
    ref_tx = Recording(lambda c: 1e-5)
    ref_state = TrainState.create(ref_model, dict(ref_model.named_parameters()), ref_tx)
    ref_metrics = make_train_step(sched)(ref_state, batch, 3)[1]
    m = model()
    if mode == "tp":
        params, specs = tp_shard_params(m, mesh)
    else:
        params, specs = shard_params(m, mesh)
    part = shard_batch(batch, mesh, spatial=mode == "spatial")
    before = LAUNCHES["attention.f32"]
    with torch.no_grad(), attach(m, mesh, mode, specs):
        out = m(part["image"], t, part["masked_image"], part["mask"])
    launches = LAUNCHES["attention.f32"] - before
    if mode == "spatial":
        out = gather_h(out, ax, dim=1)
    tx = Recording(lambda c: 1e-5)
    state = TrainState.create(m, params, tx, specs=specs)
    metrics = make_train_step(sched, mesh=mesh, spatial=mode == "spatial")(state, part, 3)[1]
    whole, grads = full_params(state.params, specs, mesh), full_params(tx.grads, specs, mesh)

    def rel(name):
        return abs(float(metrics[name]) - float(ref_metrics[name])) / abs(float(ref_metrics[name]))

    torch.save({"forward": ((out - ref).abs().max() / ref.abs().max()).item(),
                "launches": launches, "loss": rel("loss"), "grad_norm": rel("grad_norm"),
                # each gradient's error over its bound, 2e-5 of its largest value + 1e-7
                "grads": max((grads[k] - g).abs().max().item()
                             / (2e-5 * g.abs().max().item() + 1e-7)
                             for k, g in ref_tx.grads.items()),
                "params": max((whole[k] - p).abs().max().item()
                              for k, p in ref_state.params.items())},
               f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


def _model_axis_training_rank(rank, port, case, out_dir):
    """One of two gloo ranks on the card for the rest of training over the
    axis, at the small size of `_model_axis_rank`, float32, against the
    unmeshed calls: {name: (error, bound)} and the attention launches
    against those wanted, written to OUT_DIR/rank<RANK>.pt."""
    import torch.distributed as dist

    from fidm_tpu_torch.data.dataset import DataLoader
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.lora import init_lora, lora_weights
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.parallel import create_mesh, shard_batch, shard_params, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import ShardedModule, full_params
    from fidm_tpu_torch.training import (CheckpointManager, FitConfig, TrainState, fit,
                                         init_ema, make_eval_step, make_train_step)
    from fidm_tpu_torch.training.train_state import Optimizer

    class Recording(Optimizer):  # keeps the reduced gradients of its first update
        def update(self, grads, state, params, *args):
            if not hasattr(self, "grads"):
                self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return super().update(grads, state, params, *args)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = create_mesh(model=2)
    cfg = UNetConfig(image_size=32, in_channels=9, model_channels=64, out_channels=6,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=2, num_head_channels=64, dtype=torch.float32)
    sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")

    def model():
        torch.manual_seed(0)
        m = InpaintingUNet(cfg)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn_like(p))
        return m.to("cuda")

    def rows(n, seed):
        rng = np.random.default_rng(seed)
        img = np.clip(0.5 * rng.standard_normal((n, 32, 32, 3)), -1, 1).astype(np.float32)
        mask = np.zeros((n, 32, 32, 1), np.float32)
        mask[:, 8:24, 4:20] = 1.0
        return [{"image": img[i], "masked_image": img[i] * (1 - mask[i]), "mask": mask[i]}
                for i in range(n)]

    batch = {k: torch.from_numpy(np.stack([r[k] for r in rows(2, 0)])).cuda()
             for k in ("image", "masked_image", "mask")}
    errors, launches = {}, []

    def compare(label, got, ref):
        """loss and grad_norm 1e-5 relative, each gradient over its bound
        (2e-5 of its largest value + 1e-7)."""
        (gm, gg), (rm, rg) = got, ref
        for k in ("loss", "grad_norm"):
            errors[f"{label} {k}"] = (abs(float(gm[k]) - float(rm[k])) / abs(float(rm[k])), 1e-5)
        errors[f"{label} grads"] = (max((gg[k] - g).abs().max().item()
                                        / (2e-5 * g.abs().max().item() + 1e-7)
                                        for k, g in rg.items()), 1.0)

    def counted(fn, want):
        before = LAUNCHES["attention.f32"]
        out = fn()
        launches.append((LAUNCHES["attention.f32"] - before, want))
        return out

    if case.startswith("lora"):
        def lora(layout):
            m = model().requires_grad_(False)
            adapter = {k: (v + 0.05 * torch.randn_like(v) if k.endswith("/b") else v)
                       .requires_grad_(True) for k, v in init_lora(1, m, cfg).items()}
            me = None if layout is None else mesh
            specs = tp_shard_params(m, mesh)[1] if layout == "tp" else None
            tx = Recording(lambda c: 1e-5)
            state = TrainState.create(m, adapter, tx, model_specs=specs)
            step = make_train_step(sched, mesh=me, spatial=layout == "spatial",
                                   param_transform=lambda l: lora_weights(m, cfg, l, specs, me))
            part = batch if me is None else shard_batch(batch, me, spatial=layout == "spatial")
            metrics = counted(lambda: step(state, part, 3)[1], 4)
            return metrics, tx.grads

        compare(case, lora(case[5:]), lora(None))
    elif case == "distill_tp":
        for kind in ("progressive", "consistency"):
            res = []
            for me in (None, mesh):
                student, teacher = model(), model().requires_grad_(False)
                params, specs = ((dict(student.named_parameters()), None) if me is None
                                 else tp_shard_params(student, mesh))
                if me is not None and kind == "progressive":
                    tp, ts = tp_shard_params(teacher, mesh)
                    teacher = ShardedModule(teacher, mesh, params=tp, specs=ts)
                tx = Recording(lambda c: 1e-5)
                state = TrainState.create(student, params, tx, specs=specs, ema_params=(
                    init_ema(params) if kind == "consistency" else None))
                step = (make_distill_step(sched, unet_apply, unet_apply, teacher_steps=4,
                                          mesh=me) if kind == "progressive" else
                        make_consistency_step(sched, unet_apply, unet_apply, grid_size=10,
                                              mesh=me))
                metrics = counted(lambda: step(state, teacher, batch, 3)[1], 12)
                res.append((metrics, tx.grads if me is None else full_params(tx.grads, specs, me)))
            compare(kind, res[1], res[0])
    elif case.startswith("fit"):
        spatial = case == "fit_spatial"

        def run(me, ckdir):
            m = model()
            if me is None:
                params, specs = dict(m.named_parameters()), None
            else:
                params, specs = (shard_params if spatial else tp_shard_params)(m, mesh)
            state = TrainState.create(m, params, Recording(lambda c: 1e-5), specs=specs)
            mgr = None if ckdir is None else CheckpointManager(ckdir, mesh=me)
            sp = spatial and me is not None
            state, hist = counted(lambda: fit(
                state, make_train_step(sched, mesh=me, spatial=sp),
                make_eval_step(sched, mesh=me, spatial=sp),
                DataLoader(rows(4, 1), 2, shuffle=True, seed=3, drop_last=True),
                DataLoader(rows(2, 2), 2), 5,
                FitConfig(num_epochs=1, log_fn=lambda *a, **k: None, handle_preemption=False),
                checkpoint_manager=mgr, mesh=me), 12)
            return state, hist[0]

        _, ref = run(None, None)
        state, got = run(mesh, f"{out_dir}/fit_ckpt")
        for k in ("train_loss", "val_loss"):
            errors[f"fit {k}"] = (abs(got[k] - ref[k]) / abs(ref[k]), 1e-5)
        m = model()
        one = TrainState.create(m, dict(m.named_parameters()), Recording(lambda c: 1e-5))
        CheckpointManager(f"{out_dir}/fit_ckpt").restore("latest", one)
        joined = full_params(state.params, state.specs, mesh)
        errors["fit checkpoint restored into one process"] = (
            max((one.params[k] - p).abs().max().item() for k, p in joined.items()), 0.0)
    else:  # guided_spatial
        def mirror(x, t):
            energy = -0.25 * (x - torch.flip(x, dims=[1])).square().sum()
            return torch.autograd.grad(energy, x)[0]

        ddim = SamplerConfig(method="ddim", num_steps=4, eta=0.9, injection=True)
        config = PipelineConfig(unet=cfg, sampler=ddim)
        gt, mask = batch["image"], batch["mask"]
        ref = InpaintingPipeline(model().requires_grad_(False), sched, config).inpaint(
            gt, mask, 0, cond_fn=mirror)
        pipe = InpaintingPipeline(model().requires_grad_(False), sched, config, mesh=mesh,
                                  shard_spatial=True)
        out = counted(lambda: pipe.inpaint(gt, mask, 0, cond_fn=mirror), 20)
        keep = mask[..., 0] < 0.5
        errors["guided images"] = ((out - ref).abs().max().item(), 1e-4)
        errors["guided known pixels"] = ((out[keep] - gt[keep]).abs().max().item(), 0.0)
    torch.save({"errors": errors, "launches": launches}, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


_TRAINING_CASES = ["lora_tp", "lora_spatial", "distill_tp", "fit_tp", "fit_spatial",
                   "guided_spatial"]


@pytest.mark.parametrize("mode", ["tp", "spatial"] + _TRAINING_CASES)
def test_model_axis_two_ranks_on_the_card(cuda, mode, tmp_path):
    """Two gloo ranks on the card (chip_smoke.py phase 14 at a small size):
    the forward through the attention kernel (4 launches per rank: three
    attention blocks at 16² and the middle one; under TP at one head each)
    within 1e-4 of the unmeshed forward, relative to its largest value; one
    train step's loss and grad_norm 1e-5 relative, its reduced gradients
    2e-5 of each tensor's largest value plus 1e-7 (the parameters, 2e-5
    after it, move by about lr whatever the gradient's size). The rest of
    training at the train step's bounds: a LoRA step under TP and under
    spatial partitioning; a progressive step (the teacher its own slices)
    and a consistency step (the teacher whole) under TP; a 1-epoch 2-step
    fit under TP and one under spatial partitioning, each checkpoint
    restored into one process bit for bit; a
    guided 4-step DDIM under shard_spatial within 1e-4, known pixels exact;
    each with its unmeshed call's attention launches."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rank_fn = _model_axis_rank if mode in ("tp", "spatial") else _model_axis_training_rank
    mp.spawn(rank_fn, args=(port, mode, str(tmp_path)), nprocs=2)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        if mode not in ("tp", "spatial"):
            assert all(n == want for n, want in res["launches"]), res
            assert all(err <= bound for err, bound in res["errors"].values()), res
            continue
        assert res["launches"] == 4, res
        assert res["forward"] <= 1e-4 and res["loss"] <= 1e-5 and res["params"] <= 2e-5, res
        assert res["grad_norm"] <= 1e-5 and res["grads"] <= 1.0, res
