#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`fidm_tpu_torch`) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, one line each (or a few), any failure exits non-zero:

1. the card's name and power limit; the CUDA kernels are built with nvcc
   from `fidm_tpu_torch/ops/csrc/` (sm_90a);
2. each kernel against its plain PyTorch version on the card, over
   sequence lengths, head dims and dtypes, with its time beside the plain
   version's, a PyTorch library call's and its bound;
3. the main path at full width: `InpaintingPipeline.create(PipelineConfig())`
   (the FFHQ-256 UNet, random weights from seed 0 with every zero-initialised
   conv re-drawn so that the output is not identically 0), DDIM-100 on a
   batch of 4 with a box mask, through the attention kernel;
4. the same path with the plain attention forced, held against phase 3, and
   one full-width UNet forward kernel against plain;
5. a JSON line of the kernels, then the contract line
   {"ok": true, "device": {...}}.

Both TF32 switches are off, so float32 products and convolutions are full
float32 wherever numbers are compared. Without a CUDA device, or without the
`fidm_tpu_torch` package beside this file, it exits non-zero and prints no
result.
"""
import dataclasses
import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 / f32
ATOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
BATCH = 4
# The main path, kernel against plain attention (phase 4), with what this
# script measured on an H100 SXM. One UNet forward, max abs / max |plain|: in
# float32 only the order of the sums differs (4.4e-6); in bf16 the plain
# version rounds the attention logits to bf16 and the kernel does not, which
# in this random-weight model moves the output by 2e-2, inside the 3-4e-2
# that separates the bf16 model from its own float32 copy. The DDIM-100
# images, mean abs in the hole: 101 steps with eta 0.9 carry that bf16
# difference into a few pixels (1.7e-2; median 9e-3, max 0.55 on [-1, 1]).
UNET_F32_TOL = 1e-4
UNET_BF16_TOL = 5e-2
IMAGE_MEAN_TOL = 5e-2


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, budget_ms=150.0, min_iters=3, max_iters=500):
    """Device time of one call of `fn`, by CUDA events around a run of
    launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = int(min(max_iters, max(min_iters, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(torch, fn, n=20):
    """Device time of one call of `fn`: its kernels' time summed by
    torch.profiler over `n` calls after a warm-up, host gaps left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total > 0, "the profiler recorded no device time")
    return total / 1e3 / n


def attention_bound(b, h, s, d, dtype):
    """(bound_ms, bound_by) for one attention call: q, k, v read once and o
    written once, against the two products' 4*B*H*S*S*D operations."""
    itemsize = 2 if dtype == "torch.bfloat16" else 4
    bytes_ms = 4 * b * h * s * d * itemsize / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * s * s * d / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_kernels(torch, F, attention, kernel_override):
    """Phase 2: the attention kernel against its plain version. Returns the
    row measured at the main path's largest shape."""
    main_row = None
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 32):
            for s in (64, 256, 1024, 4096, 100):
                q, k, v = (torch.randn(BATCH, 8, s, d, device="cuda", generator=g).to(dtype)
                           for _ in range(3))
                out = attention._attention_cuda(q, k, v)
                torch.cuda.synchronize()
                with kernel_override(False, "attention"):
                    ref = attention.qkv_attention(q, k, v)
                err = (out.float() - ref.float()).abs().max().item()
                tol = ATOL[str(dtype)]
                ms = device_ms(torch, lambda: attention._attention_cuda(q, k, v))
                call_ms = cuda_ms(torch, lambda: attention._attention_cuda(q, k, v))
                plain_ms = device_ms(torch, lambda: attention._attention_reference(q, k, v))
                lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
                bound_ms, bound_by = attention_bound(BATCH, 8, s, d, str(dtype))
                print(f"  attention {str(dtype)[6:]} B={BATCH} H=8 S={s} D={d}: "
                      f"max_abs_err={err:.3g} (tol {tol}) kernel_ms={ms:.5f} "
                      f"(wrapper call {call_ms:.5f}) plain_ms={plain_ms:.5f} "
                      f"sdpa_ms={lib_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})",
                      flush=True)
                check(err <= tol, f"attention kernel disagrees with its plain version "
                                  f"at S={s} D={d} {dtype}: {err} > {tol}")
                if (dtype, s, d) == (torch.bfloat16, 256, 64):
                    main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
                del q, k, v, out, ref
    torch.cuda.empty_cache()
    return main_row


def redraw_zero_convs(torch, model, seed):
    """Give every all-zero conv (ADM's zero-initialised block outputs and
    final conv) torch's default random init, from `seed`."""
    zero = [m for m in model.modules()
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and not m.weight.any()]
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        for m in zero:
            m.reset_parameters()
    return len(zero)


def profile_forward(torch, label, fn, top=8):
    """One call of `fn` (a UNet forward): its time by CUDA events, the host's
    time to enqueue it, and its device time by kernel (torch.profiler);
    prints the top kernels and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = cuda_ms(torch, fn)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in rows)
    print(f"{label}: {fwd_ms:.4f} ms by CUDA events, host enqueue "
          f"{sorted(host)[2]:.4f} ms; device busy {busy:.4f} ms in "
          f"{sum(n for _, _, n in rows)} kernels, idle share "
          f"{max(0.0, 1 - busy / fwd_ms):.3f}", flush=True)
    if busy == 0:
        print("      the profiler recorded no device time: not measured", flush=True)
        return
    for key, ms, _ in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"      {ms:9.4f} ms {ms / busy:6.1%}  {key[:110]}", flush=True)
    attn = sum(ms for key, ms, _ in rows if "attention_fwd_kernel" in key)
    print(f"      {attn:9.4f} ms {attn / busy:6.1%}  attention_fwd_kernel (all calls)",
          flush=True)


def main_inputs(torch, image_size):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    shape = (BATCH, image_size, image_size, 3)
    gt = torch.clamp(0.5 * torch.randn(shape, device="cuda", generator=g), -1.0, 1.0)
    mask = torch.zeros(shape[:-1] + (1,), device="cuda")
    lo, hi = image_size // 4, 3 * image_size // 4
    mask[:, lo:hi, lo:hi] = 1.0
    return gt, mask


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    try:
        import torch.nn.functional as F
        from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
        from fidm_tpu_torch.models import InpaintingUNet
        from fidm_tpu_torch.models.layers import AttentionBlock
        from fidm_tpu_torch.ops import LAUNCHES, attention, build, kernel_override
        from fidm_tpu_torch.sampling.sampler import _ddim_tables
    except ImportError as e:
        fail(f"the fidm_tpu_torch package is not importable from here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card, and the kernels' build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln]
    print(f"[1] built {list(build.KERNELS)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)}); ptxas: {sorted(set(regs))}", flush=True)

    # 2. each kernel against its plain version
    print("[2] attention kernel vs plain version (tolerance: f32 1e-5, sums in "
          "another order; bf16 2e-2, the plain version rounds q*scale, k*scale, "
          "the logits and the softmax to bf16 where the kernel keeps f32). "
          "*_ms: device time by torch.profiler; wrapper call: CUDA events around "
          "back-to-back calls, host cost included", flush=True)
    main_row = phase_kernels(torch, F, attention, kernel_override)

    # 3. the main path at full width
    config = PipelineConfig()
    pipe = InpaintingPipeline.create(config, seed=0, device="cuda")
    n_zero = redraw_zero_convs(torch, pipe.model, seed=1)
    n_attn = sum(isinstance(m, AttentionBlock) for m in pipe.model.modules())
    gt, mask = main_inputs(torch, config.unet.image_size)
    keep = mask[..., 0] < 0.5
    warm = dataclasses.replace(config.sampler, num_steps=5)
    pipe.inpaint(gt, mask, 0, sampler=warm)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"[3] ffhq256 UNet: {n_params} parameters, {n_zero} zero-init convs "
          f"re-drawn, {n_attn} attention blocks; sampler {config.sampler}", flush=True)

    for name in build.KERNELS:
        LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.inpaint(gt, mask, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in build.KERNELS}
    n_steps = len(_ddim_tables(pipe.sched, config.sampler)["t"])
    print(f"[3] DDIM-100 inpaint B={BATCH} at {config.unet.image_size}^2: "
          f"{seconds:.4f} s per call, {seconds / BATCH:.4f} s per sample, "
          f"{seconds / n_steps * 1e3:.3f} ms per step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}",
          flush=True)
    check(launches["attention"] == n_attn * n_steps,
          f"attention kernel launches {launches['attention']} != {n_attn} x {n_steps}")
    check(tuple(out.shape) == tuple(gt.shape) and out.dtype == torch.float32,
          f"output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(torch.equal(out[keep], gt[keep]), "known pixels differ from gt")
    check(out.abs().max().item() <= 1.0, "output outside [-1, 1]")
    hole_change = (out[~keep] - gt[~keep]).abs().mean().item()
    check(hole_change > 1e-3, "the hole was not filled")
    print(f"[3] output finite, known pixels bit-equal to gt, hole mean |out-gt| "
          f"{hole_change:.4f}", flush=True)

    # one UNet forward: device time by kernel, and the device's idle share
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    x = torch.randn(gt.shape, device="cuda", generator=g)
    t = torch.full((BATCH,), 500, device="cuda", dtype=torch.int32)
    masked = gt * keep[..., None]
    with torch.inference_mode():
        profile_forward(torch, f"[3] one UNet forward B={BATCH}",
                        lambda: pipe.model(x, t, masked, mask))

    # 4. the plain attention forced, same weights, inputs and seed
    def plain(fn):
        before = LAUNCHES["attention"]
        with kernel_override(False, "attention"):
            result = fn()
        check(LAUNCHES["attention"] == before, "the plain path launched the kernel")
        return result

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    f32_model = InpaintingUNet(dataclasses.replace(config.unet, dtype=torch.float32))
    f32_model.load_state_dict(pipe.model.state_dict())
    f32_model = f32_model.to("cuda").eval()
    with torch.inference_mode():
        yk16, yk32 = (m(x, t, masked, mask) for m in (pipe.model, f32_model))
        yp16, yp32 = plain(lambda: [m(x, t, masked, mask) for m in (pipe.model, f32_model)])
        plain(lambda: profile_forward(torch, "[4] the same forward, plain attention",
                                      lambda: pipe.model(x, t, masked, mask)))
    e32, e16 = rel(yk32, yp32), rel(yk16, yp16)
    print(f"[4] one UNet forward, kernel vs plain, max abs / max |plain|: float32 "
          f"{e32:.4g} (tol {UNET_F32_TOL}); bf16 {e16:.4g} (tol {UNET_BF16_TOL}); "
          f"bf16 against the float32 model: kernel {rel(yk16, yp32):.4g}, plain "
          f"{rel(yp16, yp32):.4g}", flush=True)
    t0 = time.perf_counter()
    out_plain = plain(lambda: pipe.inpaint(gt, mask, 0))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_again = pipe.inpaint(gt, mask, 0)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    print(f"[4] the kernel path once more, after the plain one: {again_s:.4f} s per call; "
          f"bit-identical to the first call: {torch.equal(out_again, out)}", flush=True)
    check(torch.equal(out_again, out), "the same seed gave another image")
    hole = (out - out_plain).abs()[~keep]
    q = torch.quantile(hole.flatten().float(), torch.tensor([0.5, 0.99], device="cuda"))
    print(f"[4] plain-attention path: {plain_s:.4f} s per call; images kernel vs plain "
          f"in the hole: mean abs {hole.mean().item():.4g} (tol {IMAGE_MEAN_TOL}), "
          f"median {q[0].item():.4g}, p99 {q[1].item():.4g}, max {hole.max().item():.4g}",
          flush=True)
    check(e32 <= UNET_F32_TOL, "float32 UNet forward: kernel and plain disagree")
    check(e16 <= UNET_BF16_TOL, "bf16 UNet forward: kernel and plain disagree")
    check(torch.equal(out_plain[keep], gt[keep]), "plain path: known pixels differ")
    check(hole.mean().item() <= IMAGE_MEAN_TOL, "kernel and plain paths disagree")

    # 5. the record
    kernels = [dict(name="attention", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/attention.cu",
                    replaces="fidm_tpu/ops/attention.py:46",
                    launches=launches["attention"], **main_row)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
