#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`fidm_tpu_torch`) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, one line each (or a few), any failure exits non-zero:

1. the card's name and power limit, and whether PIL imports on this machine;
   the CUDA kernels are built with nvcc from `fidm_tpu_torch/ops/csrc/`
   (sm_90a), one process per source, all started together;
2. each kernel against its plain PyTorch version on the card, with its time
   beside the plain version's, a PyTorch call's and its bound: attention
   over sequence lengths, head dims and dtypes, and in bf16 at every batch
   size of phase 6's ladder and at phase 7's batch 16; the int8 quantizer at the
   FFHQ-256 UNet's weight shapes, a ragged one and a tall one that streams,
   bit for bit, cold and warm, one device operation per call, with its
   launch geometry;
3. the main path at full width: `InpaintingPipeline.create(PipelineConfig())`
   (the FFHQ-256 UNet, random weights from seed 0 with every zero-initialised
   conv re-drawn so that the output is not identically 0), DDIM-100 on a
   batch of 4 with a box mask, through the attention kernel; then the
   server's default preset, `dpm-25-sde`, on the same pipeline and inputs;
4. the same two calls with the plain attention forced, held against phase 3,
   and one full-width UNet forward kernel against plain;
5. the quantization path at full width: phase 3's model written as an ADM
   `.pt`, `fidm_tpu_torch.cli.quantize` on it (absmax, through the quantize
   kernel; every kernel-rounded tensor of the `.npz` against the plain
   version; twice, bit-identical; then `--calibrate` on a packed shard
   directory written with numpy), the absmax `.npz` loaded into a pipeline,
   DDIM-100 on it with phase 3's inputs and seed, and one UNet forward
   quantized against unquantized;
6. the serving path at full width: `fidm_tpu_torch.cli.serve`'s flags and
   presets (`dpm-25-sde`, `ddim-100` and a refine tier) on phase 5's `.pt`,
   `serving.serve(..., warmup=True)` in this process on a local port, 27
   requests over HTTP from 8 client threads, every response gated, the
   attention launches tied to the batches the server ran, six requests
   replayed alone and against phase 3's pipeline, the cross-batch bound's
   witness (a batch of 8 again in bf16 and in float32, and another seed), a
   uint8 round trip, and one instrumented pass's phase times; the server also
   offers `ddim-100-deep`, and 3 of its requests join the 24, with the same
   witness for one of them at batch 4;
7. feature caching at full width: key and cached UNet forwards (encoder mode,
   DeepCache branches 1, 2 and 5) held bit for bit against the plain forward,
   with their attention launches, host enqueue and device time; the four
   cached presets (`ddim-100-deep`, `ddim-100-turbo`, `ddim-20-fast`,
   `dpm-20-fast`) through `InpaintingPipeline.inpaint` on phase 3's pipeline
   and inputs, their launches from the sampler's keymask, `ddim-100-deep` with
   the plain attention forced; then `ddim-100-deep` and exact `ddim-100` at
   batch 16, their launches and images gated, printed as one line in
   `bench.py`'s schema;
8. a JSON line of the kernels, then the contract line
   {"ok": true, "device": {...}}.

Both TF32 switches are off, so float32 products and convolutions are full
float32 wherever numbers are compared. Without a CUDA device, or without the
`fidm_tpu_torch` package beside this file, it exits non-zero and prints no
result.
"""
import collections
import dataclasses
import hashlib
import io
import itertools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 / f32
ATOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
# The bf16 kernel against the plain version run in float32 on the same bf16
# inputs: |err| <= 2^-8 |ref| + 3e-3. The kernel rounds only P (unnormalised,
# <= 1) and its output to bf16; on an H100 SXM it stayed within 2-4e-3 of the
# float32 version, the bf16 plain version about 1e-2. The same bound holds it
# in tests/test_torch_port_cuda.py.
BF16_F32_RTOL = 2.0 ** -8
BF16_F32_ATOL = 3e-3
BATCH = 4
# Phase 6's batch-size ladder; phase 2 holds the bf16 kernel against its plain
# version at each of these batch sizes and at BENCH_BATCH, at the shapes the
# UNet gives it.
SERVE_BATCHES = (1, 4, 8)
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
# dpm-25-sde, the server's default (26 model evaluations, 2nd-order steps with
# fresh noise), kernel against plain attention, mean abs in the hole: the same
# per-forward bf16 difference, carried through 26 steps instead of 101; held
# to DDIM-100's bound.
SDE_IMAGE_MEAN_TOL = 5e-2
# Phase 6, a dpm-25-sde request replayed alone (batch 1) against its first
# run inside a batch of 8, mean abs in the hole. Every noise draw is the same
# (per-row seeds), and on an H100 the attention kernel takes the same key
# groups at both sizes; but the convolutions and products of the model are
# other cuDNN and cuBLAS choices at another batch size, and their bf16 sums
# round differently. On an H100 SXM this read 6.5e-3 (max 0.14), the size of
# the kernel-vs-plain gap of phase 4 (4.6e-3). The witness: the same batch
# and row through the float32 model (TF32 off), where rounding is 2^-16 times
# smaller, must fall below BATCH_F32_MEAN_TOL, and the same request at another
# seed, the size of a row-dependent fault, must lie at least FAULT_FACTOR times
# above BATCH_MEAN_TOL. The bf16 bound is three times its reading.
BATCH_MEAN_TOL = 2e-2
BATCH_F32_MEAN_TOL = 1e-3
FAULT_FACTOR = 5
# A replay alone of a request of a 101-step preset (phase 6's `ddim-100-deep`)
# against its first run in a batch of 4, mean abs in the hole: the same bf16
# rounding as BATCH_MEAN_TOL's, carried through 101 steps with eta 0.9. On an
# H100 SXM it read 1.24e-2 and 1.33e-2, and phase 7's kernel-vs-plain gap on
# the same preset 1.25e-2; its own float32 witness (batch_witness, as for
# dpm-25-sde) must fall below BATCH_F32_MEAN_TOL. A request that ran exact
# DDIM-100 in place of the cached path lands 7.2e-2 away (phase 7). The bound
# sits between, 2.3 times the larger reading and 2.4 times below that fault.
LONG_BATCH_MEAN_TOL = 3e-2
# Phase 7. Attention launches of one cached UNet call at full width, by cache
# branch (0: encoder mode; -1: output reuse, which runs no model). The
# FFHQ-256 model attends at 16x downsampling, level 4 of 0-5: one block in the
# encoder, one in the middle, two in the decoder (4 per full forward). An
# encoder-mode call runs the decoder only; branches 1-4 stop above level 4;
# branch 5 runs encoder and decoder level 4.
CACHED_ATTN = {0: 2, 1: 0, 2: 0, 3: 0, 4: 0, 5: 3, -1: 0}
CACHE_MODES = (None, 1, 2, 5)
# The cached presets at batch 4, and their attention launches per call: 4 per
# key step of the sampler's keymask (K steps, key steps: 101, 41; 101, 34;
# 21, 13; 21, 13), 0 per cached step (branch 2 or 1).
CACHED_PRESETS = {"ddim-100-deep": 164, "ddim-100-turbo": 136, "ddim-20-fast": 52,
                  "dpm-20-fast": 52}
# bench.py's headline: ddim-100-deep at batch 16, 3 timed calls after one
# warm-up, against the reference's 3.42 s per sample for DDIM-100.
BENCH_BATCH = 16
BENCH_REPEATS = 3
BASELINE_TIME_PER_SAMPLE = 3.42
# The quantizer at the shapes the FFHQ-256 UNet gives it ([rows, out channels]:
# the 3x3 convs at 512 out and 1024/1536/768 in, qkv, a 3x3 conv at 128 out),
# a ragged one that the kernel takes though the dispatch never sends it, and
# two tall ones whose strips exceed what a cluster of 8 CTAs holds in shared
# memory, so that its CTAs stream part of their rows.
QUANT_SHAPES = ((9216, 512), (4608, 512), (512, 1536), (1152, 128), (100, 200), (16384, 512),
                (32768, 256))
QUANT_SEED = 7
# Phase 5. The FFHQ-256 model at the JAX dispatch rule: 116 kernels quantized,
# 114 of them [N, C] with N % 8 == 0 and C % 128 == 0 (the kernel's launches).
QUANT_TENSORS = 116
QUANT_LAUNCHES = 114
# One UNet forward in bf16, the int8 absmax weights (dequantized) against the
# float32 ones, max abs / max |float32 weights|. Each weight moves by less
# than one step, 1/127 of its channel's absmax; in this random-weight model
# that moved the output by 4.9e-2 of its max on an H100 SXM, where bf16
# activations alone move it by 3-4e-2 (phase 4). The bound is twice that.
QUANT_UNET_TOL = 0.1


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
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


def profiled_calls(torch, fn, n, tries):
    """The device events (kernels and memsets) of `n` calls of `fn` in one
    torch.profiler session after a warm-up, or None after `tries` sessions
    that each lost events.

    Now and then a session comes back with no device event at all (on an
    H100, about once in a few hundred sessions of this script), or with one
    call's kernel missing from it (n calls, n - 1 events). Every call of the
    functions timed here launches the same kernels, so a session whose event
    count is not a multiple of `n` lost some, and is run again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in events)
        if count and count % n == 0:
            return events
        print(f"      a profiler session recorded {count} device operations in {n} "
              f"calls: run again", flush=True)
    return None


def device_ms(torch, fn, n=20, tries=3):
    """Device time of one call of `fn`: its kernels' time summed by
    torch.profiler over `n` calls after a warm-up, host gaps left out. After
    `tries` sessions that lost events (`profiled_calls`) the time is taken
    by CUDA events instead (host cost included), and the line says so."""
    events = profiled_calls(torch, fn, n, tries)
    if events is not None:
        return sum(e.self_device_time_total for e in events) / 1e3 / n
    print(f"      the profiler lost device events in {tries} sessions: "
          f"the next time is by CUDA events", flush=True)
    return cuda_ms(torch, fn)


def attention_bound(b, h, s, d, dtype):
    """(bound_ms, bound_by) for one attention call: q, k, v read once and o
    written once, against the two products' 4*B*H*S*S*D operations."""
    itemsize = 2 if dtype == "torch.bfloat16" else 4
    bytes_ms = 4 * b * h * s * d * itemsize / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * s * s * d / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def ptxas_summary(log, kernel):
    """Registers and spills of each instance of `kernel`, from the
    `-Xptxas=-v` lines of nvcc's output."""
    found, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(rf"({kernel}\w*?)(?:I(\w*?)EEv|E)", name or "")
        if m and ("registers" in ln or "spill" in ln):
            args = ", ".join(re.findall(r"Li(\d+)E", m.group(2) or ""))
            found.setdefault(f"{m.group(1)}<{args}>", []).append(
                re.sub(r"^ptxas info\s*:\s*", "", ln.strip()))
    return [f"{inst}: {'; '.join(lines)}" for inst, lines in sorted(found.items())]


def phase_kernels(torch, F, attention, kernel_override):
    """Phase 2: the attention kernels against their plain version, at batch 4
    and, at the shapes the UNet gives the bf16 kernel, at every batch size of
    the server's ladder and at bench_line's batch. Returns the rows measured
    at the main path's largest shape, by dtype."""
    main_rows, table = {}, []
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    batches = (BATCH,) + tuple(b for b in SERVE_BATCHES + (BENCH_BATCH,) if b != BATCH)
    cases = [(dtype, d, s, b) for dtype in (torch.bfloat16, torch.float32) for d in (64, 32)
             for s in (64, 256, 1024, 4096, 100)
             for b in (batches if (dtype, d) == (torch.bfloat16, 64) and s in (64, 256)
                       else (BATCH,))]
    for dtype, d, s, b in cases:
        q, k, v = (torch.randn(b, 8, s, d, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        out = attention._attention_cuda(q, k, v)
        torch.cuda.synchronize()
        with kernel_override(False, "attention"):
            ref = attention.qkv_attention(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATOL[str(dtype)]
        f32_note, f32_excess = "", 0.0
        if dtype == torch.bfloat16:
            # both against the plain version in float32 on the same inputs
            ref32 = attention._attention_reference(q.float(), k.float(), v.float())
            err32 = (out.float() - ref32).abs()
            f32_excess = (err32 - BF16_F32_RTOL * ref32.abs()).max().item()
            f32_note = (f" | vs plain in f32: kernel {err32.max().item():.3g} "
                        f"(|err| - 2^-8 |ref| {f32_excess:.3g}, tol {BF16_F32_ATOL}), plain "
                        f"{(ref.float() - ref32).abs().max().item():.3g}")
            del ref32, err32
        picked = attention._key_groups(b * 8, s, attention._sm_count(q.get_device()))
        ms = device_ms(torch, lambda: attention._attention_cuda(q, k, v))
        call_ms = cuda_ms(torch, lambda: attention._attention_cuda(q, k, v))
        plain_ms = device_ms(torch, lambda: attention._attention_reference(q, k, v))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound(b, 8, s, d, str(dtype))
        print(f"  attention {str(dtype)[6:]} B={b} H=8 S={s} D={d}: "
              f"max_abs_err={err:.3g} (tol {tol}){f32_note} kernel_ms={ms:.5f} "
              f"(wrapper call {call_ms:.5f}) plain_ms={plain_ms:.5f} "
              f"sdpa_ms={lib_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})"
              + (f" key groups {picked}" if dtype == torch.bfloat16 else ""), flush=True)
        table.append((str(dtype)[6:], b, s, d, ms, bound_ms, bound_by, lib_ms, call_ms))
        check(err <= tol, f"attention kernel disagrees with its plain version "
                          f"at B={b} S={s} D={d} {dtype}: {err} > {tol}")
        check(f32_excess <= BF16_F32_ATOL,
              f"bf16 attention kernel strays from the float32 plain version at "
              f"B={b} S={s} D={d}: |err| - 2^-8 |ref| = {f32_excess} > {BF16_F32_ATOL}")
        if (b, s, d) == (BATCH, 256, 64):
            main_rows[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        if dtype == torch.bfloat16 and d == 64 and s in (64, 256, 1024) and b == BATCH:
            # every key-group count of the bf16 kernel
            groups = {kg: device_ms(torch, lambda: attention._attention_cuda(q, k, v, kg))
                      for kg in attention.KEY_GROUPS}
            print(f"      key groups at S={s}, the wrapper picks {picked}: " +
                  ", ".join(f"{kg}: {t:.5f} ms" for kg, t in groups.items()), flush=True)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    print("[2] attention summary: dtype B S D | kernel_ms | bound_ms | bound/kernel | "
          "sdpa_ms | kernel/sdpa | wrapper call ms", flush=True)
    for dt, b, s, d, ms, bound_ms, bound_by, lib_ms, call_ms in table:
        print(f"      {dt:8s} {b} {s:5d} {d:3d} | {ms:.5f} | {bound_ms:.6f} ({bound_by}) | "
              f"{bound_ms / ms:.3f} | {lib_ms:.5f} | {ms / lib_ms:.2f} | {call_ms:.5f}",
              flush=True)
    return main_rows


def quantize_bound(n, c):
    """(bound_ms, bound_by) for one [n, c] quantize call: x read once, the
    int8 values and float32 scales written once. Its operations (a Philox
    call per four elements, a division per element) are below the card's
    rate."""
    return (5 * n * c + 4 * c) / PEAK_BYTES_PER_S * 1e3, "bytes"


def device_kernels(torch, fn, n=10, tries=10):
    """Device operations (kernels and memsets) per call of `fn` and their
    names, by torch.profiler, from a session that lost no event
    (`profiled_calls`); after `tries` sessions that lost some it fails."""
    events = profiled_calls(torch, fn, n, tries)
    if events is None:
        fail(f"the profiler lost device operations in {tries} sessions")
    return sum(e.count for e in events) / n, sorted(e.key[:60] for e in events)


def quantize_shapes(torch, quantize_ops):
    """For each of QUANT_SHAPES, the quantize kernel of `quantize_ops` (this
    checkout's, or another's for an A/B: see the verify skill) held bit for
    bit against its plain version, and its device time cold (each call on
    another copy of x, the copies together more than twice the L2 cache, as
    the CLI finds every weight cold) and warm (the same x again). Yields (n,
    c, x, max_abs_err, cold_ms, warm_ms)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    for n, c in QUANT_SHAPES:
        x = 0.05 * torch.randn(n, c, device="cuda", generator=g)
        x[0, 0] = 0.0
        values, scales = quantize_ops._quantize_cuda(x, QUANT_SEED)
        torch.cuda.synchronize()
        ref_values, ref_scales = quantize_ops._quantize_stochastic_reference(x, QUANT_SEED)
        err = max((values.int() - ref_values.int()).abs().max().item(),
                  (scales - ref_scales).abs().max().item())
        check(err == 0 and torch.equal(values, ref_values) and torch.equal(scales, ref_scales),
              f"quantize kernel disagrees with its plain version at [{n}, {c}]: "
              f"{int((values != ref_values).sum().item())} values differ")
        del values, scales, ref_values, ref_scales
        copies = [x] + [x.clone() for _ in range(max(1, -(-2 * l2 // (4 * n * c))))]
        cycle = itertools.cycle(copies)
        cold_ms = device_ms(torch, lambda: quantize_ops._quantize_cuda(next(cycle), QUANT_SEED))
        del copies, cycle
        warm_ms = device_ms(torch, lambda: quantize_ops._quantize_cuda(x, QUANT_SEED))
        print(f"  quantize f32 [{n}, {c}]: max_abs_err={err:.3g} (tol 0) cold_ms={cold_ms:.5f} "
              f"warm_ms={warm_ms:.5f}", flush=True)
        yield n, c, x, err, cold_ms, warm_ms
        del x
    torch.cuda.empty_cache()


def phase_quantize_kernel(torch, quantize_ops, quant_int8, kernel_override):
    """Phase 2: the quantize kernel against its plain version (bit for bit,
    cold and warm: `quantize_shapes`), beside the plain version's time and
    its bound, the device operations of one call (gated at 1) and its
    launch geometry. Returns the row measured at the largest shape."""
    main_row, table = None, []
    device = torch.cuda.current_device()
    smem, static_smem, fits = quantize_ops._card(device)
    print(f"      the card: {smem} bytes of shared memory a block, the kernel's static "
          f"{static_smem}; clusters of 1..{len(fits)} CTAs held at once: {fits}", flush=True)
    for n, c, x, err, cold_ms, ms in quantize_shapes(torch, quantize_ops):
        call_ms = cuda_ms(torch, lambda: quantize_ops._quantize_cuda(x, QUANT_SEED))
        ops, names = device_kernels(torch, lambda: quantize_ops._quantize_cuda(x, QUANT_SEED))
        plain_ms = device_ms(
            torch, lambda: quantize_ops._quantize_stochastic_reference(x, QUANT_SEED))
        with kernel_override(False, "quantize"):
            nearest_ms = device_ms(torch, lambda: quant_int8.quantize_tensor(x))
        bound_ms, bound_by = quantize_bound(n, c)
        geo = quantize_ops._geometry(n, c, device)
        fit = quantize_ops.max_active_clusters(geo.cluster, device)
        print(f"      wrapper call {call_ms:.5f} ms, plain_ms={plain_ms:.5f} "
              f"nearest_torch_ms={nearest_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}) "
              f"bound/cold={bound_ms / cold_ms:.3f}; device operations per call: {ops} "
              f"{names}", flush=True)
        print(f"      geometry: {geo.strips} strips of {geo.strip} columns, clusters of "
              f"{geo.cluster} CTAs, {geo.ctas} CTAs, {geo.rows_per_cta} rows per CTA, "
              f"{geo.hold_rows} held in {geo.smem_bytes} bytes of shared memory; the card "
              f"holds {fit} such clusters at once "
              f"({'one wave' if geo.strips <= fit else 'waves'})", flush=True)
        check(fit >= 1, f"no cluster of {geo.cluster} CTAs fits the card")
        check(ops == 1, f"one quantize call ran {ops} device operations, not 1: {names}")
        table.append((n, c, cold_ms, ms, bound_ms, ops))
        if (n, c) == QUANT_SHAPES[0]:
            main_row = dict(max_abs_err=err, ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
    print("[2] quantize summary: shape | cold_ms | warm_ms | bound_ms | bound/cold | "
          "device operations per call", flush=True)
    for n, c, cold_ms, ms, bound_ms, ops in table:
        print(f"      [{n}, {c}] | {cold_ms:.5f} | {ms:.5f} | {bound_ms:.6f} | "
              f"{bound_ms / cold_ms:.3f} | {ops}", flush=True)
    return main_row


def write_packed_dir(np, directory, n, size, seed):
    """A packed shard directory (`fidm_tpu_torch.data.shards` format) of n
    random uint8 images, written with numpy alone."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.save(directory / "shard_00000.npy",
            rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))
    index = {"img_size": size, "num_images": n,
             "shards": [{"file": "shard_00000.npy", "count": n}],
             "paths": [f"synthetic_{i:03d}.png" for i in range(n)]}
    (directory / "index.json").write_text(json.dumps(index))


def cli_stages(torch, np, ckpt, cfg, out):
    """Where the quantize CLI's wall time goes: its stages, run one by one as
    `fidm_tpu_torch.cli.quantize.main` runs them, host clock around each
    (ending in a synchronize), and the device time of the quantize stage
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from fidm_tpu_torch.models.weights import jax_tree_from_state_dict, load_adm_checkpoint
    from fidm_tpu_torch.quant import flatten_quantized, quantize_params

    times = {}
    t0 = time.perf_counter()
    sd = load_adm_checkpoint(str(ckpt), cfg)
    times["load .pt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = jax_tree_from_state_dict({k: v.to("cuda") for k, v in sd.items()}, cfg)
    torch.cuda.synchronize()
    times["to device, JAX layout"] = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qp = quantize_params(params)
        torch.cuda.synchronize()
        times["quantize"] = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    kernels = sum(e.count for e in events if "quantize_kernel" in e.key)
    t0 = time.perf_counter()
    flat = flatten_quantized(qp)
    times["to host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.savez_compressed(out, **flat)
    times["savez_compressed"] = time.perf_counter() - t0
    busy = (f"{busy:.4f} ms in {sum(e.count for e in events)} device operations, "
            f"{kernels} of them the quantize kernel" if busy > 0
            else "not measured (the profiler recorded none)")
    print("[5] quantize CLI stages, s: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; the quantize stage's device time {busy}", flush=True)


def check_cli_rounding(torch, np, ckpt, cfg, npz, quantize_ops, quant_int8, device="cuda"):
    """The kernel-rounded tensors of the absmax CLI's `.npz`, each against
    the plain version at the seed `quantize_params` gave it (seed 0 + its
    place among the quantized tensors, in tree order). Returns (tensors
    compared, names of those that differ)."""
    from fidm_tpu_torch.models.weights import jax_tree_from_state_dict, load_adm_checkpoint

    sd = load_adm_checkpoint(str(ckpt), cfg)
    params = jax_tree_from_state_dict({k: v.to(device) for k, v in sd.items()}, cfg)
    seed, compared, differ = 0, 0, []
    with np.load(npz) as data:
        def walk(tree, path):
            nonlocal seed, compared
            for k, v in tree.items():
                p = path + (k,)
                if isinstance(v, dict):
                    walk(v, p)
                elif quant_int8._is_quantizable(p, v, 4096):
                    seed += 1
                    x2d = v.reshape(-1, v.shape[-1]).float().contiguous()
                    if x2d.shape[0] % 8 or x2d.shape[1] % 128:
                        continue  # rounded to nearest, as the dispatch rule says
                    ref_q, ref_s = quantize_ops._quantize_stochastic_reference(x2d, seed)
                    name = "/".join(p)
                    compared += 1
                    if not (np.array_equal(data[name + ".__q__"].reshape(x2d.shape),
                                           ref_q.cpu().numpy())
                            and np.array_equal(data[name + ".__scale__"],
                                               ref_s[0].cpu().numpy())):
                        differ.append(name)

        walk(params, ())
    return compared, differ


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


def check_images(torch, label, out, gt, keep):
    """The output contract of one inpaint call: gt's shape in float32,
    finite, in [-1, 1], known pixels bit-equal to gt, the hole filled."""
    check(tuple(out.shape) == tuple(gt.shape) and out.dtype == torch.float32,
          f"{label}: output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    check(torch.equal(out[keep], gt[keep]), f"{label}: known pixels differ from gt")
    check(out.abs().max().item() <= 1.0, f"{label}: output outside [-1, 1]")
    hole_change = (out[~keep] - gt[~keep]).abs().mean().item()
    check(hole_change > 1e-3, f"{label}: the hole was not filled")
    print(f"{label}: output finite, in [-1, 1], known pixels bit-equal to gt, "
          f"hole mean |out-gt| {hole_change:.4f}; sha1 of the output "
          f"{output_digest(out)}", flush=True)


def output_digest(out):
    """A short sha1 of a tensor's bytes: two runs that print the same digest
    gave the same output bit for bit."""
    return hashlib.sha1(out.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main_inputs(torch, image_size):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    shape = (BATCH, image_size, image_size, 3)
    gt = torch.clamp(0.5 * torch.randn(shape, device="cuda", generator=g), -1.0, 1.0)
    mask = torch.zeros(shape[:-1] + (1,), device="cuda")
    lo, hi = image_size // 4, 3 * image_size // 4
    mask[:, lo:hi, lo:hi] = 1.0
    return gt, mask


def preset_steps(sched, cfg):
    """(steps, key steps) of one inpaint call of `cfg`, from the sampler's own
    tables and host keymask; without caching every step is a key step."""
    from fidm_tpu_torch.sampling.sampler import _cache_keymask, _ddim_tables, _dpm_tables

    K = len((_ddim_tables if cfg.method == "ddim" else _dpm_tables)(sched, cfg)["t"])
    return K, int(_cache_keymask(cfg, K).sum()) if cfg.encoder_cache_period > 1 else K


def attention_per_call(sched, cfg, n_attn):
    """Attention launches of one inpaint call of `cfg`: n_attn per full
    forward, CACHED_ATTN[branch] per cached step."""
    K, n_key = preset_steps(sched, cfg)
    return n_attn * n_key + CACHED_ATTN[cfg.cache_branch] * (K - n_key)


SERVE_ARGV = ["--presets", "dpm-25-sde", "ddim-100", "ddim-100-deep", "--refine_tier", "0.3",
              "--batch_size", str(max(SERVE_BATCHES)), "--batch_sizes",
              *map(str, SERVE_BATCHES), "--port", "0"]
# Phase 6's traffic: 27 requests, (client thread, preset, explicit seed or
# None for a server-assigned one), each thread sending its own in order.
# Thread 0's first request (ddim-100, 101 steps) runs alone; the first
# requests of threads 1-7 (all dpm-25-sde) queue while it runs and form one
# batch of 7, padded to 8. The last three are ddim-100-deep (feature caching).
TRAFFIC = [(0, "ddim-100", 1000), (0, "refine", 1001), (0, "dpm-25-sde", 1002),
           (1, "dpm-25-sde", 1010), (1, "dpm-25-sde", 1011), (1, "refine", 1012),
           (2, "dpm-25-sde", 1020), (2, "refine", None), (2, "dpm-25-sde", 1022),
           (3, "dpm-25-sde", 1030), (3, "ddim-100", 1031), (3, "dpm-25-sde", None),
           (4, "dpm-25-sde", 1040), (4, "dpm-25-sde", 1041), (4, "ddim-100", 1042),
           (5, "dpm-25-sde", 1050), (5, "refine", 1051), (5, "dpm-25-sde", 1052),
           (6, "dpm-25-sde", None), (6, "dpm-25-sde", 1061), (6, "refine", 1062),
           (7, "dpm-25-sde", None), (7, "dpm-25-sde", None), (7, "dpm-25-sde", 1072),
           (1, "ddim-100-deep", 1013), (4, "ddim-100-deep", 1043), (7, "ddim-100-deep", None)]
CLIENTS = 8


def request_inputs(np, j, size):
    """Request j's image (numpy noise in [-1, 1]) and mask: a box of half the
    side (128x128 at 256^2) at a random place for even j, brush strokes (a
    random walk of disks) for odd j."""
    rng = np.random.default_rng(100 + j)
    image = np.clip(0.5 * rng.standard_normal((size, size, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((size, size, 1), np.float32)
    if j % 2 == 0:
        side = size // 2
        y, x = rng.integers(0, size - side, 2)
        mask[y:y + side, x:x + side] = 1.0
        return image, mask
    yy, xx = np.mgrid[:size, :size]
    for _ in range(4):
        y, x = rng.uniform(size / 8, size - size / 8, 2)
        for _ in range(12):
            r = rng.uniform(6, 14)
            mask[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 1.0
            a = rng.uniform(0, 2 * np.pi)
            y = np.clip(y + 12 * np.sin(a), 0, size - 1)
            x = np.clip(x + 12 * np.cos(a), 0, size - 1)
    return image, mask


def http_inpaint(np, port, timeout=300, **arrays):
    """POST one npz request; (status, reply arrays or error text, seconds)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/inpaint", data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            reply = dict(np.load(io.BytesIO(r.read())))
            return r.status, reply, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace"), time.perf_counter() - t0


def serve_in_thread(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return thread


def stop_server(httpd, dispatcher, thread):
    httpd.shutdown()
    httpd.server_close()
    dispatcher.close(drain_s=30.0)
    thread.join(timeout=30)
    check(not thread.is_alive() and not dispatcher._thread.is_alive(),
          "a server thread did not stop")


def phases_line(snap, before=None):
    """The server's phase times, ms per batch, of the batches in `snap` (a
    stats snapshot) that are not in `before`."""
    old = (before or {}).get("phases_ms", {})
    parts = []
    for k, v in snap.get("phases_ms", {}).items():
        n = v["n"] - old.get(k, {}).get("n", 0)
        ms = v["ms"] - old.get(k, {}).get("ms", 0.0)
        parts.append(f"{k} {ms / max(n, 1):.3f} ms x{n}")
    return ", ".join(parts)


def batch_witness(torch, np, pipe, label, cfg, inputs, rows, seeds, k, first, alone, tol):
    """Why a request differs between its batch and its replay alone: request
    `rows[k]`'s batch (`rows` and `seeds` as the server ran it, pad rows
    included; `first` the server's answer, or None for a batch the server
    did not run; `alone` its replay at batch 1) through phase 3's pipeline,
    then through the same weights in float32, and the request alone at
    another seed. Gates the bf16 reading at `tol`, the float32 one at
    BATCH_F32_MEAN_TOL, and the other seed's gap at FAULT_FACTOR times `tol`
    or more."""
    from fidm_tpu_torch import InpaintingPipeline
    from fidm_tpu_torch.models import InpaintingUNet

    gt = np.stack([inputs[j][0] for j in rows])
    mask = np.stack([inputs[j][1] for j in rows])
    hole = mask[k, ..., 0] > 0.5
    t0 = time.perf_counter()
    batch16 = pipe.inpaint(gt, mask, seeds, sampler=cfg).cpu().numpy()[k]
    check(first is None or np.array_equal(batch16, first),
          f"the server's batch of {len(rows)} differs from the pipeline's on the same rows")
    model32 = InpaintingUNet(dataclasses.replace(pipe.config.unet, dtype=torch.float32))
    model32.load_state_dict(pipe.model.state_dict())
    pipe32 = InpaintingPipeline(model32.to(pipe.device).eval().requires_grad_(False),
                                pipe.sched, pipe.config)
    batch32 = pipe32.inpaint(gt, mask, seeds, sampler=cfg).cpu().numpy()[k]
    alone32 = pipe32.inpaint(gt[k:k + 1], mask[k:k + 1], seeds[k:k + 1],
                             sampler=cfg).cpu().numpy()[0]
    other = pipe.inpaint(gt[k:k + 1], mask[k:k + 1], [seeds[k] + 1],
                         sampler=cfg).cpu().numpy()[0]
    del pipe32, model32
    torch.cuda.empty_cache()
    d16, d32 = np.abs(alone - batch16)[hole], np.abs(alone32 - batch32)[hole]
    d_other = np.abs(other - alone)[hole]
    n = len(rows)
    print(f"[6] batch of {n} vs alone, {label}, row {k} of the batch (seed {seeds[k]}), hole mean "
          f"abs (max): bf16 {d16.mean():.6g} ({d16.max():.6g}), tol {tol}; float32 model "
          f"{d32.mean():.6g} ({d32.max():.6g}), tol {BATCH_F32_MEAN_TOL}; bf16 alone at seed "
          f"{seeds[k] + 1} {d_other.mean():.6g} ({d_other.max():.6g}), at least "
          f"{FAULT_FACTOR * tol}; the server's batch equals the pipeline's: "
          f"{'True' if first is not None else 'not run by the server'}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(d16.mean() <= tol, f"{label} bf16 batch of {n} vs alone: hole mean abs "
                             f"{d16.mean()} > {tol}")
    check(d32.mean() <= BATCH_F32_MEAN_TOL,
          f"{label} float32 batch of {n} vs alone: hole mean abs {d32.mean()} > "
          f"{BATCH_F32_MEAN_TOL}")
    check(d_other.mean() >= FAULT_FACTOR * tol,
          f"{label}: another seed moves the image by {d_other.mean()} only: the bound "
          f"{tol} cannot tell a fault")


def phase_serving(torch, np, ckpt, pipe, n_attn, smi):
    """Phase 6: the serving path at full width, through `cli.serve`'s flags,
    presets and `build_pipeline`, and `serving.serve`, over HTTP."""
    from fidm_tpu_torch.cli import serve as serve_cli
    from fidm_tpu_torch.ops import LAUNCHES
    from fidm_tpu_torch.sampling.sampler import GeneratorNoise, _dpm_tables
    from fidm_tpu_torch.serving import InpaintingServer, serve

    args = serve_cli.parse_args(["--checkpoint", str(ckpt)] + SERVE_ARGV)
    presets = serve_cli.build_presets(args)
    spipe = serve_cli.build_pipeline(args, presets)
    size = spipe.config.unet.image_size
    steps = {name: preset_steps(spipe.sched, cfg) for name, cfg in presets.items()}
    print(f"[6] cli.serve {' '.join(SERVE_ARGV)}: presets {list(presets)}, (steps, key "
          f"steps) per call {steps}, device {spipe.device}", flush=True)

    # every pipeline run of the server: (preset, batch size, seeds)
    runs = []
    name_of = {cfg: name for name, cfg in presets.items()}
    inpaint = spipe.inpaint

    def counted(gt, mask, seed, sampler=None, **kw):
        runs.append((name_of[sampler], len(gt), tuple(seed)))
        return inpaint(gt, mask, seed, sampler=sampler, **kw)

    spipe.inpaint = counted
    t0 = time.perf_counter()
    httpd, dispatcher = serve(
        spipe, args.host, args.port, args.batch_size, args.max_wait_ms,
        batch_sizes=tuple(args.batch_sizes), base_seed=args.base_seed, warmup=True,
        compress_responses=args.compress_responses, adaptive_wait=not args.no_adaptive_wait,
        presets=presets, max_queue=args.max_queue,
        default_deadline_s=args.default_deadline_s)
    warm_s = time.perf_counter() - t0
    print(f"[6] warm-up: {len(runs)} runs (every preset at batch sizes "
          f"{dispatcher.batch_sizes}) in {warm_s:.2f} s", flush=True)
    check(sorted((p, b) for p, b, _ in runs)
          == sorted((p, b) for p in presets for b in dispatcher.batch_sizes),
          f"warm-up ran {[(p, b) for p, b, _ in runs]}")
    port = httpd.server_address[1]
    thread = serve_in_thread(httpd)
    inputs = [request_inputs(np, j, size) for j in range(len(TRAFFIC))]
    try:
        # --- traffic: 24 requests from 8 client threads over HTTP
        runs.clear()
        LAUNCHES.clear()
        replies, errors = {}, []

        def client(tid):
            for j, (t, preset, seed) in enumerate(TRAFFIC):
                if t != tid:
                    continue
                image, mask = inputs[j]
                extra = {} if seed is None else {"seed": seed}
                try:
                    replies[j] = http_inpaint(np, port, image=image, mask=mask,
                                              preset=preset, **extra)
                except Exception as e:  # gated below: any failure fails the phase
                    errors.append(f"request {j}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(tid,)) for tid in range(CLIENTS)]
        threads[0].start()
        while not runs and time.perf_counter() - t0 < 60:  # thread 0's first run started
            time.sleep(0.005)
        for th in threads[1:]:
            th.start()
        for th in threads:
            th.join(timeout=600)
        traffic_s = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "a client thread hung")
        check(not errors, f"client errors: {errors}")
        launches = dict(sorted(LAUNCHES.items()))
        snap = dispatcher.stats_snapshot()
        traffic_runs = list(runs)

        # every response
        ran_at = {}
        for name, b, seeds in traffic_runs:
            for sd in seeds:
                ran_at[(name, sd)] = b
        latencies = []
        for j, (_, preset, seed) in enumerate(TRAFFIC):
            status, reply, secs = replies.get(j, (None, "no reply", 0.0))
            check(status == 200, f"request {j}: HTTP {status} {reply}")
            image, mask = inputs[j]
            out, got_seed = reply["image"], int(reply["seed"])
            keep = mask[..., 0] < 0.5
            check(out.shape == (size, size, 3) and out.dtype == np.float32,
                  f"request {j}: image {out.shape} {out.dtype}")
            check(seed is None or got_seed == seed, f"request {j}: seed {got_seed} != {seed}")
            check(np.array_equal(out[keep], image[keep]),
                  f"request {j}: known pixels differ from the request's image")
            check(bool(np.isfinite(out).all()) and np.abs(out).max() <= 1.0,
                  f"request {j}: output not finite or outside [-1, 1]")
            check((preset, got_seed) in ran_at, f"request {j}: no run of ({preset}, {got_seed})")
            latencies.append(secs)
        lat = np.array(latencies)
        print(f"[6] traffic: {len(TRAFFIC)} requests from {CLIENTS} client threads in "
              f"{traffic_s:.3f} s, {len(TRAFFIC) / traffic_s:.4f} images/s; latency p50 "
              f"{np.percentile(lat, 50):.4f} s, p99 {np.percentile(lat, 99):.4f} s, max "
              f"{lat.max():.4f} s; {smi}", flush=True)
        print(f"[6] stats: batches {snap['batches']}, batches_by_size "
              f"{snap['batches_by_size']}, requests_by_preset {snap['requests_by_preset']}; "
              f"runs (preset, batch size) {[(p, b) for p, b, _ in traffic_runs]}; "
              f"unfenced phases: {phases_line(snap)}; {smi}", flush=True)
        check(snap["requests"] == len(TRAFFIC) and snap["batches"] == len(traffic_runs),
              f"stats {snap} against {len(traffic_runs)} runs")
        by_size = collections.Counter(b for _, b, _ in traffic_runs)
        check(all(snap["batches_by_size"][b] == by_size[b] for b in dispatcher.batch_sizes),
              "batches_by_size disagrees with the runs")
        check(snap["requests_by_preset"] == dict(collections.Counter(p for _, p, _ in TRAFFIC)),
              f"requests_by_preset {snap['requests_by_preset']}")
        expect = sum(attention_per_call(spipe.sched, presets[p], n_attn)
                     for p, _, _ in traffic_runs)
        print(f"[6] attention launches during the traffic {launches}; expected "
              f"{n_attn} x key steps of each batch's preset = {expect}", flush=True)
        check(launches.get("attention") == launches.get("attention.bf16") == expect,
              f"serving: attention launches {launches} != {expect}")

        # --- determinism: three requests replayed alone
        size_of = {j: ran_at[(p, int(replies[j][1]["seed"]))] for j, (_, p, _) in
                   enumerate(TRAFFIC)}
        alone = next((j for j in size_of if size_of[j] == 1), None)
        in8 = next((j for j in size_of if size_of[j] == 8 and TRAFFIC[j][1] == "dpm-25-sde"),
                   None)
        refine = next(j for j in size_of if TRAFFIC[j][1] == "refine")
        deep = [j for j in size_of if TRAFFIC[j][1] == "ddim-100-deep"]
        check(alone is not None and in8 is not None,
              f"the traffic formed no batch of 1 or no dpm-25-sde batch of 8: {size_of}")
        replayed = {}
        for j in dict.fromkeys((alone, in8, refine, *deep)):
            preset, seed = TRAFFIC[j][1], int(replies[j][1]["seed"])
            image, mask = inputs[j]
            runs.clear()
            status, reply, secs = http_inpaint(np, port, image=image, mask=mask, seed=seed,
                                               preset=preset)
            check(status == 200 and [b for _, b, _ in runs] == [1],
                  f"replay of request {j}: HTTP {status}, runs {runs}")
            first, again = replies[j][1]["image"], reply["image"]
            hole = mask[..., 0] > 0.5
            diff = np.abs(again - first)[hole]
            ref = pipe.inpaint(image[None], mask[None], [seed],
                               sampler=presets[preset]).cpu().numpy()[0]
            same_pipe = np.array_equal(again, ref)
            print(f"[6] replay alone of request {j} ({preset}, seed {seed}, first run at "
                  f"batch {size_of[j]}): bit-equal {np.array_equal(again, first)}, hole "
                  f"max abs diff {diff.max():.6g}, mean {diff.mean():.6g}; bit-equal to "
                  f"phase 3's pipeline at batch 1: {same_pipe}; {secs:.4f} s", flush=True)
            check(same_pipe, f"replay of request {j} differs from phase 3's pipeline")
            if size_of[j] == 1:
                check(np.array_equal(again, first),
                      f"request {j}: a replay at the same batch size differs")
            else:
                tol = LONG_BATCH_MEAN_TOL if steps[preset][0] > 100 else BATCH_MEAN_TOL
                check(diff.mean() <= tol,
                      f"request {j}: replay alone vs batch {size_of[j]}: hole mean abs "
                      f"{diff.mean()} > {tol}")
            replayed[j] = again
        in8_seeds = next(sd for p, b, sd in traffic_runs if p == "dpm-25-sde" and b == 8
                         and int(replies[in8][1]["seed"]) in sd)
    finally:
        spipe.inpaint = inpaint
        stop_server(httpd, dispatcher, thread)

    # --- the witness for the cross-batch bound: request in8's batch of 8 again
    j_of = {(p, int(replies[j][1]["seed"])): j for j, (_, p, _) in enumerate(TRAFFIC)}
    rows = [j_of[("dpm-25-sde", sd)] for sd in in8_seeds]
    batch_witness(torch, np, pipe, "dpm-25-sde", presets["dpm-25-sde"], inputs, rows,
                  list(in8_seeds), rows.index(in8), replies[in8][1]["image"], replayed[in8],
                  BATCH_MEAN_TOL)
    # and for ddim-100-deep (101 steps, cached): the first of its batches of more
    # than one, or, where every one of its requests ran alone, the batch of 4 the
    # server forms from the three (padded with the last)
    deep_runs = [sd for p, b, sd in traffic_runs if p == "ddim-100-deep" and b > 1]
    if deep_runs:
        rows = [j_of[("ddim-100-deep", sd)] for sd in deep_runs[0]]
        first = replies[rows[0]][1]["image"]
    else:
        rows, first = deep + [deep[-1]] * (BATCH - len(deep)), None
    batch_witness(torch, np, pipe, "ddim-100-deep", presets["ddim-100-deep"], inputs, rows,
                  [int(replies[j][1]["seed"]) for j in rows], 0, first, replayed[rows[0]],
                  LONG_BATCH_MEAN_TOL)

    # --- a uint8 round trip: cli.serve --output_dtype uint8 on a second server
    args8 = serve_cli.parse_args(["--preset", "dpm-25-sde", "--output_dtype", "uint8",
                                  "--batch_size", "1", "--port", "0"])
    httpd, dispatcher = serve(spipe, args8.host, args8.port, args8.batch_size,
                              presets=serve_cli.build_presets(args8))
    thread = serve_in_thread(httpd)
    try:
        image, mask = inputs[in8]
        seed = int(replies[in8][1]["seed"])
        status, reply, secs = http_inpaint(np, httpd.server_address[1], image=image,
                                           mask=mask, seed=seed)
    finally:
        stop_server(httpd, dispatcher, thread)
    check(status == 200, f"uint8 server: HTTP {status} {reply}")
    q = reply["image"]
    expect = torch.clamp((torch.from_numpy(replayed[in8]) + 1.0) * 127.5, 0, 255).to(
        torch.uint8).numpy()
    print(f"[6] uint8 round trip (request {in8} alone): {q.dtype} {q.shape}, equal to "
          f"the float32 replay's toU8: {np.array_equal(q, expect)}; {secs:.4f} s", flush=True)
    check(q.dtype == np.uint8 and q.shape == (size, size, 3) and np.array_equal(q, expect),
          "uint8 response")

    # --- one instrumented pass: each phase fenced by torch.cuda.synchronize()
    server = InpaintingServer(spipe, batch_size=max(SERVE_BATCHES), batch_sizes=SERVE_BATCHES,
                              presets=presets, instrument=True, adaptive_wait=False,
                              max_wait_ms=500)
    try:
        futs = [server.submit(*inputs[j], seed=2000 + j) for j in range(8)]
        outs = [f.result(timeout=300) for f in futs]
        snap8 = server.stats_snapshot()
        server.submit(*inputs[0], seed=2100).result(timeout=300)
        snap = server.stats_snapshot()
    finally:
        server.close()
    check(all(np.isfinite(o).all() for o in outs), "instrumented pass: non-finite output")
    print(f"[6] instrumented pass, dpm-25-sde: batch of 8 ({snap8['batches_by_size']}): "
          f"{phases_line(snap8)}; then a batch of 1: {phases_line(snap, snap8)}; {smi}",
          flush=True)

    # --- the host cost of per-row seeds
    shape = (8, size, size, 3)
    sde_tables = _dpm_tables(spipe.sched, presets["dpm-25-sde"])
    draws = (1 + int((sde_tables["sde_noise"] > 0).sum())
             + int((sde_tables["inject_gate"] > 0).sum()))
    cost = {}
    for label, seed in (("8 seeds", list(range(8))), ("one seed", 0)):
        noise = GeneratorNoise(seed, spipe.device)
        noise.step(0, shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(20):
            noise.step(i, shape)
        cost[label] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    print(f"[6] noise draws at [8, {size}, {size}, 3], host ms per draw: "
          + ", ".join(f"{k} {v:.4f}" for k, v in cost.items())
          + f"; {draws} draws per dpm-25-sde call: {draws * cost['8 seeds']:.3f} ms of host "
          f"time per batch-8 call with per-row seeds; {smi}", flush=True)
    del spipe
    torch.cuda.empty_cache()


def cached_forwards(torch, model, n_attn, args):
    """Phase 7: for each of CACHE_MODES, a key forward (`return_cache=True`)
    and a cached forward at the same inputs, each held bit for bit against
    the plain forward, with their attention launches; then the host enqueue
    and device time of a key forward and of cached forwards."""
    from fidm_tpu_torch.ops import LAUNCHES

    plain = model(*args)
    for depth in CACHE_MODES:
        LAUNCHES.clear()
        key, cache = model(*args, return_cache=True, cache_depth=depth)
        key_launches = dict(LAUNCHES)
        LAUNCHES.clear()
        cached = model(*args, cache=cache, cache_depth=depth)
        cached_launches = dict(LAUNCHES)
        tensors = [cache[0], *cache[1]] if depth is None else [cache]
        mode = "encoder mode" if depth is None else f"branch {depth}"
        print(f"[7] {mode}: key forward bit-equal to the plain forward "
              f"{torch.equal(key, plain)}, cached forward at the same (x, t) "
              f"{torch.equal(cached, plain)}; attention launches key {key_launches}, cached "
              f"{cached_launches} (expected {n_attn} and {CACHED_ATTN[depth or 0]}); the cache: "
              f"{len(tensors)} tensors, {sum(a.numel() * a.element_size() for a in tensors)} "
              f"bytes, {tensors[0].dtype}", flush=True)
        check(torch.equal(key, plain), f"{mode}: the key forward differs from the plain one")
        check(torch.equal(cached, plain),
              f"{mode}: the cached forward at the key inputs differs from the plain one")
        check(key_launches.get("attention.bf16") == key_launches.get("attention") == n_attn,
              f"{mode}: key forward launched {key_launches}, not {n_attn} bf16 kernels")
        check(cached_launches.get("attention.bf16", 0) == cached_launches.get("attention", 0)
              == CACHED_ATTN[depth or 0],
              f"{mode}: cached forward launched {cached_launches}, not "
              f"{CACHED_ATTN[depth or 0]} bf16 kernels")
        del key, cache, cached, tensors
    profile_forward(torch, "[7] key forward, branch 2 (return_cache=True)",
                    lambda: model(*args, return_cache=True, cache_depth=2))
    for depth in (2, 1):
        _, cache = model(*args, return_cache=True, cache_depth=depth)
        profile_forward(torch, f"[7] cached forward, branch {depth}",
                        lambda: model(*args, cache=cache, cache_depth=depth))
    del cache
    torch.cuda.empty_cache()


def cached_presets(torch, pipe, n_attn, gt, mask, keep, exact, smi):
    """Phase 7: the cached presets through `InpaintingPipeline.inpaint` on
    phase 3's pipeline and inputs, seed 0; `ddim-100-deep` again with the
    plain attention forced."""
    from fidm_tpu_torch import SAMPLER_PRESETS
    from fidm_tpu_torch.ops import LAUNCHES, kernel_override

    outs = {}
    for name, table in CACHED_PRESETS.items():
        cfg = SAMPLER_PRESETS[name]
        K, n_key = preset_steps(pipe.sched, cfg)
        expect = attention_per_call(pipe.sched, cfg, n_attn)
        LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = pipe.inpaint(gt, mask, 0, sampler=cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(sorted(LAUNCHES.items()))
        print(f"[7] {name} inpaint B={BATCH}: {secs:.4f} s per call, {secs / BATCH:.4f} s per "
              f"sample, {secs / K * 1e3:.3f} ms per step ({K} steps, {n_key} key steps, "
              f"branch {cfg.cache_branch}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}, "
              f"expected {expect} from the keymask; {smi}", flush=True)
        check(expect == table, f"{name}: the keymask gives {expect} launches, not {table}")
        check(launches.get("attention") == launches.get("attention.bf16") == expect,
              f"{name}: attention launches {launches} != {expect} of the bf16 kernel")
        check_images(torch, f"[7] {name}", outs[name], gt, keep)

    deep = outs["ddim-100-deep"]
    before = LAUNCHES["attention"]
    t0 = time.perf_counter()
    with kernel_override(False, "attention"):
        deep_plain = pipe.inpaint(gt, mask, 0, sampler=SAMPLER_PRESETS["ddim-100-deep"])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(LAUNCHES["attention"] == before, "the plain path launched the kernel")
    hole = (deep - deep_plain).abs()[~keep]
    vs_exact = (deep - exact).abs()[~keep]
    print(f"[7] ddim-100-deep, plain-attention path: {plain_s:.4f} s per call; images kernel "
          f"vs plain in the hole: mean abs {hole.mean().item():.4g} (tol {IMAGE_MEAN_TOL}), "
          f"max {hole.max().item():.4g}. Against phase 3's exact DDIM-100 at the same seed "
          f"(not gated: random weights make it no quality measure): hole mean abs "
          f"{vs_exact.mean().item():.4g}, max {vs_exact.max().item():.4g}", flush=True)
    check(torch.equal(deep_plain[keep], gt[keep]), "ddim-100-deep plain path: known pixels differ")
    check(hole.mean().item() <= IMAGE_MEAN_TOL, "ddim-100-deep: kernel and plain paths disagree")


def bench_line(torch, np, pipe, n_attn, smi):
    """Phase 7: `ddim-100-deep` at batch 16 as `bench.py` times it (inputs as
    bench.py makes them, clipped to [-1, 1] as images are; one warm-up call,
    BENCH_REPEATS timed calls ending in a synchronize), exact `ddim-100` the
    same way as its anchor. The timed calls' attention launches are held to
    the keymask's count and each image to `check_images`; then one line in
    bench.py's schema, the numbers unrounded."""
    from fidm_tpu_torch import SAMPLER_PRESETS
    from fidm_tpu_torch.ops import LAUNCHES

    S = pipe.config.unet.image_size
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(np.clip(rng.standard_normal((BENCH_BATCH, S, S, 3)) * 0.5, -1, 1)
                          .astype(np.float32)).to(pipe.device)
    mask = torch.zeros((BENCH_BATCH, S, S, 1), device=pipe.device)
    mask[:, S // 4:3 * S // 4, S // 4:3 * S // 4] = 1.0
    keep = mask[..., 0] < 0.5

    def per_sample(name):
        cfg = SAMPLER_PRESETS[name]
        expect = attention_per_call(pipe.sched, cfg, n_attn) * BENCH_REPEATS
        pipe.inpaint(gt, mask, 0, sampler=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        outs = [pipe.inpaint(gt, mask, i + 1, sampler=cfg) for i in range(BENCH_REPEATS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(sorted(LAUNCHES.items()))
        peak = torch.cuda.max_memory_allocated()
        print(f"[7] bench {name} B={BENCH_BATCH}: launches of the {BENCH_REPEATS} timed calls "
              f"{launches}, expected {expect} from the keymask", flush=True)
        check(launches.get("attention") == launches.get("attention.bf16") == expect,
              f"bench {name}: attention launches {launches} != {expect} of the bf16 kernel")
        for i, out in enumerate(outs):
            check_images(torch, f"[7] bench {name} B={BENCH_BATCH} seed {i + 1}", out, gt, keep)
        return dt / (BENCH_REPEATS * BENCH_BATCH), peak

    deep = SAMPLER_PRESETS["ddim-100-deep"]
    tps, peak = per_sample("ddim-100-deep")
    exact_tps, exact_peak = per_sample("ddim-100")
    print(f"[7] bench: ddim-100-deep at batch {BENCH_BATCH} {tps:.6f} s per sample, peak "
          f"memory {peak / 2**30:.3f} GiB; exact ddim-100 {exact_tps:.6f} s per sample, peak "
          f"{exact_peak / 2**30:.3f} GiB; {smi}", flush=True)
    print(json.dumps({
        "metric": f"{S}^2 inpainted images/sec/chip (DDIM-100, deep-cache "
                  f"p{deep.encoder_cache_period}/b{deep.cache_branch})",
        "value": 1.0 / tps, "unit": "img/s", "vs_baseline": BASELINE_TIME_PER_SAMPLE / tps,
        "time_per_sample_s": tps, "batch": BENCH_BATCH, "backend": "cuda",
        "encoder_cache_period": deep.encoder_cache_period,
        "encoder_cache_tail": deep.encoder_cache_tail, "cache_branch": deep.cache_branch,
        "exact_time_per_sample_s": exact_tps}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    try:
        import numpy as np
        import torch.nn.functional as F
        from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
        from fidm_tpu_torch.cli import quantize as quantize_cli
        from fidm_tpu_torch.models import InpaintingUNet
        from fidm_tpu_torch.models.layers import AttentionBlock
        from fidm_tpu_torch.ops import LAUNCHES, attention, build, kernel_override
        from fidm_tpu_torch.ops import quantize as quantize_ops
        from fidm_tpu_torch.quant import int8 as quant_int8
        from fidm_tpu_torch.quant import load_quantized_state_dict
        from fidm_tpu_torch.sampling.sampler import _ddim_tables, _dpm_tables
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
    try:
        import PIL
        pil = f"yes, Pillow {PIL.__version__}"
    except ImportError as e:
        pil = f"no ({e})"
    print(f"[1] PIL imports: {pil}", flush=True)
    t0 = time.perf_counter()
    built = list(build.KERNELS)
    logs = build.build_all(built)
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln]
    print(f"[1] built {built} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)}); ptxas: {sorted(set(regs))}", flush=True)
    for line in (ptxas_summary(logs.get("attention", ""), "attention_fwd_kernel")
                 + ptxas_summary(logs.get("quantize", ""), "quantize_kernel")):
        print(f"[1] ptxas {line}", flush=True)
    # 2. each kernel against its plain version
    print("[2] attention kernel vs plain version (tolerance: f32 1e-5, sums in "
          "another order; bf16 2e-2, the plain version rounds q*scale, k*scale, "
          "the logits and the softmax to bf16 where the kernel keeps f32). "
          "*_ms: device time by torch.profiler; wrapper call: CUDA events around "
          "back-to-back calls, host cost included", flush=True)
    attn_rows = phase_kernels(torch, F, attention, kernel_override)
    print("[2] quantize kernel vs plain version (tolerance 0: both draw the same "
          "Philox bits and divide in IEEE float32). cold: every call on another copy "
          "of x, the copies more than twice the L2 cache; warm: the same x again. "
          "nearest_torch: the round-to-nearest torch path, for context (no one "
          "PyTorch call rounds stochastically)", flush=True)
    quant_row = phase_quantize_kernel(torch, quantize_ops, quant_int8, kernel_override)

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

    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.inpaint(gt, mask, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sorted(LAUNCHES.items()))
    n_steps = len(_ddim_tables(pipe.sched, config.sampler)["t"])
    print(f"[3] DDIM-100 inpaint B={BATCH} at {config.unet.image_size}^2: "
          f"{seconds:.4f} s per call, {seconds / BATCH:.4f} s per sample, "
          f"{seconds / n_steps * 1e3:.3f} ms per step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}",
          flush=True)
    check(launches.get("attention") == launches.get("attention.bf16") == n_attn * n_steps,
          f"attention kernel launches {launches} != {n_attn} x {n_steps} of the bf16 kernel")
    check_images(torch, "[3] DDIM-100", out, gt, keep)

    # the server's default preset on the same pipeline, inputs and seed
    sde = SAMPLER_PRESETS["dpm-25-sde"]
    n_sde_steps = len(_dpm_tables(pipe.sched, sde)["t"])
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out_sde = pipe.inpaint(gt, mask, 0, sampler=sde)
    torch.cuda.synchronize()
    sde_s = time.perf_counter() - t0
    sde_launches = dict(sorted(LAUNCHES.items()))
    print(f"[3] dpm-25-sde inpaint B={BATCH} at {config.unet.image_size}^2: "
          f"{sde_s:.4f} s per call, {sde_s / BATCH:.4f} s per sample, "
          f"{sde_s / n_sde_steps * 1e3:.3f} ms per step ({n_sde_steps} steps); "
          f"launches {sde_launches}", flush=True)
    check(sde_launches.get("attention") == sde_launches.get("attention.bf16")
          == n_attn * n_sde_steps,
          f"dpm-25-sde: attention launches {sde_launches} != {n_attn} x {n_sde_steps} "
          f"of the bf16 kernel")
    check_images(torch, "[3] dpm-25-sde", out_sde, gt, keep)

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
        yk16 = pipe.model(x, t, masked, mask)
        LAUNCHES.clear()
        yk32 = f32_model(x, t, masked, mask)
        f32_launches = dict(sorted(LAUNCHES.items()))
        print(f"[4] one float32 UNet forward: launches {f32_launches}", flush=True)
        check(f32_launches.get("attention.f32") == n_attn,
              f"float32 forward: {f32_launches} launches, not {n_attn} of the f32 kernel")
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
    t0 = time.perf_counter()
    sde_plain = plain(lambda: pipe.inpaint(gt, mask, 0, sampler=sde))
    torch.cuda.synchronize()
    sde_plain_s = time.perf_counter() - t0
    hole = (out_sde - sde_plain).abs()[~keep]
    print(f"[4] dpm-25-sde, plain-attention path: {sde_plain_s:.4f} s per call; images "
          f"kernel vs plain in the hole: mean abs {hole.mean().item():.4g} (tol "
          f"{SDE_IMAGE_MEAN_TOL}), max {hole.max().item():.4g}", flush=True)
    check(torch.equal(sde_plain[keep], gt[keep]), "dpm-25-sde plain path: known pixels differ")
    check(hole.mean().item() <= SDE_IMAGE_MEAN_TOL,
          "dpm-25-sde: kernel and plain paths disagree")

    # 5. the quantization path at full width
    # the checkpoint outlives phase 5: the server of phase 6 loads it
    ckpt_dir = tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_ckpt_")
    ckpt = Path(ckpt_dir.name) / "ffhq256_random.pt"
    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_") as tmp:
        tmp = Path(tmp)
        torch.save({k: v.cpu() for k, v in pipe.model.state_dict().items()}, ckpt)
        print(f"[5] wrote phase 3's model as an ADM checkpoint, "
              f"{ckpt.stat().st_size} bytes", flush=True)

        def quantize(out, *extra):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            report = quantize_cli.main(["--checkpoint", str(ckpt), "--out", str(out),
                                        *extra])
            torch.cuda.synchronize()
            return report, time.perf_counter() - t0, {n: LAUNCHES[n] for n in build.KERNELS}

        report, quant_s, quant_launches = quantize(tmp / "int8.npz")
        print(f"[5] quantize CLI (absmax): {quant_s:.4f} s wall, compression "
              f"{report['compression']}, {report['tensors_quantized']} tensors, "
              f"launches {quant_launches}", flush=True)
        check(report["tensors_quantized"] == QUANT_TENSORS,
              f"{report['tensors_quantized']} tensors quantized, not {QUANT_TENSORS}")
        check(quant_launches["quantize"] == QUANT_LAUNCHES,
              f"quantize kernel launches {quant_launches['quantize']} != {QUANT_LAUNCHES}")
        t0 = time.perf_counter()
        compared, differ = check_cli_rounding(torch, np, ckpt, config.unet, tmp / "int8.npz",
                                              quantize_ops, quant_int8)
        print(f"[5] the .npz's kernel-rounded tensors against the plain version at their "
              f"seeds: {compared} compared, {len(differ)} differ "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(compared == QUANT_LAUNCHES and not differ,
              f"{compared} kernel-rounded tensors compared, differing: {differ[:5]}")
        cli_stages(torch, np, ckpt, config.unet, tmp / "stages.npz")
        report2, again_s, _ = quantize(tmp / "int8_again.npz")
        with np.load(tmp / "int8.npz") as a, np.load(tmp / "int8_again.npz") as b:
            same = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
        print(f"[5] the same command again: {again_s:.4f} s wall; bit-identical "
              f".npz: {same}", flush=True)
        check(same and report2 == report, "the same seed gave another .npz")

        write_packed_dir(np, tmp / "calib", 8, config.unet.image_size, seed=4)
        report_cal, cal_s, cal_launches = quantize(
            tmp / "int8_calibrated.npz", "--calibrate", str(tmp / "calib"),
            "--calib_samples", "8", "--calib_batch", "4")
        print(f"[5] quantize CLI --calibrate (8 images, 2 batches of 4): {cal_s:.4f} s "
              f"wall, compression {report_cal['compression']}, launches {cal_launches}",
              flush=True)
        check(report_cal["calibrated"] and report_cal["tensors_quantized"] == QUANT_TENSORS,
              f"calibrated report {report_cal}")

        qpipe = InpaintingPipeline.create(config, seed=0, device="cuda")
        qpipe.model.load_state_dict(
            load_quantized_state_dict(str(tmp / "int8.npz"), config.unet), strict=True)

    LAUNCHES.clear()
    t0 = time.perf_counter()
    out_q = qpipe.inpaint(gt, mask, 0)
    torch.cuda.synchronize()
    q_seconds = time.perf_counter() - t0
    q_launches = {name: LAUNCHES[name] for name in build.KERNELS}
    hole_q = (out_q - out).abs()[~keep].mean().item()
    print(f"[5] DDIM-100 inpaint on the int8 weights, B={BATCH}: {q_seconds:.4f} s per "
          f"call, {q_seconds / BATCH:.4f} s per sample; launches {q_launches}; hole "
          f"mean |int8 - phase 3| {hole_q:.4g}", flush=True)
    check(bool(torch.isfinite(out_q).all()), "int8 weights: non-finite output")
    check(torch.equal(out_q[keep], gt[keep]), "int8 weights: known pixels differ from gt")
    check(q_launches["attention"] == n_attn * n_steps, "int8 weights: attention launches")
    f32_int8 = InpaintingUNet(f32_model.config)
    f32_int8.load_state_dict(qpipe.model.state_dict())
    f32_int8 = f32_int8.to("cuda").eval()
    with torch.inference_mode():
        yq, yf = qpipe.model(x, t, masked, mask), pipe.model(x, t, masked, mask)
        e_q32 = rel(f32_int8(x, t, masked, mask), yk32)
    e_q = rel(yq, yf)
    print(f"[5] one UNet forward, int8 against float32 weights, max abs / max "
          f"|float32 weights|: bf16 {e_q:.4g} (tol {QUANT_UNET_TOL}); float32 model "
          f"{e_q32:.4g}", flush=True)
    check(e_q <= QUANT_UNET_TOL, "int8 weights: the UNet forward moved too far")
    del qpipe, f32_int8, f32_model
    torch.cuda.empty_cache()

    # 6. the serving path at full width, on phase 5's checkpoint
    phase_serving(torch, np, ckpt, pipe, n_attn, smi)
    ckpt_dir.cleanup()

    # 7. feature caching at full width, on phase 3's pipeline and inputs
    with torch.inference_mode():
        cached_forwards(torch, pipe.model, n_attn, (x, t, masked, mask))
    cached_presets(torch, pipe, n_attn, gt, mask, keep, out, smi)
    bench_line(torch, np, pipe, n_attn, smi)

    # 8. the record
    # launches: attention_bf16 in phase 3's DDIM-100 call, attention_f32 in
    # phase 4's float32 UNet forward, quantize in phase 5's absmax CLI run
    kernels = [dict(name="attention_bf16", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/attention.cu",
                    replaces="fidm_tpu/ops/attention.py:46",
                    launches=launches["attention.bf16"], **attn_rows[torch.bfloat16]),
               dict(name="attention_f32", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/attention.cu",
                    replaces="fidm_tpu/ops/attention.py:46",
                    launches=f32_launches["attention.f32"], **attn_rows[torch.float32]),
               dict(name="quantize", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/quantize.cu",
                    replaces="fidm_tpu/quant/int8.py:28",
                    launches=quant_launches["quantize"], **quant_row)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
