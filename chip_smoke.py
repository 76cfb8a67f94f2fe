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
8. the evaluate path at full width: `fidm_tpu_torch.cli.evaluate` on phase
   5's `.pt` over 8 seeded 256² PNGs with box and brush masks (`ddim-100`
   with FID, KID and LPIPS from seeded weights in the published layouts;
   `ddim-100-deep` against `cli.fid_stats` reference statistics; 10-step
   runs on the int8 `.npz`, with `--quantize int8` and with `--dtype f32`;
   a run from `cli.pack_data` shards), each `metrics.json` held to the JAX
   CLI's keys, every kernel's launches counted, the metric networks on the
   card held against the CPU; last, one float32 UNet forward profiled (the
   forward of `--dtype f32`), with torch's TF32 switches and with both off;
9. the rest of sampling at full width on phase 3's model and inputs: the
   presets `ddpm-100`, `dpm3-20`, `unipc-20`, `consistency-2` and
   `repaint-100-light` (`ddpm-1000`, 1000 model evaluations, is not run: a
   cut of depth that pays for phase 14); classifier guidance with `ddim-30` (a closed-form
   gradient) and `ddpm-100` (a gradient taken by autograd) through
   `InpaintingPipeline.inpaint`; classifier-free guidance at scale 3 on a
   class-conditional model (batch 8 per model call); `ddim-50` with a
   trajectory frame every 10 steps; `unipc-20` and `ddpm-100` with the plain
   attention forced; then `cli.generate` on a full-width 3-channel base UNet
   `.pt` (dpm++3m, unipc, consistency), `cli.visualize_noise` and
   `cli.evaluate --save_trajectory` on 4 of phase 8's images. Each call's
   images and attention launches (4 per model evaluation of the sampler's
   host tables) are gated;
10. training at full width: the attention op under autograd (the kernel
   forward, the plain version's backward, no launch in it);
   `fidm_tpu_torch.cli.train` from phase 5's `.pt` on 8 seeded 256² PNGs
   with a mask directory, batch 4, 2 epochs with an EMA, then `--resume
   latest` for a third (every step's loss finite, history keys, the
   checkpoint layout, the resumed epoch, attention launches 4 per train and
   per validation forward; ms per step, images/s, peak memory, seconds per
   save); a LoRA run on procedural masks (the base bit-equal, the merged
   model at step 0 the base); `cli.evaluate` on both checkpoint directories
   (`--use_ema`; the LoRA adapter merged) and `cli.generate` on the first;
   then one train step with the kernel against the plain attention, and the
   remat policies none / convs / full (loss, gradient norm, launches, peak
   memory, ms per step);
11. the warm program cache at full width on phase 3's model and inputs:
   `compile_batch` / `install_program` programs (CUDA graphs of one whole
   sampler call) for `ddim-100` at batch 4 with one seed, `dpm-25-sde` with
   one seed and with per-row seeds, and `ddim-100-deep` at bench.py's batch
   16, each replay bit-equal to the eager call, with its
   attention launches, times (capture, replay, the host's buffer fill) and
   memory; one replay's kernels in the profiler; `serving.serve` with a
   program cache directory over phase 6's presets and ladder, restarted on
   it (every manifest loaded, none written), replies bit-equal to the eager
   pipeline, an instrumented batch of 8, a corrupt manifest healed;
   `cli.evaluate --program_cache` against the run without it; then
   `cast_params(torch.bfloat16)` and `split_decoder_skips` forwards against
   their float32 and concatenating counterparts;
12. distillation at full width: `fidm_tpu_torch.cli.distill` from phase 5's
   `.pt` on phase 10's PNGs and masks, batch 4: progressive (4 -> 2 -> 1, 2
   steps a round), consistency distillation (grid 40) and consistency
   training, 3 steps each (every loss finite, attention launches 4 per
   forward: 12 / 12 / 8 a step, none in a backward; the student
   directories' layout, grids and metadata; ms per step, images/s, peak
   memory, seconds per save); `cli.evaluate` on student_2/ with its grid
   and the mean_type of its metadata, `--preset consistency-2` and
   `cli.generate --method consistency` on consistency/; `cli.export_torch`
   of student_2/ (bit-equal, strict load, the same per-sample metrics);
   then one step of each kind with the kernel against the plain attention,
   the target network bit-equal to a module holding the EMA tensors, the
   frozen teacher unmoved;
13. the native data helpers and a one-rank process group: the port's g++
   libraries built (maskgen must build; imgload wherever jpeglib.h and
   png.h are found), the fused normalize/compose against numpy on a 256²
   batch of 4 (one ulp), the native decode against PIL on phase 10's PNGs
   (bit for bit), 256² masks of each kind (coverage, repeatable), with host
   times; then a one-rank NCCL group started as a launcher starts one and
   `create_mesh(data=1, fsdp=1)` over it: 3 full-width train steps, a
   progressive and a consistency step, and `ddim-100` through
   `InpaintingPipeline(mesh=)`, each bit-equal to the same calls without the
   mesh (phase 3's output, 404 launches), and `cli.train` for one epoch and
   again over its directory with and without the group (the same history,
   files, best.json and state); ms per step with and without the mesh; the
   group destroyed after it;
14. the mesh's "model" axis: two ranks over gloo on the card (NCCL refuses
   two ranks on one device), each a process of its own with CUDA tensors and
   the built kernel libraries, a `create_mesh(data=1, fsdp=1, model=2)`, at
   full width from phase 5's `.pt`, batch 2: a tensor-parallel and a
   spatially partitioned forward against the unmeshed forward in float32
   and in bf16 (4 attention launches on each rank, under TP at 4 of the 8
   heads; the TP forward also against itself with the plain attention), one
   train step of each layout against the unmeshed step in float32, and a
   10-step DDIM through `InpaintingPipeline(tp_params=True)` and
   `(shard_spatial=True)` against the unmeshed call (known pixels bit-equal
   to gt); the ranks' times are printed, and are no scaling figure;
15. a JSON line of the kernels, then the contract line
   {"ok": true, "device": {...}}.

Both TF32 switches are off in phases 1-7, 9, 11, 13 and 14, so float32 products and
convolutions are full float32 wherever numbers are compared. Phases 8, 10 and 12
run the CLIs under torch's own switches, as a user's process has them: there
the metric networks keep full float32 by their own scoping, which its gates
test. Without a CUDA device, or without the `fidm_tpu_torch` package beside
this file, it exits non-zero and prints no result.
"""
import collections
import dataclasses
import gc
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
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 / f32 CUDA cores
# The float32 kernel takes every product as three TF32 products of split
# operands (3xTF32) on the tensor cores: its bound counts three times the
# operations at the dense TF32 peak. The CUDA-core figure (PEAK_FLOPS'
# float32, one product each) is printed beside it.
PEAK_TF32_FLOPS = 494.7e12
TF32_SPLIT_PRODUCTS = 3
# Phase 2's head dims for the f32 kernel: the UNet's 64, and 32 and 128, which
# the kernel takes too (the bf16 rows: 64 and 32)
F32_HEAD_DIMS = (64, 32, 128)
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
# Phase 11's server warms two rungs of that ladder (its restart's requests
# are of batch 1 and 8): a cut of depth that keeps the script well inside
# its time limit.
PROGRAM_BATCHES = (1, 8)
# The main path, kernel against plain attention (phase 4), with what this
# script measured on an H100 SXM. One UNet forward, max abs / max |plain|: in
# float32 the kernel's 3xTF32 products and the order of the sums differ (4.0e-6;
# 4.4e-6 with the CUDA-core kernel before them); in bf16 the plain
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
# Phase 8, the evaluate path: 8 samples in batches of 4 (2 batches), as the
# JAX CLI's --quick_test sizes a run; the 10-step runs take one batch of 4.
EVAL_SAMPLES = 8
EVAL_BATCH = 4
QUICK_STEPS = 10
# The metric networks on the card against the same port functions on the
# CPU, both in full float32 (TF32 off by `metrics.inception.full_float32`
# alone: phase 8 runs with torch's default switches, cuDNN's TF32 on):
# the sums of 100+ float32 layers in another order. Inception features 1e-4
# of the largest feature, LPIPS 1e-5 relative, SSIM 1e-5 absolute.
EVAL_FEAT_TOL = 1e-4
EVAL_LPIPS_TOL = 1e-5
EVAL_SSIM_TOL = 1e-5
# The keys of the JAX CLI's metrics.json (`fidm_tpu/cli/evaluate.py:496-539`):
# always, with --fid_weights (FID, and KID for 2 samples or more), with
# LPIPS weights; and the per-sample lists.
EVAL_KEYS = {"num_samples", "preset", "sampler", "ssim_mean", "psnr_mean", "hole_ssim_mean",
             "hole_psnr_mean", "fid_proxy", "time_per_sample_s", "time_per_sample_steady_s",
             "backend", "per_sample"}
EVAL_FID_KEYS = {"fid", "kid_mean", "kid_std"}
EVAL_LPIPS_KEYS = {"lpips_mean", "hole_lpips_mean"}
EVAL_PER_SAMPLE = {"ssim", "psnr", "hole_ssim", "hole_psnr"}
# Phase 11. One UNet forward with the parameters cast to bf16
# (`cast_params`) against the float32 parameters, both with bf16
# activations, max abs / max |float32 parameters|: each weight moves by at
# most 2^-9 of itself, less than the int8 step of QUANT_UNET_TOL, and the
# activations are rounded to bf16 either way; held to the bf16 forward bound
# of phase 4.
CAST_UNET_TOL = 5e-2
# `split_decoder_skips` against the concatenating forward on the same
# weights, max abs / max |concat|: in float32 the sums of the half-kernel
# convolutions and the one-pass GroupNorm statistics in another order (the
# phase-4 float32 bound); in bf16 the split path also normalises each half
# in bf16 where GroupNorm32 does it in float32 (the JAX package's own bf16
# bound, tests/test_unet.py).
SPLIT_F32_TOL = 1e-4
SPLIT_BF16_TOL = 5e-2


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


def attention_bound(b, h, s, d, dtype, cuda_cores=False):
    """(bound_ms, bound_by) for one attention call: q, k, v read once and o
    written once, against the two products' 4*B*H*S*S*D operations, in
    float32 three TF32 products each on the tensor cores (`cuda_cores`: one
    each at the CUDA cores' float32 peak, the figure of the kernel before
    3xTF32)."""
    itemsize = 2 if dtype == "torch.bfloat16" else 4
    bytes_ms = 4 * b * h * s * d * itemsize / PEAK_BYTES_PER_S * 1e3
    flops = 4 * b * h * s * s * d
    if dtype == "torch.bfloat16" or cuda_cores:
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    else:
        ops_ms = TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3
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
    cases = [(dtype, d, s, b) for dtype in (torch.bfloat16, torch.float32)
             for d in ((64, 32) if dtype == torch.bfloat16 else F32_HEAD_DIMS)
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
        f32_note, f32_excess, err64 = "", 0.0, 0.0
        if dtype == torch.float32:
            # both against the plain version in float64 on the same inputs
            ref64 = attention._attention_reference(q.double(), k.double(), v.double())
            err64 = (out.double() - ref64).abs().max().item()
            f32_note = (f" | vs plain in f64: kernel {err64:.3g} (tol {tol}), plain "
                        f"{(ref.double() - ref64).abs().max().item():.3g}")
            del ref64
        if dtype == torch.bfloat16:
            # both against the plain version in float32 on the same inputs
            ref32 = attention._attention_reference(q.float(), k.float(), v.float())
            err32 = (out.float() - ref32).abs()
            f32_excess = (err32 - BF16_F32_RTOL * ref32.abs()).max().item()
            f32_note = (f" | vs plain in f32: kernel {err32.max().item():.3g} "
                        f"(|err| - 2^-8 |ref| {f32_excess:.3g}, tol {BF16_F32_ATOL}), plain "
                        f"{(ref.float() - ref32).abs().max().item():.3g}")
            del ref32, err32
        sms = attention._sm_count(q.get_device())
        picked = (attention._key_groups(b * 8, s, sms) if dtype == torch.bfloat16
                  else attention._f32_tiling(b * 8, s, sms))
        ms = device_ms(torch, lambda: attention._attention_cuda(q, k, v))
        call_ms = cuda_ms(torch, lambda: attention._attention_cuda(q, k, v))
        plain_ms = device_ms(torch, lambda: attention._attention_reference(q, k, v))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound(b, 8, s, d, str(dtype))
        core_ms = (attention_bound(b, 8, s, d, str(dtype), cuda_cores=True)[0]
                   if dtype == torch.float32 else None)
        print(f"  attention {str(dtype)[6:]} B={b} H=8 S={s} D={d}: "
              f"max_abs_err={err:.3g} (tol {tol}){f32_note} kernel_ms={ms:.5f} "
              f"(wrapper call {call_ms:.5f}) plain_ms={plain_ms:.5f} "
              f"sdpa_ms={lib_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}"
              + (f"; CUDA cores {core_ms:.6f})" if core_ms else ")")
              + (f" key groups {picked}" if dtype == torch.bfloat16 else f" tiling {picked}"),
              flush=True)
        table.append((str(dtype)[6:], b, s, d, ms, bound_ms, bound_by, lib_ms, call_ms, core_ms))
        check(err <= tol, f"attention kernel disagrees with its plain version "
                          f"at B={b} S={s} D={d} {dtype}: {err} > {tol}")
        check(err64 <= tol, f"f32 attention kernel strays from the float64 plain version "
                            f"at B={b} S={s} D={d}: {err64} > {tol}")
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
        if dtype == torch.float32 and d in (64, 128) and b == BATCH and s != 100:
            # both tilings of the f32 kernel at this D
            tilings = {t: device_ms(torch, lambda: attention._attention_cuda(q, k, v, t))
                       for t in attention.F32_TILINGS}
            print(f"      f32 tilings at S={s} D={d} (1: 64 rows a block, 2: 128), the "
                  f"wrapper picks {picked}: " +
                  ", ".join(f"{t}: {ms_t:.5f} ms" for t, ms_t in tilings.items()), flush=True)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    print("[2] attention summary: dtype B S D | kernel_ms | bound_ms | bound/kernel | "
          "sdpa_ms | kernel/sdpa | wrapper call ms | f32: the CUDA-core bound, "
          "bound/kernel", flush=True)
    for dt, b, s, d, ms, bound_ms, bound_by, lib_ms, call_ms, core_ms in table:
        print(f"      {dt:8s} {b} {s:5d} {d:3d} | {ms:.5f} | {bound_ms:.6f} ({bound_by}) | "
              f"{bound_ms / ms:.3f} | {lib_ms:.5f} | {ms / lib_ms:.2f} | {call_ms:.5f}"
              + (f" | {core_ms:.6f}, {core_ms / ms:.3f}" if core_ms else ""), flush=True)
    return main_rows


def f32_kernel_times(torch, attention):
    """Device time of the f32 attention kernel of the imported `attention`
    module at phase 2's f32 shapes, [BATCH, 8, S, D], each call first held to
    1e-5 of that module's plain version, on the same seeded inputs in every
    checkout. For an A/B against another checkout, run from that checkout's
    root (the verify skill has the command); phase 2 times this checkout's
    kernel."""
    g = torch.Generator(device="cuda")
    rows = {}
    for d in F32_HEAD_DIMS:
        for s in (64, 256, 1024, 4096, 100):
            g.manual_seed(s * d)
            q, k, v = (torch.randn(BATCH, 8, s, d, device="cuda", generator=g)
                       for _ in range(3))
            err = (attention._attention_cuda(q, k, v)
                   - attention._attention_reference(q, k, v)).abs().max().item()
            check(err <= ATOL["torch.float32"],
                  f"f32 attention kernel at S={s} D={d}: {err} > {ATOL['torch.float32']}")
            rows[s, d] = device_ms(torch, lambda: attention._attention_cuda(q, k, v))
            print(f"  f32 kernel [{BATCH}, 8, {s}, {d}]: {rows[s, d]:.5f} ms "
                  f"(max_abs_err {err:.3g})", flush=True)
    return rows


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
    """One call of `fn` (a UNet forward, or a train step): its time by CUDA
    events, the host's time to enqueue it, and its device time by kernel
    (torch.profiler); prints the top kernels and the device's idle share."""
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
    """(model-evaluating steps, key steps) of one sampler call of `cfg`, from
    the sampler's own host tables and keymask: every row of the method's
    tables but repaint's renoise rows, which run no model; without caching
    every such step is a key step."""
    from fidm_tpu_torch.sampling.sampler import _cache_keymask, _method_tables

    tables = _method_tables(sched, cfg)
    K = int(tables["is_denoise"].sum()) if "is_denoise" in tables else len(tables["t"])
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
    presets and `build_pipeline`, and `serving.serve`, over HTTP. Returns the
    warm-up's seconds and the instrumented batch of 8's phase times."""
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
    batch8 = phases_line(snap8)
    print(f"[6] instrumented pass, dpm-25-sde: batch of 8 ({snap8['batches_by_size']}): "
          f"{batch8}; then a batch of 1: {phases_line(snap, snap8)}; {smi}",
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
    return warm_s, batch8


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
    bench.py's schema, the numbers unrounded. Returns each preset's first
    timed output (seed 1, on the host) and seconds per call."""
    from fidm_tpu_torch import SAMPLER_PRESETS
    from fidm_tpu_torch.ops import LAUNCHES

    S = pipe.config.unet.image_size
    gt, mask = bench_inputs(torch, np, S)
    keep = mask[..., 0] < 0.5
    firsts = {}

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
        firsts[name] = (outs[0].cpu(), dt / BENCH_REPEATS)
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
    return firsts


def bench_inputs(torch, np, size):
    """`bench.py`'s inputs at batch BENCH_BATCH, clipped to [-1, 1] as images
    are, and its centred box mask, on the card."""
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(np.clip(rng.standard_normal((BENCH_BATCH, size, size, 3)) * 0.5, -1, 1)
                          .astype(np.float32)).cuda()
    mask = torch.zeros((BENCH_BATCH, size, size, 1), device="cuda")
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    return gt, mask


def write_eval_tree(np, root, size, n, seed):
    """n smooth seeded PNGs (low-frequency colour waves and mild noise) in
    root/images, and a mask root with a test/ dir of a box and a brush mask
    (black = hole). Returns (image dir, mask root, the masks in the order
    the ordered loader cycles them, 1 = hole)."""
    from PIL import Image

    img_dir, mask_dir = root / "images", root / "masks" / "test"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    for i in range(n):
        freq = rng.uniform(0.5, 3.0, (3, 2))
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
                         for (fy, fx), ph in zip(freq, phase)], -1)
        arr = np.clip(127.5 + 100 * base + rng.normal(0, 6, base.shape), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(img_dir / f"face_{i:02d}.png")
    box = np.zeros((size, size), np.float32)
    box[size // 4:3 * size // 4, size // 8:5 * size // 8] = 1.0
    brush = request_inputs(np, 1, size)[1][..., 0]
    masks = [box, brush]
    for j, (name, m) in enumerate(zip(("box", "brush"), masks)):
        Image.fromarray(np.where(m > 0.5, 0, 255).astype(np.uint8)).save(
            mask_dir / f"mask_{j}_{name}.png")
    return img_dir, root / "masks", masks


def write_metric_weights(torch, root):
    """Seeded Inception (pt_inception layout, non-trivial BN statistics),
    AlexNet and LPIPS-head state dicts from the repository's test oracles,
    as files: {"fid", "alex", "lin"}: path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from oracle_fid_inception import FIDInceptionOracle
    from oracle_fid_inception import randomize as randomize_inception
    from oracle_lpips import LPIPSOracle
    from oracle_lpips import randomize as randomize_lpips

    paths = {"fid": root / "pt_inception.pth", "alex": root / "alexnet.pth",
             "lin": root / "lpips_lin.pt"}
    torch.save(randomize_inception(FIDInceptionOracle(), seed=0).state_dict(), paths["fid"])
    oracle = randomize_lpips(LPIPSOracle(), seed=0)
    torch.save(oracle.alexnet_state_dict(), paths["alex"])
    torch.save(oracle.lpips_state_dict(), paths["lin"])
    return {k: str(v) for k, v in paths.items()}


def check_eval_blob(np, label, blob, keys, per_sample, masks, n):
    """metrics.json against the JAX CLI's layout: its keys, n values per
    sample, None exactly where the JAX CLI gives None (a hole score of a
    sample whose mask has no hole, or none outside the SSIM border band),
    every other number finite."""
    from fidm_tpu_torch.metrics.ssim import DEFAULT_WIN_SIZE

    check(set(blob) == keys, f"{label}: metrics.json keys {sorted(set(blob) ^ keys)} differ "
                             f"from the JAX CLI's")
    check(set(blob["per_sample"]) == per_sample,
          f"{label}: per-sample keys {sorted(blob['per_sample'])}")
    r = (DEFAULT_WIN_SIZE - 1) // 2
    for key, values in blob["per_sample"].items():
        check(len(values) == n, f"{label}: {len(values)} values of {key}, not {n}")
        for i, v in enumerate(values):
            m = masks[i % len(masks)]
            scorable = m[r:-r, r:-r].sum() > 0 if key == "hole_ssim" else m.sum() > 0
            if key.startswith("hole_") and not scorable:
                check(v is None, f"{label}: {key}[{i}] is {v}, the JAX CLI gives None")
            else:
                check(v is not None and np.isfinite(v), f"{label}: {key}[{i}] = {v}")
    for key, v in blob.items():
        if isinstance(v, float):
            check(np.isfinite(v), f"{label}: {key} = {v}")


def check_known_pixels(np, label, out_dir, masks, n):
    """Each inpainted PNG equals its original PNG outside the hole, and
    differs inside it."""
    from PIL import Image

    for i in range(n):
        out = np.asarray(Image.open(out_dir / "inpainted" / f"{i:05d}.png"))
        gt = np.asarray(Image.open(out_dir / "original" / f"{i:05d}.png"))
        keep = masks[i % len(masks)] < 0.5
        check(out.shape == gt.shape and np.array_equal(out[keep], gt[keep]),
              f"{label}: inpainted image {i}: known pixels differ from the original")
        check(not np.array_equal(out[~keep], gt[~keep]), f"{label}: image {i}: hole unfilled")


def metric_networks(torch, np, out_dir, weights, masks, n, smi):
    """Phase 8: Inception, LPIPS and SSIM on the card against the same port
    functions on the CPU, on the first evaluate run's images, under torch's
    default TF32 switches (cuDNN's on): the tolerances hold only if the
    metric calls run in full float32 (`metrics.inception.full_float32`).
    Also their device time per batch of EVAL_BATCH on the card, and, as a
    witness that the Inception gate sees TF32, the card's features from the
    same network called outside `full_float32`."""
    from PIL import Image

    from fidm_tpu_torch import metrics
    from fidm_tpu_torch.data.dataset import load_image
    from fidm_tpu_torch.metrics.inception import preprocess

    def images(kind):
        return np.stack([load_image(out_dir / kind / f"{i:05d}.png", masks[0].shape[0])
                         for i in range(n)])

    gt, out = images("original"), images("inpainted")
    mask = np.stack([masks[i % len(masks)] for i in range(n)])[..., None].astype(np.float32)
    params = metrics.convert_torch_inception_weights(torch.load(weights["fid"]))
    alex = {k: v.numpy() for k, v in torch.load(weights["alex"]).items()}
    lin = {k: v.numpy() for k, v in torch.load(weights["lin"]).items()}
    lp_weights = metrics.lpips.convert_torch_lpips_weights(alex, lin)
    rows = {}
    for device in ("cuda", "cpu"):
        inception = metrics.InceptionFeatureExtractor(params, device=device)
        lpips = metrics.LPIPS(lp_weights, device=device)
        g, o, m = (torch.from_numpy(a).to(device) for a in (gt, out, mask))
        rows[device] = dict(
            feats=inception((o + 1) / 2), lpips=lpips(g, o), hole_lpips=lpips.masked(g, o, m),
            ssim=metrics.ssim((g + 1) / 2, (o + 1) / 2).cpu().numpy(),
            hole_ssim=metrics.masked_ssim((g + 1) / 2, (o + 1) / 2, m).cpu().numpy())
        if device == "cuda":
            with torch.inference_mode():  # TF32 as the process has it
                tf32_feats = inception.model(preprocess((o + 1) / 2)).cpu().numpy()
            b = slice(0, EVAL_BATCH)
            g4, o4, m4 = g[b], o[b], m[b]
            times = {
                "inception": device_ms(torch, lambda: inception((o4 + 1) / 2), n=5),
                "lpips": device_ms(torch, lambda: lpips(g4, o4), n=5),
                "hole lpips": device_ms(torch, lambda: lpips.masked(g4, o4, m4), n=5),
                "ssim": device_ms(torch, lambda: metrics.ssim((g4 + 1) / 2, (o4 + 1) / 2), n=5),
                "hole ssim": device_ms(
                    torch, lambda: metrics.masked_ssim((g4 + 1) / 2, (o4 + 1) / 2, m4), n=5)}
            t0 = time.perf_counter()
            inception((o4 + 1) / 2)
            host_inception = time.perf_counter() - t0
        del inception, lpips
    torch.cuda.empty_cache()
    card, cpu = rows["cuda"], rows["cpu"]
    feat_err = np.abs(card["feats"] - cpu["feats"]).max() / np.abs(cpu["feats"]).max()
    tf32_err = np.abs(tf32_feats - cpu["feats"]).max() / np.abs(cpu["feats"]).max()
    lp_err = max(np.abs(card[k] / cpu[k] - 1).max() for k in ("lpips", "hole_lpips"))
    ssim_err = max(np.abs(card[k] - cpu[k]).max() for k in ("ssim", "hole_ssim"))
    print(f"[8] metric networks, card against CPU on {n} images at {masks[0].shape[0]}^2: "
          f"Inception features max abs / max |feature| {feat_err:.3g} (tol {EVAL_FEAT_TOL}), "
          f"LPIPS and hole LPIPS max relative {lp_err:.3g} (tol {EVAL_LPIPS_TOL}), SSIM and "
          f"hole SSIM max abs {ssim_err:.3g} (tol {EVAL_SSIM_TOL}); the same Inception outside "
          f"full_float32 (cuDNN TF32 {torch.backends.cudnn.allow_tf32}) {tf32_err:.3g}", flush=True)
    print(f"[8] device ms per batch of {EVAL_BATCH} on the card (torch.profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; one Inception call, host clock with its download, {host_inception * 1e3:.3f} ms;"
          f" {smi}", flush=True)
    check(feat_err <= EVAL_FEAT_TOL, "Inception features: card and CPU disagree")
    check(lp_err <= EVAL_LPIPS_TOL, "LPIPS: card and CPU disagree")
    check(ssim_err <= EVAL_SSIM_TOL, "SSIM: card and CPU disagree")


def phase_evaluate(torch, np, ckpt, npz, n_attn, smi):
    """Phase 8: the evaluate path on the card at full width (the CLIs'
    default model, 256²) through `cli.evaluate`, `cli.fid_stats` and
    `cli.pack_data`. Returns the float32 run's attention launches."""
    from fidm_tpu_torch import SAMPLER_PRESETS, PipelineConfig
    from fidm_tpu_torch.cli import evaluate as evaluate_cli
    from fidm_tpu_torch.cli import fid_stats as fid_stats_cli
    from fidm_tpu_torch.cli import pack_data as pack_cli
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.metrics import fid as fid_module
    from fidm_tpu_torch.ops import LAUNCHES

    t_phase = time.perf_counter()
    size = PipelineConfig().unet.image_size
    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    fd_seconds = []
    real_fd = fid_module.frechet_distance

    def timed_fd(*args, **kw):  # the host's sqrtm, timed where the CLIs call it
        t0 = time.perf_counter()
        result = real_fd(*args, **kw)
        fd_seconds.append((len(args[0]), time.perf_counter() - t0))
        return result

    import fidm_tpu_torch.metrics as metrics_pkg

    metrics_pkg.frechet_distance = fid_module.frechet_distance = timed_fd
    try:
        with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_eval_") as tmp:
            tmp = Path(tmp)
            img_dir, mask_root, masks = write_eval_tree(np, tmp, size, EVAL_SAMPLES, seed=5)
            weights = write_metric_weights(torch, tmp)
            data = ["--data_dir", str(img_dir), "--mask_dir", str(mask_root),
                    "--device", "cuda"]
            full = ["--num_samples", str(EVAL_SAMPLES), "--batch_size", str(EVAL_BATCH)]
            quick = ["--ddim_timesteps", str(QUICK_STEPS), "--num_samples", str(EVAL_BATCH),
                     "--batch_size", str(EVAL_BATCH), "--no_save_images"]

            def evaluate(label, out, *argv):
                LAUNCHES.clear()
                t0 = time.perf_counter()
                results = evaluate_cli.main(data + ["--output_dir", str(out), *argv])
                secs = time.perf_counter() - t0
                launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
                with open(out / "metrics.json") as f:
                    blob = json.load(f)
                print(f"[8] {label}: {secs:.3f} s wall; time_per_sample_s "
                      f"{results['time_per_sample_s']:.6f}, steady "
                      f"{results['time_per_sample_steady_s']:.6f}; ssim "
                      f"{results['ssim_mean']:.6g}, psnr {results['psnr_mean']:.6g}, hole ssim "
                      f"{results['hole_ssim_mean']:.6g}, "
                      f"fid_proxy {results['fid_proxy']:.6g}"
                      + "".join(f", {k} {results[k]:.6g}" for k in
                                ("fid", "kid_mean", "lpips_mean", "hole_lpips_mean")
                                if k in results)
                      + f"; backend {results['backend']}; launches {launches}; {smi}", flush=True)
                return blob, launches

            def attention(preset, steps=None):
                cfg = SAMPLER_PRESETS[preset]
                if steps is not None:
                    cfg = dataclasses.replace(cfg, num_steps=steps)
                return attention_per_call(sched, cfg, n_attn)

            # ddim-100 with real FID, KID and LPIPS
            out1 = tmp / "ddim-100"
            blob, launches = evaluate(
                "evaluate --preset ddim-100 with --fid_weights and LPIPS", out1,
                "--checkpoint", str(ckpt), *full, "--fid_weights", weights["fid"],
                "--lpips_alexnet", weights["alex"], "--lpips_lin", weights["lin"])
            check_eval_blob(np, "[8] ddim-100", blob, EVAL_KEYS | EVAL_FID_KEYS | EVAL_LPIPS_KEYS,
                            EVAL_PER_SAMPLE | {"lpips", "hole_lpips"}, masks, EVAL_SAMPLES)
            check_known_pixels(np, "[8] ddim-100", out1, masks, EVAL_SAMPLES)
            expect = attention("ddim-100") * EVAL_SAMPLES // EVAL_BATCH
            check(launches == {"attention": expect, "attention.bf16": expect},
                  f"[8] ddim-100: launches {launches}, not {expect} of the bf16 kernel")
            metric_networks(torch, np, out1, weights, masks, EVAL_SAMPLES, smi)

            # reference statistics once, then ddim-100-deep scored against them
            stats = tmp / "stats.npz"
            t0 = time.perf_counter()
            info = fid_stats_cli.main(["--data_dir", str(img_dir), "--fid_weights",
                                       weights["fid"], "--out", str(stats), "--image_size",
                                       str(size), "--device", "cuda"])
            print(f"[8] cli.fid_stats on the data: {info}, {time.perf_counter() - t0:.3f} s",
                  flush=True)
            check(info["num_images"] == EVAL_SAMPLES and info["dim"] == 2048, "fid_stats")
            blob, launches = evaluate(
                "evaluate --preset ddim-100-deep --fid_stats", tmp / "deep",
                "--checkpoint", str(ckpt), "--preset", "ddim-100-deep", *full,
                "--fid_weights", weights["fid"], "--fid_stats", str(stats))
            check_eval_blob(np, "[8] ddim-100-deep", blob, EVAL_KEYS | EVAL_FID_KEYS,
                            EVAL_PER_SAMPLE, masks, EVAL_SAMPLES)
            expect = attention("ddim-100-deep") * EVAL_SAMPLES // EVAL_BATCH
            check(launches == {"attention": expect, "attention.bf16": expect},
                  f"[8] ddim-100-deep: launches {launches}, not {expect} of the bf16 kernel")

            # the inpainted PNGs against the stats (pytorch-fid's two-dirs flow)
            t0 = time.perf_counter()
            report = fid_stats_cli.main(["--fake_dir", str(out1 / "inpainted"), "--fid_stats",
                                         str(stats), "--fid_weights", weights["fid"],
                                         "--image_size", str(size), "--device", "cuda"])
            print(f"[8] cli.fid_stats --fake_dir on the ddim-100 PNGs: {report}, "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            check(report["num_real"] == report["num_fake"] == EVAL_SAMPLES
                  and all(np.isfinite(report[k]) for k in ("fid", "kid_mean")),
                  f"fid_stats --fake_dir report {report}")

            # 10-step runs of one batch: the int8 .npz, --quantize int8, --dtype f32
            blob_npz, launches = evaluate("evaluate --checkpoint int8.npz, 10 steps",
                                          tmp / "npz", "--checkpoint", str(npz), *quick)
            check_eval_blob(np, "[8] int8 .npz", blob_npz, EVAL_KEYS, EVAL_PER_SAMPLE, masks,
                            EVAL_BATCH)
            expect = attention("ddim-100", QUICK_STEPS)
            check(launches == {"attention": expect, "attention.bf16": expect},
                  f"[8] int8 .npz: launches {launches}, not {expect} of the bf16 kernel")
            blob_q, launches = evaluate("evaluate --quantize int8, 10 steps", tmp / "q",
                                        "--checkpoint", str(ckpt), "--quantize", "int8", *quick)
            check(launches == {"attention": expect, "attention.bf16": expect,
                               "quantize": QUANT_LAUNCHES},
                  f"[8] --quantize int8: launches {launches}, not {expect} of the bf16 kernel "
                  f"and {QUANT_LAUNCHES} of the quantize kernel")
            # the same kernel, seeds (1, 2, ... in tree order) and weights as
            # phase 5's CLI wrote into the .npz: the same images
            same = blob_q["per_sample"] == blob_npz["per_sample"]
            print(f"[8] --quantize int8 equals the int8 .npz run per sample: {same}", flush=True)
            check(same, "--quantize int8 and the int8 .npz gave other metrics")
            blob, f32_launches = evaluate("evaluate --dtype f32, 10 steps", tmp / "f32",
                                          "--checkpoint", str(ckpt), "--dtype", "f32", *quick)
            check_eval_blob(np, "[8] --dtype f32", blob, EVAL_KEYS, EVAL_PER_SAMPLE, masks,
                            EVAL_BATCH)
            check(f32_launches == {"attention": expect, "attention.f32": expect},
                  f"[8] --dtype f32: launches {f32_launches}, not {expect} of the f32 kernel")

            # the data packed into shards, then the .npz run again from them
            t0 = time.perf_counter()
            packed = pack_cli.main(["--data_dir", str(img_dir), "--out", str(tmp / "packed"),
                                    "--image_size", str(size)])
            print(f"[8] cli.pack_data: {packed}, {time.perf_counter() - t0:.3f} s", flush=True)
            data[1] = str(tmp / "packed")
            blob, _ = evaluate("evaluate --checkpoint int8.npz from the packed shards",
                               tmp / "packed_run", "--checkpoint", str(npz), *quick)
            same = blob["per_sample"] == blob_npz["per_sample"]
            print(f"[8] packed and PNG runs equal per sample: {same}", flush=True)
            check(same, "the packed and the PNG run gave other metrics")
    finally:
        metrics_pkg.frechet_distance = fid_module.frechet_distance = real_fd
    inception_s = [t for dim, t in fd_seconds if dim == 2048]
    print(f"[8] frechet_distance on the host, s: at 2048^2 (Inception) "
          + ", ".join(f"{t:.3f}" for t in inception_s) + "; at 256^2 (proxy) "
          + ", ".join(f"{t:.3f}" for dim, t in fd_seconds if dim != 2048)
          + f"; phase wall {time.perf_counter() - t_phase:.1f} s, of it "
          f"{sum(inception_s):.1f} s in the 2048^2 calls; {smi}", flush=True)
    return f32_launches.get("attention.f32", 0)


def phase_sampling(torch, np, ckpt, n_attn, smi):
    """Phase 9: the rest of sampling at full width on phase 3's pipeline and
    inputs (the same seeds give the same model): the new presets, classifier
    and classifier-free guidance, a trajectory, each new method's kernel
    against plain attention, then `cli.generate`, `cli.visualize_noise` and
    `cli.evaluate --save_trajectory`. Returns the bf16 attention launches of
    the phase's kernel-path calls."""
    from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.cli import evaluate as evaluate_cli
    from fidm_tpu_torch.cli import generate as generate_cli
    from fidm_tpu_torch.cli import visualize_noise as noise_cli
    from fidm_tpu_torch.diffusion import DiffusionSchedule, get_named_beta_schedule
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.ops import LAUNCHES, kernel_override
    from fidm_tpu_torch.sampling import GeneratorNoise, classifier_free, inpaint_sample
    from fidm_tpu_torch.sampling.sampler import _method_tables

    t_phase = time.perf_counter()
    config = PipelineConfig()
    size = config.unet.image_size
    pipe = InpaintingPipeline.create(config, seed=0, device="cuda")
    redraw_zero_convs(torch, pipe.model, seed=1)
    gt, mask = main_inputs(torch, size)
    keep = mask[..., 0] < 0.5
    total = collections.Counter()

    def run(label, cfg, call, evals=None):
        """One timed call; gates its images and its attention launches, 4
        per model evaluation of the host tables (or `evals`)."""
        if evals is None:
            evals = preset_steps(pipe.sched, cfg)[0]
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        images = out[0] if isinstance(out, tuple) else out
        print(f"[9] {label} B={BATCH}: {secs:.4f} s per call, {secs / BATCH:.4f} s per sample, "
              f"{evals} model evaluations; launches {launches}; {smi}", flush=True)
        expect = n_attn * evals
        check(launches == {"attention": expect, "attention.bf16": expect},
              f"[9] {label}: launches {launches}, not {expect} of the bf16 kernel")
        check_images(torch, f"[9] {label}", images, gt, keep)
        return out, secs

    # the other methods' presets, at their full step counts
    outs = {}
    for name in ("ddpm-100", "dpm3-20", "unipc-20", "consistency-2", "repaint-100-light"):
        cfg = SAMPLER_PRESETS[name]
        outs[name], _ = run(name, cfg, lambda: pipe.inpaint(gt, mask, 0, sampler=cfg))
    rows = len(_method_tables(pipe.sched, SAMPLER_PRESETS["repaint-100-light"])["t"])
    print(f"[9] repaint-100-light: {rows} table rows, "
          f"{preset_steps(pipe.sched, SAMPLER_PRESETS['repaint-100-light'])[0]} of them "
          f"denoise rows that run the model", flush=True)

    # classifier guidance: a closed-form gradient with DDIM, and one that
    # autograd takes through `inpaint` (which then samples under no_grad)
    ddim30 = SAMPLER_PRESETS["ddim-30"]
    plain30, _ = run("ddim-30", ddim30, lambda: pipe.inpaint(gt, mask, 0, sampler=ddim30))
    guided, _ = run("ddim-30 with a closed-form cond_fn", ddim30,
                    lambda: pipe.inpaint(gt, mask, 0, sampler=ddim30,
                                         cond_fn=lambda x, t: 0.1 * (0.25 - x)))
    moved = (guided - plain30).abs()[~keep].mean().item()
    print(f"[9] ddim-30 guided against unguided, hole mean abs {moved:.4g}", flush=True)
    check(moved > 1e-3, "[9] the closed-form cond_fn did not move the image")
    target = torch.linspace(-0.5, 0.5, size, device="cuda")[None, :, None, None]

    def autograd_cond_fn(x, t):
        logp = -0.05 * ((x - target) ** 2).sum()
        return torch.autograd.grad(logp, x)[0]

    probe = torch.randn(gt.shape, device="cuda", requires_grad=True)
    err = (autograd_cond_fn(probe, None) + 0.1 * (probe - target)).abs().max().item()
    print(f"[9] autograd cond_fn against its closed form on a probe: max abs {err:.3g}",
          flush=True)
    check(err <= 1e-6, "[9] the autograd cond_fn's gradient is wrong")
    ddpm100 = SAMPLER_PRESETS["ddpm-100"]
    run("ddpm-100 with an autograd cond_fn", ddpm100,
        lambda: pipe.inpaint(gt, mask, 0, sampler=ddpm100, cond_fn=autograd_cond_fn))

    # classifier-free guidance at scale 3 on a class-conditional model: one
    # model call of batch 8 per step
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(2)
        cond_model = InpaintingUNet(dataclasses.replace(config.unet, num_classes=11))
    cond_model = cond_model.to("cuda").eval().requires_grad_(False)
    redraw_zero_convs(torch, cond_model, seed=3)
    batches = []

    def labelled(x, t, mi, m, y):
        batches.append(x.shape[0])
        return cond_model(x, t, mi, m, y)

    guide = classifier_free(labelled, y=torch.arange(BATCH, device="cuda"), null_label=10,
                            scale=3.0)

    def cfg_call():
        with torch.inference_mode():
            return inpaint_sample(guide, pipe.sched, ddim30, gt=gt, mask=mask,
                                  noise=GeneratorNoise(0, "cuda"))

    run("ddim-30 with classifier_free (scale 3, 11 classes)", ddim30, cfg_call)
    check(set(batches) == {2 * BATCH}, f"[9] classifier_free model batches {set(batches)}")
    del cond_model

    # a trajectory: ddim-50, a frame every 10 steps
    traj_cfg = dataclasses.replace(SAMPLER_PRESETS["ddim-50"], trajectory_every=10)
    (out50, frames), _ = run("ddim-50 with trajectory_every=10", traj_cfg,
                             lambda: pipe.inpaint(gt, mask, 0, sampler=traj_cfg))
    K50 = preset_steps(pipe.sched, traj_cfg)[0]
    same = torch.equal(frames[-1][~keep], out50[~keep])
    print(f"[9] ddim-50 trajectory: frames {tuple(frames.shape)} {frames.dtype} for {K50} "
          f"steps; the last frame equals the output in the hole: {same}", flush=True)
    check(tuple(frames.shape) == ((K50 - 1) // 10 + 1,) + tuple(gt.shape)
          and frames.dtype == torch.float32, "[9] trajectory frames")
    check(same, "[9] the last frame differs from the output in the hole")

    # kernel against plain attention, a deterministic and a stochastic method
    for name in ("unipc-20", "ddpm-100"):
        before = LAUNCHES["attention"]
        with kernel_override(False, "attention"):
            plain = pipe.inpaint(gt, mask, 0, sampler=SAMPLER_PRESETS[name])
        check(LAUNCHES["attention"] == before, "the plain path launched the kernel")
        hole = (outs[name] - plain).abs()[~keep]
        print(f"[9] {name}, plain-attention path: images kernel vs plain in the hole: mean "
              f"abs {hole.mean().item():.4g} (tol {IMAGE_MEAN_TOL}, phase 4's bound), max "
              f"{hole.max().item():.4g}", flush=True)
        check(torch.equal(plain[keep], gt[keep]), f"[9] {name} plain path: known pixels")
        check(hole.mean().item() <= IMAGE_MEAN_TOL, f"[9] {name}: kernel and plain disagree")
    del pipe
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_sampling_") as tmp:
        tmp = Path(tmp)
        # cli.generate on a full-width 3-channel base UNet (6 out channels)
        args = generate_cli.parse_args([])
        base = generate_cli.build_model(args, "cuda")
        redraw_zero_convs(torch, base, seed=4)
        base_pt = tmp / "ffhq256_base.pt"
        torch.save({k: v.cpu() for k, v in base.state_dict().items()}, base_pt)
        del base
        lin = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device="cpu")
        for extra in (["--method", "dpm++3m", "--ddim_timesteps", "20"],
                      ["--method", "unipc", "--ddim_timesteps", "10"],
                      ["--method", "consistency"]):
            out_dir = tmp / f"gen_{extra[1]}"
            argv = ["--checkpoint", str(base_pt), "--num_samples", "8", "--batch_size", "4",
                    "--output_dir", str(out_dir), *extra]
            evals = preset_steps(lin, generate_cli.build_sampler(generate_cli.parse_args(argv)))[0]
            LAUNCHES.clear()
            t0 = time.perf_counter()
            n = generate_cli.main(argv)
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
            total.update(launches)
            files = sorted(p.name for p in out_dir.iterdir())
            print(f"[9] cli.generate {' '.join(extra)} (8 samples, batches of 4): {secs:.3f} s "
                  f"wall, {n} samples, {len(files)} files, {evals} model evaluations a batch; "
                  f"launches {launches}; {smi}", flush=True)
            expect = 2 * n_attn * evals
            check(files == [f"{i:05d}.png" for i in range(8)] + ["grid.png"],
                  f"[9] cli.generate wrote {files}")
            check(launches == {"attention": expect, "attention.bf16": expect},
                  f"[9] cli.generate: launches {launches}, not {expect} of the bf16 kernel")

        # cli.visualize_noise: its SNR table, from the card's float32 alpha_bar
        t0 = time.perf_counter()
        snr = noise_cli.main(["--out", str(tmp / "noise"), "--device", "cuda"])
        worst = 0.0
        for name, table in snr.items():
            acp = np.cumprod(1.0 - get_named_beta_schedule(name, 1000))
            acp32 = acp.astype(np.float32).astype(np.float64)
            check(np.array_equal(table, acp32 / (1 - acp32)),
                  f"[9] visualize_noise: the {name} SNR is not the float32 alpha_bar's")
            worst = max(worst, float(np.max(np.abs(table / (acp / (1 - acp)) - 1))))
        grid = (tmp / "noise" / "noising_grid.png").exists()
        print(f"[9] cli.visualize_noise: {time.perf_counter() - t0:.3f} s; SNR tables of "
              f"{sorted(snr)} equal to the float64 host numbers of the float32 alpha_bar; "
              f"largest relative distance from the float64 alpha_bar's SNR {worst:.3g}; "
              f"noising_grid.png {grid}, schedule_curves.png "
              f"{(tmp / 'noise' / 'schedule_curves.png').exists()}", flush=True)
        check(grid, "[9] visualize_noise wrote no grid")

        # cli.evaluate --save_trajectory on 4 of phase 8's images
        img_dir, mask_root, _ = write_eval_tree(np, tmp / "eval", size, EVAL_BATCH, seed=5)
        out_dir = tmp / "eval_traj"
        LAUNCHES.clear()
        t0 = time.perf_counter()
        evaluate_cli.main(["--data_dir", str(img_dir), "--mask_dir", str(mask_root),
                           "--output_dir", str(out_dir), "--checkpoint", str(ckpt),
                           "--preset", "ddim-30", "--num_samples", str(EVAL_BATCH),
                           "--batch_size", str(EVAL_BATCH), "--no_save_images",
                           "--save_trajectory", "10", "--device", "cuda"])
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        K30 = preset_steps(DiffusionSchedule.create("quadratic", 1000, device="cpu"), ddim30)[0]
        n_frames = (K30 - 1) // 10 + 1
        names = sorted(p.name for p in (out_dir / "trajectory").iterdir())
        from PIL import Image

        shapes = {np.asarray(Image.open(out_dir / "trajectory" / f)).shape for f in names}
        print(f"[9] cli.evaluate --preset ddim-30 --save_trajectory 10: {secs:.3f} s wall; "
              f"{names}, shapes {shapes}; launches {launches}", flush=True)
        check(names == [f"{i:05d}_strip.png" for i in range(EVAL_BATCH)],
              f"[9] trajectory files {names}")
        check(shapes == {(size, (n_frames + 2) * size, 3)}, f"[9] strip shapes {shapes}")
        check(launches == {"attention": n_attn * K30, "attention.bf16": n_attn * K30},
              f"[9] evaluate --save_trajectory: launches {launches}")
    print(f"[9] phase wall {time.perf_counter() - t_phase:.1f} s; bf16 attention launches "
          f"{total['attention.bf16']}; {smi}", flush=True)
    return total["attention.bf16"]


# Phase 10, training at full width from phase 5's `.pt`, batch 4. cli.train
# runs on 8 training and 4 validation PNGs: 2 train steps and 1 validation
# batch an epoch, 2 epochs, then a resumed third.
TRAIN_IMAGES = 8
VAL_IMAGES = 4
TRAIN_EPOCHS = 2
# The keys of each entry of the JAX CLI's history.json (`fidm_tpu/training/loop.py`).
HISTORY_KEYS = {"epoch", "train_loss", "val_loss", "seconds"}
# One train step from the same state and draws, the attention kernel against
# the plain version forced (in both the backward is the plain version's: only
# the forward differs, by the bf16 rounding of the attention logits that
# moves one forward's output by 2e-2 of its max, phase 4). The loss is a mean
# over 786432 squared errors and the gradient norm a norm over 93.6M
# gradients, so both move far less than the largest output element; each is
# held to the forward's own bound of 5e-2, relative.
TRAIN_KERNEL_TOL = 5e-2
# Remat "full" and "convs" against none on the same state and draws: the
# recompute runs the same kernels on the same tensors, and only the order of
# the backward's sums may differ (cuDNN's weight gradients), relative.
REMAT_TOL = 1e-3


def write_train_tree(np, root, size):
    """TRAIN_IMAGES and VAL_IMAGES seeded PNGs (`write_eval_tree`'s) and a
    mask root with train/, val/ and test/ dirs of the same box and brush
    masks. Returns (train dir, val dir, mask root, the masks)."""
    import shutil

    train_dir, mask_root, masks = write_eval_tree(np, root / "train", size, TRAIN_IMAGES, seed=11)
    val_dir, _, _ = write_eval_tree(np, root / "val", size, VAL_IMAGES, seed=12)
    for split in ("train", "val"):
        shutil.copytree(mask_root / "test", mask_root / split)
    return train_dir, val_dir, mask_root, masks


def phase_training(torch, np, ckpt, n_attn, smi):
    """Phase 10: training at full width. `cli.train` from phase 5's `.pt`
    (2 epochs with an EMA, then `--resume latest` for a third), one train
    step with the kernel against the plain attention, the three remat
    policies, a LoRA run on procedural masks, and the checkpoint directories
    read back by `cli.evaluate` and `cli.generate`. Returns the bf16
    attention launches of the phase's kernel-path calls."""
    import contextlib

    import fidm_tpu_torch.training as training_pkg
    from fidm_tpu_torch.cli import evaluate as evaluate_cli
    from fidm_tpu_torch.cli import generate as generate_cli
    from fidm_tpu_torch.cli import train as train_cli
    from fidm_tpu_torch.data import create_inpainting_dataloaders
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.lora import merge_lora, select_lora_targets
    from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
    from fidm_tpu_torch.models.weights import load_adm_checkpoint, torch_key_map
    from fidm_tpu_torch.ops import LAUNCHES, kernel_override, qkv_attention
    from fidm_tpu_torch.ops.attention import _attention_reference
    from fidm_tpu_torch.training import (TrainState, make_lr_schedule, make_optimizer,
                                         make_train_step)

    t_phase = time.perf_counter()
    cfg = ffhq256_config()
    size = cfg.image_size
    total = collections.Counter()
    base_sd = load_adm_checkpoint(str(ckpt), cfg)

    # the attention op under autograd: the forward launches the kernel, the
    # backward recomputes the plain version (no launch) and differentiates it
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    shape = (BATCH, 8, 256, 64)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    up = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    LAUNCHES.clear()
    out = qkv_attention(q, k, v)
    fwd = LAUNCHES["attention.bf16"]
    grads = torch.autograd.grad(out, (q, k, v), up)
    torch.cuda.synchronize()
    bwd = LAUNCHES["attention.bf16"] - fwd
    refs = [a.detach().requires_grad_() for a in (q, k, v)]
    ref_grads = torch.autograd.grad(_attention_reference(*refs), refs, up)
    gaps = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in zip(grads, ref_grads)]
    print(f"[10] attention under autograd {list(shape)} bf16: forward kernel launches {fwd}, "
          f"backward launches {bwd}; dq, dk, dv against the plain version's autograd, max abs "
          f"/ max: {', '.join(f'{e:.3g}' for e in gaps)} (tol 2^-8: the same plain ops)",
          flush=True)
    check(fwd == 1 and bwd == 0, f"[10] attention launches forward {fwd}, backward {bwd}")
    check(max(gaps) <= 2.0 ** -8, "[10] the attention backward is not the plain version's")
    del q, k, v, up, out, grads, refs, ref_grads

    # cli.train's steps and saves, recorded where the CLI looks them up
    record = {"steps": [], "saves": [], "state": None, "initial": None}
    real_make, real_mgr = training_pkg.make_train_step, training_pkg.CheckpointManager

    def recording_make(*args, **kw):
        step = real_make(*args, **kw)

        def recorded(state, batch, draws):
            if record["state"] is None:
                record["state"] = state
                record["initial"] = {k: t.detach().clone() for k, t in state.params.items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, batch, draws)
            end.record()
            end.synchronize()
            record["steps"].append((float(metrics["loss"]), start.elapsed_time(end),
                                    (time.perf_counter() - t0) * 1e3))
            return state, metrics

        return recorded

    class TimedManager(real_mgr):
        def save(self, *args, **kw):
            t0 = time.perf_counter()
            result = super().save(*args, **kw)
            record["saves"].append(time.perf_counter() - t0)
            return result

    def cli_train(label, argv, n_epochs):
        record.update(steps=[], saves=[], state=None, initial=None)
        LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        steps = record["steps"]
        n_train, n_val = n_epochs * per_epoch[0], n_epochs * per_epoch[1]
        ev = [s[1] for s in steps[1:]]
        host = [s[2] for s in steps[1:]]
        ms = float(np.mean(ev)) if ev else float("nan")
        print(f"[10] {label}: {secs:.3f} s wall, {len(steps)} train steps, losses "
              f"{[round(s[0], 5) for s in steps]}; after the first step {ms:.3f} ms per step "
              f"by CUDA events ({', '.join(f'{x:.3f}' for x in ev)}), "
              f"{float(np.mean(host)) if host else float('nan'):.3f} ms by host clock, "
              f"{BATCH / ms * 1e3:.2f} training images/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; checkpoint saves "
              f"{', '.join(f'{x:.3f}' for x in record['saves'])} s; launches {launches}; "
              f"history {[{k: h[k] for k in ('epoch', 'train_loss', 'val_loss')} for h in history]}"
              f"; {smi}", flush=True)
        check(len(steps) == n_train, f"[10] {label}: {len(steps)} train steps, not {n_train}")
        check(all(np.isfinite(s[0]) for s in steps), f"[10] {label}: a non-finite loss")
        expect = n_attn * (n_train + n_val)
        check(launches == {"attention": expect, "attention.bf16": expect},
              f"[10] {label}: launches {launches}, not {n_attn} x ({n_train} train + "
              f"{n_val} validation forwards) of the bf16 kernel")
        check(all(set(h) == HISTORY_KEYS for h in history),
              f"[10] {label}: history keys {[sorted(h) for h in history]}")
        return history

    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        train_dir, val_dir, mask_root, masks = write_train_tree(np, tmp / "data", size)
        # train steps and validation batches an epoch, from the CLI's loaders
        per_epoch = tuple(len(ld) for ld in create_inpainting_dataloaders(
            train_dir, val_dir, mask_root, batch_size=BATCH, img_size=size))
        common = ["--train_dir", str(train_dir), "--val_dir", str(val_dir), "--pretrained",
                  str(ckpt), "--batch_size", str(BATCH), "--device", "cuda"]
        ck, lora_ck = tmp / "ck", tmp / "lora"
        training_pkg.make_train_step, training_pkg.CheckpointManager = recording_make, TimedManager
        try:
            # 1. cli.train, 2 epochs with an EMA, then resumed for a third
            argv = common + ["--mask_dir", str(mask_root), "--checkpoint_dir", str(ck),
                             "--ema_decay", "0.999"]
            history = cli_train("cli.train, 2 epochs, --ema_decay 0.999",
                                argv + ["--num_epochs", str(TRAIN_EPOCHS)], TRAIN_EPOCHS)
            layout = sorted(p.name for p in ck.iterdir())
            steps = sorted(p.name for p in (ck / "steps").iterdir())
            best = json.loads((ck / "best.json").read_text())
            print(f"[10] checkpoint dir: {layout}, steps {steps}, best.json {best}", flush=True)
            check([h["epoch"] for h in history] == [0, 1], f"[10] epochs {history}")
            check(steps == ["0", "1"] and (ck / "best" / "state.pt").exists()
                  and {"mean_type", "epoch", "val_loss", "step"} <= set(best),
                  f"[10] checkpoint layout {layout}, steps {steps}, best.json {best}")
            resumed = cli_train("cli.train --resume latest, to 3 epochs",
                                argv + ["--num_epochs", str(TRAIN_EPOCHS + 1), "--resume",
                                        "latest"], 1)
            check([h["epoch"] for h in resumed] == [TRAIN_EPOCHS],
                  f"[10] the resumed run's epochs {[h['epoch'] for h in resumed]}")

            # 4. LoRA rank 8, one epoch, on procedural masks
            cli_train("cli.train --lora_rank 8, 1 epoch, procedural masks",
                      common + ["--checkpoint_dir", str(lora_ck), "--lora_rank", "8",
                                "--num_epochs", "1"], 1)
        finally:
            training_pkg.make_train_step, training_pkg.CheckpointManager = real_make, real_mgr
        lora_state, lora0 = record["state"], record["initial"]
        base_now = {k: t.cpu() for k, t in lora_state.model.state_dict().items()}
        saved_base = torch.load(lora_ck / "lora_base" / "state.pt", weights_only=True)
        merged0 = merge_lora(base_sd, {k: t.cpu() for k, t in lora0.items()}, cfg)
        trained = train_cli.load_checkpoint_params(str(lora_ck), "latest", False, cfg)
        prefixes = {p for fp, p, kind in torch_key_map(cfg)
                    if "/".join(("base",) + fp) in set(select_lora_targets(cfg))}
        moved = sorted(k for k in base_sd if not torch.equal(trained[k], base_sd[k]))
        print(f"[10] LoRA: {len(lora0)} adapter tensors on {len(prefixes)} layers; the base "
              f"after training bit-equal to the .pt: "
              f"{all(torch.equal(base_now[k], base_sd[k]) for k in base_sd)}; lora_base/ "
              f"bit-equal: {all(torch.equal(saved_base[k], base_sd[k]) for k in base_sd)}; "
              f"merged at step 0 bit-equal to the base: "
              f"{all(torch.equal(merged0[k], base_sd[k]) for k in base_sd)}; weights the "
              f"trained adapter moves: {len(moved)}", flush=True)
        check(all(torch.equal(base_now[k], base_sd[k]) for k in base_sd),
              "[10] LoRA training changed the frozen base")
        check(all(torch.equal(saved_base[k], base_sd[k]) for k in base_sd),
              "[10] lora_base/ is not the base")
        check(all(torch.equal(merged0[k], base_sd[k]) for k in base_sd),
              "[10] the merged model at step 0 is not the base")
        check(moved and set(moved) == {f"{p}.weight" for p in prefixes},
              f"[10] the trained adapter moved {moved}, not the target weights")
        del lora_state, record["state"]

        # 5. the checkpoint directories read back: cli.evaluate (EMA; LoRA)
        # and cli.generate (the 9-channel model with full-hole conditioning)
        for label, ck_dir, extra in (("--use_ema", ck, ["--use_ema"]), ("LoRA", lora_ck, [])):
            out_dir = tmp / f"eval_{label.strip('-')}"
            argv = ["--data_dir", str(val_dir), "--mask_dir", str(mask_root), "--output_dir",
                    str(out_dir), "--checkpoint", str(ck_dir), "--num_samples", str(VAL_IMAGES),
                    "--batch_size", str(BATCH), "--ddim_timesteps", str(QUICK_STEPS),
                    "--device", "cuda", *extra]
            sched_q = DiffusionSchedule.create("quadratic", 1000, device="cpu")
            K = preset_steps(sched_q, evaluate_cli.build_sampler(evaluate_cli.parse_args(argv)))[0]
            LAUNCHES.clear()
            t0 = time.perf_counter()
            evaluate_cli.main(argv)
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
            total.update(launches)
            blob = json.loads((out_dir / "metrics.json").read_text())
            print(f"[10] cli.evaluate --checkpoint DIR {label}, {VAL_IMAGES} images, {K} steps: "
                  f"{secs:.3f} s wall; ssim {blob['ssim_mean']:.4f}, psnr "
                  f"{blob['psnr_mean']:.3f}; launches {launches}", flush=True)
            check_eval_blob(np, f"[10] evaluate {label}", blob, EVAL_KEYS, EVAL_PER_SAMPLE,
                            masks, VAL_IMAGES)
            check_known_pixels(np, f"[10] evaluate {label}", out_dir, masks, VAL_IMAGES)
            check(launches == {"attention": n_attn * K, "attention.bf16": n_attn * K},
                  f"[10] evaluate {label}: launches {launches}, not {n_attn} x {K}")
        gen_dir = tmp / "gen"
        argv = ["--checkpoint", str(ck), "--use_ema", "--num_samples", str(BATCH),
                "--batch_size", str(BATCH), "--method", "ddim", "--ddim_timesteps",
                str(QUICK_STEPS), "--schedule", "quadratic", "--output_dir", str(gen_dir),
                "--device", "cuda"]
        sched_q = DiffusionSchedule.create("quadratic", 1000, device="cpu")
        evals = preset_steps(sched_q, generate_cli.build_sampler(generate_cli.parse_args(argv)))[0]
        LAUNCHES.clear()
        t0 = time.perf_counter()
        n = generate_cli.main(argv)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        files = sorted(p.name for p in gen_dir.iterdir())
        from PIL import Image

        imgs = [np.asarray(Image.open(gen_dir / f"{i:05d}.png")) for i in range(BATCH)]
        print(f"[10] cli.generate --checkpoint DIR --use_ema (the 9-channel model, full-hole "
              f"conditioning): {secs:.3f} s wall, {n} samples, {files}, {evals} model "
              f"evaluations; launches {launches}", flush=True)
        check(files == [f"{i:05d}.png" for i in range(BATCH)] + ["grid.png"],
              f"[10] cli.generate wrote {files}")
        check(all(im.shape == (size, size, 3) and im.std() > 0 for im in imgs),
              "[10] cli.generate: a flat or misshapen image")
        check(launches == {"attention": n_attn * evals, "attention.bf16": n_attn * evals},
              f"[10] cli.generate: launches {launches}, not {n_attn} x {evals}")

        # 2-3. one train step from one state and draws: the kernel against
        # the plain attention, and the three remat policies
        model = InpaintingUNet(cfg)
        model.load_state_dict(base_sd, strict=True)
        model = model.to("cuda")
        sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
        loader, _ = create_inpainting_dataloaders(train_dir, val_dir, mask_root,
                                                  batch_size=BATCH, img_size=size, seed=0)
        batch = next(iter(loader))
        step_fn = make_train_step(sched)

        def fresh_state(policy):
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(base_sd[name])
            model.config = dataclasses.replace(cfg, remat=policy != "none",
                                               remat_policy=policy if policy != "none" else "full")
            return TrainState.create(model, dict(model.named_parameters()),
                                     make_optimizer(make_lr_schedule("none", 5e-5, 1)))

        def one_step(policy, plain=False):
            state = fresh_state(policy)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()

            def ctx():
                return kernel_override(False, "attention") if plain else contextlib.nullcontext()

            with ctx():
                _, metrics = step_fn(state, batch, 0)
            metrics = {k: float(m) for k, m in metrics.items()}
            launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
            peak = torch.cuda.max_memory_allocated()
            with ctx():
                ms = cuda_ms(torch, lambda: step_fn(state, batch, 0), budget_ms=300.0)
            del state
            return metrics, launches, peak, ms

        results = {}
        for policy in ("none", "convs", "full"):
            results[policy] = one_step(policy)
            total.update(results[policy][1])
        # where a step's time goes: device busy against the step, by kernel
        state = fresh_state("none")
        before = LAUNCHES["attention.bf16"]
        profile_forward(torch, f"[10] one train step B={BATCH} (no remat)",
                        lambda: step_fn(state, batch, 0))
        total["attention.bf16"] += LAUNCHES["attention.bf16"] - before
        del state
        plain_metrics, plain_launches, _, plain_ms = one_step("none", plain=True)
        # the kernel path timed again after the others: the first step timed
        # in a process pays for the allocator's growth and cuDNN's choices
        again = one_step("none")
        total.update(again[1])
        again_ms = again[3]
        model.config = cfg

        def rel(a, b):
            return abs(a - b) / abs(b)

        km = results["none"][0]
        print(f"[10] one train step B={BATCH}, kernel vs plain attention: loss {km['loss']:.6f} / "
              f"{plain_metrics['loss']:.6f} (rel {rel(km['loss'], plain_metrics['loss']):.3g}), "
              f"grad_norm {km['grad_norm']:.6f} / {plain_metrics['grad_norm']:.6f} (rel "
              f"{rel(km['grad_norm'], plain_metrics['grad_norm']):.3g}), tol "
              f"{TRAIN_KERNEL_TOL}; launches {results['none'][1]} / {plain_launches}; "
              f"{results['none'][3]:.3f} (timed first; {again_ms:.3f} timed last) / "
              f"{plain_ms:.3f} ms per step; {smi}", flush=True)
        check(plain_launches == {}, "[10] the plain train step launched the kernel")
        check(results["none"][1] == {"attention": n_attn, "attention.bf16": n_attn},
              f"[10] a train step launched {results['none'][1]}, not {n_attn} forwards and a "
              f"plain backward")
        check(rel(km["loss"], plain_metrics["loss"]) <= TRAIN_KERNEL_TOL
              and rel(km["grad_norm"], plain_metrics["grad_norm"]) <= TRAIN_KERNEL_TOL,
              "[10] train step: kernel and plain attention disagree")
        for policy in ("none", "convs", "full"):
            m, launches, peak, ms = results[policy]
            print(f"[10] remat {policy}: loss {m['loss']:.6f} (rel {rel(m['loss'], km['loss']):.3g}"
                  f"), grad_norm {m['grad_norm']:.6f} (rel "
                  f"{rel(m['grad_norm'], km['grad_norm']):.3g}), tol {REMAT_TOL}; launches "
                  f"{launches}; peak device memory {peak / 2**30:.3f} GiB; {ms:.3f} ms per step "
                  f"by CUDA events; {smi}", flush=True)
            check(rel(m["loss"], km["loss"]) <= REMAT_TOL
                  and rel(m["grad_norm"], km["grad_norm"]) <= REMAT_TOL,
                  f"[10] remat {policy} moved the loss or the gradient norm")
            # the forward, and under remat each attention block once more in
            # the backward's recompute
            expect = n_attn * (1 if policy == "none" else 2)
            check(launches == {"attention": expect, "attention.bf16": expect},
                  f"[10] remat {policy}: launches {launches}, not {expect}")
        check(results["full"][2] < results["none"][2],
              "[10] remat full did not lower the peak memory")
        del model
        torch.cuda.empty_cache()
    print(f"[10] phase wall {time.perf_counter() - t_phase:.1f} s; bf16 attention launches "
          f"{total['attention.bf16']}; {smi}", flush=True)
    return total["attention.bf16"]


def program_memory(torch, build):
    """(result of `build()`, device bytes it left reserved): the caching
    allocator's reserve after `empty_cache`, before and after."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    result = build()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return result, torch.cuda.memory_reserved() - before


def fill_seconds(torch, program, seed):
    """Host seconds of a program call's buffer fill alone: every draw's
    buffer filled from `GeneratorNoise(seed)`, as the call does it."""
    from fidm_tpu_torch.sampling import GeneratorNoise

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        noise = GeneratorNoise(seed, program.device)
        for (stream, index), buf in program.draws.items():
            noise.fill(stream, index, buf)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs


def launches_of(fn):
    """(fn(), the kernel launches it counted), LAUNCHES left running."""
    from fidm_tpu_torch.ops import LAUNCHES

    before = collections.Counter(LAUNCHES)
    result = fn()
    diff = collections.Counter(LAUNCHES)
    diff.subtract(before)
    return result, {k: v for k, v in sorted(diff.items()) if v}


def phase_programs(torch, np, ckpt, n_attn, refs, serving6, smi):
    """Phase 11: the warm program cache at full width, on phase 3's model
    (phase 5's `.pt`) and inputs, both TF32 switches off. `refs` holds eager
    outputs and seconds of earlier phases: phase 3's DDIM-100 and
    `dpm-25-sde` at batch 4 with seed 0, phase 7's `ddim-100-deep` at batch
    16 with seed 1 (bench.py's cell; its `ddim-100` there is not replayed:
    a cut of depth, as PROGRAM_BATCHES). `serving6` is phase 6's warm-up
    seconds and instrumented batch of 8. Returns the bf16 attention launches
    of the phase's replays and calls."""
    from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.cli import evaluate as evaluate_cli
    from fidm_tpu_torch.cli import serve as serve_cli
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.models.weights import load_adm_checkpoint
    from fidm_tpu_torch.ops import LAUNCHES
    from fidm_tpu_torch.serving import aot, serve

    t_phase = time.perf_counter()
    launched = LAUNCHES["attention.bf16"]
    config = PipelineConfig()
    size = config.unet.image_size
    pipe = InpaintingPipeline.create(config, checkpoint=str(ckpt), device="cuda")
    gt, mask = main_inputs(torch, size)
    keep = mask[..., 0] < 0.5

    # --- the pipeline's programs: batch 4, one seed and per-row seeds
    def program_run(label, name, gt, mask, keep, seed, ref, eager_s, expect):
        """Build, install and call the program of (preset, batch, seed
        layout), held to the eager call `ref` (run here when None); then
        uninstall it and return it."""
        cfg = SAMPLER_PRESETS[name]
        batch, batched = gt.shape[0], not isinstance(seed, int)
        if ref is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = pipe.inpaint(gt, mask, seed, sampler=cfg)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
        program, held = program_memory(
            torch, lambda: pipe.compile_batch(batch, cfg, batched_key=batched))
        check(isinstance(program.graph, torch.cuda.CUDAGraph),
              f"{label}: the program holds no captured CUDA graph")
        pipe.install_program(batch, cfg, program, batched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = launches_of(lambda: pipe.inpaint(gt, mask, seed, sampler=cfg))
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        fill_s = fill_seconds(torch, program, seed)
        same = torch.equal(out.cpu(), ref.cpu())
        print(f"{label}: replay {call_s:.4f} s per call ({call_s / batch:.4f} s per sample), "
              f"eager {eager_s:.4f} s ({eager_s / batch:.4f}); recording run "
              f"{program.record_s:.3f} s, capture {program.capture_s:.3f} s; the call on the "
              f"host: buffer fill {fill_s * 1e3:.2f} ms (timed alone), the replay's launch and "
              f"the rest {(host_s - fill_s) * 1e3:.2f} ms, then the device's tail "
              f"{(call_s - host_s) * 1e3:.2f} ms; "
              f"{len(program.draws)} draws, static buffers {program.static_bytes} bytes, "
              f"device memory the program holds {held} bytes (graph pool about "
              f"{held - program.static_bytes}); launches per replay {launches} "
              f"(recorded {dict(program.launches)}); bit-equal to the eager call: {same}",
              flush=True)
        check(same, f"{label}: the replay differs from the eager call")
        check(launches.get("attention") == launches.get("attention.bf16") == expect,
              f"{label}: attention launches per replay {launches}, not {expect} of the bf16 "
              f"kernel")
        check_images(torch, label, out, gt, keep)
        pipe.uninstall_program(batch, cfg, batched)
        return program

    seeds = [10, 11, 12, 13]
    expect = {name: attention_per_call(pipe.sched, SAMPLER_PRESETS[name], n_attn)
              for name in ("ddim-100", "dpm-25-sde", "ddim-100-deep")}
    print(f"[11] programs: attention launches per call from the host tables {expect}; "
          f"{smi}", flush=True)
    (ref0, ddim_s), (ref_sde, sde_s) = refs["ddim-100"], refs["dpm-25-sde"]
    ddim_program = program_run(f"[11] ddim-100 B={BATCH} one seed", "ddim-100", gt, mask, keep,
                               0, ref0, ddim_s, expect["ddim-100"])
    # per-row seeds at batch 4 with dpm-25-sde only: a cut of depth that pays
    # for phase 14 (the server below replays ddim-100 with per-row seeds)
    program_run(f"[11] dpm-25-sde B={BATCH} one seed", "dpm-25-sde", gt, mask, keep, 0,
                ref_sde, sde_s, expect["dpm-25-sde"])
    program_run(f"[11] dpm-25-sde B={BATCH} per-row seeds", "dpm-25-sde", gt, mask, keep,
                seeds, None, None, expect["dpm-25-sde"])

    # one ddim-100 replay in the profiler: the kernel's own symbol, no softmax
    events = profiled_calls(torch, lambda: ddim_program(gt, mask, 0), 1, 3)
    if events is None:
        fail("[11] the profiler recorded no device operation of a ddim-100 replay in 3 "
             "sessions")
    names = collections.Counter()
    for e in events:
        names[e.key] += e.count
    attn = sum(n for k, n in names.items() if "attention_fwd_kernel" in k)
    softmax = sum(n for k, n in names.items() if "softmax" in k.lower())
    print(f"[11] torch.profiler over one ddim-100 replay: {sum(names.values())} device "
          f"operations, attention_fwd_kernel {attn} (kernels "
          f"{sorted({k[:60] for k in names if 'attention_fwd_kernel' in k})}), softmax "
          f"kernels {softmax}", flush=True)
    check(attn == expect["ddim-100"] and softmax == 0,
          f"[11] a ddim-100 replay ran {attn} attention kernels and {softmax} softmax "
          f"kernels, not {expect['ddim-100']} and 0")
    del ddim_program

    # bench.py's cell: batch 16, against phase 7's first timed call (seed 1)
    bgt, bmask = bench_inputs(torch, np, size)
    bkeep = bmask[..., 0] < 0.5
    for name in ("ddim-100-deep",):
        ref, secs = refs[f"bench {name}"]
        program_run(f"[11] {name} B={BENCH_BATCH} one seed (bench.py's cell)", name, bgt,
                    bmask, bkeep, 1, ref, secs, expect[name])
    del bgt, bmask

    # --- the server: phase 6's flags, presets and ladder, a program cache
    args = serve_cli.parse_args(["--checkpoint", str(ckpt)] + SERVE_ARGV
                                + ["--batch_sizes", *map(str, PROGRAM_BATCHES)])
    presets = serve_cli.build_presets(args)
    n_programs = len(presets) * len(PROGRAM_BATCHES)
    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_programs_") as cache:
        cache = Path(cache)

        def start(**kw):
            spipe = serve_cli.build_pipeline(args, presets)
            kw = {"max_wait_ms": args.max_wait_ms, **kw}
            t0 = time.perf_counter()
            (httpd, dispatcher), held = program_memory(torch, lambda: serve(
                spipe, args.host, args.port, args.batch_size,
                batch_sizes=tuple(args.batch_sizes), base_seed=args.base_seed, warmup=True,
                program_cache_dir=str(cache), presets=presets, **kw))
            return spipe, httpd, dispatcher, time.perf_counter() - t0, held

        def stamps():
            return {p.name: p.stat().st_mtime_ns for p in cache.glob("prog_b*.json")}

        def installed(spipe):
            return [p for p in (spipe.installed_program(b, cfg, True) for cfg in
                                presets.values() for b in PROGRAM_BATCHES) if p is not None]

        spipe, httpd, dispatcher, warm_s, held = start()
        httpd.server_close()
        dispatcher.close()
        written, programs = stamps(), installed(spipe)
        static = sum(p.static_bytes for p in programs)
        print(f"[11] serve(..., warmup=True, program_cache_dir=DIR) with phase 6's presets "
              f"{list(presets)} and batch sizes {PROGRAM_BATCHES}: warm-up {warm_s:.2f} s "
              f"(phase 6, eager: {serving6[0]:.2f} s); {len(written)} manifests written; "
              f"{len(programs)} programs installed, holding {held} bytes of device memory "
              f"({static} of it static buffers); {smi}", flush=True)
        check(len(written) == n_programs and len(programs) == n_programs,
              f"[11] {len(written)} manifests and {len(programs)} programs, not {n_programs}")
        del spipe, httpd, dispatcher, programs
        torch.cuda.empty_cache()

        # a restart on the same directory: every program built from its manifest
        spipe, httpd, dispatcher, warm2_s, held = start(
            instrument=True, adaptive_wait=False, max_wait_ms=500)
        try:
            n_installed = len(installed(spipe))
            print(f"[11] restart on the same directory: warm-up {warm2_s:.2f} s, manifests "
                  f"untouched: {stamps() == written}, {n_installed} programs installed, "
                  f"holding {held} bytes", flush=True)
            check(stamps() == written, "[11] the restarted server wrote manifests")
            check(n_installed == n_programs, f"[11] the restart installed {n_installed} programs")
            eager = InpaintingPipeline(spipe.model, spipe.sched, spipe.config)  # no program
            inputs = [request_inputs(np, j, size) for j in range(8)]
            futs = [dispatcher.submit(*inputs[j], seed=3000 + j, preset="dpm-25-sde")
                    for j in range(8)]
            outs = np.stack([f.result(timeout=300) for f in futs])
            snap8 = dispatcher.stats_snapshot()
            check(snap8["batches_by_size"][8] == 1, f"[11] batches {snap8['batches_by_size']}")
            requests = [("dpm-25-sde", list(range(8)), outs)]
            for j, name in enumerate(("ddim-100", "ddim-100-deep", "refine")):
                out = dispatcher.submit(*inputs[j], seed=3100 + j,
                                        preset=name).result(timeout=300)
                requests.append((name, [j], out[None]))
            for name, rows, got in requests:
                seeds_r = ([3000 + j for j in rows] if name == "dpm-25-sde"
                           else [3100 + rows[0]])
                ref = eager.inpaint(np.stack([inputs[j][0] for j in rows]),
                                    np.stack([inputs[j][1] for j in rows]), seeds_r,
                                    sampler=presets[name]).cpu().numpy()
                same = np.array_equal(got, ref)
                print(f"[11] {name} request(s) {rows}, batch of {len(rows)}: bit-equal to "
                      f"the eager pipeline at that batch size and seeds: {same}", flush=True)
                check(same, f"[11] a {name} reply differs from the eager call")
            print(f"[11] instrumented batch of 8, dpm-25-sde, replayed: {phases_line(snap8)} "
                  f"(phase 6, eager: {serving6[1]}); {smi}", flush=True)
        finally:
            httpd.server_close()
            dispatcher.close()

        # a corrupt manifest is removed, then written again
        path = Path(aot.program_path(str(cache), spipe, 1, presets["refine"], batched_key=True))
        path.write_text("{not json")
        fresh = InpaintingPipeline(spipe.model, spipe.sched, spipe.config)
        del spipe, httpd, dispatcher, eager
        torch.cuda.empty_cache()
        n_loaded = aot.load_programs(fresh, str(cache), [1], presets["refine"], batched_key=True)
        removed = not path.exists()
        n_saved = aot.save_programs(fresh, str(cache), [1], presets["refine"], batched_key=True)
        print(f"[11] corrupt manifest: loaded {n_loaded}, removed {removed}, then saved "
              f"{n_saved}, present again {path.exists()}", flush=True)
        check(n_loaded == 0 and removed and n_saved == 1 and path.exists(),
              "[11] the corrupt manifest was not healed")
        del fresh
        torch.cuda.empty_cache()

    # --- cli.evaluate --program_cache on phase 8's images, 10 steps
    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_programs_eval_") as tmp:
        tmp = Path(tmp)
        img_dir, mask_root, _ = write_eval_tree(np, tmp, size, EVAL_SAMPLES, seed=5)
        blobs = {}
        for label, extra in (("without the flag", []),
                             ("--program_cache DIR (written)", ["--program_cache",
                                                                str(tmp / "cache")]),
                             ("--program_cache DIR (loaded)", ["--program_cache",
                                                               str(tmp / "cache")])):
            out = tmp / f"run{len(blobs)}"
            t0 = time.perf_counter()
            results, launches = launches_of(lambda: evaluate_cli.main(
                ["--data_dir", str(img_dir), "--mask_dir", str(mask_root), "--device", "cuda",
                 "--checkpoint", str(ckpt), "--ddim_timesteps", str(QUICK_STEPS),
                 "--num_samples", str(EVAL_SAMPLES), "--batch_size", str(EVAL_BATCH),
                 "--no_save_images", "--output_dir", str(out), *extra]))
            secs = time.perf_counter() - t0
            with open(out / "metrics.json") as f:
                blob = json.load(f)
            for k in ("time_per_sample_s", "time_per_sample_steady_s"):
                blob.pop(k)
            blobs[label] = blob
            print(f"[11] cli.evaluate {label}, {EVAL_SAMPLES} images, {QUICK_STEPS} steps: "
                  f"{secs:.3f} s wall, time_per_sample_s {results['time_per_sample_s']:.6f}, "
                  f"steady {results['time_per_sample_steady_s']:.6f}; launches {launches}",
                  flush=True)
        plain = blobs.pop("without the flag")
        same = all(b == plain for b in blobs.values())
        print(f"[11] cli.evaluate: metrics.json with --program_cache equal to the run without "
              f"it (timings aside): {same}", flush=True)
        check(same, "[11] cli.evaluate --program_cache changed metrics.json")

    # --- cast_params(bf16): one forward against float32 parameters
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    x = torch.randn(gt.shape, device="cuda", generator=g)
    t = torch.full((BATCH,), 500, device="cuda", dtype=torch.int32)
    masked = gt * keep[..., None]
    cast = InpaintingPipeline.create(config, checkpoint=str(ckpt), device="cuda")
    cast.cast_params(torch.bfloat16)
    with torch.inference_mode():
        y32, y16 = pipe.model(x, t, masked, mask), cast.model(x, t, masked, mask)
    e_cast = ((y16 - y32).abs().max() / y32.abs().max()).item()
    bytes32 = sum(p.nbytes for p in pipe.model.parameters())
    bytes16 = sum(p.nbytes for p in cast.model.parameters())
    print(f"[11] cast_params(torch.bfloat16): parameters {bytes32} -> {bytes16} bytes; one "
          f"UNet forward against float32 parameters, max abs / max |float32|: {e_cast:.4g} "
          f"(tol {CAST_UNET_TOL}); output {y16.dtype}", flush=True)
    check(y16.dtype == torch.float32 and e_cast <= CAST_UNET_TOL,
          "[11] cast_params: the bf16-parameter forward moved too far")
    del cast

    # --- split_decoder_skips: one forward against the concatenating one
    state = load_adm_checkpoint(str(ckpt), config.unet)
    rows = []
    for dtype, tol in ((torch.float32, SPLIT_F32_TOL), (torch.bfloat16, SPLIT_BF16_TOL)):
        outs = {}
        for split in (False, True):
            unet = dataclasses.replace(config.unet, dtype=dtype, split_decoder_skips=split)
            model = InpaintingUNet(unet)
            model.load_state_dict(state, strict=True)
            model = model.to("cuda").eval()
            with torch.inference_mode():
                fn = lambda: model(x, t, masked, mask)  # noqa: E731
                ms = cuda_ms(torch, fn)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                outs[split] = fn()
                peak = torch.cuda.max_memory_allocated() - base
            rows.append(f"{str(dtype)[6:]} {'split' if split else 'concat'} {ms:.4f} ms, "
                        f"peak {peak / 2**20:.1f} MiB above the model")
            del model
        err = ((outs[True] - outs[False]).abs().max() / outs[False].abs().max()).item()
        print(f"[11] split_decoder_skips, {dtype}: one forward against the concatenating "
              f"one, max abs / max |concat|: {err:.4g} (tol {tol})", flush=True)
        check(err <= tol, f"[11] split_decoder_skips {dtype}: the forwards disagree")
    print(f"[11] forward B={BATCH}, CUDA events: {'; '.join(rows)}; {smi}", flush=True)
    del pipe
    torch.cuda.empty_cache()
    launched = LAUNCHES["attention.bf16"] - launched
    print(f"[11] phase wall {time.perf_counter() - t_phase:.1f} s; bf16 attention launches "
          f"{launched}", flush=True)
    return launched


# Phase 12, distillation at full width from phase 5's `.pt` on phase 10's 8
# training PNGs and masks, batch 4: `cli.distill` progressive (4 -> 2 -> 1,
# 2 steps a round), consistency distillation and consistency training (3
# steps each), the students read back, one step of each kind kernel against
# plain, and `cli.export_torch` of student_2/.
DISTILL_ROUND_STEPS = 2
CONSISTENCY_STEPS = 3
# Forwards per step of each kind, each with n_attn attention launches and
# none in its backward: progressive runs the teacher twice and the student
# once, consistency distillation the teacher, the target network and the
# student, consistency training the target network and the student.
DISTILL_FORWARDS = {"progressive": 3, "consistency": 3, "consistency-training": 2}
# One step of each kind from the same weights and draws, the attention
# kernel against the plain version forced: the forwards differ by the bf16
# rounding of the attention logits (2e-2 of a forward's max, phase 4), the
# teacher's and the target's reach the loss only through its target, the
# student's backward is the plain version's in both. The loss is a mean
# over 786432 weighted squared errors (progressive) or of 4 pseudo-Huber
# norms over 196608 errors each, the gradient norm a norm over 93.6M
# gradients: each held to the forward's own bound of 5e-2, relative, as [10]
# holds the train step.
DISTILL_KERNEL_TOL = 5e-2
# The JAX CLI's metadata keys (`fidm_tpu/cli/distill.py`).
STUDENT_META = {"student_steps", "mean_type", "schedule", "diffusion_steps", "timesteps_grid"}
CONSISTENCY_META = {"mode", "mean_type", "schedule", "diffusion_steps", "sampler_method"}


def phase_distill(torch, np, ckpt, n_attn, smi):
    """Phase 12: distillation at full width. `cli.distill` in its three
    modes from phase 5's `.pt`, every step's launches and loss gated, the
    student directories read by `cli.evaluate` and `cli.generate`, one step
    of each kind with the kernel against the plain attention (the teacher
    left as it was, the target network the EMA tensors), and
    `cli.export_torch` of student_2/ (bit-equal, its evaluate run equal to
    the directory's). Returns the bf16 attention launches of the phase's
    kernel-path calls."""
    import contextlib

    import fidm_tpu_torch.distill as distill_pkg
    import fidm_tpu_torch.training as training_pkg
    from fidm_tpu_torch.cli import distill as distill_cli
    from fidm_tpu_torch.cli import evaluate as evaluate_cli
    from fidm_tpu_torch.cli import export_torch as export_cli
    from fidm_tpu_torch.cli import generate as generate_cli
    from fidm_tpu_torch.data import create_inpainting_dataloaders
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.consistency import _at_params
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
    from fidm_tpu_torch.models.weights import load_adm_checkpoint
    from fidm_tpu_torch.ops import LAUNCHES, kernel_override
    from fidm_tpu_torch.training import (CheckpointManager, TrainState, init_ema,
                                         make_lr_schedule, make_optimizer)

    t_phase = time.perf_counter()
    cfg = ffhq256_config()
    size = cfg.image_size
    total = collections.Counter()
    sched_q = DiffusionSchedule.create("quadratic", 1000, device="cpu")

    # cli.distill's steps and saves, recorded where the CLI looks them up
    record = {"steps": [], "saves": []}
    real = (distill_pkg.make_distill_step, distill_pkg.make_consistency_step,
            training_pkg.CheckpointManager)

    def recording(make):
        def made(*args, **kw):
            step = make(*args, **kw)

            def recorded(state, teacher, batch, draws):
                before = LAUNCHES["attention.bf16"]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, metrics = step(state, teacher, batch, draws)
                end.record()
                end.synchronize()
                record["steps"].append((float(metrics["loss"]), start.elapsed_time(end),
                                        (time.perf_counter() - t0) * 1e3,
                                        LAUNCHES["attention.bf16"] - before))
                return state, metrics

            return recorded

        return made

    class TimedManager(real[2]):
        def save(self, *args, **kw):
            t0 = time.perf_counter()
            result = super().save(*args, **kw)
            record["saves"].append(time.perf_counter() - t0)
            return result

    def cli_distill(kind, argv, n_steps):
        record.update(steps=[], saves=[])
        LAUNCHES.clear()
        # what earlier phases left for the collector is not the CLI's
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        report = distill_cli.main(argv)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        steps = record["steps"]
        # after the first step: it pays for the allocator's growth and cuDNN's choices
        ev, host = [s[1] for s in steps[1:]], [s[2] for s in steps[1:]]
        ms = float(np.mean(ev)) if ev else float("nan")
        per_step = n_attn * DISTILL_FORWARDS[kind]
        print(f"[12] cli.distill --mode {kind}: {secs:.3f} s wall, {len(steps)} steps, losses "
              f"{[round(s[0], 5) for s in steps]}; after the first step {ms:.3f} ms per step by "
              f"CUDA events ({', '.join(f'{x:.3f}' for x in ev)}), "
              f"{float(np.mean(host)) if host else float('nan'):.3f} ms by host clock, "
              f"{BATCH / ms * 1e3:.2f} training images/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of it "
              f"{held / 2**30:.3f} GiB held before the call; checkpoint saves "
              f"{', '.join(f'{x:.3f}' for x in record['saves'])} s; attention launches per step "
              f"{[s[3] for s in steps]}; {smi}", flush=True)
        check(len(steps) == n_steps, f"[12] {kind}: {len(steps)} steps, not {n_steps}")
        check(all(np.isfinite(s[0]) for s in steps), f"[12] {kind}: a non-finite loss")
        check(all(s[3] == per_step for s in steps)
              and launches == {"attention": per_step * n_steps,
                               "attention.bf16": per_step * n_steps},
              f"[12] {kind}: launches {launches}, per step {[s[3] for s in steps]}, not "
              f"{n_attn} x {DISTILL_FORWARDS[kind]} forwards of the bf16 kernel and none in "
              f"a backward")
        return report

    def run_cli(label, main, argv, evals):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        result = main(argv)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in sorted(LAUNCHES.items()) if v}
        total.update(launches)
        print(f"[12] {label}: {secs:.3f} s wall, {evals} model evaluations; launches "
              f"{launches}", flush=True)
        check(launches == {"attention": n_attn * evals, "attention.bf16": n_attn * evals},
              f"[12] {label}: launches {launches}, not {n_attn} x {evals}")
        return result

    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_distill_") as tmp:
        tmp = Path(tmp)
        train_dir, val_dir, mask_root, masks = write_train_tree(np, tmp / "data", size)
        common = ["--train_dir", str(train_dir), "--mask_dir", str(mask_root), "--batch_size",
                  str(BATCH), "--device", "cuda"]
        out_p, out_c, out_t = tmp / "progressive", tmp / "consistency", tmp / "training"
        distill_pkg.make_distill_step = recording(real[0])
        distill_pkg.make_consistency_step = recording(real[1])
        training_pkg.CheckpointManager = TimedManager
        try:
            report = cli_distill("progressive", common + [
                "--checkpoint", str(ckpt), "--out", str(out_p), "--teacher_steps", "4",
                "--final_steps", "1", "--steps_per_round", str(DISTILL_ROUND_STEPS)],
                2 * DISTILL_ROUND_STEPS)
            rounds = [r["student_steps"] for r in report["rounds"]]
            check(rounds == [2, 1], f"[12] progressive rounds {rounds}")
            for r in report["rounds"]:
                K = r["student_steps"]
                sdir = out_p / f"student_{K}"
                grid = json.loads((sdir / "grid.json").read_text())
                meta = json.loads((sdir / "steps" / "0" / "meta.json").read_text())
                layout = (sorted(p.name for p in sdir.iterdir()),
                          sorted(p.name for p in (sdir / "steps" / "0").iterdir()))
                print(f"[12] student_{K}/: {layout}, grid.json {grid}, metadata {meta}",
                      flush=True)
                check(grid == {"grid": distill_cli.student_grid(1000, K),
                               "mean_type": "velocity"}
                      and all(np.diff(grid["grid"]) < 0) and r["grid"] == grid["grid"],
                      f"[12] student_{K}: grid {grid}")
                check(layout == (["grid.json", "steps"], ["meta.json", "state.pt"])
                      and set(meta) == STUDENT_META and meta["timesteps_grid"] == grid["grid"],
                      f"[12] student_{K}: layout {layout}, metadata {meta}")
            for kind, out, extra in (("consistency", out_c, ["--grid_size", "40"]),
                                     ("consistency-training", out_t, [])):
                report = cli_distill(kind, common + [
                    "--checkpoint", str(ckpt), "--mode", kind, "--out", str(out),
                    "--steps_per_round", str(CONSISTENCY_STEPS), *extra], CONSISTENCY_STEPS)
                meta = json.loads((out / "consistency" / "steps" / "0" / "meta.json").read_text())
                check(report["checkpoint"] == str(out / "consistency")
                      and set(meta) == CONSISTENCY_META and meta["mode"] == kind,
                      f"[12] {kind}: report {report}, metadata {meta}")
        finally:
            (distill_pkg.make_distill_step, distill_pkg.make_consistency_step,
             training_pkg.CheckpointManager) = real

        # the students read back: student_2/ on its grid, with the mean_type
        # its metadata records; consistency/ by the preset and by cli.generate
        grid = json.loads((out_p / "student_2" / "grid.json").read_text())["grid"]
        ev = ["--data_dir", str(val_dir), "--mask_dir", str(mask_root), "--num_samples",
              str(VAL_IMAGES), "--batch_size", str(BATCH), "--device", "cuda"]
        student_argv = ev + ["--checkpoint", str(out_p / "student_2"), "--output_dir",
                             str(tmp / "ev_student"), "--timesteps", *map(str, grid)]
        sampler = evaluate_cli.build_sampler(evaluate_cli.parse_args(student_argv))
        check(sampler.mean_type.name == "VELOCITY",
              f"[12] student_2's mean_type read as {sampler.mean_type}")
        K = preset_steps(sched_q, sampler)[0]
        run_cli(f"cli.evaluate on student_2/ --timesteps {grid}", evaluate_cli.main,
                student_argv, K)
        blob_dir = json.loads((tmp / "ev_student" / "metrics.json").read_text())
        check_eval_blob(np, "[12] evaluate student_2", blob_dir, EVAL_KEYS, EVAL_PER_SAMPLE,
                        masks, VAL_IMAGES)
        check_known_pixels(np, "[12] evaluate student_2", tmp / "ev_student", masks, VAL_IMAGES)
        preset_argv = ev + ["--checkpoint", str(out_c / "consistency"), "--output_dir",
                            str(tmp / "ev_consistency"), "--preset", "consistency-2"]
        K = preset_steps(sched_q, evaluate_cli.build_sampler(
            evaluate_cli.parse_args(preset_argv)))[0]
        run_cli("cli.evaluate --preset consistency-2 on consistency/", evaluate_cli.main,
                preset_argv, K)
        blob = json.loads((tmp / "ev_consistency" / "metrics.json").read_text())
        check_eval_blob(np, "[12] evaluate consistency-2", blob, EVAL_KEYS, EVAL_PER_SAMPLE,
                        masks, VAL_IMAGES)
        check_known_pixels(np, "[12] evaluate consistency-2", tmp / "ev_consistency", masks,
                           VAL_IMAGES)
        gen_dir = tmp / "gen"
        gen_argv = ["--checkpoint", str(out_t / "consistency"), "--method", "consistency",
                    "--num_samples", str(BATCH), "--batch_size", str(BATCH), "--output_dir",
                    str(gen_dir), "--device", "cuda"]
        K = preset_steps(sched_q, generate_cli.build_sampler(generate_cli.parse_args(gen_argv)))[0]
        run_cli("cli.generate --method consistency on consistency/ (consistency-training)",
                generate_cli.main, gen_argv, K)
        files = sorted(p.name for p in gen_dir.iterdir())
        check(files == [f"{i:05d}.png" for i in range(BATCH)] + ["grid.png"],
              f"[12] cli.generate wrote {files}")

        # cli.export_torch of student_2/: bit-equal to the directory's params,
        # loads with strict=True, and evaluates as the directory did
        pt = tmp / "student_2.pt"
        t0 = time.perf_counter()
        exported = export_cli.main(["--checkpoint", str(out_p / "student_2"), "--out", str(pt),
                                    "--attention_resolutions", "16", "--device", "cuda"])
        secs = time.perf_counter() - t0
        sd = torch.load(pt, weights_only=True)
        params = CheckpointManager(str(out_p / "student_2")).restore_params("latest")
        InpaintingUNet(cfg).load_state_dict(sd, strict=True)
        same = set(sd) == set(params) and all(torch.equal(sd[k], params[k]) for k in params)
        print(f"[12] cli.export_torch student_2/: {secs:.3f} s wall, report {exported}; loads "
              f"with strict=True; {len(sd)} tensors bit-equal to the directory's params: "
              f"{same}", flush=True)
        check(same and set(exported) == {"out", "bytes", "in_channels", "image_size"},
              "[12] the export differs from the directory's params")
        run_cli("cli.evaluate on the exported .pt", evaluate_cli.main,
                ev + ["--checkpoint", str(pt), "--output_dir", str(tmp / "ev_pt"), "--timesteps",
                      *map(str, grid), "--mean_type", "velocity"], preset_steps(sched_q, sampler)[0])
        blob_pt = json.loads((tmp / "ev_pt" / "metrics.json").read_text())
        same = blob_pt["per_sample"] == blob_dir["per_sample"]
        print(f"[12] the .pt's evaluate run equals student_2/'s per sample: {same}", flush=True)
        check(same, "[12] the exported .pt evaluates otherwise than its directory")

        # one step of each kind from the same weights and draws, the kernel
        # against the plain attention
        base_sd = load_adm_checkpoint(str(ckpt), cfg)
        student = InpaintingUNet(cfg)
        student.load_state_dict(base_sd, strict=True)
        student = student.to("cuda")
        teacher = InpaintingUNet(cfg)
        teacher.load_state_dict(base_sd, strict=True)
        teacher = teacher.to("cuda").requires_grad_(False)
        sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
        loader, _ = create_inpainting_dataloaders(train_dir, val_dir, mask_root,
                                                  batch_size=BATCH, img_size=size, seed=0)
        batch = next(iter(loader))
        steps = {"progressive": (make_distill_step(sched, unet_apply, unet_apply,
                                                   teacher_steps=4), teacher),
                 "consistency": (make_consistency_step(sched, unet_apply, unet_apply,
                                                       grid_size=40), teacher),
                 "consistency-training": (make_consistency_step(sched, None, unet_apply,
                                                                grid_size=40), None)}

        def one(kind, plain):
            step, teach = steps[kind]
            with torch.no_grad():
                for name, p in student.named_parameters():
                    p.copy_(base_sd[name])
            params = dict(student.named_parameters())
            state = TrainState.create(
                student, params, make_optimizer(make_lr_schedule("none", 1e-4, 1),
                                                weight_decay=0.0),
                ema_params=None if kind == "progressive" else init_ema(params))
            torch.cuda.synchronize()
            before = LAUNCHES["attention.bf16"]
            ctx = kernel_override(False, "attention") if plain else contextlib.nullcontext()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with ctx:
                state, metrics = step(state, teach, batch, 0)
            end.record()
            end.synchronize()
            launches = LAUNCHES["attention.bf16"] - before
            if not plain:
                total["attention.bf16"] += launches
            return ({k: float(m) for k, m in metrics.items()}, launches,
                    start.elapsed_time(end), state)

        def rel(a, b):
            return abs(a - b) / abs(b)

        for kind in steps:
            km, k_launches, k_ms, _ = one(kind, False)
            pm, p_launches, p_ms, state = one(kind, True)
            print(f"[12] one {kind} step B={BATCH}, kernel vs plain attention: loss "
                  f"{km['loss']:.6f} / {pm['loss']:.6f} (rel {rel(km['loss'], pm['loss']):.3g}), "
                  f"grad_norm {km['grad_norm']:.6f} / {pm['grad_norm']:.6f} (rel "
                  f"{rel(km['grad_norm'], pm['grad_norm']):.3g}), tol {DISTILL_KERNEL_TOL}; "
                  f"launches {k_launches} / {p_launches}; {k_ms:.3f} / {p_ms:.3f} ms (CUDA "
                  f"events, the first of each); {smi}", flush=True)
            check(k_launches == n_attn * DISTILL_FORWARDS[kind] and p_launches == 0,
                  f"[12] {kind} step: launches {k_launches} kernel, {p_launches} plain")
            check(rel(km["loss"], pm["loss"]) <= DISTILL_KERNEL_TOL
                  and rel(km["grad_norm"], pm["grad_norm"]) <= DISTILL_KERNEL_TOL,
                  f"[12] {kind} step: kernel and plain attention disagree")
            if state.ema_params is not None:
                # the target network is the student module at every EMA tensor
                target = InpaintingUNet(cfg).to("cuda")
                target.load_state_dict(state.ema_params, strict=True)
                x = torch.as_tensor(batch["image"], device="cuda")
                t = torch.full((BATCH,), 500, device="cuda", dtype=torch.int32)
                cond = (torch.as_tensor(batch["masked_image"], device="cuda"),
                        torch.as_tensor(batch["mask"], device="cuda"))
                before = LAUNCHES["attention.bf16"]
                with torch.inference_mode():
                    same = torch.equal(_at_params(unet_apply, student, state.ema_params, x, t,
                                                  *cond), target(x, t, *cond))
                total["attention.bf16"] += LAUNCHES["attention.bf16"] - before
                print(f"[12] {kind}: the target network's forward bit-equal to a module "
                      f"holding the EMA tensors: {same}", flush=True)
                check(same, f"[12] {kind}: the target network is not the EMA")
                del target
            del state
        moved = [k for k, p in teacher.named_parameters()
                 if not torch.equal(p, base_sd[k].to("cuda"))]
        print(f"[12] the frozen teacher after the progressive and consistency steps: "
              f"{len(moved)} tensors moved", flush=True)
        check(not moved, f"[12] the teacher moved: {moved[:5]}")
        del student, teacher
        torch.cuda.empty_cache()
    print(f"[12] phase wall {time.perf_counter() - t_phase:.1f} s; bf16 attention launches "
          f"{total['attention.bf16']}; {smi}", flush=True)
    return total["attention.bf16"]


PARALLEL_STEPS = 3     # phase 13's train steps with and without the one-rank mesh
PARALLEL_TIMED = 4     # then timed steps of each run (plain, mesh, plain again)
NATIVE_MASKS = 8       # masks of each kind per seed ladder in phase 13
MASK_COVERAGE = (0.01, 0.80)  # the JAX package's own bounds (tests/test_native.py)


def host_ms(fn, n):
    """Host milliseconds per call of `fn` over n calls (after one)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def phase_native(torch, np, train_dir, size, smi):
    """Phase 13's native half: both helper libraries built with g++ (maskgen
    must build; imgload wherever jpeglib.h and png.h are found), the fused
    normalize against numpy on a 256² batch of 4, native decode against PIL
    on phase 10's PNGs bit for bit, 256² masks of each kind, and the host
    times of each."""
    from PIL import Image

    from fidm_tpu_torch.data import random_mask
    from fidm_tpu_torch.data.dataset import _normalize_compose, list_images
    from fidm_tpu_torch.native import build as native_build
    from fidm_tpu_torch.native.imgload import decode_resize

    t0 = time.perf_counter()
    masklib, imglib = native_build.load(), native_build.load_imgload()
    secs = time.perf_counter() - t0
    headers = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                             input="#include <jpeglib.h>\n#include <png.h>\n",
                             capture_output=True, text=True).returncode == 0
    print(f"[13] native helpers: g++ {' '.join(native_build.CXX_FLAGS)}, {secs:.1f} s; maskgen "
          f"{native_build.lib_path('native').name if masklib else native_build.last_error()}; "
          f"jpeglib.h and png.h found: {headers}; imgload "
          f"{native_build.lib_path('imgload').name if imglib else native_build.last_error('imgload')}"
          f"; the dataset decodes "
          f"{'with the native loader' if imglib else 'with PIL, as fidm_tpu would here'}",
          flush=True)
    check(masklib is not None, f"[13] maskgen did not build: {native_build.last_error()}")
    check(imglib is not None or not headers,
          f"[13] imgload did not build with its headers present: "
          f"{native_build.last_error('imgload')}")

    # normalize and compose: the C++ helper against numpy, a 256² batch of 4
    rng = np.random.default_rng(13)
    u8 = rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
    masks = np.stack([random_mask(np.random.default_rng(i), size) for i in range(BATCH)])
    native = [_normalize_compose(u, m) for u, m in zip(u8, masks)]
    image = np.stack([n[0] for n in native])
    masked = np.stack([n[1] for n in native])
    numpy_image = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
    ulp = float(np.spacing(np.float32(1.0)))
    gap = float(np.abs(image - numpy_image).max())
    n_diff = int((image != numpy_image).sum())
    native_ms = host_ms(lambda: [_normalize_compose(u, m) for u, m in zip(u8, masks)], 5) / BATCH
    numpy_ms = host_ms(lambda: [(lambda im: (im, im * (1.0 - m)))(
        u.astype(np.float32) / 255.0 * 2.0 - 1.0) for u, m in zip(u8, masks)], 5) / BATCH
    print(f"[13] normalize/compose {BATCH}x{size}^2: native against numpy max abs {gap:.3g} "
          f"(tol one float32 ulp of 1, {ulp:.3g}: u8 * (2/255) - 1 against u8 / 255 * 2 - 1), "
          f"{n_diff} of {image.size} values differ; host ms per image native {native_ms:.4f}, "
          f"numpy {numpy_ms:.4f} (host times on the card's machine); {smi}", flush=True)
    check(gap <= ulp and np.array_equal(masked, image * (1.0 - masks)),
          "[13] the native normalize/compose disagrees with numpy")

    # decode: the native loader against PIL on phase 10's PNGs
    paths = list_images(train_dir)
    if imglib is not None:
        same = all(np.array_equal(decode_resize(p, size, "RGB"), np.asarray(
            Image.open(p).convert("RGB").resize((size, size), Image.BILINEAR))) for p in paths)
        dec_ms = host_ms(lambda: [decode_resize(p, size, "RGB") for p in paths], 3) / len(paths)
    else:
        same, dec_ms = None, float("nan")
    pil_ms = host_ms(lambda: [np.asarray(Image.open(p).convert("RGB").resize(
        (size, size), Image.BILINEAR)) for p in paths], 3) / len(paths)
    print(f"[13] decode {len(paths)} PNGs at {size}^2: native bit-equal to PIL: {same}; host ms "
          f"per image native {dec_ms:.4f}, PIL {pil_ms:.4f}; {smi}", flush=True)
    check(same is None or same, "[13] the native decode differs from PIL")

    # masks of each kind at 256²: in range, the same twice from one seed
    rows = []
    for kind in ("box", "brush"):
        covs, repeat = [], True
        for s in range(NATIVE_MASKS):
            a = random_mask(np.random.default_rng(s), size, kind=kind)
            b = random_mask(np.random.default_rng(s), size, kind=kind)
            repeat &= np.array_equal(a, b) and set(np.unique(a)) <= {0.0, 1.0}
            covs.append(float(a.mean()))
        n_ms = host_ms(lambda: random_mask(np.random.default_rng(1), size, kind=kind), 5)
        p_ms = host_ms(lambda: random_mask(np.random.default_rng(1), size, kind=kind,
                                           use_native=False), 2)
        rows.append(f"{kind}: coverage {min(covs):.3f}-{max(covs):.3f}, repeatable {repeat}, "
                    f"host ms per mask native {n_ms:.4f}, numpy {p_ms:.4f}")
        check(repeat and all(MASK_COVERAGE[0] <= c <= MASK_COVERAGE[1] for c in covs),
              f"[13] {kind} masks: coverage {covs}, repeatable {repeat}")
    print(f"[13] {NATIVE_MASKS} {size}^2 masks of each kind (coverage bounds "
          f"{MASK_COVERAGE}): {'; '.join(rows)}; {smi}", flush=True)
    return imglib is not None


def phase_parallel(torch, np, ckpt, n_attn, refs, smi):
    """Phase 13: the native data helpers (`phase_native`), then a one-rank
    NCCL process group started as a launcher starts one, a
    `create_mesh(data=1, fsdp=1)` over it, and at full width from phase 5's
    `.pt`: 3 train steps (and 3 more with the biases frozen by a
    param_mask), a progressive and a consistency distillation step
    and `ddim-100` through `InpaintingPipeline(mesh=)`, each bit-equal to the
    same calls without the mesh (phase 3's output for the pipeline), and
    `cli.train` for one epoch and once more over it (a save, a best, an
    overwrite) with and without the group: the same history and checkpoint
    directory. Both TF32 switches off and cuDNN deterministic, so that two
    runs of one step are comparable bit for bit. Destroys the group at the
    end. Returns the bf16 attention launches of the phase's kernel-path
    calls."""
    import os
    import socket

    import torch.distributed as dist

    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.cli import train as train_cli
    from fidm_tpu_torch.data import create_inpainting_dataloaders
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
    from fidm_tpu_torch.models.weights import load_adm_checkpoint
    from fidm_tpu_torch.ops import LAUNCHES
    from fidm_tpu_torch.parallel import create_mesh, multihost, shard_batch
    from fidm_tpu_torch.pipeline import create_model_and_schedule
    from fidm_tpu_torch.sampling.sampler import _ddim_tables
    from fidm_tpu_torch.training import (TrainState, init_ema, make_lr_schedule,
                                         make_optimizer, make_train_step)

    t_phase = time.perf_counter()
    cfg = ffhq256_config()
    size = cfg.image_size
    total = collections.Counter()
    held = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_parallel_") as tmp:
        tmp = Path(tmp)
        train_dir, val_dir, mask_root, _ = write_train_tree(np, tmp / "data", size)
        native_loader = phase_native(torch, np, train_dir, size, smi)
        held.append("native normalize (1 ulp), decode (bits), masks")

        # cli.train for one epoch, then once more over the same directory
        argv = ["--train_dir", str(train_dir), "--val_dir", str(val_dir), "--mask_dir",
                str(mask_root), "--pretrained", str(ckpt), "--batch_size", str(BATCH),
                "--device", "cuda", "--num_epochs", "1"]

        def cli_train(label, ck):
            runs = []
            for _ in range(2):
                LAUNCHES.clear()
                t0 = time.perf_counter()
                history = train_cli.main(argv + ["--checkpoint_dir", str(ck)])
                torch.cuda.synchronize()
                runs.append([{k: h[k] for k in ("epoch", "train_loss", "val_loss")}
                             for h in history])
                total.update({k: v for k, v in LAUNCHES.items() if k == "attention.bf16"})
                print(f"[13] cli.train {label}, 1 epoch into {ck.name}/: "
                      f"{time.perf_counter() - t0:.3f} s wall; history {runs[-1]}; launches "
                      f"{dict(sorted((k, v) for k, v in LAUNCHES.items() if v))}", flush=True)
            files = sorted(str(p.relative_to(ck)) for p in ck.rglob("*") if p.is_file())
            best = json.loads((ck / "best.json").read_text())
            return runs, files, best

        plain_cli = cli_train("without a process group", tmp / "ck_plain")

        # the one-rank group, as a launcher starts it
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        torch.cuda.set_device(multihost.local_device("cuda"))
        dist.init_process_group("nccl", world_size=1, rank=0)
        try:
            mesh = create_mesh(data=1, fsdp=1)
            print(f"[13] process group: backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, rank {dist.get_rank()} (env RANK=0 WORLD_SIZE=1 "
                  f"LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT={port}); mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}",
                  flush=True)

            # 3 train steps with and without the mesh, the same state and draws
            base_sd = load_adm_checkpoint(str(ckpt), cfg)
            model = InpaintingUNet(cfg)
            model.load_state_dict(base_sd, strict=True)
            model = model.to("cuda")
            sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
            loader, _ = create_inpainting_dataloaders(train_dir, val_dir, mask_root,
                                                      batch_size=BATCH, img_size=size, seed=0)
            batches = list(loader)

            def reset():
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(base_sd[name])
                return dict(model.named_parameters())

            def train_run(m, masked=False, timed=PARALLEL_TIMED):
                """PARALLEL_STEPS gated steps, their metrics and parameters,
                then `timed` more, timed; `masked`: the biases frozen."""
                params = reset()
                frozen = {k: not k.endswith(".bias") for k in params} if masked else None
                state = TrainState.create(model, params,
                                          make_optimizer(make_lr_schedule("none", 5e-5, 1),
                                                         param_mask=frozen))
                step = make_train_step(sched, mesh=m)
                gated = None
                metrics, ev, host, launches = [], [], [], []
                for i in range(PARALLEL_STEPS + timed):
                    if i == PARALLEL_STEPS:
                        gated = {k: p.detach().clone() for k, p in params.items()}
                    batch = batches[i % len(batches)]
                    batch = batch if m is None else shard_batch(batch, m)
                    before = LAUNCHES["attention.bf16"]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    state, mt = step(state, batch, 0)
                    end.record()
                    end.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                    ev.append(start.elapsed_time(end))
                    launches.append(LAUNCHES["attention.bf16"] - before)
                    metrics.append({k: v.clone() for k, v in mt.items()})
                total["attention.bf16"] += sum(launches)
                n = PARALLEL_STEPS
                if gated is None:
                    gated = {k: p.detach().clone() for k, p in params.items()}
                return metrics[:n], gated, launches[:n], ev[n:], host[n:]

            # timed in the order plain, mesh, plain again
            plain = train_run(None)
            meshed = train_run(mesh)
            control = train_run(None)

            def same_run(a, b):
                return (all(torch.equal(x[k], y[k]) for x, y in zip(a[0], b[0]) for k in x)
                        and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))

            eq, eq_control = same_run(meshed, plain), same_run(control, plain)
            ms = {lab: (float(np.mean(ev)), float(np.mean(host)))
                  for lab, ev, host in (("mesh", meshed[3], meshed[4]),
                                        ("no mesh", plain[3] + control[3], plain[4] + control[4]))}
            print(f"[13] {PARALLEL_STEPS} train steps B={BATCH} at {size}^2 under the mesh: "
                  f"losses {[round(float(x['loss']), 6) for x in meshed[0]]}, grad_norms "
                  f"{[round(float(x['grad_norm']), 6) for x in meshed[0]]}; metrics and all "
                  f"{len(meshed[1])} parameters bit-equal to the steps without the mesh: {eq} "
                  f"(two runs without it bit-equal: {eq_control}); attention launches per "
                  f"step {meshed[2]} / {plain[2]}; ms per step by CUDA events / host clock over "
                  f"{PARALLEL_TIMED} more steps of each run (plain, mesh, plain again): mesh "
                  f"{ms['mesh'][0]:.3f} / {ms['mesh'][1]:.3f} "
                  f"({', '.join(f'{x:.1f}' for x in meshed[3])}), no mesh "
                  f"{ms['no mesh'][0]:.3f} / {ms['no mesh'][1]:.3f} "
                  f"({', '.join(f'{x:.1f}' for x in plain[3] + control[3])}) (one rank: the "
                  f"collectives' own cost, not a scaling figure); {smi}", flush=True)
            check(eq, "[13] the meshed train steps differ from the unmeshed ones")
            check(meshed[2] == plain[2] == [n_attn] * PARALLEL_STEPS,
                  f"[13] train step launches {meshed[2]} / {plain[2]}, not {n_attn} a forward")
            held.append(f"{PARALLEL_STEPS} train steps (bits)")
            del meshed, plain, control

            # the same with the biases frozen by a param_mask: the clip's norm
            # is the trainable gradients' under the mesh too
            plain, meshed = (train_run(m, masked=True, timed=0) for m in (None, mesh))
            eq = same_run(meshed, plain)
            kept = all(torch.equal(p, base_sd[k].to("cuda")) for k, p in meshed[1].items()
                       if k.endswith(".bias"))
            print(f"[13] {PARALLEL_STEPS} train steps with the biases frozen (param_mask) "
                  f"under the mesh: grad_norms "
                  f"{[round(float(x['grad_norm']), 6) for x in meshed[0]]}; metrics and "
                  f"parameters bit-equal to the steps without the mesh: {eq}; the frozen "
                  f"biases unchanged: {kept}; attention launches per step {meshed[2]} / "
                  f"{plain[2]}", flush=True)
            check(eq and kept, "[13] the masked meshed train steps differ from the unmeshed")
            check(meshed[2] == plain[2] == [n_attn] * PARALLEL_STEPS,
                  f"[13] masked train step launches {meshed[2]} / {plain[2]}")
            held.append(f"{PARALLEL_STEPS} masked train steps (bits)")
            del meshed, plain

            # one progressive and one consistency step under the mesh
            teacher = InpaintingUNet(cfg)
            teacher.load_state_dict(base_sd, strict=True)
            teacher = teacher.to("cuda").requires_grad_(False)
            makers = {"progressive": lambda m: make_distill_step(
                          sched, unet_apply, unet_apply, teacher_steps=4, mesh=m),
                      "consistency": lambda m: make_consistency_step(
                          sched, unet_apply, unet_apply, grid_size=40, mesh=m)}
            for kind, make in makers.items():
                res = []
                for m in (None, mesh):
                    params = reset()
                    state = TrainState.create(
                        model, params, make_optimizer(make_lr_schedule("none", 1e-4, 1),
                                                      weight_decay=0.0),
                        ema_params=None if kind == "progressive" else init_ema(params))
                    batch = batches[0] if m is None else shard_batch(batches[0], m)
                    before = LAUNCHES["attention.bf16"]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state, metrics = make(m)(state, teacher, batch, 0)
                    end.record()
                    end.synchronize()
                    n = LAUNCHES["attention.bf16"] - before
                    total["attention.bf16"] += n
                    tensors = {k: p.detach().clone() for k, p in params.items()}
                    if state.ema_params is not None:
                        tensors.update({f"ema.{k}": v.clone() for k, v in state.ema_params.items()})
                    res.append((metrics, tensors, n, start.elapsed_time(end)))
                    del state
                (m0, t0_, n0, ms0), (m1, t1_, n1, ms1) = res
                eq = (all(torch.equal(m0[k], m1[k]) for k in m0)
                      and all(torch.equal(t0_[k], t1_[k]) for k in t0_))
                print(f"[13] one {kind} step B={BATCH} under the mesh: loss "
                      f"{float(m1['loss']):.6f}, grad_norm {float(m1['grad_norm']):.6f}; metrics "
                      f"and {len(t1_)} tensors bit-equal to the step without it: {eq}; "
                      f"launches {n1} / {n0}; {ms1:.3f} / {ms0:.3f} ms (CUDA events, one step "
                      f"each, the unmeshed first); {smi}", flush=True)
                check(eq, f"[13] the meshed {kind} step differs from the unmeshed one")
                check(n0 == n1 == n_attn * DISTILL_FORWARDS[kind],
                      f"[13] {kind} launches {n1} / {n0}")
                held.append(f"a {kind} step (bits)")
            moved = [k for k, p in teacher.named_parameters()
                     if not torch.equal(p, base_sd[k].to("cuda"))]
            check(not moved, f"[13] the teacher moved: {moved[:5]}")
            del model, teacher, res
            torch.cuda.empty_cache()

            # ddim-100 through InpaintingPipeline(mesh=), against phase 3's call
            config = PipelineConfig()
            pmodel, psched = create_model_and_schedule(config, checkpoint=str(ckpt),
                                                       device="cuda")
            pipe = InpaintingPipeline(pmodel, psched, config, mesh=mesh)
            gt, mask = main_inputs(torch, size)
            n_steps = len(_ddim_tables(pipe.sched, config.sampler)["t"])
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = pipe.inpaint(gt, mask, 0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(sorted((k, v) for k, v in LAUNCHES.items() if v))
            total["attention.bf16"] += LAUNCHES["attention.bf16"]
            ref, ref_s = refs["ddim-100"]
            eq = torch.equal(out.cpu(), ref)
            print(f"[13] ddim-100 through InpaintingPipeline(mesh=) B={BATCH}: {secs:.4f} s per "
                  f"call (phase 3 without the mesh {ref_s:.4f} s); bit-equal to phase 3's "
                  f"output: {eq} (digest {output_digest(out)}); launches {launches}; {smi}",
                  flush=True)
            check(eq, "[13] the meshed pipeline's ddim-100 differs from phase 3's")
            check(launches.get("attention.bf16") == n_attn * n_steps,
                  f"[13] meshed ddim-100 launches {launches}, not {n_attn} x {n_steps}")
            held.append(f"ddim-100 (bits, {n_attn * n_steps} launches)")
            del pipe, pmodel
            torch.cuda.empty_cache()

            group_cli = cli_train("under the one-rank group", tmp / "ck_group")
        finally:
            dist.destroy_process_group()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            torch.backends.cudnn.deterministic = deterministic

        (runs_p, files_p, best_p), (runs_g, files_g, best_g) = plain_cli, group_cli
        states = [torch.load(ck / "steps" / "0" / "state.pt", map_location="cpu",
                             weights_only=True) for ck in (tmp / "ck_plain", tmp / "ck_group")]
        same_state = all(torch.equal(states[0][sec][k], states[1][sec][k])
                         for sec in ("params",) for k in states[0][sec])
        same_state &= all(torch.equal(states[0]["opt_state"][m][k], states[1]["opt_state"][m][k])
                          for m in ("mu", "nu") for k in states[0]["opt_state"][m])
        del states
        print(f"[13] cli.train under the group against without it: histories equal "
              f"{runs_g == runs_p}, files equal {files_g == files_p} ({files_g}), best.json "
              f"equal {best_g == best_p}, steps/0/state.pt params and moments bit-equal "
              f"{same_state}; both datasets' masks and normalize/compose native (maskgen), "
              f"their decode {'native (imgload)' if native_loader else 'PIL (no imgload here)'}",
              flush=True)
        check(runs_g == runs_p and files_g == files_p and best_g == best_p and same_state,
              "[13] cli.train under the one-rank group differs from the run without it")
        check(files_g.count("steps/0/state.pt") == 1 and "best/state.pt" in files_g
              and not any("overwrite_backup" in f for f in files_g),
              f"[13] checkpoint files {files_g}")
        held.append("cli.train x2 (history, files, best.json, state bits)")
    print(f"[13] held: {'; '.join(held)}; phase wall {time.perf_counter() - t_phase:.1f} s; "
          f"bf16 attention launches {total['attention.bf16']}; {smi}", flush=True)
    return total["attention.bf16"]


# Phase 14, the mesh's "model" axis: two ranks over gloo on the one card (NCCL
# refuses two ranks on one device), a mesh (data=1, fsdp=1, model=2), phase
# 5's `.pt`, batch 2 at full width. The forwards and train steps in float32
# with TF32 off are held to JAX's own bounds of sharded against unsharded
# (tests/test_tp.py): a forward 1e-4 of its largest value (phase 4's float32
# bound), a train step's loss 1e-5 relative and its parameters 2e-5 after one
# AdamW step at a learning rate of 5e-6. That step moves a parameter by about
# lr whatever its gradient's size, so the parameters alone cannot tell a
# wrong gradient; the step's gradients (the reduced ones its optimizer gets,
# joined whole) are held to the unmeshed step's at the CPU test's bound, 2e-5
# of each tensor's largest value plus 1e-7, and its grad_norm at 1e-5
# relative. bf16 forwards at phase 4's bound, the 10-step DDIM images (and a
# 10-step `ddim-100-deep`, its feature cache under both layouts) at phase 4's
# hole mean abs. The rest of training over the axis, float32, at the train
# step's bounds against the unmeshed calls: a LoRA step (the default
# attention targets, `b` drawn away from zero) under TP and under spatial
# partitioning, a progressive step (the teacher its own TP slices) and a
# consistency-distillation step (the teacher whole) under TP (its pseudo-Huber
# gradient follows pred - target, a small difference of two forwards, so
# float32 rounding weighs more there: its gradients are held to a fixed 2.5
# times that bound, above the readings of sound runs on the H100, 1.61-1.68,
# and below a control's, the same TP step with TF32 on in cuBLAS and cuDNN,
# which must exceed it in the same run), a 1-epoch 2-step `fit` under TP with validation and a
# checkpoint (losses at the train step's bound, the checkpoint restored into
# one process bit for bit);
# then a 10-step guided `ddim-100` under shard_spatial against the unmeshed
# guided call at the images' bound, its `cond_fn` an autograd gradient that
# mirrors H, so that it needs every block of rows.
MODEL_AXIS_RANKS = 2
MODEL_AXIS_BATCH = 2
MODEL_AXIS_LR = 5e-6
MODEL_AXIS_STEPS = 10
MODEL_AXIS_CACHE_TAIL = 2
MODEL_AXIS_LOSS_RTOL = 1e-5
MODEL_AXIS_NORM_RTOL = 1e-5
MODEL_AXIS_PARAM_TOL = 2e-5
MODEL_AXIS_GRAD_REL = 2e-5
MODEL_AXIS_GRAD_FLOOR = 1e-7
MODEL_AXIS_CONSISTENCY_GATE = 2.5
MODEL_AXIS_TIMEOUT = 360
MODEL_AXIS_FIT_ROWS = 4
MODEL_AXIS_GUIDANCE = 0.5
NOT_SCALING = "two ranks on one card over gloo: not a scaling figure"


def model_axis_rank(rank, port, workdir, ckpt):
    """One rank of phase 14 (`python3 chip_smoke.py --model-axis-rank RANK
    PORT WORKDIR CKPT`): a gloo process group of MODEL_AXIS_RANKS on the
    card, every gate checked here (a failed one exits non-zero), the bf16
    attention launches of its kernel-path calls written to
    WORKDIR/rank<RANK>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
    from fidm_tpu_torch.models.weights import load_adm_checkpoint
    from fidm_tpu_torch.ops import LAUNCHES, kernel_override
    from fidm_tpu_torch.parallel import (create_mesh, shard_batch, shard_params,
                                         tp_shard_params)
    from fidm_tpu_torch.parallel.collectives import full_params, gather_h, model_group
    from fidm_tpu_torch.parallel.tp import attach
    from fidm_tpu_torch.training import TrainState, make_train_step
    from fidm_tpu_torch.training.train_state import Optimizer

    def say(msg):
        print(f"[14] rank {rank}: {msg}", flush=True)

    class Recording(Optimizer):
        """AdamW that keeps the gradients of its first update: the step's
        gradients reduced into the state's layout, before the clip."""

        def update(self, grads, state, params, *args):
            if not hasattr(self, "grads"):
                self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return super().update(grads, state, params, *args)

    t_rank = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=MODEL_AXIS_RANKS, rank=rank)
    mesh = create_mesh(data=1, fsdp=1, model=MODEL_AXIS_RANKS)
    ax = model_group(mesh)
    say(f"process group {dist.get_backend()} of {dist.get_world_size()} on "
        f"{torch.cuda.get_device_name(0)}; mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
        f"model index {ax.rank}")
    cfg16 = ffhq256_config()
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    sd = {k: v.to("cuda") for k, v in load_adm_checkpoint(str(ckpt), cfg16).items()}
    size, B = cfg16.image_size, MODEL_AXIS_BATCH

    def model_of(cfg):
        with torch.device("cuda"):  # the random init on the card, then the weights
            m = InpaintingUNet(cfg)
        m.load_state_dict(sd, strict=True)
        return m

    gt, mask = (a[:B] for a in main_inputs(torch, size))
    keep = mask[..., 0] < 0.5
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    x = torch.randn(gt.shape, device="cuda", generator=g)
    t = torch.tensor([500, 250], device="cuda", dtype=torch.int32)
    masked = gt * keep[..., None]
    lo, hi = ax.rank * size // ax.size, (ax.rank + 1) * size // ax.size
    bf16_launches = 0

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    # --- forwards: TP and spatial against the unmeshed forward, f32 and bf16
    for cfg, tol in ((cfg32, UNET_F32_TOL), (cfg16, UNET_BF16_TOL)):
        kind = "attention.f32" if cfg.dtype == torch.float32 else "attention.bf16"
        name = str(cfg.dtype).replace("torch.", "")
        with torch.inference_mode():
            model = model_of(cfg).eval()
            ref = model(x, t, masked, mask)
            LAUNCHES.clear()
            with attach(model, mesh, "spatial"):
                out, ev, host = timed(lambda: model(x[:, lo:hi], t, masked[:, lo:hi],
                                                    mask[:, lo:hi]))
            n_sp = LAUNCHES[kind]
            e_sp = rel(gather_h(out, ax, dim=1), ref)
            say(f"spatial forward B={B} {name}: rows [{lo}, {hi}) of {size}; max abs / max "
                f"|unmeshed| {e_sp:.4g} (tol {tol}); {n_sp} {kind} launches; {ev:.3f} ms by "
                f"CUDA events, {host:.3f} ms host ({NOT_SCALING})")
            check(e_sp <= tol, f"[14] rank {rank}: the spatial {name} forward disagrees")
            check(n_sp == 4 and LAUNCHES["attention"] == 4,
                  f"[14] rank {rank}: spatial {name} forward launches {dict(LAUNCHES)}")
            del model
            model = model_of(cfg).eval()
            specs = tp_shard_params(model, mesh)[1]
            LAUNCHES.clear()
            with attach(model, mesh, "tp", specs):
                out, ev, host = timed(lambda: model(x, t, masked, mask))
                n_tp = LAUNCHES[kind]
                with kernel_override(False, "attention"):
                    plain = model(x, t, masked, mask)
            e_tp, e_kp = rel(out, ref), rel(out, plain)
            n_split = sum(type(s).__name__ == "ModelShard" for s in specs.values())
            say(f"TP forward B={B} {name}: {n_split} tensors split; max abs / max |unmeshed| "
                f"{e_tp:.4g} (tol {tol}); kernel against plain attention under TP {e_kp:.4g} "
                f"(tol {tol}); {n_tp} {kind} launches (attention at [{B}, "
                f"{8 // ax.size}, 256 / 64, 64]); {ev:.3f} ms by CUDA events, {host:.3f} ms "
                f"host ({NOT_SCALING})")
            check(e_tp <= tol and e_kp <= tol, f"[14] rank {rank}: the TP {name} forward disagrees")
            check(n_tp == 4 and LAUNCHES[kind] == 4,
                  f"[14] rank {rank}: TP {name} forward launches {dict(LAUNCHES)}")
            if kind == "attention.bf16":
                bf16_launches += n_sp + n_tp
            del model, ref, out, plain
        torch.cuda.empty_cache()

    # --- one train step each, float32, against the unmeshed step
    sched = DiffusionSchedule.create("quadratic", 1000, device="cuda")
    batch = {"image": gt, "masked_image": masked, "mask": mask}

    def train(layout):
        model = model_of(cfg32)
        if layout == "tp":
            params, specs = tp_shard_params(model, mesh)
        elif layout == "spatial":
            params, specs = shard_params(model, mesh)
        else:
            params, specs = dict(model.named_parameters()), None
        tx = Recording(lambda c: MODEL_AXIS_LR)
        state = TrainState.create(model, params, tx, specs=specs)
        m = None if layout is None else mesh
        step = make_train_step(sched, mesh=m, spatial=layout == "spatial")
        part = batch if m is None else shard_batch(batch, m, spatial=layout == "spatial")
        LAUNCHES.clear()
        (_, metrics), ev, host = timed(lambda: step(state, part, 7))
        n = LAUNCHES["attention.f32"]

        def whole(t):
            return {k: v.detach().clone()
                    for k, v in (t if m is None else full_params(t, specs, m)).items()}

        return ({k: float(v) for k, v in metrics.items()}, whole(state.params),
                whole(tx.grads), n, ev, host)

    ref_m, ref_p, ref_g, _, ref_ev, ref_host = train(None)
    for layout in ("tp", "spatial"):
        got_m, got_p, got_g, n, ev, host = train(layout)
        loss_err = abs(got_m["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
        norm_err = abs(got_m["grad_norm"] - ref_m["grad_norm"]) / ref_m["grad_norm"]
        p_err = max((got_p[k] - ref_p[k]).abs().max().item() for k in ref_p)
        # each gradient's error over its bound, 2e-5 of its largest value + 1e-7
        g_err = {k: (got_g[k] - g).abs().max().item()
                 / (MODEL_AXIS_GRAD_REL * g.abs().max().item() + MODEL_AXIS_GRAD_FLOOR)
                 for k, g in ref_g.items()}
        worst = max(g_err, key=g_err.get)
        say(f"{layout} train step B={B} float32: loss {got_m['loss']:.7f} against "
            f"{ref_m['loss']:.7f} unmeshed (relative {loss_err:.3g}, tol "
            f"{MODEL_AXIS_LOSS_RTOL}); grad_norm {got_m['grad_norm']:.7f} against "
            f"{ref_m['grad_norm']:.7f} (relative {norm_err:.3g}, tol {MODEL_AXIS_NORM_RTOL}); "
            f"{len(got_g)} gradients, the worst at {g_err[worst]:.3g} of its bound "
            f"({MODEL_AXIS_GRAD_REL} of its largest + {MODEL_AXIS_GRAD_FLOOR}; {worst}); "
            f"{len(got_p)} parameters within {p_err:.3g} (tol {MODEL_AXIS_PARAM_TOL}, lr "
            f"{MODEL_AXIS_LR}); {n} attention.f32 launches; {ev:.3f} ms by CUDA events, "
            f"{host:.3f} ms host, unmeshed {ref_ev:.3f} / {ref_host:.3f} ms ({NOT_SCALING})")
        check(set(got_g) == set(ref_g) and g_err[worst] <= 1.0,
              f"[14] rank {rank}: the {layout} train step's gradients disagree ({worst})")
        check(loss_err <= MODEL_AXIS_LOSS_RTOL and norm_err <= MODEL_AXIS_NORM_RTOL
              and p_err <= MODEL_AXIS_PARAM_TOL,
              f"[14] rank {rank}: the {layout} train step disagrees with the unmeshed step")
        check(n == 4, f"[14] rank {rank}: {layout} train step launches {n}")
        del got_p, got_g
        torch.cuda.empty_cache()
    del ref_p, ref_g

    # --- the rest of training over the axis, float32, against the unmeshed calls
    def grad_errors(got_g, ref_g):
        """Each gradient's error over its bound, 2e-5 of its largest + 1e-7."""
        return {k: (got_g[k] - g).abs().max().item()
                / (MODEL_AXIS_GRAD_REL * g.abs().max().item() + MODEL_AXIS_GRAD_FLOOR)
                for k, g in ref_g.items()}

    def held(label, got, ref, n, want, ms, ref_ms, slack=1.0):
        """Gate one step's (metrics, whole gradients) against the unmeshed
        step's: loss and grad_norm 1e-5 relative, each gradient within
        `slack` times its bound; `want` attention.f32 launches."""
        (got_m, got_g), (ref_m, ref_g) = got, ref
        errs = {k: abs(got_m[k] - ref_m[k]) / abs(ref_m[k]) for k in ("loss", "grad_norm")}
        g_err = grad_errors(got_g, ref_g)
        worst = max(g_err, key=g_err.get)
        say(f"{label} B={B} float32: loss {got_m['loss']:.7f} against {ref_m['loss']:.7f} "
            f"unmeshed (relative {errs['loss']:.3g}, tol {MODEL_AXIS_LOSS_RTOL}); grad_norm "
            f"relative {errs['grad_norm']:.3g} (tol {MODEL_AXIS_NORM_RTOL}); {len(got_g)} "
            f"gradients, the worst at {g_err[worst]:.3g} of its bound ({worst}; gate "
            f"{slack:.3g}); {n} "
            f"attention.f32 launches (want {want}); {ms:.3f} ms by CUDA events, unmeshed "
            f"{ref_ms:.3f} ms ({NOT_SCALING})")
        check(set(got_g) == set(ref_g) and g_err[worst] <= slack
              and errs["loss"] <= MODEL_AXIS_LOSS_RTOL and errs["grad_norm"] <= MODEL_AXIS_NORM_RTOL,
              f"[14] rank {rank}: {label} disagrees with the unmeshed call")
        check(n == want, f"[14] rank {rank}: {label} launches {n}, want {want}")

    from fidm_tpu_torch.data.dataset import DataLoader
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.lora import init_lora, lora_weights
    from fidm_tpu_torch.parallel.collectives import ShardedModule
    from fidm_tpu_torch.training import (CheckpointManager, FitConfig, fit, init_ema,
                                         make_eval_step)

    def lora_step(layout):
        model = model_of(cfg32).requires_grad_(False)
        adapter = init_lora(5, model, cfg32)  # on the whole model, then cut under TP
        g = torch.Generator(device="cuda")
        g.manual_seed(6)
        adapter = {k: (v + 0.01 * torch.randn(v.shape, device="cuda", generator=g)
                       if k.endswith("/b") else v).requires_grad_(True)
                   for k, v in adapter.items()}
        m = None if layout is None else mesh
        specs = tp_shard_params(model, mesh)[1] if layout == "tp" else None
        tx = Recording(lambda c: MODEL_AXIS_LR)
        state = TrainState.create(model, adapter, tx, model_specs=specs)
        step = make_train_step(sched, mesh=m, spatial=layout == "spatial",
                               param_transform=lambda l: lora_weights(model, cfg32, l, specs, m))
        part = batch if m is None else shard_batch(batch, m, spatial=layout == "spatial")
        LAUNCHES.clear()
        (_, metrics), ev, _ = timed(lambda: step(state, part, 7))
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.clone() for k, v in tx.grads.items()}), LAUNCHES["attention.f32"], ev

    ref, _, ref_ev = lora_step(None)
    for layout in ("tp", "spatial"):
        got, n, ev = lora_step(layout)
        held(f"LoRA step ({layout}, {len(got[1]) - 1} adapter tensors)", got, ref, n, 4, ev,
             ref_ev)
    del ref, got
    torch.cuda.empty_cache()

    def distill_step(kind, layout):
        student = model_of(cfg32)
        teacher = model_of(cfg32).requires_grad_(False)
        m = None if layout is None else mesh
        if m is None:
            params, specs = dict(student.named_parameters()), None
        else:
            params, specs = tp_shard_params(student, mesh)
            if kind == "progressive":  # the teacher on its own slices
                tparams, tspecs = tp_shard_params(teacher, mesh)
                teacher = ShardedModule(teacher, mesh, params=tparams, specs=tspecs)
        tx = Recording(lambda c: MODEL_AXIS_LR)
        state = TrainState.create(student, params, tx, specs=specs,
                                  ema_params=init_ema(params) if kind != "progressive" else None)
        step = (make_distill_step(sched, unet_apply, unet_apply, teacher_steps=4, mesh=m)
                if kind == "progressive" else
                make_consistency_step(sched, unet_apply, unet_apply, grid_size=40, mesh=m))
        LAUNCHES.clear()
        (_, metrics), ev, _ = timed(lambda: step(state, teacher, batch, 7))
        grads = tx.grads if m is None else full_params(tx.grads, specs, m)
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.clone() for k, v in grads.items()}), LAUNCHES["attention.f32"], ev

    for kind in ("progressive", "consistency"):
        ref, _, ref_ev = distill_step(kind, None)
        got, n, ev = distill_step(kind, "tp")
        slack = 1.0
        if kind == "consistency":
            # its gradients at a fixed multiple of the bound; the control, the
            # same step in TF32, shows in this run that the gate can fail
            slack = MODEL_AXIS_CONSISTENCY_GATE
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                control, _, _ = distill_step(kind, "tp")
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            c = grad_errors(control[1], ref[1])
            worst = max(c, key=c.get)
            say(f"consistency step control: the TP step with TF32 on against the unmeshed "
                f"float32 step, the worst gradient at {c[worst]:.3g} of its bound ({worst}; "
                f"must exceed the gate {slack})")
            check(c[worst] > slack,
                  f"[14] rank {rank}: the consistency gate does not refuse the TF32 control")
            del control
        teacher_kind = "its own TP slices" if kind == "progressive" else "whole"
        held(f"{kind} distillation step (tp, the teacher {teacher_kind})", got, ref, n, 12, ev,
             ref_ev, slack)
        del ref, got
        torch.cuda.empty_cache()

    class FitRows:
        """MODEL_AXIS_FIT_ROWS seeded rows at full size; records what it reads."""

        def __init__(self, seed):
            self.seed, self.read = seed, []

        def __len__(self):
            return MODEL_AXIS_FIT_ROWS

        def __getitem__(self, i):
            self.read.append(int(i))
            r = np.random.default_rng(self.seed + i)
            img = np.clip(0.5 * r.standard_normal((size, size, 3)), -1, 1).astype(np.float32)
            box = np.zeros((size, size, 1), np.float32)
            box[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 1.0
            return {"image": img, "masked_image": img * (1 - box), "mask": box}

    def run_fit(m, ckdir):
        model = model_of(cfg32)
        params, specs = ((dict(model.named_parameters()), None) if m is None
                         else tp_shard_params(model, mesh))
        state = TrainState.create(model, params, Recording(lambda c: MODEL_AXIS_LR), specs=specs)
        rows = FitRows(20)
        mgr = None if ckdir is None else CheckpointManager(ckdir, mesh=m)
        LAUNCHES.clear()
        (state, hist), ev, _ = timed(lambda: fit(
            state, make_train_step(sched, mesh=m), make_eval_step(sched, mesh=m),
            DataLoader(rows, B, shuffle=True, seed=3, drop_last=True),
            DataLoader(FitRows(40), B), 11,
            FitConfig(num_epochs=1, log_fn=lambda *a, **k: None, handle_preemption=False),
            checkpoint_manager=mgr, mesh=m))
        if mgr is not None:
            mgr.close()
        return state, hist[0], rows.read, LAUNCHES["attention.f32"], ev

    ckdir = str(Path(workdir) / "fit_tp")
    _, ref_h, _, _, ref_ev = run_fit(None, None)
    state, got_h, read, n, ev = run_fit(mesh, ckdir)
    want = 4 * (MODEL_AXIS_FIT_ROWS // B + MODEL_AXIS_FIT_ROWS // B)
    errs = {k: abs(got_h[k] - ref_h[k]) / abs(ref_h[k]) for k in ("train_loss", "val_loss")}
    reads = [None] * MODEL_AXIS_RANKS
    dist.all_gather_object(reads, read)
    # the checkpoint restored into one process: the state's slices joined
    whole_model = model_of(cfg32)
    one = TrainState.create(whole_model, dict(whole_model.named_parameters()),
                            Recording(lambda c: MODEL_AXIS_LR))
    CheckpointManager(ckdir).restore("latest", one)
    joined = full_params(state.params, state.specs, mesh)
    same = sorted(joined) == sorted(one.params) and all(
        torch.equal(one.params[k], p) for k, p in joined.items())
    say(f"fit under TP, 1 epoch of {MODEL_AXIS_FIT_ROWS // B} steps B={B} float32 with "
        f"validation and a checkpoint: train loss {got_h['train_loss']:.7f}, val loss "
        f"{got_h['val_loss']:.7f}, relative to the unmeshed fit {errs['train_loss']:.3g} / "
        f"{errs['val_loss']:.3g} (tol {MODEL_AXIS_LOSS_RTOL}); rows read per rank {reads}; the "
        f"checkpoint restored into one process equals the slices joined: {same}; {n} "
        f"attention.f32 launches (want {want}); {ev:.3f} ms by CUDA events, unmeshed "
        f"{ref_ev:.3f} ms ({NOT_SCALING})")
    check(max(errs.values()) <= MODEL_AXIS_LOSS_RTOL and same and n == want
          and all(r == reads[0] for r in reads),
          f"[14] rank {rank}: fit under TP disagrees")
    del state, one, joined, whole_model
    torch.cuda.empty_cache()

    # --- 10-step DDIM through the pipeline, bf16, against the unmeshed call;
    # then `ddim-100-deep` at 10 steps (its last MODEL_AXIS_CACHE_TAIL full),
    # the feature cache under both layouts, launching what the unmeshed call does
    config = PipelineConfig()
    plain_pipe = InpaintingPipeline(model_of(cfg16).eval().requires_grad_(False), sched, config)
    pipes = [InpaintingPipeline(model_of(cfg16).eval().requires_grad_(False), sched, config,
                                mesh=mesh, **kw)
             for kw in (dict(tp_params=True), dict(shard_spatial=True))]
    for preset, cfg in (
            ("ddim", dataclasses.replace(SAMPLER_PRESETS["ddim-100"],
                                         num_steps=MODEL_AXIS_STEPS)),
            ("ddim-100-deep", dataclasses.replace(
                SAMPLER_PRESETS["ddim-100-deep"], num_steps=MODEL_AXIS_STEPS,
                encoder_cache_tail=MODEL_AXIS_CACHE_TAIL))):
        LAUNCHES.clear()
        ref = plain_pipe.inpaint(gt, mask, 0, sampler=cfg)
        n_ref = LAUNCHES["attention.bf16"]
        for layout, pipe in zip(("tp_params", "shard_spatial"), pipes):
            LAUNCHES.clear()
            out, ev, host = timed(lambda: pipe.inpaint(gt, mask, 0, sampler=cfg))
            n = LAUNCHES["attention.bf16"]
            bf16_launches += n
            hole = (out - ref).abs()[~keep].mean().item()
            exact = torch.equal(out[keep], gt[keep])
            say(f"{preset} at {MODEL_AXIS_STEPS} steps through InpaintingPipeline({layout}=True) "
                f"B={B}: known pixels bit-equal to gt: {exact}; hole mean abs against the "
                f"unmeshed call {hole:.4g} (tol {IMAGE_MEAN_TOL}); {n} attention.bf16 launches "
                f"(the unmeshed call {n_ref}); {host / 1e3:.4f} s per call ({NOT_SCALING})")
            check(exact and bool(torch.isfinite(out).all()),
                  f"[14] rank {rank}: {preset} {layout}: known pixels or finiteness")
            check(hole <= IMAGE_MEAN_TOL, f"[14] rank {rank}: {preset} {layout}: images disagree")
            check(n == n_ref and LAUNCHES["attention"] == n and n > 0,
                  f"[14] rank {rank}: {preset} {layout}: launches {dict(LAUNCHES)}, unmeshed "
                  f"{n_ref}")
            if preset == "ddim":
                check(n == 4 * (MODEL_AXIS_STEPS + 1),
                      f"[14] rank {rank}: {layout}: launches {n}")
            del out
        if preset == "ddim":
            unguided = ref
        del ref

    def mirror_guidance(x, t):
        """grad of -c/2 |x - x mirrored along H|^2: each row's gradient needs
        its mirror row, held by the other rank under shard_spatial."""
        energy = -0.5 * MODEL_AXIS_GUIDANCE * (x - torch.flip(x, dims=[1])).square().sum()
        return torch.autograd.grad(energy, x)[0]

    ddim10 = dataclasses.replace(SAMPLER_PRESETS["ddim-100"], num_steps=MODEL_AXIS_STEPS)
    ref = plain_pipe.inpaint(gt, mask, 0, sampler=ddim10, cond_fn=mirror_guidance)
    LAUNCHES.clear()
    out, ev, host = timed(lambda: pipes[1].inpaint(gt, mask, 0, sampler=ddim10,
                                                   cond_fn=mirror_guidance))
    n = LAUNCHES["attention.bf16"]
    bf16_launches += n
    hole = (out - ref).abs()[~keep].mean().item()
    moved = (ref - unguided).abs()[~keep].mean().item()
    exact = torch.equal(out[keep], gt[keep])
    say(f"guided ddim at {MODEL_AXIS_STEPS} steps through InpaintingPipeline(shard_spatial=True) "
        f"B={B}, cond_fn on the whole image: known pixels bit-equal to gt: {exact}; hole mean "
        f"abs against the unmeshed guided call {hole:.4g} (tol {IMAGE_MEAN_TOL}); the guidance "
        f"moved the unmeshed hole by {moved:.4g} (must exceed the tol); {n} attention.bf16 "
        f"launches; {host / 1e3:.4f} s per call ({NOT_SCALING})")
    check(exact and bool(torch.isfinite(out).all()) and hole <= IMAGE_MEAN_TOL
          and moved > IMAGE_MEAN_TOL, f"[14] rank {rank}: the guided spatial call disagrees")
    check(n == 4 * (MODEL_AXIS_STEPS + 1) and LAUNCHES["attention"] == n,
          f"[14] rank {rank}: guided spatial launches {dict(LAUNCHES)}")
    del out, ref, unguided, plain_pipe, pipes
    torch.cuda.empty_cache()
    with open(Path(workdir) / f"rank{rank}.json", "w") as f:
        json.dump({"attention.bf16": bf16_launches}, f)
    dist.barrier()
    dist.destroy_process_group()
    say(f"all gates held; {time.perf_counter() - t_rank:.1f} s in this rank")


def phase_model_axis(torch, ckpt, smi):
    """Phase 14: the mesh's "model" axis, MODEL_AXIS_RANKS ranks, each a
    process of its own on the one card (`model_axis_rank`), started together
    and stopped by the end of the phase. Returns the bf16 attention launches
    of their kernel-path calls."""
    import os
    import socket

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_model_axis_") as tmp:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(MODEL_AXIS_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--model-axis-rank", str(r), str(port), tmp, str(ckpt)],
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(MODEL_AXIS_RANKS)]
        try:
            deadline = time.time() + MODEL_AXIS_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines():
                if line.startswith(("[14]", "FAIL", "Traceback", "  ")) or "Error" in line:
                    print(line, flush=True)
            f.close()
        codes = [p.returncode for p in procs]
        check(codes == [0] * MODEL_AXIS_RANKS, f"[14] the ranks exited with {codes}")
        launches = sum(json.loads((Path(tmp) / f"rank{r}.json").read_text())["attention.bf16"]
                       for r in range(MODEL_AXIS_RANKS))
    print(f"[14] model axis: {MODEL_AXIS_RANKS} ranks held TP and spatial forwards, train "
          f"steps (gradients too), LoRA steps, a progressive and a consistency step, a fit "
          f"with its checkpoint, {MODEL_AXIS_STEPS}-step ddim and ddim-100-deep pipelines and "
          f"a guided spatial ddim to the unmeshed calls; bf16 attention "
          f"launches {launches}; phase wall {time.perf_counter() - t_phase:.1f} s; {smi}",
          flush=True)
    return launches


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
        from fidm_tpu_torch.models.weights import load_adm_checkpoint
        from fidm_tpu_torch.ops import LAUNCHES, attention, build, kernel_override
        from fidm_tpu_torch.ops import quantize as quantize_ops
        from fidm_tpu_torch.quant import int8 as quant_int8
        from fidm_tpu_torch.quant import load_quantized_state_dict
        from fidm_tpu_torch.sampling.sampler import _ddim_tables, _dpm_tables
    except ImportError as e:
        fail(f"the fidm_tpu_torch package is not importable from here: {e}")
    # torch's own TF32 switches, which phase 8 runs under, as a user's process
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
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
    print("[2] attention kernel vs plain version (tolerance: f32 1e-5, 3xTF32 "
          "products and sums in another order, also against the plain version in "
          "float64; bf16 2e-2, the plain version rounds q*scale, k*scale, "
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
    refs = {"ddim-100": (out.cpu(), seconds)}
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
    refs["dpm-25-sde"] = (out_sde.cpu(), sde_s)
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
    # the checkpoint and the .npz outlive phase 5: the server of phase 6
    # and the evaluate runs of phase 8 load them
    ckpt_dir = tempfile.TemporaryDirectory(prefix="fidm_chip_smoke_ckpt_")
    ckpt = Path(ckpt_dir.name) / "ffhq256_random.pt"
    npz = Path(ckpt_dir.name) / "int8.npz"
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

        report, quant_s, quant_launches = quantize(npz)
        print(f"[5] quantize CLI (absmax): {quant_s:.4f} s wall, compression "
              f"{report['compression']}, {report['tensors_quantized']} tensors, "
              f"launches {quant_launches}", flush=True)
        check(report["tensors_quantized"] == QUANT_TENSORS,
              f"{report['tensors_quantized']} tensors quantized, not {QUANT_TENSORS}")
        check(quant_launches["quantize"] == QUANT_LAUNCHES,
              f"quantize kernel launches {quant_launches['quantize']} != {QUANT_LAUNCHES}")
        t0 = time.perf_counter()
        compared, differ = check_cli_rounding(torch, np, ckpt, config.unet, npz,
                                              quantize_ops, quant_int8)
        print(f"[5] the .npz's kernel-rounded tensors against the plain version at their "
              f"seeds: {compared} compared, {len(differ)} differ "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(compared == QUANT_LAUNCHES and not differ,
              f"{compared} kernel-rounded tensors compared, differing: {differ[:5]}")
        cli_stages(torch, np, ckpt, config.unet, tmp / "stages.npz")
        report2, again_s, _ = quantize(tmp / "int8_again.npz")
        with np.load(npz) as a, np.load(tmp / "int8_again.npz") as b:
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
            load_quantized_state_dict(str(npz), config.unet), strict=True)

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
    serving6 = phase_serving(torch, np, ckpt, pipe, n_attn, smi)

    # 7. feature caching at full width, on phase 3's pipeline and inputs
    with torch.inference_mode():
        cached_forwards(torch, pipe.model, n_attn, (x, t, masked, mask))
    cached_presets(torch, pipe, n_attn, gt, mask, keep, out, smi)
    refs.update({f"bench {name}": first
                 for name, first in bench_line(torch, np, pipe, n_attn, smi).items()})

    # 8. the evaluate path at full width, on phase 5's checkpoint and .npz,
    # under torch's default TF32 switches: the CLIs as a user runs them
    del pipe
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    print(f"[8] TF32 switches as torch sets them: matmul {tf32_defaults[0]}, cuDNN "
          f"{tf32_defaults[1]}", flush=True)
    eval_f32_launches = phase_evaluate(torch, np, ckpt, npz, n_attn, smi)
    # where the time of `--dtype f32` goes: one float32 forward with torch's
    # TF32 switches (the CLI's), then with both off, profiled last, since it
    # may leave device memory allocated (cuDNN's float32 convolutions) that
    # would enter the peak memory of phases 3-7
    before = torch.cuda.memory_allocated()
    f32_model = InpaintingUNet(dataclasses.replace(config.unet, dtype=torch.float32))
    f32_model.load_state_dict(load_adm_checkpoint(str(ckpt), config.unet), strict=True)
    f32_model = f32_model.to("cuda").eval()
    with torch.inference_mode():
        profile_forward(torch, f"[8] one float32 UNet forward B={BATCH} (--dtype f32, "
                        f"cuDNN TF32 {tf32_defaults[1]})", lambda: f32_model(x, t, masked, mask))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        profile_forward(torch, f"[8] one float32 UNet forward B={BATCH} (--dtype f32, TF32 "
                        f"off)", lambda: f32_model(x, t, masked, mask))
    del f32_model
    torch.cuda.empty_cache()
    print(f"[8] device memory allocated before that model {before} bytes, after it is "
          f"deleted {torch.cuda.memory_allocated()} bytes", flush=True)

    # 9. the rest of sampling at full width, both TF32 switches off again
    # (phase 8's last forward left them so), on phase 3's model and phase 5's
    # checkpoint
    sampling_launches = phase_sampling(torch, np, ckpt, n_attn, smi)

    # 10. training at full width from phase 5's checkpoint, under torch's
    # default TF32 switches, as a user's training process has them
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    training_launches = phase_training(torch, np, ckpt, n_attn, smi)

    # 11. the warm program cache, both TF32 switches off again
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    program_launches = phase_programs(torch, np, ckpt, n_attn, refs, serving6, smi)

    # 12. distillation at full width from phase 5's checkpoint, under torch's
    # default TF32 switches, as phase 10 trains
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    distill_launches = phase_distill(torch, np, ckpt, n_attn, smi)

    # 13. the native data helpers, then a one-rank NCCL group and its mesh,
    # both TF32 switches off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    parallel_launches = phase_parallel(torch, np, ckpt, n_attn, refs, smi)

    # 14. the mesh's "model" axis: two ranks over gloo on the card
    model_axis_launches = phase_model_axis(torch, ckpt, smi)
    ckpt_dir.cleanup()

    # 15. the record
    # launches: attention_bf16 in phase 3's DDIM-100 call, phase 9's
    # kernel-path calls (the new methods, guidance, the trajectory, the
    # CLIs), phase 10's (cli.train's train and validation forwards, the
    # remat policies' steps, the CLIs on its checkpoints), phase 11's
    # (program replays and their recording runs, the servers, the CLI
    # runs, the forwards) and phase 12's (cli.distill's steps, the CLIs on
    # the students and the export, the kernel-path steps and the target
    # network's forwards), phase 13's (the meshed and unmeshed train,
    # distill and ddim-100 calls, cli.train with and without the group) and
    # phase 14's (both ranks' TP and spatial forwards and pipelines),
    # attention_f32 in
    # phase 8's `cli.evaluate --dtype f32` run (its user path; phase 4's
    # float32 forward launched it too), quantize in phase 5's absmax CLI run
    kernels = [dict(name="attention_bf16", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/attention.cu",
                    replaces="fidm_tpu/ops/attention.py:46",
                    launches=launches["attention.bf16"] + sampling_launches
                    + training_launches + program_launches + distill_launches
                    + parallel_launches + model_axis_launches,
                    **attn_rows[torch.bfloat16]),
               dict(name="attention_f32", route="cuda",
                    source="fidm_tpu_torch/ops/csrc/attention.cu",
                    replaces="fidm_tpu/ops/attention.py:46",
                    launches=eval_f32_launches, **attn_rows[torch.float32]),
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
    if sys.argv[1:2] == ["--model-axis-rank"]:
        model_axis_rank(*sys.argv[2:])
    else:
        main()
