"""Time the port's inpainting presets on the GPU, for one or more checkouts
of the repo, interleaved, so that two versions are compared within one run.

    python3 time_presets.py --trees OLD . . OLD [--presets ddim-100 ...]
                            [--repeats 5] [--out FILE]

Each entry of --trees is a directory that holds a `fidm_tpu_torch` package
(this checkout, or an older commit unpacked with `git archive`). For each
entry in the order given, a child process imports that directory's package,
builds its attention kernel, creates the pipeline at full `ffhq256_config`
width (bf16, random weights from seed 0, the zero-initialised convs re-drawn
from seed 1, as `chip_smoke.py` phase 3 does), makes phase 3's inputs (batch
4, 256², a centred 128×128 hole) and times, for every preset, one warm-up
call and then --repeats calls, each ending in `torch.cuda.synchronize()`
(host clock). It also times the sampler loop alone: `inpaint_sample` of
each uncached preset with a model that returns one precomputed output, so
that the loop's own host and device cost per step shows without the UNet.

Every call's output is hashed (sha1 of its bytes): two checkouts that print
the same digest gave the same images bit for bit. The card's name and power
limit (`nvidia-smi`) stand beside the numbers. The last line of standard
output is one JSON object with every measurement; --out writes it to a file
as well. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = 4
DEFAULT_PRESETS = ("ddim-100", "dpm-25-sde", "ddim-100-deep")


def _digest(out) -> str:
    return hashlib.sha1(out.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _child(tree: str, presets, repeats: int) -> dict:
    """Runs in the child process: time `presets` on the package in `tree`."""
    sys.path.insert(0, tree)
    import torch

    import fidm_tpu_torch
    from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.ops import LAUNCHES, build
    from fidm_tpu_torch.sampling import inpaint_sample
    from fidm_tpu_torch.sampling.sampler import GeneratorNoise

    pkg = Path(fidm_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(tree).resolve():
        raise RuntimeError(f"imported {pkg}, not the package in {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all(["attention"])
    build_s = time.perf_counter() - t0

    pipe = InpaintingPipeline.create(PipelineConfig(), seed=0, device="cuda")
    zero = [m for m in pipe.model.modules()
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and not m.weight.any()]
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(1)
        for m in zero:
            m.reset_parameters()
    S = pipe.config.unet.image_size
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    gt = torch.clamp(0.5 * torch.randn((BATCH, S, S, 3), device="cuda", generator=g), -1.0, 1.0)
    mask = torch.zeros((BATCH, S, S, 1), device="cuda")
    mask[:, S // 4:3 * S // 4, S // 4:3 * S // 4] = 1.0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    result = {"tree": tree, "package": str(pkg), "build_s": build_s, "presets": {},
              "loop_only": {}}
    for name in presets:
        cfg = SAMPLER_PRESETS[name]
        pipe.inpaint(gt, mask, 0, sampler=cfg)
        LAUNCHES.clear()
        calls = [timed(lambda: pipe.inpaint(gt, mask, 0, sampler=cfg)) for _ in range(repeats)]
        result["presets"][name] = {
            "s_per_call": [s for s, _ in calls],
            "s_per_sample_median": statistics.median(s for s, _ in calls) / BATCH,
            "digests": sorted({_digest(o) for _, o in calls}),
            "attention_launches": LAUNCHES.get("attention", 0)}

    # the loop alone: a "model" that hands back one precomputed output
    t = torch.full((BATCH,), 500, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        fixed = pipe.model(torch.randn_like(gt), t, gt * (1.0 - mask), mask)
    for name in presets:
        cfg = SAMPLER_PRESETS[name]
        if cfg.encoder_cache_period > 1:
            continue

        def loop():
            with torch.inference_mode():
                return inpaint_sample(lambda x, t, m, k: fixed, pipe.sched, cfg, gt=gt,
                                      mask=mask, noise=GeneratorNoise(0, "cuda"))

        loop()
        calls = [timed(loop) for _ in range(repeats)]
        result["loop_only"][name] = {"s_per_call": [s for s, _ in calls],
                                     "digests": sorted({_digest(o) for _, o in calls})}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", default=["."],
                   help="checkouts to time, in this order (repeat one to interleave)")
    p.add_argument("--presets", nargs="+", default=list(DEFAULT_PRESETS))
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the JSON summary here")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.child is not None:
        print(json.dumps(_child(args.child, args.presets, args.repeats)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        tree = str(Path(tree).resolve())
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree,
             "--repeats", str(args.repeats), "--presets", *args.presets],
            cwd=tree, capture_output=True, text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"FAIL: run {i} on {tree} exited {proc.returncode}", file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["position"] = i
        runs.append(run)
        for name, r in run["presets"].items():
            calls = " ".join(f"{s:.4f}" for s in r["s_per_call"])
            print(f"run {i} {tree}: {name} B={BATCH} s per call [{calls}], median "
                  f"{r['s_per_sample_median']:.6f} s per sample, attention launches "
                  f"{r['attention_launches']}, digests {r['digests']}", flush=True)
        for name, r in run["loop_only"].items():
            calls = " ".join(f"{s:.4f}" for s in r["s_per_call"])
            print(f"run {i} {tree}: loop alone {name} s per call [{calls}]", flush=True)
    summary = {"device": smi, "batch": BATCH, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
