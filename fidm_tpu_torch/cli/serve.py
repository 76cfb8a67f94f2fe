"""Serving CLI: batched inpainting over HTTP (PyTorch port).

Counterpart of `fidm_tpu/cli/serve.py`, with the same flags and defaults
(the `dpm-25-sde` preset) plus `--device`. `--program_cache DIR` makes the
warm-up capture a CUDA graph of one whole sampler call for every (preset,
batch size) and replay them for every batch; DIR keeps one manifest per
program (`serving/aot.py`). A graph does not outlive its process, so a
restart captures every listed program again: DIR says which, and checks them
against this process's software, card and model.

    python -m fidm_tpu_torch.cli.serve --checkpoint model.pt --port 8571

`--checkpoint` is an ADM `.pt`; without one the weights are random (seed 0).
On "cuda" (the default) it raises when no GPU is present.
"""
from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Inpainting inference server")
    p.add_argument("--checkpoint", default=None, help="ADM .pt checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default cuda; raises when no GPU "
                        "is present)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batch_sizes", type=int, nargs="+", default=None,
                   help="batch-size ladder (default powers of two up to "
                        "batch_size); shallow queues use the smallest fitting "
                        "size for low latency")
    p.add_argument("--max_wait_ms", type=float, default=20.0)
    p.add_argument("--no_adaptive_wait", action="store_true",
                   help="always wait out max_wait_ms before dispatching "
                        "(default: the window is only armed while the "
                        "previous batch was full, so low-load requests "
                        "dispatch immediately)")
    p.add_argument("--compress_responses", action="store_true",
                   help="zlib-compress response npz (costs tens of ms of "
                        "single-core CPU per response for <2x on float "
                        "image data; default off)")
    p.add_argument("--base_seed", type=int, default=0,
                   help="deterministic per-request seed base")
    p.add_argument("--max_queue", type=int, default=None,
                   help="queue-depth bound: past it new requests get HTTP "
                        "429 instead of joining an unbounded backlog "
                        "(default max(64, 8*batch_size))")
    p.add_argument("--drain_s", type=float, default=30.0,
                   help="graceful-shutdown budget: on exit, wait up to this "
                        "long for accepted requests to finish before "
                        "failing the remainder (0 = fail-fast)")
    p.add_argument("--default_deadline_s", type=float, default=None,
                   help="server-side default per-request deadline: requests "
                        "that would START past it are shed with HTTP 504 "
                        "(clients can override per request via npz field "
                        "'timeout_ms'; default: no shedding)")
    # dpm-25-sde: DDIM-100-class quality at 1/4 the model evaluations,
    # stochastic; the deterministic dpm++2m collapses on hard irregular
    # masks, and serving sees arbitrary client masks
    p.add_argument("--preset", default="dpm-25-sde")
    p.add_argument("--presets", nargs="+", default=None,
                   help="serve several sampler presets side by side as "
                        "per-request quality tiers (npz field 'preset'); "
                        "the FIRST is the default for unmarked requests "
                        "and overrides --preset. Warm-up runs every "
                        "(preset, batch size) once")
    p.add_argument("--program_cache", default=None,
                   help="directory of the warm programs' manifests: the "
                        "warm-up captures a CUDA graph of every (preset, batch "
                        "size) and every batch replays one; a restart "
                        "captures the listed programs again (a graph does not "
                        "outlive its process); written on first warm-up")
    p.add_argument("--refine_tier", type=float, default=None, metavar="S",
                   help="add a 'refine' preset: the default preset with "
                        "strength=S, SDEdit harmonization of a "
                        "client-supplied composite at ~S x a full run's "
                        "cost (clients select it with preset='refine' and "
                        "send their composite as 'image')")
    p.add_argument("--timesteps", type=int, nargs="+", default=None,
                   help="explicit descending timestep grid for the DEFAULT "
                        "preset (and its refine tier): how a "
                        "progressive-distillation student serves on ITS "
                        "training grid (pair with --mean_type velocity). "
                        "Overrides the preset's num_steps; requires a "
                        "ddim/ddpm/dpm default preset.")
    p.add_argument("--mean_type", default=None,
                   choices=["epsilon", "xstart", "velocity", "xprev"],
                   help="model output parameterization override for every "
                        "preset (distilled students are velocity; default: "
                        "each preset's own)")
    p.add_argument("--output_dtype", choices=["float32", "uint8"],
                   default="float32",
                   help="response image dtype, applied to every preset. "
                        "uint8 quantizes [-1,1] -> [0,255] on the device "
                        "(reference toU8 semantics): the download and the "
                        "response payload both shrink 4x")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--schedule", default="quadratic")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[16])
    return p.parse_args(argv)


def build_presets(args):
    """{name: SamplerConfig} from --preset/--presets [+ --refine_tier].

    The FIRST entry is the server default. `--timesteps` replaces the default
    preset's grid before the optional 'refine' tier (the default preset at
    strength=S) is derived from it, so a student's refine tier runs on the
    student's grid too."""
    from ..pipeline import SAMPLER_PRESETS

    names = args.presets or [args.preset]
    unknown = [n for n in names if n not in SAMPLER_PRESETS]
    if unknown:
        raise SystemExit(f"unknown presets: {unknown} "
                         f"(available: {sorted(SAMPLER_PRESETS)})")
    presets = {n: SAMPLER_PRESETS[n] for n in names}
    if args.timesteps:
        default = presets[names[0]]
        if default.method not in ("ddim", "ddpm", "dpm++2m", "dpm++2m-sde",
                                  "dpm++3m", "unipc"):
            raise SystemExit(
                f"--timesteps needs a ddim/ddpm/dpm/unipc default preset, "
                f"not {default.method!r}")
        presets[names[0]] = dataclasses.replace(
            default, timesteps=tuple(args.timesteps), num_steps=None)
    if args.refine_tier is not None:
        s = args.refine_tier
        if not 0.0 < s < 1.0:
            raise SystemExit(f"--refine_tier must be in (0, 1), got {s}")
        base = presets[names[0]]
        if base.method in ("repaint", "consistency"):
            raise SystemExit(
                f"--refine_tier needs a ddim/ddpm/dpm default preset, not "
                f"{base.method!r}")
        presets["refine"] = dataclasses.replace(base, strength=s)
    if args.mean_type:
        from ..diffusion import ModelMeanType

        mt = ModelMeanType.from_name(args.mean_type)
        presets = {n: dataclasses.replace(c, mean_type=mt)
                   for n, c in presets.items()}
    if args.output_dtype != "float32":
        presets = {n: dataclasses.replace(c, output_dtype=args.output_dtype)
                   for n, c in presets.items()}
    return presets


def build_pipeline(args, presets):
    """The pipeline the server runs: the model shape from the flags, the
    default preset as its sampler, the weights from --checkpoint."""
    from ..models import ffhq256_config
    from ..pipeline import InpaintingPipeline, PipelineConfig

    config = PipelineConfig(
        unet=ffhq256_config(
            image_size=args.image_size,
            model_channels=args.model_channels,
            channel_mult=tuple(args.channel_mult),
            num_heads=args.num_heads,
            num_head_channels=args.num_head_channels,
            attention_resolutions=tuple(args.attention_resolutions),
        ),
        schedule=args.schedule,
        num_timesteps=args.diffusion_steps,
        sampler=next(iter(presets.values())),
    )
    return InpaintingPipeline.create(config, checkpoint=args.checkpoint,
                                     device=args.device)


def main(argv=None):
    from ..serving import serve

    args = parse_args(argv)
    presets = build_presets(args)
    names = list(presets)
    pipe = build_pipeline(args, presets)
    print("warming up (every preset at every batch size)...", flush=True)
    httpd, dispatcher = serve(
        pipe, args.host, args.port, args.batch_size, args.max_wait_ms,
        batch_sizes=tuple(args.batch_sizes) if args.batch_sizes else None,
        base_seed=args.base_seed, warmup=True,
        program_cache_dir=args.program_cache,
        compress_responses=args.compress_responses,
        adaptive_wait=not args.no_adaptive_wait,
        presets=presets, max_queue=args.max_queue,
        default_deadline_s=args.default_deadline_s,
    )
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(batch sizes {dispatcher.batch_sizes}, presets {names}, "
          f"default {names[0]}, device {pipe.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        # graceful: let accepted requests finish before failing the rest
        dispatcher.close(drain_s=args.drain_s)


if __name__ == "__main__":
    main()
