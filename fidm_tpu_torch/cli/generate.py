"""Unconditional generation CLI (the base FFHQ model, no inpainting);
PyTorch port of `fidm_tpu/cli/generate.py`.

The library path of the reference's `p_sample_loop` / `ddim_sample_loop`
without injection, e.g. the DDPM-1000 baseline of a pretrained model:

    python -m fidm_tpu_torch.cli.generate --checkpoint ffhq.pt --num_samples 16

`--checkpoint` takes a torch `.pt` of the 3-channel base UNet (6 output
channels, learned-range variance), or a training checkpoint directory of
`cli.train`, whose 9-channel inpainting model is sampled with full-hole
conditioning (its latest step, the EMA with `--use_ema`, a LoRA adapter
merged onto its `lora_base/`, its recorded `mean_type`); without one the
weights are random (torch's init, seed `--seed`). Writes `{i:05d}.png` per sample and
`grid.png` (the first 16, 4 a row) to `--output_dir`. The flags and defaults
are the JAX CLI's, plus `--device` (default cuda; raises without a GPU).

Each batch's noise is `GeneratorNoise` seeded from (`--seed`, the index of
the batch's first sample), as `cli.evaluate.batch_noise` makes it; the JAX
CLI folds that offset into its key, whose threefry draws torch cannot
reproduce, so the two CLIs sample other noise.

The JAX CLI does not merge a LoRA adapter here; the port does, with
`cli.evaluate`'s code.
"""
from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Unconditional sampling")
    p.add_argument("--checkpoint", default=None,
                   help="torch .pt (3-channel base UNet) or a training "
                        "checkpoint dir (cli.train)")
    p.add_argument("--use_ema", action="store_true",
                   help="native dir: sample the EMA parameters")
    p.add_argument("--output_dir", default="generated")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[16])
    p.add_argument("--method", default="ddpm",
                   choices=["ddpm", "ddim", "dpm++2m", "dpm++3m",
                            "unipc", "consistency"],
                   help="dpm++3m/unipc: higher-order solvers; consistency: "
                        "1-2 step sampling from a consistency-trained or "
                        "distilled model (defaults to 2 steps; pair with "
                        "--mean_type velocity)")
    p.add_argument("--mean_type", default=None,
                   choices=["epsilon", "xstart", "velocity"],
                   help="default: velocity for --method consistency, else "
                        "epsilon")
    p.add_argument("--ddim_timesteps", type=int, default=None)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--schedule", default="linear")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    return p.parse_args(argv)


def build_sampler(args, meta_mean_type=None):
    """The sampler config the JAX CLI builds from the same flags (and the
    `mean_type` a training checkpoint recorded)."""
    from ..diffusion import ModelMeanType
    from ..sampling import SamplerConfig

    num_steps = args.ddim_timesteps if args.method != "ddpm" else None
    if args.method == "consistency" and num_steps is None:
        num_steps = 2  # 1-2 evaluations is the method's operating point
    if args.mean_type is not None:
        mean_type = ModelMeanType.from_name(args.mean_type)
    elif meta_mean_type:
        mean_type = ModelMeanType.from_name(meta_mean_type)
    else:
        # consistency students are velocity-parameterized by default
        mean_type = (ModelMeanType.VELOCITY if args.method == "consistency"
                     else ModelMeanType.EPSILON)
    return SamplerConfig(method=args.method, num_steps=num_steps, eta=args.eta,
                         injection=False, final_blend=False, mean_type=mean_type)


def build_model(args, device):
    """The 3-channel base UNet of the flags' shape on `device`: from the
    `.pt`, else randomly initialised from `--seed`."""
    from ..models import UNet, ffhq256_config
    from ..models.weights import load_adm_checkpoint

    cfg = ffhq256_config(
        in_channels=3,
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = UNet(cfg)
    if args.checkpoint:
        model.load_state_dict(load_adm_checkpoint(args.checkpoint, cfg), strict=True)
    return model.to(device).eval().requires_grad_(False)


def build_checkpoint_model(args, device):
    """A training checkpoint directory's 9-channel inpainting model, sampled
    unconditionally with full-hole conditioning (masked image 0, mask 1: the
    model sees no known pixel), as the JAX CLI does: its latest step (the
    EMA with `--use_ema`; a LoRA adapter merged onto `lora_base/`). Returns
    (model(x, t), the recorded mean_type or None)."""
    from ..models import InpaintingUNet, ffhq256_config
    from .train import checkpoint_mean_type, load_checkpoint_params

    cfg = ffhq256_config(
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
    )
    params = load_checkpoint_params(args.checkpoint, "latest", args.use_ema, cfg)
    meta_mt = checkpoint_mean_type(args.checkpoint, "latest")
    if meta_mt:
        print(f"mean_type '{meta_mt}' from checkpoint metadata")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model9 = InpaintingUNet(cfg)
    model9.load_state_dict(params, strict=True)
    model9 = model9.to(device).eval().requires_grad_(False)
    S = args.image_size

    def model_apply(x, t):
        B = x.shape[0]
        return model9(x, t, torch.zeros((B, S, S, 3), dtype=x.dtype, device=x.device),
                      torch.ones((B, S, S, 1), dtype=x.dtype, device=x.device))

    return model_apply, meta_mt


def main(argv=None):
    from ..device import resolve_device
    from ..diffusion import DiffusionSchedule
    from ..sampling import sample
    from ..utils import save_comparison_grid, save_png, to_uint8
    from .evaluate import batch_noise

    args = parse_args(argv)
    if args.checkpoint and os.path.isdir(args.checkpoint):
        from .train import require_checkpoint

        require_checkpoint(args.checkpoint)
    device = resolve_device(args.device)
    sched = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device=device)
    if args.checkpoint and os.path.isdir(args.checkpoint):
        model, meta_mt = build_checkpoint_model(args, device)
    else:
        model, meta_mt = build_model(args, device), None
    scfg = build_sampler(args, meta_mt)
    S = args.image_size

    os.makedirs(args.output_dir, exist_ok=True)
    done, imgs = 0, []
    while done < args.num_samples:
        with torch.inference_mode():
            out = sample(model, sched, scfg, shape=(args.batch_size, S, S, 3),
                         noise=batch_noise(args.seed, done, device)).cpu().numpy()
        for i in range(min(args.batch_size, args.num_samples - done)):
            save_png(to_uint8(out[i]), os.path.join(args.output_dir, f"{done + i:05d}.png"))
            imgs.append(to_uint8(out[i]))
        done += args.batch_size
    rows = [imgs[i: i + 4] for i in range(0, min(len(imgs), 16), 4)]
    save_comparison_grid(rows, os.path.join(args.output_dir, "grid.png"))
    n = min(done, args.num_samples)
    print(f"saved {n} samples to {args.output_dir}")
    return n


if __name__ == "__main__":
    main()
