"""Post-training int8 weight-only quantization CLI (PyTorch port).

Counterpart of `fidm_tpu/cli/quantize.py`, with the same flags plus
`--device`. It loads an ADM `.pt` checkpoint, quantizes every large kernel to
int8 with per-output-channel scales (absmax, or with `--calibrate DATA_DIR`
the activation-aware clipping search of `quant/calibrate.py`), writes the
quantized tree as an `.npz` in the JAX package's format (each package reads
the other's files) and prints a size report.

    python -m fidm_tpu_torch.cli.quantize --checkpoint model.pt --out model_int8.npz

On "cuda" (the default) absmax quantization rounds the tile-aligned kernels
stochastically through the CUDA kernel, as the JAX CLI does through its
Pallas kernel on a TPU; on "cpu" every kernel is rounded to nearest, as the
JAX CLI does on the CPU. Calibration draws its timesteps and noise from a
`torch.Generator` seeded by `--seed`, so it does not reproduce the JAX CLI's
draws.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..quant.npz import load_quantized

__all__ = ["parse_args", "main", "load_quantized"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="int8 weight-only PTQ")
    p.add_argument("--checkpoint", required=True, help="torch .pt to quantize")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--image_size", type=int, default=256)
    # model-shape overrides (defaults = the FFHQ-256 architecture)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[16])
    p.add_argument("--min_size", type=int, default=4096,
                   help="min tensor elements to quantize")
    p.add_argument("--calibrate", default=None, metavar="DATA_DIR",
                   help="activation-aware calibration (quant/calibrate.py): "
                        "run ~--calib_samples images from DATA_DIR through "
                        "the model at random diffusion timesteps, record "
                        "per-input-channel activation energy, and fit "
                        "per-output-channel clipping scales minimizing the "
                        "weighted weight error. Default: plain absmax scales")
    p.add_argument("--calib_mask_dir", default=None,
                   help="mask dir for calibration (default: procedural "
                        "masks)")
    p.add_argument("--calib_samples", type=int, default=128)
    p.add_argument("--calib_batch", type=int, default=8)
    p.add_argument("--schedule", default="quadratic",
                   help="beta schedule for calibration noising")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to quantize and calibrate on (default cuda; "
                        "raises when no GPU is present)")
    return p.parse_args(argv)


def _calibration_moments(args, model, device):
    """Input-channel activation moments from real data at random timesteps
    (x_t ~ q(x_t | x_0), the distribution inference visits)."""
    from ..data.dataset import InpaintingDataset
    from ..diffusion import DiffusionSchedule
    from ..diffusion.gaussian import q_sample
    from ..quant import collect_input_moments

    sched = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device=device)
    mask_mode = "serial" if args.calib_mask_dir else "procedural"
    ds = InpaintingDataset(args.calibrate, args.calib_mask_dir, split="",
                           img_size=args.image_size, mask_mode=mask_mode,
                           seed=args.seed)
    n = min(args.calib_samples, len(ds))
    gen = torch.Generator().manual_seed(args.seed)
    batches = []
    for start in range(0, n, args.calib_batch):
        items = [ds[i] for i in range(start, min(start + args.calib_batch, n))]

        def stack(key):
            return torch.from_numpy(np.stack([it[key] for it in items])).to(device)

        x0, mask, masked = stack("image"), stack("mask"), stack("masked_image")
        t = torch.randint(0, args.diffusion_steps, (x0.shape[0],), generator=gen)
        noise = torch.randn(x0.shape, generator=gen)
        t = t.to(device)
        xt = q_sample(sched, x0, t, noise.to(device))
        batches.append((xt, t, masked, mask))
    print(f"calibrating on {n} samples / {len(batches)} batches")
    return collect_input_moments(model, batches)


def main(argv=None):
    from ..models import InpaintingUNet, ffhq256_config
    from ..models.weights import jax_tree_from_state_dict, load_adm_checkpoint
    from ..quant import (
        quantize_params,
        quantize_params_calibrated,
        quantized_size_bytes,
        save_quantized,
    )

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = ffhq256_config(
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
    )
    sd = load_adm_checkpoint(args.checkpoint, cfg)
    params = jax_tree_from_state_dict({k: v.to(device) for k, v in sd.items()}, cfg)

    if args.calibrate:
        model = InpaintingUNet(cfg)
        model.load_state_dict(sd, strict=True)
        model = model.to(device).eval().requires_grad_(False)
        moments = _calibration_moments(args, model, device)
        qp = quantize_params_calibrated(params, moments, min_size=args.min_size)
    else:
        qp = quantize_params(params, min_size=args.min_size)
    before = quantized_size_bytes(params)
    after = quantized_size_bytes(qp)

    flat = save_quantized(args.out, qp)
    report = {
        "bytes_before": before,
        "bytes_after": after,
        "compression": round(before / after, 3),
        "tensors_quantized": sum(1 for k in flat if k.endswith(".__q__")),
        "calibrated": bool(args.calibrate),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
