"""Noise-schedule visualization CLI (PyTorch port of
`fidm_tpu/cli/visualize_noise.py`).

Forward-noises an image at chosen timesteps under each beta schedule, saves
the grid (`noising_grid.png`: one row per schedule, one column per
timestep), plots the beta / alpha-bar / SNR curves (`schedule_curves.png`,
when matplotlib is installed) and prints the SNR table at the timesteps:

    python -m fidm_tpu_torch.cli.visualize_noise --image face.png --out noise_vis/

The flags and defaults are the JAX CLI's, plus `--device` (default cuda;
raises without a GPU). The noise is a numpy standard-normal draw seeded with
`--seed` (the JAX CLI draws from threefry, which torch cannot reproduce).
The SNR table is alpha_bar / (1 - alpha_bar) from the schedule's float32
alpha_bar, as the JAX CLI computes it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize beta schedules")
    p.add_argument("--image", default=None,
                   help="input image (synthetic gradient if omitted)")
    p.add_argument("--out", default="noise_visualization")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--schedules", nargs="+",
                   default=["linear", "cosine", "quadratic"])
    p.add_argument("--timesteps", nargs="+", type=int,
                   default=[0, 50, 100, 250, 500, 750, 999])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {schedule: SNR at every timestep}, float64."""
    from ..data.dataset import load_image
    from ..device import resolve_device
    from ..diffusion import DiffusionSchedule
    from ..diffusion.gaussian import q_sample
    from ..utils import save_comparison_grid, to_uint8

    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if args.image:
        img = load_image(args.image, args.image_size)
    else:
        # synthetic radial gradient test image
        yy, xx = np.mgrid[0: args.image_size, 0: args.image_size]
        r = np.sqrt((yy - args.image_size / 2) ** 2 + (xx - args.image_size / 2) ** 2)
        img = np.stack([np.cos(r / 8), np.sin(r / 13), np.cos(r / 21)], -1)
        img = img.astype(np.float32) * 0.8

    x0 = torch.as_tensor(np.asarray(img, np.float32)[None], device=device)
    noise = torch.as_tensor(
        np.random.default_rng(args.seed).standard_normal(x0.shape).astype(np.float32),
        device=device)

    rows = []
    snr_table = {}
    scheds = {}
    for name in args.schedules:
        sched = scheds[name] = DiffusionSchedule.create(name, args.steps, device=device)
        ts = torch.tensor(args.timesteps, device=device)
        xt = q_sample(sched, x0.expand(len(ts), -1, -1, -1), ts, noise.expand(len(ts), -1, -1, -1))
        rows.append([to_uint8(a) for a in xt.cpu().numpy()])
        acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
        snr_table[name] = acp / (1 - acp)

    save_comparison_grid(rows, os.path.join(args.out, "noising_grid.png"))
    print(f"grid (rows={args.schedules}, cols=t{args.timesteps}) -> "
          f"{args.out}/noising_grid.png")

    # curves
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for name in args.schedules:
            axes[0].plot(scheds[name].betas.cpu().numpy(), label=name)
            axes[1].plot(scheds[name].alphas_cumprod.cpu().numpy(), label=name)
            axes[2].semilogy(snr_table[name], label=name)
        for ax, title in zip(axes, ["beta_t", "alpha_bar_t", "SNR (log)"]):
            ax.set_title(title)
            ax.set_xlabel("t")
            ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, "schedule_curves.png"), dpi=120)
        plt.close(fig)
        print(f"curves -> {args.out}/schedule_curves.png")
    except ImportError:
        print("matplotlib unavailable; skipped curves")

    # SNR table at the sampled timesteps
    print(f"{'t':>6} " + " ".join(f"{n:>14}" for n in args.schedules))
    for t in args.timesteps:
        print(f"{t:>6} " + " ".join(
            f"{snr_table[n][t]:>14.4f}" for n in args.schedules))
    return snr_table


if __name__ == "__main__":
    main()
