"""Unified evaluation/inference CLI with presets (PyTorch port of
`fidm_tpu/cli/evaluate.py`).

One config-driven harness in place of the reference's six forked eval
scripts (SURVEY.md §2):

    python -m fidm_tpu_torch.cli.evaluate --data_dir ... --mask_dir ... \
        --preset ddim-100 --num_samples 100 --checkpoint model.pt

Batched sampling on the card, per-sample timing, per-image PNGs and
comparison grids, SSIM/PSNR and their hole-region variants, the proxy FID,
InceptionV3 FID and KID with `--fid_weights`, LPIPS with `--lpips_alexnet`
and `--lpips_lin`, and `metrics.txt` / `metrics.json` in the JAX CLI's
layout (`InpaintingSampler.run_sampling`, `test_inpainting_better.py:715-807`).

The flags and defaults are the JAX CLI's, plus `--device` (default cuda;
raises without a GPU). `--checkpoint` takes an ADM `.pt` or an int8 `.npz`
of either package; without one the weights are random (seed `--seed`).
Each batch's noise comes from `batch_noise(seed, batch index)`, a
`GeneratorNoise`: the JAX CLI folds the batch index into its key, whose
threefry draws torch cannot reproduce, so the two CLIs sample other noise.
`backend` in the results names the torch device type ("cuda" or "cpu").

Not ported yet, and refused with NotImplementedError: orbax checkpoint
directories (with `--use_ema` or LoRA adapters; they come with training),
`--save_trajectory` (with the rest of sampling) and `--program_cache` (with
a CUDA-graph warm cache). Presets whose method is not ported raise
NotImplementedError before the model is built. The JAX CLI's persistent
compilation cache has no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batched inpainting evaluation")
    p.add_argument("--config", default=None,
                   help="JSON file of argument defaults (CLI flags override)")
    p.add_argument("--data_dir", required=True, help="test images directory")
    p.add_argument("--mask_dir", required=True,
                   help="mask root (with test/ subdir) or flat mask dir")
    p.add_argument("--output_dir", default="inpainting_results")
    p.add_argument("--checkpoint", default=None,
                   help="ADM torch .pt or int8 .npz (random init if absent)")
    p.add_argument("--preset", default="ddim-100",
                   help="ddpm-1000 | ddpm-250 | ddpm-100 | ddim-30 | ddim-50 "
                        "| ddim-50-eta0.75 | ddim-100 | ddim-100-det | "
                        "ddim-20-fast | dpm-25 | dpm-20 | dpm-20-fast | "
                        "dpm-25-sde | dpm3-20 | dpm3-12 | repaint-250 | "
                        "repaint-100-light | consistency-1 | consistency-2")
    p.add_argument("--time_spacing", default=None,
                   choices=["uniform", "trailing", "lambda", "karras"],
                   help="how steps are placed on the chain (default: preset)")
    p.add_argument("--ddim_timesteps", type=int, default=None,
                   help="override preset step count")
    p.add_argument("--timesteps", type=int, nargs="+", default=None,
                   help="explicit descending timestep grid (overrides "
                        "step count) — e.g. a distilled student's grid")
    p.add_argument("--eta", type=float, default=None, help="override preset eta")
    p.add_argument("--schedule", default="quadratic",
                   choices=["linear", "cosine", "quadratic", "sqrt"])
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[16])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_injection", action="store_true")
    p.add_argument("--no_blend", action="store_true")
    p.add_argument("--injection_schedule", default="all",
                   choices=["all", "high", "low"])
    p.add_argument("--mean_type", default=None,
                   choices=["epsilon", "xstart", "velocity", "xprev"],
                   help="model output parameterization (velocity = distilled "
                        "students). Default: the preset's (epsilon for all "
                        "but the consistency presets)")
    p.add_argument("--quantize", default="none", choices=["none", "int8"])
    p.add_argument("--encoder_cache", type=int, default=None,
                   help="UNet encoder-reuse period (Faster-Diffusion style); "
                        "run the encoder every k-th step, decoder-only in "
                        "between. 1 = exact sampling (presets may default "
                        "higher, e.g. ddim-20-fast)")
    p.add_argument("--jump_length", type=int, default=None,
                   help="RePaint time-travel jump size (repaint presets)")
    p.add_argument("--jump_n_sample", type=int, default=None,
                   help="RePaint resamplings per segment (1 = plain DDPM)")
    p.add_argument("--encoder_cache_tail", type=int, default=None,
                   help="always run the full model on the last N steps "
                        "(caching hurts most near t=0)")
    p.add_argument("--cache_branch", type=int, default=None,
                   help="with --encoder_cache k>1: 0 = cache encoder+middle "
                        "(default), b>0 = DeepCache deep-trunk mode — cache "
                        "the decoder feature at branch depth b and recompute "
                        "only UNet levels 0..b-1 on non-key steps, -1 = "
                        "output reuse — skip the model entirely on non-key "
                        "steps (cheapest, coarsest)")
    p.add_argument("--cache_keysteps", default=None,
                   help="with --encoder_cache k>1: explicit full-evaluation "
                        "schedule replacing the periodic gate. Either a "
                        "comma list of ascending step indices starting at 0 "
                        "('0,3,7,...') or 'N@center:power' to generate an "
                        "N-evaluation non-uniform grid (DeepCache §4.2), "
                        "e.g. '17@1.0:2.0'")
    p.add_argument("--save_trajectory", type=int, default=0, metavar="K",
                   help="save every K-th intermediate sampler state as a "
                        "per-sample strip PNG (not ported yet: 0 only)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="compute dtype of the UNet's activations (parameters "
                        "stay float32)")
    p.add_argument("--program_cache", default=None,
                   help="directory of saved sampling programs (not ported "
                        "yet: refused)")
    p.add_argument("--quick_test", action="store_true",
                   help="8 samples, 2 batches, 10 DDIM steps "
                        "(test_inpainting_better.py:865-889)")
    p.add_argument("--save_images", action="store_true", default=True)
    p.add_argument("--no_save_images", dest="save_images", action="store_false")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA parameters of an orbax training "
                        "checkpoint (not ported yet)")
    p.add_argument("--lpips_alexnet", default=None,
                   help="path to torchvision AlexNet .pth for real LPIPS")
    p.add_argument("--lpips_lin", default=None,
                   help="path to lpips linear-head .pt")
    p.add_argument("--fid_weights", default=None,
                   help="path to a pt_inception-2015-12-05-layout torch "
                        "checkpoint; enables the real InceptionV3 FID "
                        "(without it only the proxy FID is reported)")
    p.add_argument("--fid_stats", default=None,
                   help=".npz of precomputed reference statistics "
                        "(cli.fid_stats); FID is then computed against "
                        "that fixed reference set instead of this run's "
                        "ground-truth images")
    p.add_argument("--device", default="cuda",
                   help="device to sample and score on (default cuda; raises "
                        "when no GPU is present)")
    args, _ = p.parse_known_args(argv)
    if args.config:
        with open(args.config) as f:
            p.set_defaults(**json.load(f))
    return p.parse_args(argv)


def batch_noise(seed: int, bi: int, device):
    """The sampler's noise source for batch `bi` of a run seeded with
    `seed`: a `GeneratorNoise` whose seed is drawn from (seed, bi)."""
    from ..sampling import GeneratorNoise

    return GeneratorNoise(int(np.random.SeedSequence([seed, bi]).generate_state(1, np.uint64)[0]),
                          device)


def _refuse_unported(args):
    """The JAX CLI's branches that later parts of the port bring, refused
    before anything is built."""
    if args.checkpoint and os.path.isdir(args.checkpoint):
        raise NotImplementedError(
            f"{args.checkpoint} is a directory: orbax training checkpoints "
            "(and --use_ema, LoRA adapters) are not ported yet; they come "
            "with the training port. Pass an ADM .pt or an int8 .npz")
    if args.save_trajectory:
        raise NotImplementedError(
            "--save_trajectory is not ported yet: it comes with the rest of "
            "sampling (trajectory_every)")
    if args.program_cache:
        raise NotImplementedError(
            "--program_cache is not ported yet: it comes with the warm cache "
            "(CUDA-graph captures per preset and batch size)")


def build_sampler(args):
    """The preset with the CLI's overrides applied, as the JAX CLI applies
    them (without checkpoint metadata: orbax directories are refused)."""
    from ..diffusion import ModelMeanType
    from ..pipeline import SAMPLER_PRESETS

    sampler = SAMPLER_PRESETS[args.preset]
    if args.ddim_timesteps is not None and sampler.method in (
            "ddim", "ddpm", "dpm++2m", "dpm++2m-sde", "dpm++3m", "unipc",
            "repaint", "consistency"):
        sampler = dataclasses.replace(sampler, num_steps=args.ddim_timesteps)
    if args.jump_length is not None:
        sampler = dataclasses.replace(sampler, jump_length=args.jump_length)
    if args.jump_n_sample is not None:
        sampler = dataclasses.replace(sampler, jump_n_sample=args.jump_n_sample)
    if args.eta is not None:
        sampler = dataclasses.replace(sampler, eta=args.eta)
    mean_type = (ModelMeanType.from_name(args.mean_type) if args.mean_type is not None
                 else sampler.mean_type)
    sampler = dataclasses.replace(
        sampler,
        injection=not args.no_injection,
        injection_schedule=args.injection_schedule,
        final_blend=not args.no_blend,
        mean_type=mean_type,
    )
    if args.time_spacing is not None:
        sampler = dataclasses.replace(sampler, time_spacing=args.time_spacing)
    if args.timesteps is not None:
        sampler = dataclasses.replace(sampler, timesteps=tuple(args.timesteps))
    if args.encoder_cache is not None:
        sampler = dataclasses.replace(sampler, encoder_cache_period=args.encoder_cache)
    if args.cache_branch is not None:
        sampler = dataclasses.replace(sampler, cache_branch=args.cache_branch)
    if args.encoder_cache_tail is not None:
        sampler = dataclasses.replace(sampler, encoder_cache_tail=args.encoder_cache_tail)
    if args.cache_keysteps is not None:
        from ..diffusion import DiffusionSchedule
        from ..sampling.sampler import _respaced_seq, host_alphas_cumprod, keysteps_from_spec

        if sampler.method in ("consistency", "repaint"):
            # their step grids differ in length from _respaced_seq, so an
            # "N@center:power" spec would be scaled to the wrong K
            raise SystemExit(
                f"--cache_keysteps is not supported with "
                f"method={sampler.method!r} (its step grid is not the "
                f"respaced DDIM grid the spec is scaled to)")
        sched = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device="cpu")
        n_grid = len(_respaced_seq(sched, sampler, host_alphas_cumprod(sched)))
        sampler = dataclasses.replace(
            sampler, cache_keysteps=keysteps_from_spec(args.cache_keysteps, n_grid))
    return sampler


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def build_pipeline(args, sampler):
    """The pipeline on `--device`: the model shape from the flags, the
    weights from `--checkpoint` (`.pt` or int8 `.npz`), then `--quantize
    int8` (quantized and dequantized on the device: the quantize kernel on
    the card)."""
    from ..models import ffhq256_config
    from ..models.weights import jax_tree_from_state_dict, state_dict_from_jax
    from ..pipeline import InpaintingPipeline, PipelineConfig
    from ..quant import dequantize_params, load_quantized_state_dict, quantize_params

    config = PipelineConfig(
        unet=ffhq256_config(
            dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
            image_size=args.image_size,
            model_channels=args.model_channels,
            channel_mult=tuple(args.channel_mult),
            num_heads=args.num_heads,
            num_head_channels=args.num_head_channels,
            attention_resolutions=tuple(args.attention_resolutions),
        ),
        schedule=args.schedule,
        num_timesteps=args.diffusion_steps,
        sampler=sampler,
    )
    ckpt = args.checkpoint
    if args.use_ema:
        print("WARNING: --use_ema ignored — only orbax training checkpoints "
              "carry EMA parameters")
    if ckpt and ckpt.endswith(".npz"):
        pipe = InpaintingPipeline.create(config, seed=args.seed, device=args.device)
        pipe.model.load_state_dict(load_quantized_state_dict(ckpt, config.unet), strict=True)
        print(f"loaded int8-quantized params from {ckpt}")
    else:
        pipe = InpaintingPipeline.create(config, checkpoint=ckpt, seed=args.seed,
                                         device=args.device)
    if args.quantize == "int8":
        params = jax_tree_from_state_dict(pipe.model.state_dict(), config.unet)
        deq = dequantize_params(quantize_params(params))
        pipe.model.load_state_dict(state_dict_from_jax(_to_cpu(deq), config.unet), strict=True)
        print("int8 weight-only quantization applied")
    return pipe


def main(argv=None):
    from ..data import create_inference_dataloader
    from ..metrics import (
        LPIPS,
        InceptionFeatureExtractor,
        RandomConvFeatureExtractor,
        fid_from_features,
        masked_psnr,
        masked_ssim,
        psnr,
        ssim,
    )
    from ..metrics.ssim import DEFAULT_WIN_SIZE
    from ..sampling.sampler import _check_ported
    from ..utils import StepTimer, save_comparison_grid, save_png, to_uint8

    args = parse_args(argv)
    if args.quick_test:
        args.num_samples = 8
        args.batch_size = 4
        args.ddim_timesteps = args.ddim_timesteps or 10
    _refuse_unported(args)
    if args.fid_stats and not args.fid_weights:
        raise ValueError(
            "--fid_stats requires --fid_weights (the same InceptionV3 "
            "checkpoint the stats were computed with)")
    sampler = build_sampler(args)
    _check_ported(sampler, None)
    pipe = build_pipeline(args, sampler)
    device = pipe.device

    loader = create_inference_dataloader(
        args.data_dir, args.mask_dir, batch_size=args.batch_size,
        img_size=args.image_size, num_samples=args.num_samples, seed=args.seed,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    timer = StepTimer()
    reals, fakes = [], []
    ssims, psnrs, lpips_vals = [], [], []
    hole_ssims, hole_psnrs, hole_lpips = [], [], []
    lpips_fn = None
    if args.lpips_alexnet and args.lpips_lin:
        lpips_fn = LPIPS.from_torch_files(args.lpips_alexnet, args.lpips_lin, device=device)
    inception = None
    if args.fid_weights:
        inception = InceptionFeatureExtractor.from_torch_file(args.fid_weights, device=device)

    n_done = 0
    for bi, batch in enumerate(loader):
        gt = batch["image"]
        mask = batch["mask"]
        if gt.shape[0] < args.batch_size:
            # pad the trailing partial batch to keep one batch shape
            pad = args.batch_size - gt.shape[0]
            gt = np.concatenate([gt, np.repeat(gt[-1:], pad, 0)])
            mask = np.concatenate([mask, np.repeat(mask[-1:], pad, 0)])
        else:
            pad = 0
        timer.start()
        out_d = pipe.inpaint(gt, mask, args.seed, noise=batch_noise(args.seed, bi, device))
        timer.stop(out_d)
        gt_d = torch.as_tensor(gt, device=device)
        mask_d = torch.as_tensor(mask, device=device)
        if pad:
            out_d, gt_d, mask_d = out_d[:-pad], gt_d[:-pad], mask_d[:-pad]
            gt, mask = gt[:-pad], mask[:-pad]
        out = out_d.cpu().numpy()

        gt01_d = (gt_d + 1) / 2
        out01_d = (out_d + 1) / 2
        ssims.extend(ssim(gt01_d, out01_d).tolist())
        psnrs.extend(psnr(gt01_d, out01_d).tolist())
        # hole-region metrics: with blending, the rest of the image is GT.
        # Unscorable samples become None (not dropped), keeping per-sample
        # arrays aligned with dataset/PNG order: PSNR needs a non-empty
        # mask; SSIM additionally needs hole pixels with a centred valid
        # window (outside the (win-1)/2 border band, metrics/ssim.py)
        m = np.asarray(mask)
        r = (DEFAULT_WIN_SIZE - 1) // 2  # centred-window border band
        scorable_psnr = m.sum(axis=(1, 2, 3)) > 0
        scorable_ssim = m[:, r:m.shape[1] - r, r:m.shape[2] - r].sum(
            axis=(1, 2, 3)) > 0
        hs = masked_ssim(gt01_d, out01_d, mask_d).tolist()
        hp = masked_psnr(gt01_d, out01_d, mask_d).tolist()
        hole_ssims.extend(
            float(v) if ok else None for v, ok in zip(hs, scorable_ssim))
        hole_psnrs.extend(
            float(v) if ok else None for v, ok in zip(hp, scorable_psnr))
        if lpips_fn is not None:
            lpips_vals.extend(lpips_fn(gt_d, out_d).tolist())
            hl = lpips_fn.masked(gt_d, out_d, mask_d)
            hole_lpips.extend(
                float(v) if ok else None
                for v, ok in zip(hl, scorable_psnr))
        reals.append(gt01_d.cpu().numpy())
        fakes.append(out01_d.cpu().numpy())

        if args.save_images:
            for i in range(out.shape[0]):
                idx = n_done + i
                save_png(to_uint8(out[i]),
                         os.path.join(args.output_dir, "inpainted",
                                      f"{idx:05d}.png"))
                save_png(to_uint8(gt[i]),
                         os.path.join(args.output_dir, "original",
                                      f"{idx:05d}.png"))
            grid_rows = [
                [to_uint8(gt[i]), to_uint8(gt[i] * (1 - mask[i])),
                 (mask[i] * 255).astype(np.uint8), to_uint8(out[i])]
                for i in range(min(out.shape[0], 4))
            ]
            save_comparison_grid(
                grid_rows,
                os.path.join(args.output_dir, f"comparison_batch{bi:03d}.png"),
            )
        n_done += out.shape[0]
        print(f"batch {bi}: {out.shape[0]} samples, "
              f"{timer.times[-1]/args.batch_size:.3f}s/sample")

    extractor = RandomConvFeatureExtractor(image_size=args.image_size, device=device)
    fid_proxy = fid_from_features(
        np.concatenate([extractor(r) for r in reals]),
        np.concatenate([extractor(f) for f in fakes]),
    )
    fid_real = None
    kid = None
    if inception is not None:
        from ..metrics import compute_statistics, frechet_distance, kid_from_features

        fake_feats = np.concatenate([inception(f) for f in fakes])
        mu_f, sig_f = compute_statistics(fake_feats)
        if args.fid_stats:
            ref = np.load(args.fid_stats)
            fid_real = frechet_distance(ref["mu"], ref["sigma"], mu_f, sig_f)
            if "features" in ref and len(fake_feats) >= 2:
                # stats files written by cli.fid_stats carry the raw
                # features, so KID works against the fixed reference set
                # too (older mu/sigma-only files skip it)
                kid = kid_from_features(
                    ref["features"].astype(np.float64), fake_feats,
                    seed=args.seed)
        else:
            real_feats = np.concatenate([inception(r) for r in reals])
            mu_r, sig_r = compute_statistics(real_feats)
            fid_real = frechet_distance(mu_r, sig_r, mu_f, sig_f)
            if len(real_feats) >= 2 and len(fake_feats) >= 2:
                # unbiased companion to FID — meaningful at sample counts
                # where the 2048x2048 covariance estimate is badly biased
                kid = kid_from_features(real_feats, fake_feats,
                                        seed=args.seed)

    results = {
        "num_samples": n_done,
        "preset": args.preset,
        "sampler": str(sampler),
        "ssim_mean": float(np.mean(ssims)),
        "psnr_mean": float(np.mean(psnrs)),
        # None (JSON null) when no sample was scorable — never NaN, which
        # json.dump would emit as an invalid-JSON token
        "hole_ssim_mean": (
            float(np.mean([v for v in hole_ssims if v is not None]))
            if any(v is not None for v in hole_ssims) else None),
        "hole_psnr_mean": (
            float(np.mean([v for v in hole_psnrs if v is not None]))
            if any(v is not None for v in hole_psnrs) else None),
        "fid_proxy": float(fid_proxy),
        # includes the first (warm-up) batch — the reference harness times
        # the same way (test_inpainting_better.py:732-739)
        "time_per_sample_s": timer.mean / args.batch_size,
        # steady-state throughput, excluding the first batch
        "time_per_sample_steady_s": (
            float(np.mean(timer.times[1:])) / args.batch_size
            if len(timer.times) > 1 else timer.mean / args.batch_size
        ),
        "backend": device.type,
    }
    if fid_real is not None:
        results["fid"] = float(fid_real)
    if kid is not None:
        results["kid_mean"], results["kid_std"] = kid
    if lpips_vals:
        results["lpips_mean"] = float(np.mean(lpips_vals))
        if any(v is not None for v in hole_lpips):
            results["hole_lpips_mean"] = float(
                np.mean([v for v in hole_lpips if v is not None]))
    with open(os.path.join(args.output_dir, "metrics.txt"), "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
    # metrics.json additionally carries per-sample values (in dataset
    # order) for downstream analysis without rerunning the sampler
    per_sample = {"ssim": ssims, "psnr": psnrs, "hole_ssim": hole_ssims,
                  "hole_psnr": hole_psnrs}
    if lpips_vals:
        per_sample["lpips"] = lpips_vals
        per_sample["hole_lpips"] = hole_lpips
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump({**results, "per_sample": per_sample}, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
