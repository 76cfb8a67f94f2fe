"""Precompute FID reference statistics (mu, sigma) for an image directory
(PyTorch port of `fidm_tpu/cli/fid_stats.py`, with the same flags plus
`--device`, default cuda).

FID compares generated samples against a FIXED reference distribution, so
the real set's InceptionV3 features are extracted once: this mirrors
pytorch-fid's `--save-stats` flow (the reference shells out to pytorch-fid,
`test_inpainting_better.py:151-223`). It writes `{mu, sigma, num_images,
dim, features}` (features as float16) to an `.npz` that
`cli.evaluate --fid_stats stats.npz` (with the same `--fid_weights`) scores
runs against; the JAX package's CLIs read the same file.

    python -m fidm_tpu_torch.cli.fid_stats --data_dir ffhq_test/ \
        --fid_weights pt_inception-2015-12-05.pth --out ffhq_test_stats.npz

Directory-compare mode (`--fake_dir`) is pytorch-fid's two-dirs protocol:
it scores a directory of saved generated PNGs against a real-image
directory or precomputed stats, and prints FID (and KID when raw real
features are at hand):

    python -m fidm_tpu_torch.cli.fid_stats --fake_dir out/inpainted \
        --data_dir ffhq_test/ --fid_weights ...      # dir vs dir
    python -m fidm_tpu_torch.cli.fid_stats --fake_dir out/inpainted \
        --fid_stats ffhq_test_stats.npz --fid_weights ...  # dir vs stats
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Precompute FID reference statistics for a dataset")
    p.add_argument("--data_dir", default=None,
                   help="real-image directory (required unless --fid_stats "
                        "provides the reference side)")
    p.add_argument("--fid_weights", required=True,
                   help="pt_inception-2015-12-05-layout torch checkpoint")
    p.add_argument("--out", default=None,
                   help="output .npz path (required in stats mode; optional "
                        "with --fake_dir to also persist the real-side "
                        "stats)")
    p.add_argument("--fake_dir", default=None,
                   help="directory of generated PNGs to score against the "
                        "reference side (pytorch-fid two-dirs protocol); "
                        "prints FID (+ KID when raw features are available)")
    p.add_argument("--fid_stats", default=None,
                   help="precomputed reference stats .npz (from a prior "
                        "run) to use as the real side instead of --data_dir")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_samples", type=int, default=None,
                   help="cap the number of images (default: all)")
    p.add_argument("--device", default="cuda",
                   help="device for the InceptionV3 forwards (default cuda; "
                        "raises when no GPU is present)")
    args = p.parse_args(argv)
    if args.fake_dir is None and args.out is None:
        p.error("--out is required in stats mode (no --fake_dir)")
    if args.data_dir is None and args.fid_stats is None:
        p.error("provide a reference side: --data_dir or --fid_stats")
    return args


def compute_stats_for_dir(data_dir: str, extractor, batch_size: int = 32,
                          image_size: int = 256, num_samples=None):
    """(mu, sigma, n, features) of pool3 features over a directory."""
    import glob
    import os

    from ..data.dataset import load_image
    from ..metrics.fid import compute_statistics

    exts = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.webp")
    paths = sorted(p for e in exts
                   for p in glob.glob(os.path.join(data_dir, "**", e),
                                      recursive=True))
    if not paths:
        raise FileNotFoundError(f"no images under {data_dir}")
    if num_samples is not None:
        paths = paths[:num_samples]
    feats = []
    for start in range(0, len(paths), batch_size):
        imgs = np.stack([load_image(p, image_size)
                         for p in paths[start:start + batch_size]])
        feats.append(extractor((imgs + 1.0) / 2.0))  # [-1,1] -> [0,1]
    feats = np.concatenate(feats, axis=0)
    mu, sigma = compute_statistics(feats)
    return mu, sigma, len(paths), feats


def main(argv=None):
    from ..metrics import InceptionFeatureExtractor

    args = parse_args(argv)
    extractor = InceptionFeatureExtractor.from_torch_file(args.fid_weights,
                                                          device=args.device)

    ref_feats = None
    if args.fid_stats:
        ref = np.load(args.fid_stats)
        mu, sigma, n = ref["mu"], ref["sigma"], int(ref["num_images"])
        if "features" in ref:
            ref_feats = ref["features"].astype(np.float64)
    else:
        mu, sigma, n, ref_feats = compute_stats_for_dir(
            args.data_dir, extractor, batch_size=args.batch_size,
            image_size=args.image_size, num_samples=args.num_samples)
    if args.out:
        # raw features ride along (f16, ~4 MB per 1k images) so evaluate
        # can also compute KID against the fixed reference set; (mu, sigma)
        # alone only supports the Frechet distance. A --fid_stats input
        # without features stays (mu, sigma)-only on re-save.
        extra = ({"features": ref_feats.astype(np.float16)}
                 if ref_feats is not None else {})
        np.savez(args.out, mu=mu, sigma=sigma, num_images=n,
                 dim=extractor.dim, **extra)
        print(f"wrote {args.out}: {n} images, dim {extractor.dim}")
    if args.fake_dir is None:
        return {"num_images": n, "dim": extractor.dim, "out": args.out}

    import json

    from ..metrics import kid_from_features
    from ..metrics.fid import compute_statistics, frechet_distance

    _, _, n_fake, fake_feats = compute_stats_for_dir(
        args.fake_dir, extractor, batch_size=args.batch_size,
        image_size=args.image_size, num_samples=args.num_samples)
    mu_f, sig_f = compute_statistics(fake_feats)
    report = {"fid": float(frechet_distance(mu, sigma, mu_f, sig_f)),
              "num_real": n, "num_fake": n_fake}
    if ref_feats is not None and n_fake >= 2 and len(ref_feats) >= 2:
        k_mean, k_std = kid_from_features(
            np.asarray(ref_feats, np.float64), fake_feats)
        report["kid_mean"], report["kid_std"] = float(k_mean), float(k_std)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
