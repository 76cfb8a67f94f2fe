"""Export weights to an ADM-layout PyTorch checkpoint (PyTorch port of
`fidm_tpu/cli/export_torch.py`).

Writes the file the JAX package's `torch_import.save_torch_checkpoint`
writes: a `.pt` state dict of float32 CPU tensors under the ADM keys, in
the order of the key map, that the reference's `UNetModel` /
`DiffusionInpaintingModel`, `cli.serve`, `cli.evaluate` and the JAX
package load with strict=True. A distilled student leaves the port this
way.

    python -m fidm_tpu_torch.cli.export_torch --checkpoint distilled/student_4 --out s4.pt
    python -m fidm_tpu_torch.cli.export_torch --checkpoint model_int8.npz --out model.pt

`--checkpoint` takes a training checkpoint directory of the port
(`cli.train`, `cli.distill`: `--which` best if present, else latest; the
params, not the EMA; a LoRA adapter merged onto its `lora_base/`), an int8
`.npz` of either package (dequantized), or a `.pt`. An orbax directory of
the JAX package is the JAX CLI's to export. The flags and defaults are the
JAX CLI's (`--attention_resolutions` defaults to 32 16 8 there, as here),
plus `--device`: the weights are loaded into the UNet of the flags on that
device (default cuda; raises without a GPU) with strict=True before the file
is written, so a model that does not fit the flags is refused.
"""
from __future__ import annotations

import argparse
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export weights to torch .pt")
    p.add_argument("--checkpoint", required=True,
                   help="training checkpoint dir, quantized .npz, or torch .pt")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--which", default=None,
                   help="checkpoint dir selector: latest | best | step number "
                        "(default: best if present, else latest)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[32, 16, 8])
    p.add_argument("--device", default="cuda",
                   help="device the weights are loaded and checked on (default "
                        "cuda; raises when no GPU is present)")
    return p.parse_args(argv)


def _load_params(args, cfg):
    """The checkpoint's state dict (CPU tensors)."""
    ckpt = args.checkpoint
    if os.path.isdir(ckpt):
        from .train import load_checkpoint_params

        which = args.which or ("best" if os.path.isdir(
            os.path.join(ckpt, "best")) else "latest")
        return load_checkpoint_params(ckpt, which, False, cfg)
    if ckpt.endswith(".npz"):
        from ..quant import load_quantized_state_dict

        return load_quantized_state_dict(ckpt, cfg)
    from ..models.weights import load_adm_checkpoint

    return load_adm_checkpoint(ckpt, cfg)


def export_state_dict(model, cfg):
    """`model`'s weights as the JAX package's `export_state_dict` lays them
    out: float32 CPU tensors (each with its own storage) under the ADM keys
    in the key map's order, each weight before its bias."""
    from ..models.weights import torch_key_map

    sd = model.state_dict()
    out = {}
    for _, prefix, _ in torch_key_map(cfg):
        for name in (f"{prefix}.weight", f"{prefix}.bias"):
            if name in sd:
                out[name] = sd[name].detach().to("cpu", torch.float32).contiguous().clone()
    return out


def main(argv=None):
    from ..device import resolve_device
    from ..models import InpaintingUNet, ffhq256_config

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = ffhq256_config(
        dtype=torch.float32,
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
    )
    params = _load_params(args, cfg)
    with torch.device(device):
        model = InpaintingUNet(cfg)
    model.load_state_dict(params, strict=True)
    torch.save(export_state_dict(model, cfg), args.out)
    report = {
        "out": args.out,
        "bytes": os.path.getsize(args.out),
        "in_channels": cfg.in_channels,
        "image_size": cfg.image_size,
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
