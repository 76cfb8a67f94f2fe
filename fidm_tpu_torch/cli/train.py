"""Training / fine-tuning CLI (PyTorch port of `fidm_tpu/cli/train.py`).

    python -m fidm_tpu_torch.cli.train --train_dir ... --val_dir ... \
        --mask_dir ... --pretrained ffhq.pt

Fine-tunes the inpainting UNet on one GPU: an ADM `.pt` as the base (a
3-channel first conv is widened to 9), optional LoRA factors, a warmup-cosine
or step learning rate, the global-norm clip, validation, latest / best /
rotating checkpoints (`training/checkpoint.py`'s format), early stopping,
`--resume latest|best|<step>`, and `history.json`. The flags and defaults
are the JAX CLI's, plus `--device` (default cuda; raises without a GPU).
`--fsdp` above 1 is refused: sharded training waits for the port's parallel
slice. The step's draws come from `TrainDraws(--seed)` (torch generators
seeded through numpy's SeedSequence), not the JAX CLI's threefry key, and a
model without `--pretrained` starts from torch's initialisation seeded with
`--seed`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Fine-tune the inpainting UNet")
    p.add_argument("--config", default=None,
                   help="JSON file of argument defaults (CLI flags override)")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--val_dir", required=True)
    p.add_argument("--mask_dir", default=None,
                   help="mask directory (omit to train on procedural masks)")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--pretrained", default=None,
                   help="torch .pt base checkpoint (FFHQ) to fine-tune from")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--scheduler", default="cosine", choices=["cosine", "step", "none"])
    p.add_argument("--min_lr_ratio", type=float, default=0.01)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+", default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+", default=[16])
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--schedule", default="quadratic",
                   choices=["linear", "cosine", "quadratic", "sqrt"])
    p.add_argument("--mask_mode", default="serial",
                   choices=["serial", "random", "ordered", "procedural"])
    p.add_argument("--no_injection", action="store_true")
    p.add_argument("--injection_schedule", default="all", choices=["all", "high", "low"])
    p.add_argument("--vb_weight", type=float, default=0.0,
                   help="hybrid MSE+VLB weight (0 = pure masked MSE)")
    p.add_argument("--loss_weight", default="none", choices=["none", "min_snr", "p2"],
                   help="timestep-dependent loss weighting: min_snr (Hang et al. "
                        "2023, clamp at --snr_gamma) or p2 (Choi et al. 2022)")
    p.add_argument("--snr_gamma", type=float, default=None,
                   help="min_snr clamp / p2 exponent (defaults: 5.0 / 1.0)")
    p.add_argument("--mean_type", default="epsilon",
                   choices=["epsilon", "xstart", "velocity", "xprev"],
                   help="training parameterization (velocity = v-prediction; "
                        "xprev = posterior-mean target)")
    p.add_argument("--early_stopping_patience", type=int, default=0)
    p.add_argument("--threaded_loader", action="store_true",
                   help="decode/stack batches on a background thread "
                        "(identical batch content)")
    p.add_argument("--keep_last_n", type=int, default=3)
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write rotating checkpoints on a background thread from a "
                        "host copy of the state: training continues while the "
                        "save writes; crash-safe overwrite and the preemption "
                        "flush are kept (training/checkpoint.py)")
    p.add_argument("--resume", default=None, help="latest | best | <step>")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lora_rank", type=int, default=0,
                   help=">0 trains only LoRA factors on attention layers")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size (1 = one device; above 1 not ported yet)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help=">0 maintains an EMA of the params (e.g. 0.9999)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step "
                        "(batch_size must be divisible); activation memory "
                        "scales with batch/accum_steps")
    p.add_argument("--remat", default="none", choices=["none", "full", "convs"],
                   help="activation rematerialization: full recomputes whole "
                        "blocks in the backward; convs saves the convolution "
                        "outputs and recomputes the glue around them")
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; raises when no GPU "
                        "is present)")
    args, _ = p.parse_known_args(argv)
    if args.config:
        with open(args.config) as f:
            p.set_defaults(**json.load(f))
    return p.parse_args(argv)


def save_lora_base(checkpoint_dir: str, state_dict) -> None:
    """The frozen base of a LoRA run as `lora_base/state.pt`, written
    atomically: into lora_base.tmp, the old base renamed to lora_base.old,
    the new one into place, the old one dropped."""
    ckdir = os.path.abspath(checkpoint_dir)
    base_dir = os.path.join(ckdir, "lora_base")
    tmp_dir, old_dir = base_dir + ".tmp", base_dir + ".old"
    os.makedirs(ckdir, exist_ok=True)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    shutil.rmtree(old_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(tmp_dir, "state.pt"))
    if os.path.isdir(base_dir):
        os.rename(base_dir, old_dir)
    os.rename(tmp_dir, base_dir)
    shutil.rmtree(old_dir, ignore_errors=True)


def require_checkpoint(checkpoint_dir: str) -> None:
    """Raise FileNotFoundError unless the directory holds a best or a
    numbered checkpoint (checked before a reader builds its model)."""
    steps = os.path.join(checkpoint_dir, "steps")
    if not (os.path.isdir(os.path.join(checkpoint_dir, "best"))
            or (os.path.isdir(steps) and any(n.isdigit() for n in os.listdir(steps)))):
        raise FileNotFoundError(f"no checkpoints in {os.path.abspath(checkpoint_dir)}")


def load_checkpoint_params(checkpoint_dir: str, which: str, prefer_ema: bool, cfg):
    """A training checkpoint directory's model state dict: the params (or
    their EMA), with a LoRA adapter merged onto the saved `lora_base/`."""
    from ..lora import is_lora, merge_lora
    from ..training import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    params = mgr.restore_params(which, prefer_ema=prefer_ema)
    mgr.close()
    if not is_lora(params):
        return params
    base_dir = os.path.join(os.path.abspath(checkpoint_dir), "lora_base")
    if not os.path.isdir(base_dir):
        # a crash mid-swap leaves the previous base at .old, valid for the
        # adapters saved before the interrupted run
        old_dir = base_dir + ".old"
        if os.path.isdir(old_dir):
            base_dir = old_dir
        else:
            raise FileNotFoundError(
                f"{checkpoint_dir} holds a LoRA adapter but no lora_base/ — "
                "re-train with the current cli.train (it saves the frozen base) "
                "or merge manually with lora.merge_lora")
    base = torch.load(os.path.join(base_dir, "state.pt"), map_location="cpu",
                      weights_only=True)
    print("merged LoRA adapter onto the saved frozen base")
    return merge_lora(base, params, cfg)


def checkpoint_mean_type(checkpoint_dir: str, which: str):
    """The `mean_type` a training run recorded in its metadata, or None."""
    from ..training import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    meta = mgr.restore_metadata(which)
    mgr.close()
    return meta.get("mean_type") if meta else None


def main(argv=None):
    from ..data import create_inpainting_dataloaders
    from ..device import resolve_device
    from ..diffusion import DiffusionSchedule, ModelMeanType
    from ..models import InpaintingUNet, ffhq256_config
    from ..training import (
        CheckpointManager,
        FitConfig,
        TrainState,
        fit,
        make_eval_step,
        make_lr_schedule,
        make_optimizer,
        make_train_step,
    )

    args = parse_args(argv)
    if args.fsdp > 1:
        raise NotImplementedError(
            "--fsdp > 1 is not ported yet: sharded (FSDP) training comes with the "
            "port's parallel slice; the port trains on one device")
    device = resolve_device(args.device)
    if args.mask_dir is None and args.mask_mode != "procedural":
        print("no --mask_dir: switching to procedural mask generation")
        args.mask_mode = "procedural"

    train_loader, val_loader = create_inpainting_dataloaders(
        args.train_dir, args.val_dir, args.mask_dir, batch_size=args.batch_size,
        img_size=args.image_size, mask_mode=args.mask_mode, seed=args.seed)
    steps_per_epoch = len(train_loader)

    cfg = ffhq256_config(
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
        remat=args.remat != "none",
        remat_policy=args.remat if args.remat != "none" else "full",
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = InpaintingUNet(cfg)
    if args.pretrained:
        from ..models.weights import load_adm_checkpoint

        model.load_state_dict(load_adm_checkpoint(args.pretrained, cfg), strict=True)
        print(f"loaded pretrained weights from {args.pretrained}")
    model = model.to(device)
    sched = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device=device)
    print(f"device: {device}")

    lr = make_lr_schedule(args.scheduler, args.lr, args.num_epochs * steps_per_epoch,
                          args.warmup_epochs * steps_per_epoch, args.min_lr_ratio)
    tx = make_optimizer(lr, args.weight_decay, grad_clip=args.grad_clip)

    param_transform = None
    if args.lora_rank > 0:
        from ..lora import init_lora, lora_param_count, lora_weights

        model.requires_grad_(False)
        train_params = init_lora(args.seed, model, cfg, rank=args.lora_rank,
                                 alpha=args.lora_alpha)
        for t in train_params.values():
            t.requires_grad_(True)
        param_transform = lambda p: lora_weights(model, cfg, p)  # noqa: E731
        print(f"LoRA: training {lora_param_count(train_params):,} params "
              f"(rank {args.lora_rank})")
        # training checkpoints hold only the adapter, so evaluation merges it
        # onto this base; a resumed run keeps the base its adapters belong
        # to, a fresh run rewrites it atomically
        if not (args.resume and os.path.isdir(os.path.join(args.checkpoint_dir, "lora_base"))):
            save_lora_base(args.checkpoint_dir, model.state_dict())
    else:
        train_params = dict(model.named_parameters())

    state = TrainState.create(model, train_params, tx)
    if args.ema_decay > 0:
        from ..training import init_ema

        state.ema_params = init_ema(train_params)

    mean_type = ModelMeanType.from_name(args.mean_type)
    loss_kw = dict(use_injection=not args.no_injection,
                   injection_schedule=args.injection_schedule, vb_weight=args.vb_weight,
                   loss_weight=args.loss_weight, loss_weight_gamma=args.snr_gamma,
                   mean_type=mean_type, param_transform=param_transform)
    train_step = make_train_step(sched, ema_decay=args.ema_decay if args.ema_decay > 0 else None,
                                 accum_steps=args.accum_steps, **loss_kw)
    eval_step = make_eval_step(sched, **loss_kw)

    ckpt = CheckpointManager(args.checkpoint_dir, keep_last_n=args.keep_last_n,
                             async_save=args.async_checkpoint)
    start_epoch = 0
    if args.resume:
        state, meta = ckpt.restore(args.resume, state)
        if meta and "epoch" in meta:
            start_epoch = int(meta["epoch"]) + 1
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    meta = {
        "schedule": args.schedule, "diffusion_steps": args.diffusion_steps,
        "image_size": args.image_size, "lr": args.lr,
        # lets cli.evaluate pick the right decoding without a flag
        "mean_type": args.mean_type,
    }
    state, history = fit(
        state, train_step, eval_step, train_loader, val_loader, args.seed,
        FitConfig(num_epochs=args.num_epochs,
                  early_stopping_patience=args.early_stopping_patience,
                  threaded_loader=args.threaded_loader),
        checkpoint_manager=ckpt, start_epoch=start_epoch, metadata=meta)
    with open(os.path.join(args.checkpoint_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)
    ckpt.close()
    return history


if __name__ == "__main__":
    main()
