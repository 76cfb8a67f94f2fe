"""Distillation CLI: train few-step students from a trained teacher
(PyTorch port of `fidm_tpu/cli/distill.py`).

--mode progressive (default; Salimans & Ho 2022): each round trains a
student to match TWO teacher DDIM steps in ONE, halving the step count
until --final_steps. Each student lands in `--out/student_<K>/`, a checkpoint
directory of `training/checkpoint.py`'s format that `cli.evaluate` loads,
with its timestep grid in the metadata and in `student_<K>/grid.json`:

    python -m fidm_tpu_torch.cli.distill --train_dir faces/ --mask_dir masks/ \
        --checkpoint ffhq.pt --out distilled/ \
        --teacher_steps 16 --final_steps 4 --steps_per_round 4000

    python -m fidm_tpu_torch.cli.evaluate --data_dir test/ --mask_dir masks/ \
        --checkpoint distilled/student_4 \
        --timesteps $(jq -r '.grid|join(" ")' distilled/student_4/grid.json)

--mode consistency (Song et al. 2023): ONE run produces ONE student that
samples at any step count via `--preset consistency-1` / `consistency-2`.
The student (the EMA target network, saved as the params) lands in
`--out/consistency/`; --mode consistency-training trains the same student
without a teacher (--checkpoint then only initialises it):

    python -m fidm_tpu_torch.cli.distill --mode consistency --train_dir faces/ \
        --checkpoint ffhq.pt --out distilled/ --steps_per_round 20000

    python -m fidm_tpu_torch.cli.evaluate --data_dir test/ --mask_dir masks/ \
        --checkpoint distilled/consistency --preset consistency-2

The flags, defaults, refusals, report and metadata are the JAX CLI's, plus
`--device` (default cuda; raises without a GPU). `--checkpoint` takes an ADM
`.pt` or a training checkpoint directory of `cli.train` (best if present,
else latest; the EMA under `--use_ema`; a LoRA adapter merged onto its
`lora_base/`); without it, consistency-training starts from torch's
initialisation seeded with `--seed`. Under a launcher (as `cli.train`: torchrun,
or RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT) every rank distills its
rows of each global batch over `auto_mesh(--batch_size, --fsdp)`, the teacher
and the student sharded over `--fsdp` ranks; in one process `--fsdp` above 1
raises. The teacher is a frozen copy of the weights; each progressive
round's trained student becomes the next round's teacher. The draws come
from `TrainDraws(--seed)`, each progressive round's folded with its teacher
step count so that rounds do not replay round 1's noise, not the JAX CLI's
threefry key.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Progressively distill a trained inpainting UNet to "
                    "fewer sampling steps")
    p.add_argument("--config", default=None,
                   help="JSON file of argument defaults (CLI flags override)")
    p.add_argument("--mode", default="progressive",
                   choices=["progressive", "consistency",
                            "consistency-training"],
                   help="progressive = step-halving ladder; consistency = "
                        "one any-step-count student (1-2 step sampling); "
                        "consistency-training = the same student WITHOUT a "
                        "teacher (paper Alg. 3; --checkpoint optional, used "
                        "only as init)")
    p.add_argument("--grid_size", type=int, default=40,
                   help="consistency mode: training grid segments N")
    p.add_argument("--ema_decay", type=float, default=0.95,
                   help="consistency mode: target-network EMA decay")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--mask_dir", default=None,
                   help="mask directory (omit to train on procedural masks)")
    p.add_argument("--checkpoint", default=None,
                   help="teacher: torch .pt or a training checkpoint dir "
                        "(required except for --mode consistency-training, "
                        "where it is an optional init)")
    p.add_argument("--out", default="distilled")
    p.add_argument("--teacher_steps", type=int, default=16,
                   help="starting DDIM step count (must be a power of 2 "
                        "multiple of final_steps)")
    p.add_argument("--final_steps", type=int, default=4,
                   help="stop once a student at this step count is trained")
    p.add_argument("--steps_per_round", type=int, default=4000,
                   help="optimizer steps per halving round")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model_channels", type=int, default=128)
    p.add_argument("--channel_mult", type=int, nargs="+",
                   default=[1, 1, 2, 2, 4, 4])
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_head_channels", type=int, default=64)
    p.add_argument("--attention_resolutions", type=int, nargs="+",
                   default=[16])
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--schedule", default="quadratic",
                   choices=["linear", "cosine", "quadratic", "sqrt"])
    p.add_argument("--mask_mode", default="serial",
                   choices=["serial", "random", "ordered", "procedural"])
    p.add_argument("--mean_type", default="epsilon",
                   choices=["epsilon", "xstart", "velocity"],
                   help="the TEACHER's parameterization (reference "
                        "checkpoints are epsilon)")
    p.add_argument("--student_mean_type", default="velocity",
                   choices=["epsilon", "xstart", "velocity"],
                   help="the students' parameterization; velocity is stable "
                        "at few steps (Salimans & Ho 2022)")
    p.add_argument("--use_ema", action="store_true",
                   help="distill from the teacher's EMA parameters")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size: ranks that share one copy of the teacher's and "
                        "the student's large tensors (ZeRO-3)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to distill on (default cuda; raises when no GPU "
                        "is present)")
    args, _ = p.parse_known_args(argv)
    if args.config:
        with open(args.config) as f:
            p.set_defaults(**json.load(f))
    return p.parse_args(argv)


def student_grid(num_timesteps: int, steps: int):
    """The descending timestep grid a K-step student samples on (the even
    boundaries of its 2K-step teacher grid)."""
    from ..distill import distill_boundaries

    return [int(t) for t in distill_boundaries(num_timesteps, 2 * steps)[::2][:-1]]


def _check_args(args) -> None:
    """The JAX CLI's refusals, word for word, before anything is built."""
    from ..distill import distill_boundaries

    if args.mode == "progressive":
        if args.teacher_steps % args.final_steps != 0 or (
            args.teacher_steps // args.final_steps
        ) & (args.teacher_steps // args.final_steps - 1):
            raise SystemExit("teacher_steps must be final_steps * 2^n")
        bounds = distill_boundaries(args.diffusion_steps, args.teacher_steps)
        if not np.all(np.diff(bounds) < 0):
            raise SystemExit(
                f"teacher_steps={args.teacher_steps} does not fit a "
                f"{args.diffusion_steps}-step chain (duplicate timestep "
                f"boundaries); use teacher_steps < diffusion_steps")
    elif args.grid_size >= args.diffusion_steps:
        raise SystemExit("grid_size must be < diffusion_steps")
    if args.checkpoint is None and args.mode != "consistency-training":
        raise SystemExit(
            f"--checkpoint is required for --mode {args.mode} (only "
            "consistency-training can start from random init)")


def _initial_weights(args, cfg):
    """The teacher's state dict (CPU): a training checkpoint directory, an
    ADM `.pt`, or, without --checkpoint, a fresh model seeded with --seed."""
    from ..models import InpaintingUNet

    if args.checkpoint is None:  # consistency-training from random init
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            return InpaintingUNet(cfg).state_dict()
    if os.path.isdir(args.checkpoint):
        from .train import load_checkpoint_params

        # same resolution as cli.evaluate: the best-loss snapshot when the
        # training run tracked one, else the latest
        which = "best" if os.path.isdir(os.path.join(args.checkpoint, "best")) else "latest"
        return load_checkpoint_params(args.checkpoint, which, args.use_ema, cfg)
    from ..models.weights import load_adm_checkpoint

    return load_adm_checkpoint(args.checkpoint, cfg)


def _module(cfg, state_dict, device, frozen: bool):
    from ..models import InpaintingUNet

    model = InpaintingUNet(cfg)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device)
    if frozen:
        model.requires_grad_(False)
    return model


def _batches(loader, device):
    """The loader's epochs, one after another, on `device` (pinned,
    non-blocking copies on CUDA)."""
    from ..data.prefetch import device_prefetch

    keys = ("image", "masked_image", "mask")

    def gen():
        while True:
            for b in loader:
                yield {k: b[k] for k in keys}

    return device_prefetch(gen(), size=2, device=device)


def _optimizer(args):
    from ..training import make_lr_schedule, make_optimizer

    return make_optimizer(
        make_lr_schedule("cosine", args.lr, args.steps_per_round, args.warmup_steps),
        weight_decay=0.0, grad_clip=args.grad_clip)


def _run(step, state, teacher, stream, draws, steps, label, say=print):
    """`steps` updates; the loss is read (a host sync) only at the JAX CLI's
    print points. Returns (state, the last metrics)."""
    last = {}
    for i in range(steps):
        state, last = step(state, teacher, next(stream), draws)
        if i % max(1, steps // 10) == 0:
            say(f"[{label}] step {i} loss {float(last['loss']):.5f}", flush=True)
    return state, last


def main(argv=None):
    from ..data import DataLoader, InpaintingDataset
    from ..device import resolve_device
    from ..diffusion import DiffusionSchedule, ModelMeanType
    from ..distill import make_consistency_step, make_distill_step
    from ..distill.progressive import unet_apply
    from ..models import ffhq256_config
    from ..parallel import auto_mesh, multihost, shard_params
    from ..parallel.collectives import ShardedModule
    from ..training import CheckpointManager, TrainDraws, TrainState, init_ema

    args = parse_args(argv)
    _check_args(args)
    if not multihost.initialize(device=args.device) and args.fsdp > 1:
        raise ValueError(f"--fsdp {args.fsdp} needs a process group of a multiple of "
                         f"{args.fsdp} ranks (torchrun --nproc_per_node ...)")
    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    device = resolve_device(multihost.local_device(args.device))
    if args.mask_dir is None and args.mask_mode != "procedural":
        say("no --mask_dir: switching to procedural mask generation")
        args.mask_mode = "procedural"

    cfg = ffhq256_config(
        image_size=args.image_size,
        model_channels=args.model_channels,
        channel_mult=tuple(args.channel_mult),
        num_heads=args.num_heads,
        num_head_channels=args.num_head_channels,
        attention_resolutions=tuple(args.attention_resolutions),
    )
    sched = DiffusionSchedule.create(args.schedule, args.diffusion_steps, device=device)
    weights = _initial_weights(args, cfg)
    say(f"device: {device}")
    mesh = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        # as the JAX CLI: the teacher (and the student made from it) sharded
        # under --fsdp, the batch over every rank
        mesh = auto_mesh(args.batch_size, fsdp=args.fsdp)
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
            f"{mesh.size()} device(s)")
    fsdp = mesh is not None and args.fsdp > 1

    ds = InpaintingDataset(args.train_dir, args.mask_dir, "train",
                           args.image_size, args.mask_mode, args.seed)
    # each rank yields its rows of every global batch
    loader = DataLoader(ds, args.batch_size, shuffle=True, drop_last=True,
                        seed=args.seed, process_local=mesh is not None)
    if len(loader) == 0:
        raise SystemExit("dataset smaller than one batch")

    teacher_mt = ModelMeanType.from_name(args.mean_type)
    student_mt = ModelMeanType.from_name(args.student_mean_type)
    os.makedirs(args.out, exist_ok=True)
    stream = _batches(loader, device)
    draws = TrainDraws(args.seed, device)
    student = _module(cfg, weights, device, frozen=False)
    params, specs = (shard_params(student, mesh, use_fsdp=fsdp) if mesh is not None
                     else (dict(student.named_parameters()), None))

    def frozen_teacher():
        teacher = _module(cfg, weights, device, frozen=True)
        return ShardedModule(teacher, mesh) if fsdp else teacher

    if args.mode in ("consistency", "consistency-training"):
        ct = args.mode == "consistency-training"
        teacher = None if ct else frozen_teacher()
        cstate = TrainState.create(student, params, _optimizer(args),
                                   ema_params=init_ema(params), specs=specs)
        cstep = make_consistency_step(
            sched, None if ct else unet_apply, unet_apply, grid_size=args.grid_size,
            teacher_mean_type=teacher_mt, student_mean_type=student_mt,
            ema_decay=args.ema_decay, mesh=mesh,
        )
        cstate, last = _run(cstep, cstate, teacher, stream, draws, args.steps_per_round,
                            args.mode, say)
        sdir = os.path.join(args.out, "consistency")
        mgr = CheckpointManager(sdir, keep_last_n=1, mesh=mesh)
        # the usable student is the EMA target network: saved AS the params
        # so that cli.evaluate --preset consistency-K works unflagged
        mgr.save(0, dataclasses.replace(cstate, params=cstate.ema_params), metadata={
            "mode": args.mode,
            "mean_type": args.student_mean_type,
            "schedule": args.schedule,
            "diffusion_steps": args.diffusion_steps,
            "sampler_method": "consistency",
        })
        mgr.close()
        report = {"mode": args.mode, "final_loss": float(last["loss"]),
                  "checkpoint": sdir, "out": args.out}
        say(json.dumps(report))
        return report

    report = {"rounds": [], "out": args.out}
    teacher = frozen_teacher()
    cur_steps, cur_mt = args.teacher_steps, teacher_mt
    while cur_steps > args.final_steps:
        if report["rounds"]:
            # the trained student is the next round's frozen teacher (shard
            # for shard under --fsdp: both have the same specs)
            with torch.no_grad():
                dst = teacher.params if fsdp else dict(teacher.named_parameters())
                for k, t in dst.items():
                    t.copy_(params[k])
        dstate = TrainState.create(student, params, _optimizer(args), specs=specs)
        dstep = make_distill_step(
            sched, unet_apply, unet_apply, teacher_steps=cur_steps,
            teacher_mean_type=cur_mt, student_mean_type=student_mt, mesh=mesh,
        )
        # the round folded into the draws: the step folds in its update
        # count, which restarts at 0 each round
        dstate, last = _run(dstep, dstate, teacher, stream, draws.fold(cur_steps),
                            args.steps_per_round, f"{cur_steps}->{cur_steps // 2}", say)
        cur_mt = student_mt
        cur_steps //= 2
        grid = student_grid(args.diffusion_steps, cur_steps)
        sdir = os.path.join(args.out, f"student_{cur_steps}")
        mgr = CheckpointManager(sdir, keep_last_n=1, mesh=mesh)
        mgr.save(0, dstate, metadata={
            "student_steps": cur_steps,
            "mean_type": args.student_mean_type,
            "schedule": args.schedule,
            "diffusion_steps": args.diffusion_steps,
            "timesteps_grid": grid,
        })
        mgr.close()
        if primary:
            with open(os.path.join(sdir, "grid.json"), "w") as f:
                json.dump({"grid": grid,
                           "mean_type": args.student_mean_type}, f)
        report["rounds"].append({
            "student_steps": cur_steps,
            "final_loss": float(last["loss"]),
            "checkpoint": sdir,
            "grid": grid,
        })
        say(f"saved {sdir} (grid {grid})", flush=True)

    say(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
