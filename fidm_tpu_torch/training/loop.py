"""The training loop: epochs, validation, checkpoints, early stopping
(PyTorch port of `fidm_tpu/training/loop.py`).

Host-side orchestration; each batch is one train step on the device (see
`train_state.py`), fed by the threaded loader and the pinned-memory
prefetcher. Losses stay on the device until the epoch's end.

Under a mesh every rank runs this loop on its own rows: `fit` sets the
loaders' `process_local` (and their `mesh`, so that the ranks of one model
group read the same rows) when the process group has more than one rank, the
steps reduce over the ranks, and `validate` returns the global mean, the same
on every rank. A step built with `spatial=True` gets this rank's block of H
rows of each batch (`parallel.mesh.spatial_block`).
"""
from __future__ import annotations

import contextlib
import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .early_stopping import EarlyStopping
from .train_state import _as_draws

__all__ = ["train_epoch", "validate", "fit", "FitConfig", "GracefulShutdown"]


class GracefulShutdown:
    """Cooperative SIGTERM/SIGINT handling: the first signal only sets a
    flag that the loop checks between steps (the step in flight finishes,
    `fit` saves a checkpoint and returns, and `--resume latest` goes on);
    a second signal raises KeyboardInterrupt. Off the main thread, where
    signal handlers cannot be set, it is a flag that nothing sets."""

    def __init__(self):
        self.requested = False
        self._orig = {}

    def __enter__(self):
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handle)
        return self

    def _handle(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt(f"second signal {signum}: hard stop")
        self.requested = True

    def __exit__(self, *exc):
        for sig, handler in self._orig.items():
            signal.signal(sig, handler)
        return False


def _device_batches(loader, device, threaded: bool = False, step=None, mesh=None):
    """The loader's batches on `device`; a `spatial` step's (see
    `make_train_step`) cut to this rank's block of H rows."""
    from ..data.prefetch import ThreadedLoader, device_prefetch
    from ..parallel.mesh import spatial_block

    keys = ("image", "masked_image", "mask", "label")
    spatial = getattr(step, "spatial", False)

    def gen():
        for b in loader:
            b = {k: b[k] for k in keys if k in b}
            yield spatial_block(b, mesh) if spatial else b

    # threaded=True moves the loader's CPU work onto a background thread;
    # the batches are the same either way
    src = ThreadedLoader(gen, queue_size=4) if threaded else gen()
    return device_prefetch(src, size=2, device=device)


def _mean(losses) -> float:
    """The float64 mean of the losses (device tensors): the one sync."""
    if not losses:
        return float("nan")
    return float(np.mean(torch.stack(losses).float().cpu().numpy()))


def _state_device(state):
    return next(iter(state.params.values())).device


def _any_rank(flag: bool, mesh) -> bool:
    """True on every rank when `flag` is True on any (one blocking
    collective per call under a mesh of more than one rank)."""
    if mesh is None or mesh.size() == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([1.0 if flag else 0.0],
                     device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class _StopVote:
    """Whether any rank asked to stop, agreed between steps without waiting
    for the device: each call starts an all-reduce (MAX) of this rank's flag
    on the host (over gloo: the default group where it takes CPU tensors,
    else a gloo group made for the epoch) and returns the result of the call
    before. So every rank reads the same votes after the same step, and all
    stop one step after the first request. In one rank, the flag itself."""

    def __init__(self, mesh):
        self.group = self.own = self.pending = None
        self.single = mesh is None or mesh.size() == 1
        if not self.single:
            import torch.distributed as dist

            if "gloo" not in str(dist.get_backend()):
                self.group = self.own = dist.new_group(backend="gloo")

    def __call__(self, flag: bool) -> bool:
        if self.single:
            return flag
        import torch.distributed as dist

        t = torch.tensor([1.0 if flag else 0.0])
        work = dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group, async_op=True)
        previous, self.pending = self.pending, (work, t)
        if previous is None:
            return False
        previous[0].wait()
        return bool(previous[1].item())

    def close(self):
        import torch.distributed as dist

        if self.pending is not None:
            self.pending[0].wait()
            self.pending = None
        if self.own is not None:
            dist.destroy_process_group(self.own)
            self.own = None


def train_epoch(state, train_step, loader, draws, mesh=None, log_every=50, log_fn=print,
                should_stop: Optional[Callable] = None, threaded: bool = False):
    """One epoch; returns (state, mean_loss). `draws` (a seed or a
    `TrainDraws`) is the epoch's; the step folds in its update count.
    `should_stop()` is checked between steps (preemption); under a mesh of
    more than one rank every rank stops when any rank's does, one step after
    the request (`_StopVote`), so no rank waits in a step the others left
    and no step waits for the one before to finish on the device."""
    device = _state_device(state)
    draws = _as_draws(draws, device)
    losses = []
    start = time.time()
    n = 0
    vote = _StopVote(mesh) if should_stop is not None else None
    try:
        for batch in _device_batches(loader, device, threaded, train_step, mesh):
            state, metrics = train_step(state, batch, draws)
            losses.append(metrics["loss"])
            n += 1
            if log_every and n % log_every == 0:
                log_fn(f"  step {n}: loss={_mean(losses[-log_every:]):.5f} "
                       f"({(time.time() - start) / n:.3f}s/step)")
            if vote is not None and vote(bool(should_stop())):
                break
    finally:
        if vote is not None:
            vote.close()
    return state, _mean(losses)


def validate(state, eval_step, loader, draws, mesh=None, threaded: bool = False):
    """The mean validation loss; batch i takes the draws `draws.fold(i)`.
    Under a mesh the eval step returns each batch's global mean, so every
    rank computes the same value; the primary's is broadcast all the same,
    so that the ranks hold one float whatever their arithmetic."""
    device = _state_device(state)
    draws = _as_draws(draws, device)
    losses = [eval_step(state, batch, draws.fold(i))["loss"]
              for i, batch in enumerate(_device_batches(loader, device, threaded, eval_step,
                                                        mesh))]
    if mesh is None:
        return _mean(losses)
    from ..parallel.collectives import broadcast_object

    return broadcast_object(_mean(losses))


@dataclass
class FitConfig:
    num_epochs: int = 10
    early_stopping_patience: int = 0  # 0 = disabled
    early_stopping_min_delta: float = 0.0
    log_fn: Callable = print
    # catch SIGTERM/SIGINT, checkpoint, and return cleanly (preemption)
    handle_preemption: bool = True
    # decode/stack batches on a background thread; the same batches
    threaded_loader: bool = False


def fit(state, train_step, eval_step, train_loader, val_loader, draws, cfg: FitConfig,
        checkpoint_manager=None, mesh=None, start_epoch: int = 0,
        metadata: Optional[dict] = None):
    """Per epoch: train, validate, checkpoint, early stop. `draws` is an
    integer seed or a `TrainDraws`: epoch e trains on `draws.fold(e)` and
    validates on `draws.fold(e).fold(10_000)`.

    `mesh`: the steps' mesh. With more than one rank each rank must feed
    only its rows of every global batch: a loader with `process_local` gets
    it set (and its `mesh`: over a "model" axis the rows are the model
    group's); another loader must yield those rows itself (logged).

    Returns (state, history), one entry per epoch: {epoch, train_loss,
    val_loss, seconds} (and preempted=True for an interrupted epoch). The
    train loss is this rank's mean of the global step losses, so the same
    on every rank."""
    from ..parallel.multihost import process_count

    draws = _as_draws(draws, _state_device(state))
    if mesh is not None and process_count() > 1:
        for ld in (train_loader, val_loader):
            if ld is None:
                continue
            if hasattr(ld, "process_local"):
                ld.process_local = True
                if hasattr(ld, "mesh"):
                    ld.mesh = mesh
            else:
                cfg.log_fn(
                    f"fit(): multi-process run with a loader of type {type(ld).__name__} "
                    "that has no process_local support: it must yield this rank's LOCAL "
                    "slice of each global batch (see parallel.multihost.host_local_slice)")
    stopper = (EarlyStopping(cfg.early_stopping_patience, cfg.early_stopping_min_delta)
               if cfg.early_stopping_patience > 0 else None)
    shutdown = GracefulShutdown() if cfg.handle_preemption else None
    history = []
    if start_epoch and hasattr(train_loader, "epoch"):
        # a resumed run goes on with the shuffle sequence (the loader derives
        # each epoch's order from seed + epoch) instead of replaying epoch 0's
        train_loader.epoch = start_epoch
    with shutdown if shutdown is not None else contextlib.nullcontext():
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            edraws = draws.fold(epoch)
            state, train_loss = train_epoch(
                state, train_step, train_loader, edraws, mesh=mesh, log_fn=cfg.log_fn,
                should_stop=(lambda: shutdown.requested) if shutdown else None,
                threaded=cfg.threaded_loader)
            # a signal on any rank stops every rank (train_epoch stopped them all)
            if shutdown is not None and _any_rank(shutdown.requested, mesh):
                cfg.log_fn(f"preemption signal at epoch {epoch} — saving checkpoint "
                           "and exiting (resume with --resume latest)")
                history.append({"epoch": epoch, "train_loss": train_loss,
                                "val_loss": float("nan"), "seconds": time.time() - t0,
                                "preempted": True})
                if checkpoint_manager is not None:
                    meta = dict(metadata or {})
                    # the last COMPLETED epoch, so that --resume latest
                    # (start_epoch = meta["epoch"] + 1) redoes the interrupted
                    # one; train_loss covers only its part
                    meta.update({"epoch": epoch - 1, "interrupted_epoch": epoch,
                                 "partial_train_loss": train_loss, "preempted": True})
                    checkpoint_manager.save(epoch, state, metadata=meta)
                break
            val_loss = validate(state, eval_step, val_loader, edraws.fold(10_000), mesh=mesh,
                                threaded=cfg.threaded_loader)
            dt = time.time() - t0
            history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                            "seconds": dt})
            cfg.log_fn(f"epoch {epoch}: train={train_loss:.5f} val={val_loss:.5f} ({dt:.1f}s)")
            if checkpoint_manager is not None:
                meta = dict(metadata or {})
                meta.update({"epoch": epoch, "train_loss": train_loss})
                if checkpoint_manager.save(epoch, state, metadata=meta, val_loss=val_loss):
                    cfg.log_fn(f"  new best (val={val_loss:.5f})")
            if stopper is not None:
                stop, best_params = stopper.update(val_loss, state.params)
                if stop:
                    cfg.log_fn(f"early stopping at epoch {epoch}")
                    with torch.no_grad():
                        for k, p in state.params.items():
                            p.copy_(best_params[k])
                    break
    if checkpoint_manager is not None and hasattr(checkpoint_manager, "wait"):
        # in-flight async saves commit before return: the preemption path
        # must never leave an uncommitted checkpoint
        checkpoint_manager.wait()
    return state, history
