"""Checkpoints: latest / best / rotating-N, and resume (PyTorch port of
`fidm_tpu/training/checkpoint.py`).

The directory contract is the JAX package's, in the port's own format
(orbax does not exist beside PyTorch):

    DIR/steps/<n>/state.pt     the train state (`TrainState.state_dict()`,
                               CPU tensors, `torch.save`)
    DIR/steps/<n>/meta.json    its metadata (epoch, val_loss, mean_type, ...)
    DIR/best/state.pt          the state with the lowest val_loss so far
    DIR/best.json              the best marker: that state's full metadata,
                               its val_loss and step
    DIR/overwrite_backup/<n>/  a step renamed aside while it is redone

Every directory and file is written under a temporary name and moved into
place with `os.replace`, so a crash leaves the old checkpoint or the new
one, never half of one. `keep_last_n` numbered steps are kept. Re-saving a
step that exists (a preempted epoch redone after resume) first renames the
old step aside; the next manager rolls an interrupted overwrite back, and a
finished one drops the backup. With `async_save=True` a save copies the
state to host memory and a background thread writes it; `wait()` (or
`close()`) flushes it, and the overwrite backup lives until then. The best
state is written at once.

The port trains in one process, so the two multi-process hazards of the
JAX manager cannot arise here: the overwrite deadlock between processes
(its `checkpoint.py:114`) and an `is_best` taken from each process's own
loss (`:160`). A directory written by the JAX package's orbax manager is not
read here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import torch

__all__ = ["CheckpointManager"]

_STATE, _META = "state.pt", "meta.json"


def _host_copy(tree):
    """A CPU copy of every tensor of a nested dict (a copy even of CPU
    tensors: training goes on updating them in place)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _replace_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _write_state_dir(path: str, tree, meta: Optional[dict]) -> None:
    """state.pt (and meta.json) into `path.tmp`, then renamed to `path`,
    which must not exist."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _STATE))
    if meta is not None:
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
    os.replace(tmp, path)


def _load_state(path: str):
    return torch.load(os.path.join(path, _STATE), map_location="cpu", weights_only=True)


class CheckpointManager:
    """latest / best / rotating-N checkpoints of a `TrainState`."""

    def __init__(self, directory: str, keep_last_n: int = 3, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self._steps_root = os.path.join(self.directory, "steps")
        os.makedirs(self._steps_root, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self._recover_interrupted_overwrite()
        self._pending_cleanup = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.best_val_loss = float("inf")
        self._load_best_marker()

    # -- metadata ----------------------------------------------------------
    def _marker_path(self) -> str:
        return os.path.join(self.directory, "best.json")

    def _best_dir(self) -> str:
        return os.path.join(self.directory, "best")

    def _load_best_marker(self):
        try:
            with open(self._marker_path()) as f:
                self.best_val_loss = json.load(f)["val_loss"]
        except (OSError, KeyError, ValueError):
            pass

    # -- crash-safe overwrite ----------------------------------------------
    def _backup_root(self) -> str:
        return os.path.join(self.directory, "overwrite_backup")

    def _recover_interrupted_overwrite(self):
        root = self._backup_root()
        if os.path.isdir(root):
            for name in os.listdir(root):
                dst = os.path.join(self._steps_root, name)
                if os.path.exists(dst):  # the new save finished: the backup is stale
                    shutil.rmtree(os.path.join(root, name), ignore_errors=True)
                else:  # crashed mid-overwrite: the old checkpoint comes back
                    os.rename(os.path.join(root, name), dst)
            shutil.rmtree(root, ignore_errors=True)
        # a write that never reached its rename
        for name in os.listdir(self._steps_root):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self._steps_root, name), ignore_errors=True)

    def _begin_overwrite(self, step: int):
        root = self._backup_root()
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        os.rename(os.path.join(self._steps_root, str(step)), os.path.join(root, str(step)))

    # -- steps ---------------------------------------------------------------
    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self._steps_root) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write_step(self, step: int, tree, meta: dict):
        _write_state_dir(os.path.join(self._steps_root, str(step)), tree, meta)
        for old in self.all_steps()[:-self.keep_last_n]:
            shutil.rmtree(os.path.join(self._steps_root, str(old)), ignore_errors=True)

    def _write_in_background(self, step: int, tree, meta: dict):
        try:
            self._write_step(step, tree, meta)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[dict] = None,
             val_loss: Optional[float] = None) -> bool:
        """Save a rotating numbered checkpoint of `state` (a `TrainState`, or
        its `state_dict()` tree); track the best by val_loss. Returns True if
        this checkpoint became the new best."""
        meta = dict(metadata or {})
        if val_loss is not None:
            meta["val_loss"] = float(val_loss)
        # an in-flight save commits before step directories move around
        if self._pending_cleanup or step in self.all_steps():
            self.wait()
        if step in self.all_steps():
            self._begin_overwrite(step)
        tree = _host_copy(state.state_dict() if hasattr(state, "state_dict") else state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write_in_background,
                                            args=(step, tree, meta), daemon=True)
            self._thread.start()
            # the overwrite backup stays until the write is confirmed
            self._pending_cleanup = True
        else:
            self._write_step(step, tree, meta)
            shutil.rmtree(self._backup_root(), ignore_errors=True)

        is_best = val_loss is not None and val_loss < self.best_val_loss
        if is_best:
            self.best_val_loss = float(val_loss)
            best, old = self._best_dir(), self._best_dir() + ".old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(best):
                os.rename(best, old)
            _write_state_dir(best, tree, None)
            shutil.rmtree(old, ignore_errors=True)
            # the full metadata: the rotating step that holds it can be
            # pruned, and readers (cli.evaluate's mean_type) prefer "best"
            _replace_json(self._marker_path(), {**meta, "val_loss": self.best_val_loss,
                                                "step": step})
        return is_best

    # -- restore -------------------------------------------------------------
    def _which_dir(self, which) -> str:
        if which == "best":
            return self._best_dir()
        step = self.latest_step() if which == "latest" else int(which)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self._steps_root, str(step))

    def restore(self, which, state=None):
        """Restore 'latest' | 'best' | a step number. With a `TrainState`,
        copy the checkpoint into it; returns (state or the raw tree,
        metadata or None)."""
        if self._pending_cleanup:  # never read behind an in-flight save
            self.wait()
        tree = _load_state(self._which_dir(which))
        meta = self.restore_metadata(which)
        if state is not None:
            return state.load_state_dict(tree), meta
        return tree, meta

    def restore_params(self, which="latest", prefer_ema: bool = False) -> Dict[str, torch.Tensor]:
        """Only the trained tensors (for evaluation): the EMA with
        prefer_ema=True when the checkpoint carries one, else the params."""
        if self._pending_cleanup:
            self.wait()
        tree = _load_state(self._which_dir(which))
        if prefer_ema and tree.get("ema_params"):
            return tree["ema_params"]
        return tree["params"]

    def restore_metadata(self, which="latest") -> Optional[dict]:
        """The JSON metadata saved with a checkpoint, or None."""
        if self._pending_cleanup:
            self.wait()
        if which == "best":
            path = self._marker_path()
        else:
            step = self.latest_step() if which == "latest" else int(which)
            if step is None:
                return None
            path = os.path.join(self._steps_root, str(step), _META)
        try:
            with open(path) as f:
                return json.load(f)
        except OSError:
            return None

    def wait(self):
        """Block until an in-flight save has committed, then drop the
        overwrite backup. Re-raises the background write's error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._pending_cleanup:
            shutil.rmtree(self._backup_root(), ignore_errors=True)
            self._pending_cleanup = False

    def close(self):
        self.wait()
