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

Several processes (one per rank of a mesh) share the directory and call
save / restore / wait / close together. The directory surgery (overwrite
backups, renames, pruning, markers) runs on the primary only, fenced by
barriers. Two decisions are the primary's and are broadcast before any rank
acts on them, so ranks that see the directory differently, or hold
different floats, still take the same branch and enter the same
collectives: whether the step exists (the overwrite), and whether the
checkpoint is the best. (The JAX manager decides both on every process: a
primary-only call that waits on the others, its `checkpoint.py:114`, and an
`is_best` from each process's own loss, `:160`.)

A state whose parameters are fsdp shards (`TrainState.specs`, a manager
made with the mesh) is saved as every shard: DIR/steps/<n>/ then holds
`state-fsdp<i>of<k>.pt` for each of the k shards (written by the ranks of
data index 0) and `shards.json`, {"fsdp": k, "dims": {name: dim}}, in place
of state.pt. `restore` reads each rank's own file when the layout is the
same, and otherwise joins the shards (or cuts a whole state.pt) to the
state's layout; `restore_params` joins them. An unsharded state keeps the
one-process format and layout bit for bit, written by the primary. Under
more than one process `async_save` writes at once (the write is
collective). A directory written by the JAX package's orbax manager is not
read here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import torch

from ..parallel.collectives import broadcast_object
from ..parallel.multihost import barrier, is_primary, process_count

__all__ = ["CheckpointManager"]

_STATE, _META, _SHARDS = "state.pt", "meta.json", "shards.json"


def _host_copy(tree):
    """A CPU copy of every tensor of a nested dict (a copy even of CPU
    tensors: training goes on updating them in place)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _shard_file(i: int, k: int) -> str:
    return f"state-fsdp{i}of{k}.pt"


_SECTIONS = ("params", "mu", "nu", "ema_params")


def _section(tree, name: str):
    return tree["opt_state"][name] if name in ("mu", "nu") else tree.get(name)


def _map_tree(tree, names, fn):
    """`tree` (a `TrainState.state_dict()`) with fn(section, name, tensor)
    in place of the entries of `names` in params, the moments (mu, nu) and
    the EMA."""
    def over(sec):
        d = _section(tree, sec)
        return None if d is None else {k: fn(sec, k, v) if k in names else v
                                       for k, v in d.items()}

    out = dict(tree, params=over("params"), ema_params=over("ema_params"))
    out["opt_state"] = dict(tree["opt_state"], mu=over("mu"), nu=over("nu"))
    return out


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


def _load_file(path: str, name: str = _STATE):
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)


def _layout(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, _SHARDS)) as f:
            return json.load(f)
    except OSError:
        return None


def _load_state(path: str):
    """The whole state of a checkpoint directory: state.pt, or its fsdp
    shards joined along their dims."""
    info = _layout(path)
    if info is None:
        return _load_file(path)
    k, dims = info["fsdp"], info["dims"]
    parts = [_load_file(path, _shard_file(i, k)) for i in range(k)]
    return _map_tree(parts[0], dims, lambda sec, name, _: torch.cat(
        [_section(p, sec)[name] for p in parts], dims[name]))


class CheckpointManager:
    """latest / best / rotating-N checkpoints of a `TrainState`. `mesh` is
    needed only to save or restore a state of fsdp shards."""

    def __init__(self, directory: str, keep_last_n: int = 3, async_save: bool = False,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self._steps_root = os.path.join(self.directory, "steps")
        self.keep_last_n = keep_last_n
        self.mesh = mesh
        self._multi = process_count() > 1
        # a write under several processes is collective, so never in a thread
        self.async_save = async_save and not self._multi
        if is_primary():
            os.makedirs(self._steps_root, exist_ok=True)
            self._recover_interrupted_overwrite()
        barrier("fidm-ckpt-init")
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
        self.best_val_loss = broadcast_object(self.best_val_loss)

    # -- crash-safe overwrite (primary only) -------------------------------
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
        src = os.path.join(self._steps_root, str(step))
        root = self._backup_root()
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        if os.path.isdir(src):
            os.rename(src, os.path.join(root, str(step)))

    # -- steps ---------------------------------------------------------------
    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self._steps_root) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        """The newest step (the primary's view of the directory)."""
        steps = self.all_steps() if is_primary() else None
        steps = broadcast_object(steps)
        return steps[-1] if steps else None

    def _prune(self):
        for old in self.all_steps()[:-self.keep_last_n]:
            shutil.rmtree(os.path.join(self._steps_root, str(old)), ignore_errors=True)

    def _write_step(self, step: int, tree, meta: dict):
        _write_state_dir(os.path.join(self._steps_root, str(step)), tree, meta)
        self._prune()

    def _write_in_background(self, step: int, tree, meta: dict):
        try:
            self._write_step(step, tree, meta)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    # -- the layout of a state -----------------------------------------------
    def _shards(self, state) -> Dict[str, int]:
        """{name: dim} of the state's fsdp shards ({} for a whole state)."""
        from ..parallel.collectives import sharded_names

        specs = getattr(state, "specs", None)
        names = sharded_names(specs)
        if names and self.mesh is None:
            raise ValueError("a state of fsdp shards needs CheckpointManager(..., mesh=)")
        return {k: specs[k].dim for k in names}

    def _model_slices(self, state) -> Dict:
        """{name: ModelShard} of the state's model-axis slices ({} if none)."""
        from ..parallel.collectives import model_sharded_names

        specs = getattr(state, "specs", None)
        names = model_sharded_names(specs)
        if names and self.mesh is None:
            raise ValueError("a state of model-axis slices needs CheckpointManager(..., mesh=)")
        return {k: specs[k] for k in names}

    def _fsdp(self):
        """(fsdp index, fsdp size, whether this rank writes its fsdp shard:
        data index 0 and model index 0)."""
        from ..parallel.mesh import axis_size, fsdp_rank, model_rank

        return fsdp_rank(self.mesh), axis_size(self.mesh, "fsdp"), \
            self.mesh.get_coordinate()[0] == 0 and model_rank(self.mesh) == 0

    def _write_collective(self, path: str, tree, meta: Optional[dict], dims: Dict[str, int]):
        """Every rank's part of one checkpoint directory: `path.tmp` made by
        the primary, the state written (by the primary; or by the ranks of
        data index 0, one file per fsdp shard), then the primary's rename."""
        tmp = path + ".tmp"
        if is_primary():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        barrier("fidm-ckpt-mkdir")
        if dims:
            i, k, writer = self._fsdp()
            if writer:
                torch.save(tree, os.path.join(tmp, _shard_file(i, k)))
        elif is_primary():
            torch.save(tree, os.path.join(tmp, _STATE))
        barrier("fidm-ckpt-written")
        if is_primary():
            if dims:
                _replace_json(os.path.join(tmp, _SHARDS), {"fsdp": self._fsdp()[1],
                                                           "dims": dims})
            if meta is not None:
                with open(os.path.join(tmp, _META), "w") as f:
                    json.dump(meta, f)
            os.replace(tmp, path)
        barrier("fidm-ckpt-renamed")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[dict] = None,
             val_loss: Optional[float] = None) -> bool:
        """Save a rotating numbered checkpoint of `state` (a `TrainState`, or
        its `state_dict()` tree); track the best by val_loss. Returns True if
        this checkpoint became the new best (the primary's decision, on
        every rank)."""
        meta = dict(metadata or {})
        if val_loss is not None:
            meta["val_loss"] = float(val_loss)
        dims = self._shards(state)
        # an in-flight save commits before step directories move around
        if self._pending_cleanup:
            self.wait()
        # the primary's view of the layout decides the overwrite everywhere
        exists = broadcast_object(step in self.all_steps() if is_primary() else None)
        if exists:
            self.wait()
            if is_primary():
                self._begin_overwrite(step)
            barrier("fidm-ckpt-overwrite")
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        slices = self._model_slices(state)
        if slices:  # every rank joins the model axis's slices (collective)
            from ..parallel.collectives import full_params

            tree = _map_tree(tree, slices, lambda sec, name, t: full_params(
                {name: t}, {name: slices[name]}, self.mesh)[name])
        tree = _host_copy(tree)
        if self._multi or dims:
            self._write_collective(os.path.join(self._steps_root, str(step)), tree, meta, dims)
            if is_primary():
                self._prune()
                shutil.rmtree(self._backup_root(), ignore_errors=True)
        elif self.async_save:
            self._thread = threading.Thread(target=self._write_in_background,
                                            args=(step, tree, meta), daemon=True)
            self._thread.start()
            # the overwrite backup stays until the write is confirmed
            self._pending_cleanup = True
        else:
            self._write_step(step, tree, meta)
            shutil.rmtree(self._backup_root(), ignore_errors=True)

        # the primary decides, with its own float; every rank takes its branch
        is_best, best = broadcast_object(
            (val_loss is not None and val_loss < self.best_val_loss,
             None if val_loss is None else float(val_loss)) if is_primary() else None)
        if is_best:
            self.best_val_loss = best
            path, old = self._best_dir(), self._best_dir() + ".old"
            if is_primary():
                shutil.rmtree(old, ignore_errors=True)
                if os.path.isdir(path):
                    os.rename(path, old)
            if self._multi or dims:
                self._write_collective(path, tree, None, dims)
            else:
                _write_state_dir(path, tree, None)
            if is_primary():
                shutil.rmtree(old, ignore_errors=True)
                # the full metadata: the rotating step that holds it can be
                # pruned, and readers (cli.evaluate's mean_type) prefer "best"
                _replace_json(self._marker_path(), {**meta, "val_loss": self.best_val_loss,
                                                    "step": step})
            barrier("fidm-ckpt-best")
        return is_best

    # -- restore -------------------------------------------------------------
    def _which_dir(self, which) -> str:
        if which == "best":
            return self._best_dir()
        step = self.latest_step() if which == "latest" else int(which)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self._steps_root, str(step))

    def _load_for(self, path: str, state):
        """The checkpoint at `path` in the layout of `state`: this rank's own
        shard file when the layouts agree, else the whole state joined and
        cut to this rank's shards; model-axis slices cut from the whole."""
        tree = self._load_fsdp(path, state)
        slices = self._model_slices(state) if state is not None else {}
        if not slices:
            return tree
        from ..parallel.mesh import axis_size, local_slice, model_rank

        k, i = axis_size(self.mesh, "model"), model_rank(self.mesh)
        return _map_tree(tree, slices,
                         lambda sec, name, t: local_slice(t, slices[name], k, i).clone())

    def _load_fsdp(self, path: str, state):
        dims = self._shards(state) if state is not None else {}
        info = _layout(path)
        if dims and info is not None and info["dims"] == dims \
                and info["fsdp"] == self._fsdp()[1]:
            return _load_file(path, _shard_file(self._fsdp()[0], info["fsdp"]))
        tree = _load_state(path)
        if not dims:
            return tree
        i, k, _ = self._fsdp()
        return _map_tree(tree, dims, lambda sec, name, t: t.chunk(k, dims[name])[i].clone())

    def restore(self, which, state=None):
        """Restore 'latest' | 'best' | a step number. With a `TrainState`,
        copy the checkpoint into it (in its layout: whole, or this rank's
        shards); returns (state or the whole tree, metadata or None)."""
        if self._pending_cleanup:  # never read behind an in-flight save
            self.wait()
        path = self._which_dir(which)
        tree = self._load_for(path, state)
        meta = self.restore_metadata(which)
        if state is not None:
            return state.load_state_dict(tree), meta
        return tree, meta

    def restore_params(self, which="latest", prefer_ema: bool = False) -> Dict[str, torch.Tensor]:
        """Only the trained tensors, whole (for evaluation): the EMA with
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
