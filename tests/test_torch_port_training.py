"""The port's training stack: the mirror of `tests/test_training.py`'s cases,
port-only where no JAX output is compared, and the training CLI.

The train step's metrics and learning, checkpoints (round trip, rotation,
async saves, overwrite recovery, the best marker's metadata, EMA restore),
early stopping whose snapshot survives in-place updates, preemption and
resume, the threaded loader, the loss scale and the training loaders
against the JAX package's, `cli.train`'s flags against the JAX CLI's, and
a tiny `cli.train` run (then resumed, and a LoRA run) whose checkpoint
directories `cli.evaluate` and `cli.generate` read. Everything runs on the
CPU at 8² or 16², float32; torch runs on one intra-op thread.

The loaders and `cli.train` are in `test_torch_port_training_cli.py`: port
test files hold at most 25 cases (ROADMAP.md).
"""
import os
import signal

import numpy as np
import pytest
import torch

from fidm_tpu.training import precision as jax_precision
from fidm_tpu_torch.training import (
    CheckpointManager,
    EarlyStopping,
    FitConfig,
    GracefulShutdown,
    TrainDraws,
    fit,
    make_eval_step,
    make_train_step,
)
from fidm_tpu_torch.training import precision as port_precision

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_training_common import SCHED, HISTORY_KEYS, _state, _batch, _params_equal


class SameDraws(TrainDraws):
    """Draws that ignore folds: every step sees the same timesteps and noise."""

    def fold(self, index):
        return self


# ------------------------------------------------------------ the train step


def test_train_step_decreases_loss():
    """With the same draws every step, eight steps lower the loss."""
    state = _state()
    step = make_train_step(SCHED)
    batch = _batch()
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch, SameDraws(42, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert state.step == 8 and state.opt_state["count"] == 8
    assert np.isfinite(losses).all()


def test_train_metrics_contract():
    """The JAX step's metrics, as 0-d tensors on the batch's device (no host
    read inside the step)."""
    state = _state()
    _, metrics = make_train_step(SCHED)(state, _batch(), 0)
    assert set(metrics) == {"loss", "mse", "grad_norm", "mask_coverage"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in metrics.values())
    assert 0.0 < float(metrics["mask_coverage"]) < 1.0
    _, metrics = make_train_step(SCHED, vb_weight=0.5)(state, _batch(), 0)
    assert set(metrics) == {"loss", "mse", "grad_norm", "mask_coverage", "vb"}


def test_eval_step_deterministic():
    state = _state()
    ev = make_eval_step(SCHED)
    before = {k: v.clone() for k, v in state.params.items()}
    a = float(ev(state, _batch(), 7)["loss"])
    b = float(ev(state, _batch(), TrainDraws(7, "cpu"))["loss"])
    assert a == b
    assert float(ev(state, _batch(), 8)["loss"]) != a
    assert state.step == 0 and _params_equal(state.params, before)


def test_ema_tracked_by_the_step():
    state = _state(ema=True)
    step = make_train_step(SCHED, ema_decay=0.5)
    for _ in range(2):
        state, m = step(state, _batch(), 2)
    assert np.isfinite(float(m["loss"]))
    name = "input_blocks.0.0.weight"
    assert not torch.equal(state.params[name], state.ema_params[name])
    assert state.ema_params[name].data_ptr() != state.params[name].data_ptr()


def test_loss_scale_dynamics_match_jax():
    """Grow after `growth_interval` finite steps, halve on overflow, the
    unscaled gradients and the finite flag, against the JAX functions."""
    ours = port_precision.init_loss_scale(8.0, growth_interval=2, device="cpu")
    ref = jax_precision.init_loss_scale(8.0, growth_interval=2)
    rng = np.random.default_rng(0)
    for i, bad in enumerate((False, False, False, True, False)):
        g = {"a": rng.standard_normal((3,)).astype(np.float32),
             "b": rng.standard_normal((2, 2)).astype(np.float32)}
        if bad:
            g["b"][0, 1] = np.inf
        ours, og, ofin = port_precision.unscale_grads(ours, {k: torch.from_numpy(v)
                                                             for k, v in g.items()})
        ref, rg, rfin = jax_precision.unscale_grads(ref, g)
        assert bool(ofin) == bool(rfin) == (not bad), i
        assert float(ours.scale) == float(ref.scale), i
        assert int(ours.growth_counter) == int(ref.growth_counter), i
        if not bad:
            for k in g:
                np.testing.assert_allclose(og[k].numpy(), np.asarray(rg[k]), rtol=1e-7)
    assert float(port_precision.scale_loss(ours, torch.tensor(2.0))) == 2.0 * float(ours.scale)


def test_loss_scale_defaults_to_the_card(monkeypatch):
    """`init_loss_scale` runs on the card unless the caller names another
    device, as every entry point of the port: with no GPU the default
    raises, and `device="cpu"` gives the JAX function's state."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_precision.init_loss_scale(8.0, growth_interval=2)
    ours = port_precision.init_loss_scale(8.0, growth_interval=2, device="cpu")
    ref = jax_precision.init_loss_scale(8.0, growth_interval=2)
    assert ours.scale.device.type == ours.growth_counter.device.type == "cpu"
    assert ours.scale.dtype == torch.float32 and ours.growth_counter.dtype == torch.int32
    assert float(ours.scale) == float(ref.scale) == 8.0
    assert int(ours.growth_counter) == int(ref.growth_counter) == 0
    assert ours.growth_interval == ref.growth_interval == 2
    assert (ours.growth_factor, ours.backoff_factor) == (ref.growth_factor, ref.backoff_factor)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2)
    step = make_train_step(SCHED)
    val_losses = [0.5, 0.3, 0.4, 0.2]
    for i, vl in enumerate(val_losses):
        state, _ = step(state, _batch(), 0)
        is_best = mgr.save(i, state, metadata={"epoch": i}, val_loss=vl)
        assert is_best == (vl == min(val_losses[: i + 1]))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    saved = {k: v.clone() for k, v in state.params.items()}
    other = _state(seed=5)
    restored, meta = mgr.restore("latest", other)
    assert restored is other and meta["epoch"] == 3 and meta["val_loss"] == 0.2
    assert other.step == 4 and other.opt_state["count"] == 4
    assert _params_equal(other.params, saved)
    assert all(torch.equal(other.opt_state["mu"][k], state.opt_state["mu"][k])
               for k in saved)
    tree, best_meta = mgr.restore("best")
    assert best_meta["step"] == 3 and best_meta["val_loss"] == 0.2
    assert _params_equal(tree["params"], saved)
    mgr.close()


def test_checkpoint_async_save_roundtrip(tmp_path):
    """async_save: save() copies the state to the host and returns; wait()
    commits. A redone step keeps its overwrite backup until then; the host
    copy is taken at save time, not when the thread writes."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=3, async_save=True)
    step = make_train_step(SCHED)
    state, _ = step(state, _batch(), 0)
    first = {k: v.clone() for k, v in state.params.items()}
    mgr.save(0, state, metadata={"epoch": 0}, val_loss=0.5)
    state, _ = step(state, _batch(), 0)  # in place, while the save may still write
    mgr.save(1, state, metadata={"epoch": 1}, val_loss=0.4)
    mgr.save(1, state, metadata={"epoch": 99}, val_loss=0.6)
    assert os.path.isdir(mgr._backup_root())  # held until the commit is confirmed
    mgr.wait()
    assert not os.path.isdir(mgr._backup_root())
    assert mgr.all_steps() == [0, 1]
    assert _params_equal(mgr.restore_params("0"), first)
    assert mgr.restore_metadata("latest")["epoch"] == 99
    assert mgr.restore_metadata("best")["val_loss"] == 0.4
    mgr.close()


def test_restore_params_prefer_ema(tmp_path):
    state = _state(ema=True)
    for v in state.ema_params.values():
        v.add_(1.0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state, metadata={})
    got = mgr.restore_params("latest", prefer_ema=True)
    assert _params_equal(got, state.ema_params)
    assert _params_equal(mgr.restore_params("latest"), state.params)
    plain = CheckpointManager(str(tmp_path / "ck2"))
    plain.save(0, _state(), metadata={})
    # no EMA in the checkpoint: the params
    assert _params_equal(plain.restore_params("latest", prefer_ema=True), _state().params)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore_params("latest")


def test_overwrite_interrupted_recovery(tmp_path):
    """A crash between the backup rename and the new save loses nothing:
    the next manager rolls the backup back. A write that never reached its
    rename is dropped."""
    state = _state()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep_last_n=3)
    mgr.save(0, state, metadata={"epoch": 0}, val_loss=1.0)
    mgr._begin_overwrite(0)
    os.makedirs(os.path.join(d, "steps", "0.tmp"))
    assert mgr.latest_step() is None
    mgr2 = CheckpointManager(d, keep_last_n=3)
    assert mgr2.latest_step() == 0
    assert not os.path.exists(os.path.join(d, "steps", "0.tmp"))
    tree, meta = mgr2.restore("latest")
    assert meta["epoch"] == 0 and _params_equal(tree["params"], state.params)


def test_overwrite_completed_discards_backup(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=3)
    mgr.save(0, state, metadata={"epoch": 0})
    mgr.save(0, state, metadata={"epoch": 99})
    assert not os.path.isdir(mgr._backup_root())
    assert mgr.restore_metadata("latest")["epoch"] == 99


def test_best_marker_carries_full_metadata(tmp_path):
    """best.json keeps the training metadata: the rotating step that holds
    it can be pruned, and cli.evaluate reads mean_type from "best"."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=1)
    mgr.save(0, state, metadata={"mean_type": "velocity", "epoch": 0}, val_loss=1.0)
    mgr.save(1, state, metadata={"mean_type": "velocity", "epoch": 1}, val_loss=2.0)
    assert mgr.all_steps() == [1]
    meta = mgr.restore_metadata("best")
    assert meta == {"mean_type": "velocity", "epoch": 0, "val_loss": 1.0, "step": 0}
    assert CheckpointManager(str(tmp_path / "ck")).best_val_loss == 1.0


# ------------------------------------------------------------ early stopping, fit


def test_early_stopping_restores_best():
    es = EarlyStopping(patience=2, restore_best_weights=True)
    p = {"w": torch.tensor([1.0])}
    assert es.update(1.0, p) == (False, p)
    assert not es.update(1.5, {"w": torch.tensor([2.0])})[0]
    stop, best = es.update(1.6, {"w": torch.tensor([3.0])})
    assert stop and float(best["w"]) == 1.0


def test_early_stopping_snapshot_survives_in_place_updates():
    """The snapshot is a clone of each tensor: the optimizer's in-place
    updates of the live parameters do not reach it."""
    state = _state()
    es = EarlyStopping(patience=1, restore_best_weights=True)
    before = {k: v.clone() for k, v in state.params.items()}
    es.update(1.0, state.params)
    state, _ = make_train_step(SCHED)(state, _batch(), 2)
    stop, best = es.update(2.0, state.params)
    assert stop and _params_equal(best, before)
    assert not _params_equal(state.params, before)


def test_fit_early_stopping_puts_the_best_weights_back(monkeypatch):
    """A rising validation loss stops fit after `patience` epochs, with the
    best epoch's weights back in the model."""
    state = _state()
    batches = [_batch(i) for i in range(2)]
    vals = iter([0.5, 0.9, 1.0])
    snaps = []

    def eval_step(state, batch, draws):
        snaps.append({k: v.clone() for k, v in state.params.items()})
        return {"loss": torch.tensor(next(vals)), "mse": torch.tensor(0.0)}

    state, history = fit(state, make_train_step(SCHED), eval_step, batches, batches[:1], 0,
                         FitConfig(num_epochs=5, early_stopping_patience=2,
                                   log_fn=lambda *a: None, handle_preemption=False))
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert _params_equal(state.params, snaps[0])


def test_graceful_shutdown_flag_and_second_signal():
    with GracefulShutdown() as g:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested  # first signal: a flag only
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)  # second: a hard stop
    assert signal.getsignal(signal.SIGTERM) is not g._handle


def test_graceful_shutdown_off_the_main_thread_is_a_flag():
    import threading

    seen = []

    def run():
        with GracefulShutdown() as g:
            seen.append((g.requested, dict(g._orig)))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen == [(False, {})]


def _preempting(step, at):
    calls = {"n": 0}

    def wrapped(state, batch, draws):
        calls["n"] += 1
        if calls["n"] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(state, batch, draws)

    return wrapped, calls


def test_fit_preemption_saves_and_exits(tmp_path):
    """SIGTERM mid-epoch: the step in flight finishes, a checkpoint tagged
    preempted is written with the last completed epoch, and fit returns."""
    state = _state()
    step, calls = _preempting(make_train_step(SCHED), 2)
    batches = [_batch(i) for i in range(5)]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state, history = fit(state, step, make_eval_step(SCHED), batches, batches[:1], 0,
                         FitConfig(num_epochs=3, log_fn=lambda *a: None),
                         checkpoint_manager=mgr)
    assert len(history) == 1 and history[0].get("preempted") is True
    assert calls["n"] == 2
    meta = mgr.restore_metadata("latest")
    assert meta["preempted"] is True
    assert meta["epoch"] == -1 and meta["interrupted_epoch"] == 0


def test_preemption_resume_roundtrip(tmp_path):
    """Preempt, resume, finish: the redone epoch re-saves its step, and the
    loader's epoch counter is restored to the resumed epoch."""
    state = _state()
    step, _ = _preempting(make_train_step(SCHED), 2)
    batches = [_batch(i) for i in range(3)]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    fit(state, step, make_eval_step(SCHED), batches, batches[:1], 0,
        FitConfig(num_epochs=2, log_fn=lambda *a: None), checkpoint_manager=mgr)
    restored, meta = mgr.restore("latest", _state(seed=1))
    start_epoch = meta["epoch"] + 1
    assert start_epoch == 0
    _, history = fit(restored, make_train_step(SCHED), make_eval_step(SCHED), batches,
                     batches[:1], 0, FitConfig(num_epochs=2, log_fn=lambda *a: None),
                     checkpoint_manager=mgr, start_epoch=start_epoch)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(set(h) == HISTORY_KEYS for h in history)
    assert mgr.latest_step() == 1

    class Loader(list):
        epoch = 0

    loader = Loader(batches)
    fit(_state(), make_train_step(SCHED), make_eval_step(SCHED), loader, batches[:1], 0,
        FitConfig(num_epochs=3, log_fn=lambda *a: None, handle_preemption=False),
        start_epoch=2)
    assert loader.epoch == 2
