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
"""
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch
from PIL import Image

import fidm_tpu.native.build as jax_native_build
from fidm_tpu.cli import train as jax_train_cli
from fidm_tpu.data import dataset as jax_dataset
from fidm_tpu.training import precision as jax_precision
from fidm_tpu_torch.cli import evaluate as port_evaluate
from fidm_tpu_torch.cli import generate as port_generate
from fidm_tpu_torch.cli import train as port_train_cli
from fidm_tpu_torch.data import create_inpainting_dataloaders
from fidm_tpu_torch.data.prefetch import ThreadedLoader, device_prefetch
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import InpaintingUNet, UNetConfig, ffhq256_config
from fidm_tpu_torch.training import (
    CheckpointManager,
    EarlyStopping,
    FitConfig,
    GracefulShutdown,
    TrainDraws,
    TrainState,
    fit,
    init_ema,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from fidm_tpu_torch.training import precision as port_precision

CFG = UNetConfig(image_size=8, in_channels=9, model_channels=32, out_channels=6,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_heads=1, num_head_channels=32, dtype=torch.float32)
SCHED = DiffusionSchedule.create("linear", 20, device="cpu")
TINY = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
        "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
        "--diffusion_steps", "50"]
# the keys of the JAX loop's history entries and of cli.train's metadata
HISTORY_KEYS = {"epoch", "train_loss", "val_loss", "seconds"}
META_KEYS = {"schedule", "diffusion_steps", "image_size", "lr", "mean_type", "epoch",
             "train_loss", "val_loss"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module: the test
    run shares the CPU between its workers."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _state(lr=1e-3, seed=0, ema=False):
    torch.manual_seed(seed)
    model = InpaintingUNet(CFG)
    with torch.no_grad():  # no zero-initialised conv: every parameter learns
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    params = dict(model.named_parameters())
    return TrainState.create(model, params, make_optimizer(make_lr_schedule("none", lr, 10)),
                             ema_params=init_ema(params) if ema else None)


def _batch(seed=1, B=2):
    g = torch.Generator().manual_seed(seed)
    S = CFG.image_size
    img = 0.5 * torch.randn((B, S, S, 3), generator=g)
    mask = torch.zeros((B, S, S, 1))
    mask[:, : S // 2] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


class SameDraws(TrainDraws):
    """Draws that ignore folds: every step sees the same timesteps and noise."""

    def fold(self, index):
        return self


def _params_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


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
    ours = port_precision.init_loss_scale(8.0, growth_interval=2)
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


def test_threaded_loader_identical_results():
    """threaded_loader changes where batches are made, never what trains."""
    batches = [_batch(i) for i in range(4)]

    def run(threaded):
        return fit(_state(), make_train_step(SCHED), make_eval_step(SCHED), batches,
                   batches[:1], 0, FitConfig(num_epochs=2, log_fn=lambda *a: None,
                                             handle_preemption=False,
                                             threaded_loader=threaded))

    s0, h0 = run(False)
    s1, h1 = run(True)
    assert [(h["train_loss"], h["val_loss"]) for h in h0] == \
           [(h["train_loss"], h["val_loss"]) for h in h1]
    assert _params_equal(s0.params, s1.params)


def test_prefetch_and_threaded_loader():
    """device_prefetch turns arrays into tensors (paths pass through) and
    keeps the order; a worker's error reaches the consumer."""
    src = [{"image": np.full((2, 2), i, np.float32), "path": f"p{i}"} for i in range(5)]
    out = list(device_prefetch(iter(src), size=2, device="cpu"))
    assert [b["path"] for b in out] == [f"p{i}" for i in range(5)]
    assert all(torch.equal(b["image"], torch.full((2, 2), float(i))) for i, b in enumerate(out))
    assert list(device_prefetch(iter([]), size=2, device="cpu")) == []

    def broken():
        yield src[0]
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(ThreadedLoader(broken))
    assert [b["path"] for b in ThreadedLoader(lambda: iter(src))] == [b["path"] for b in src]


# ------------------------------------------------------------ data and the CLI


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """4 training and 2 validation PNGs at 16², a mask root with train/,
    val/ and test/ (black = hole)."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        (root / split).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                root / split / f"{i}.png")
    for split in ("train", "val", "test"):
        (root / "masks" / split).mkdir(parents=True)
        for j in range(2):
            m = np.full((16, 16), 255, np.uint8)
            m[3 + j: 12, 2: 10 + j] = 0
            Image.fromarray(m).save(root / "masks" / split / f"m{j}.png")
    return root


def test_training_loaders_match_jax(train_tree, monkeypatch):
    """Shuffled train with drop-last, sequential val: the same batches as the
    JAX loaders over two epochs, on one device (the JAX val loader drops a
    ragged last batch when a mesh spans more than one; these tests run JAX
    on 8 virtual CPU devices); process_local is accepted and changes nothing
    in one process."""
    import jax

    monkeypatch.setattr(jax_native_build, "load", lambda: None)
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    args = (train_tree / "train", train_tree / "val", train_tree / "masks")
    ours = create_inpainting_dataloaders(*args, batch_size=3, img_size=16, seed=3)
    ref = jax_dataset.create_inpainting_dataloaders(*args, batch_size=3, img_size=16, seed=3)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for _ in range(2):
            for x, y in zip(a, b):
                assert x["image_path"] == y["image_path"]
                for key in ("image", "masked_image", "mask"):
                    np.testing.assert_array_equal(x[key], y[key])
    assert [len(x) for x in ours] == [1, 1]
    assert ours[0].drop_last and not ours[0].process_local


@pytest.mark.parametrize("argv", [
    [],
    ["--lora_rank", "8", "--ema_decay", "0.999", "--remat", "convs", "--accum_steps", "2"],
    ["--scheduler", "step", "--warmup_epochs", "2", "--mean_type", "velocity",
     "--loss_weight", "min_snr", "--snr_gamma", "3", "--async_checkpoint", "--resume", "best"],
    "config",
], ids=["defaults", "lora-ema-remat", "schedule-loss", "config-json"])
def test_parse_args_equal_to_jax(argv, tmp_path):
    base = ["--train_dir", "T", "--val_dir", "V"]
    if argv == "config":
        cfg = tmp_path / "c.json"
        cfg.write_text(json.dumps({"lr": 1e-4, "num_epochs": 3, "mask_mode": "random"}))
        argv = ["--config", str(cfg), "--num_epochs", "5"]
    ours = vars(port_train_cli.parse_args(base + argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_train_cli.parse_args(base + argv))


def _train(tree, ckdir, *extra):
    return port_train_cli.main(
        ["--train_dir", str(tree / "train"), "--val_dir", str(tree / "val"),
         "--checkpoint_dir", str(ckdir), "--batch_size", "2", "--device", "cpu", *TINY,
         *extra])


@pytest.fixture(scope="module")
def trained(train_tree, tmp_path_factory):
    """A tiny cli.train run: 2 epochs with an EMA, then resumed for a third."""
    ck = tmp_path_factory.mktemp("ck") / "run"
    first = _train(train_tree, ck, "--mask_dir", str(train_tree / "masks"), "--num_epochs",
                   "2", "--ema_decay", "0.9")
    layout = sorted(os.listdir(ck)), sorted(os.listdir(ck / "steps"))
    resumed = _train(train_tree, ck, "--mask_dir", str(train_tree / "masks"), "--num_epochs",
                     "3", "--ema_decay", "0.9", "--resume", "latest")
    return ck, first, resumed, layout


def test_cli_train_history_layout_and_resume(trained):
    ck, first, resumed, layout = trained
    assert [h["epoch"] for h in first] == [0, 1] and [h["epoch"] for h in resumed] == [2]
    assert all(set(h) == HISTORY_KEYS and np.isfinite(h["train_loss"]) for h in first + resumed)
    assert layout == (["best", "best.json", "history.json", "steps"], ["0", "1"])
    assert json.loads((ck / "history.json").read_text())[0]["epoch"] == 2
    meta = CheckpointManager(str(ck)).restore_metadata("latest")
    assert set(meta) == META_KEYS and meta["epoch"] == 2 and meta["mean_type"] == "epsilon"
    tree, _ = CheckpointManager(str(ck)).restore("latest")
    assert tree["step"] == 6 and tree["ema_params"] is not None


def test_cli_evaluate_and_generate_read_the_directory(trained, train_tree, tmp_path, capsys):
    """cli.evaluate on the directory (best, --use_ema): known pixels kept,
    the EMA weights loaded; cli.generate samples the 9-channel model."""
    ck = trained[0]
    ev = ["--data_dir", str(train_tree / "val"), "--mask_dir", str(train_tree / "masks"),
          "--checkpoint", str(ck), "--num_samples", "2", "--batch_size", "2",
          "--ddim_timesteps", "3", "--device", "cpu", *TINY]
    results = port_evaluate.main(ev + ["--output_dir", str(tmp_path / "ema"), "--use_ema"])
    assert results["num_samples"] == 2 and np.isfinite(results["ssim_mean"])
    assert "mean_type 'epsilon' from checkpoint metadata" in capsys.readouterr().out
    pipe = port_evaluate.build_pipeline(port_evaluate.parse_args(ev + ["--use_ema"]),
                                        port_evaluate.build_sampler(port_evaluate.parse_args(ev)))
    ema = CheckpointManager(str(ck)).restore_params("best", prefer_ema=True)
    assert _params_equal({k: v for k, v in pipe.model.state_dict().items()}, ema)
    n = port_generate.main(["--checkpoint", str(ck), "--num_samples", "2", "--batch_size", "2",
                            "--method", "ddim", "--ddim_timesteps", "3", "--output_dir",
                            str(tmp_path / "gen"), "--device", "cpu", "--use_ema", *TINY])
    assert n == 2
    assert sorted(os.listdir(tmp_path / "gen")) == ["00000.png", "00001.png", "grid.png"]


def test_checkpoint_mean_type_reaches_the_samplers(trained, tmp_path):
    """A run recorded as velocity-trained is decoded as velocity unless the
    flag says otherwise (evaluate reads best, generate latest)."""
    ck = tmp_path / "ck"
    shutil.copytree(trained[0], ck)
    for path in (ck / "best.json", ck / "steps" / "1" / "meta.json"):
        if path.exists():
            path.write_text(json.dumps({**json.loads(path.read_text()), "mean_type": "velocity"}))
    meta = json.loads((ck / "steps" / "2" / "meta.json").read_text())
    (ck / "steps" / "2" / "meta.json").write_text(json.dumps({**meta, "mean_type": "velocity"}))
    base = ["--data_dir", "D", "--mask_dir", "M", "--checkpoint", str(ck)]
    assert port_evaluate.build_sampler(port_evaluate.parse_args(base)).mean_type.name == "VELOCITY"
    assert port_evaluate.build_sampler(port_evaluate.parse_args(
        base + ["--mean_type", "epsilon"])).mean_type.name == "EPSILON"
    model, mt = port_generate.build_checkpoint_model(
        port_generate.parse_args(["--checkpoint", str(ck), *TINY]), torch.device("cpu"))
    assert mt == "velocity"


def test_cli_train_lora_saves_the_base_and_evaluate_merges_it(trained, train_tree, tmp_path):
    """--lora_rank on procedural masks from a `.pt` (the trained fixture's
    weights: a fresh model's zero-initialised convs would give the adapter
    no gradient): checkpoints hold the adapter only, lora_base/ the frozen
    base; cli.evaluate merges them, and refuses an adapter without a base."""
    pt = tmp_path / "base.pt"
    torch.save(CheckpointManager(str(trained[0])).restore_params("latest"), pt)
    ck = tmp_path / "lora"
    history = _train(train_tree, ck, "--num_epochs", "1", "--lora_rank", "4",
                     "--pretrained", str(pt))
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    params = CheckpointManager(str(ck)).restore_params("latest")
    assert "__meta__/scaling" in params and all(
        k.startswith("base/") or k.startswith("__meta__") for k in params)
    base = torch.load(ck / "lora_base" / "state.pt", weights_only=True)
    assert _params_equal(base, torch.load(pt, weights_only=True))
    mcfg = ffhq256_config(image_size=16, model_channels=32, channel_mult=(1, 2), num_heads=2,
                          num_head_channels=16, attention_resolutions=(2,))
    merged = port_train_cli.load_checkpoint_params(str(ck), "best", False, mcfg)
    moved = [k for k in base if not torch.equal(merged[k], base[k])]
    assert moved and all(k.endswith(("qkv.weight", "proj_out.weight")) for k in moved)
    ev = ["--data_dir", str(train_tree / "val"), "--mask_dir", str(train_tree / "masks"),
          "--checkpoint", str(ck), "--num_samples", "2", "--batch_size", "2",
          "--ddim_timesteps", "2", "--device", "cpu", "--output_dir", str(tmp_path / "ev"),
          *TINY]
    assert np.isfinite(port_evaluate.main(ev)["psnr_mean"])
    shutil.rmtree(ck / "lora_base")
    with pytest.raises(FileNotFoundError, match="lora_base"):
        port_evaluate.main(ev)


def test_cli_train_refuses_fsdp_and_defaults_to_cuda(train_tree, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="parallel"):
        _train(train_tree, tmp_path / "f", "--fsdp", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train_cli.main(["--train_dir", str(train_tree / "train"), "--val_dir",
                             str(train_tree / "val"), "--checkpoint_dir", str(tmp_path / "c")])
