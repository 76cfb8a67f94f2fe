"""The port's training loaders and `cli.train`: the threaded and prefetching
loaders, the training loaders against the JAX package's, `cli.train`'s flags
against the JAX CLI's, and a tiny `cli.train` run (then resumed, and a LoRA
run) whose checkpoint directories `cli.evaluate` and `cli.generate` read.
Everything runs on the CPU at 16², float32.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from fidm_tpu.cli import train as jax_train_cli
from fidm_tpu.data import dataset as jax_dataset
from fidm_tpu_torch.cli import evaluate as port_evaluate
from fidm_tpu_torch.cli import generate as port_generate
from fidm_tpu_torch.cli import train as port_train_cli
from fidm_tpu_torch.data import create_inpainting_dataloaders
from fidm_tpu_torch.data.prefetch import ThreadedLoader, device_prefetch
from fidm_tpu_torch.models import ffhq256_config
from fidm_tpu_torch.training import (
    CheckpointManager,
    FitConfig,
    fit,
    make_eval_step,
    make_train_step,
)

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_native_ref import jax_native  # noqa: F401
from _torch_port_training_common import SCHED, HISTORY_KEYS, _state, _batch, _params_equal


TINY = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
        "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
        "--diffusion_steps", "50"]
# the keys of cli.train's metadata
META_KEYS = {"schedule", "diffusion_steps", "image_size", "lr", "mean_type", "epoch",
             "train_loss", "val_loss"}


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


def test_training_loaders_match_jax(jax_native, train_tree, monkeypatch):
    """Shuffled train with drop-last, sequential val: the same batches as the
    JAX loaders over two epochs, on one device (the JAX val loader drops a
    ragged last batch when a mesh spans more than one; these tests run JAX
    on 8 virtual CPU devices); process_local is accepted and changes nothing
    in one process. Both packages take their native helpers (C++ decode,
    normalize and compose; `fidm_tpu`'s built for this process by
    `jax_native`), so the batches are bit-equal."""
    import jax

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
    # --fsdp shards over ranks: one process without a process group has none
    with pytest.raises(ValueError, match="needs a process group"):
        _train(train_tree, tmp_path / "f", "--fsdp", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train_cli.main(["--train_dir", str(train_tree / "train"), "--val_dir",
                             str(train_tree / "val"), "--checkpoint_dir", str(tmp_path / "c")])
