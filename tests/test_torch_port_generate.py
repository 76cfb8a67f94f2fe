"""The port's `cli.generate` and `cli.visualize_noise` against the JAX
package's.

`cli.generate` takes the JAX CLI's flags and defaults; its `.pt` is the
3-channel base UNet in the ADM layout that the JAX CLI also loads; its
images are the port's own `sample()` on the same model and noise (each
batch's `GeneratorNoise` from the seed and the batch's offset: the JAX CLI
folds the offset into a threefry key, which torch cannot draw); a native
checkpoint directory without a checkpoint is refused before a model is
built (training checkpoint directories themselves:
tests/test_torch_port_training_cli.py). `visualize_noise` prints the JAX
CLI's SNR table digit for digit. Both run here on a tiny model or image
with `--device cpu`. Torch runs on one intra-op thread here.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from fidm_tpu.cli import generate as jax_generate
from fidm_tpu.cli import visualize_noise as jax_visualize_noise
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.models.torch_import import load_torch_checkpoint
from fidm_tpu_torch.cli import evaluate as port_evaluate
from fidm_tpu_torch.cli import generate as port_generate
from fidm_tpu_torch.cli import visualize_noise as port_visualize_noise
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling import sample

TINY = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
        "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
        "--diffusion_steps", "50"]


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


@pytest.mark.parametrize("port,ref", [(port_generate, jax_generate),
                                      (port_visualize_noise, jax_visualize_noise)],
                         ids=["generate", "visualize_noise"])
def test_argparse_defaults_equal_jax(port, ref):
    ours = vars(port.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == vars(ref.parse_args([]))


@pytest.fixture(scope="module")
def base_checkpoint(tmp_path_factory):
    """A 3-channel base UNet of TINY's shape (6 output channels) as an ADM
    `.pt`, seeded, with the zero-initialised output convs drawn too."""
    args = port_generate.parse_args(TINY + ["--seed", "3"])
    model = port_generate.build_model(args, "cpu")
    g = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d) and not m.weight.any():
            m.weight.copy_(0.05 * torch.randn(m.weight.shape, generator=g))
    path = tmp_path_factory.mktemp("gen_ckpt") / "base.pt"
    torch.save(model.state_dict(), path)
    return str(path), model.state_dict()


def test_checkpoint_is_the_layout_jax_loads(base_checkpoint):
    path, sd = base_checkpoint
    jcfg = JaxUNetConfig(in_channels=3, image_size=16, model_channels=32, channel_mult=(1, 2),
                         num_heads=2, num_head_channels=16, attention_resolutions=(2,))
    args = port_generate.parse_args(TINY)
    back = state_dict_from_jax(load_torch_checkpoint(path, jcfg, wrap_base=False),
                               port_generate.build_model(args, "cpu").config)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("method,extra", [("dpm++3m", ["--ddim_timesteps", "6"]),
                                          ("consistency", [])])
def test_generate_equals_sample(base_checkpoint, tmp_path, method, extra):
    """3 samples in batches of 2: each PNG is the port's `sample()` on the
    loaded model with the CLI's per-batch noise, and grid.png holds them."""
    path, _ = base_checkpoint
    out_dir = tmp_path / "gen"
    argv = TINY + ["--checkpoint", path, "--method", method, "--num_samples", "3",
                   "--batch_size", "2", "--seed", "5", "--output_dir", str(out_dir),
                   "--device", "cpu", *extra]
    assert port_generate.main(argv) == 3
    args = port_generate.parse_args(argv)
    model = port_generate.build_model(args, "cpu")
    cfg = port_generate.build_sampler(args)
    assert cfg.method == method and not cfg.injection and not cfg.final_blend
    assert cfg.num_steps == (6 if method == "dpm++3m" else 2)
    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    images = []
    for done in (0, 2):
        with torch.inference_mode():
            x = sample(model, sched, cfg, shape=(2, 16, 16, 3),
                       noise=port_evaluate.batch_noise(5, done, "cpu"))
        images += list(np.clip((x.numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8))
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "00000.png", "00001.png", "00002.png", "grid.png"]
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(Image.open(out_dir / f"{i:05d}.png")),
                                      images[i])
    assert np.asarray(Image.open(out_dir / "grid.png")).shape == (16, 3 * 18 - 2, 3)
    assert len({images[i].tobytes() for i in range(3)}) == 3


def test_generate_refuses_a_checkpoint_directory_before_building(tmp_path, monkeypatch):
    def never(*a, **kw):
        raise AssertionError("built a model")

    monkeypatch.setattr(port_generate, "build_model", never)
    monkeypatch.setattr(port_generate, "build_checkpoint_model", never)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        port_generate.main(["--checkpoint", str(tmp_path), "--output_dir",
                            str(tmp_path / "never"), "--device", "cpu"])
    assert not (tmp_path / "never").exists()


def test_entry_points_default_to_cuda_and_raise_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_generate.main(TINY + ["--output_dir", str(tmp_path / "g")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_visualize_noise.main(["--out", str(tmp_path / "v")])


def test_visualize_noise_matches_jax(tmp_path, capsys, monkeypatch):
    """The same SNR table, printed digit for digit, and a grid of the same
    layout."""
    monkeypatch.setenv("FIDM_NO_COMPILATION_CACHE", "1")
    argv = ["--image_size", "16", "--timesteps", "0", "10", "500", "999"]
    jax_visualize_noise.main(argv + ["--out", str(tmp_path / "jax")])
    ref_out = capsys.readouterr().out
    snr = port_visualize_noise.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    table = [ln for ln in out.splitlines() if ln.strip()[:1].isdigit() or ln.strip()[:1] == "t"]
    assert len(table) == 5
    assert table == [ln for ln in ref_out.splitlines()
                     if ln.strip()[:1].isdigit() or ln.strip()[:1] == "t"]
    for name in ("linear", "cosine", "quadratic"):
        # the float64 alpha_bar rounded to the schedule's float32 table
        acp = np.cumprod(1.0 - DiffusionSchedule.create(name, 1000, device="cpu").betas_host)
        acp32 = acp.astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(snr[name], acp32 / (1 - acp32))
    for d in ("jax", "port"):
        assert np.asarray(Image.open(tmp_path / d / "noising_grid.png")).shape == (
            3 * 18 - 2, 4 * 18 - 2, 3)
    assert (tmp_path / "port" / "schedule_curves.png").exists()
