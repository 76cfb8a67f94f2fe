"""The port's `cli.export_torch` against the JAX package's export, and the
two small public functions of this slice (`noised_ground_truth`,
`inception_pool3`) against theirs.

The exported file is compared bit for bit, key order included, with what
`fidm_tpu.models.torch_import.export_state_dict` / the JAX CLI write from
the same weights: a port checkpoint directory (best if present, else
latest, `--which`; the params, not the EMA), an int8 `.npz` (against the JAX
CLI's `.pt` from it) and a `.pt`. Torch runs on one intra-op thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu.cli import export_torch as jax_export_cli
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion import noised_ground_truth as jax_noised_ground_truth
from fidm_tpu.metrics import inception as jax_inception
from fidm_tpu.models import ffhq256_config as jax_ffhq256_config
from fidm_tpu.models.torch_import import convert_state_dict, export_state_dict
from fidm_tpu_torch.cli import export_torch as port_export_cli
from fidm_tpu_torch.cli import quantize as port_quantize_cli
from fidm_tpu_torch.diffusion import DiffusionSchedule, noised_ground_truth
from fidm_tpu_torch.diffusion.gaussian import q_sample
from fidm_tpu_torch.metrics import inception as port_inception
from fidm_tpu_torch.models import InpaintingUNet, ffhq256_config
from fidm_tpu_torch.training import CheckpointManager, TrainState, make_optimizer

from oracle_fid_inception import FIDInceptionOracle
from oracle_fid_inception import randomize as randomize_inception

SIZE = dict(image_size=16, model_channels=32, channel_mult=(1, 2), num_heads=2,
            num_head_channels=16, attention_resolutions=(2,))
FLAGS = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
         "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2"]
REPORT_KEYS = {"out", "bytes", "in_channels", "image_size"}


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


def _model(seed):
    torch.manual_seed(seed)
    model = InpaintingUNet(ffhq256_config(**SIZE))
    with torch.no_grad():  # every leaf non-zero
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _jax_written(sd):
    """The state dict the JAX package exports from these weights: its
    converter's tree, then `export_state_dict`, then `save_torch_checkpoint`'s
    float32 tensors."""
    cfg = jax_ffhq256_config(dtype=jnp.float32, **SIZE)
    tree = convert_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in export_state_dict({"params": {"base": tree}}, cfg).items()}


def _same_file(ours, ref):
    """Keys in the same order, float32 tensors bit for bit."""
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and ours[k].is_contiguous(), k
        assert torch.equal(ours[k], v), k


def _export(checkpoint, out, *extra):
    return port_export_cli.main(["--checkpoint", str(checkpoint), "--out", str(out),
                                 "--device", "cpu", *FLAGS, *extra])


@pytest.mark.parametrize("argv", [[], ["--which", "7", "--attention_resolutions", "16"]],
                         ids=["defaults", "which"])
def test_parse_args_equal_to_jax(argv):
    base = ["--checkpoint", "c", "--out", "o.pt"]
    ours = vars(port_export_cli.parse_args(base + argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_export_cli.parse_args(base + argv))
    assert port_export_cli.parse_args(base).attention_resolutions == [32, 16, 8]


def test_export_of_a_checkpoint_directory_matches_jax(tmp_path):
    """A directory with a numbered step (params, an EMA that differs) and
    a best: best by default, the step with --which; the params, never the
    EMA; the file the JAX package writes from the same weights, which loads
    into the port's UNet with strict=True."""
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck))
    states = {}
    for step, seed in ((3, 1), (5, 2)):
        model = _model(seed)
        params = dict(model.named_parameters())
        state = TrainState.create(model, params, make_optimizer(lambda c: 0.0),
                                  ema_params={k: v.detach() + 1.0 for k, v in params.items()})
        mgr.save(step, state, metadata={"epoch": step},
                 val_loss=1.0 if step == 3 else None)
        states[step] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mgr.close()
    report = _export(ck, tmp_path / "best.pt")
    assert set(report) == REPORT_KEYS and report["bytes"] == (tmp_path / "best.pt").stat().st_size
    _same_file(torch.load(tmp_path / "best.pt", weights_only=True), _jax_written(states[3]))
    _export(ck, tmp_path / "latest.pt", "--which", "latest")
    written = torch.load(tmp_path / "latest.pt", weights_only=True)
    _same_file(written, _jax_written(states[5]))
    InpaintingUNet(ffhq256_config(**SIZE)).load_state_dict(written, strict=True)


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "model.pt"
    torch.save(_model(0).state_dict(), path)
    return path


def test_export_of_an_int8_npz_matches_the_jax_cli(tiny_pt, tmp_path):
    """The quantize CLI's `.npz`, dequantized and exported by both CLIs:
    the same tensors under the same keys in the same order, the same report
    but its path and size. The JAX CLI writes each dequantized kernel in
    the memory order of the `.npz`'s HWIO array (`np.array` keeps the
    strides of a transposed view), the port contiguous, so the two files
    differ in layout and size, not in any value."""
    npz = tmp_path / "int8.npz"
    port_quantize_cli.main(["--checkpoint", str(tiny_pt), "--out", str(npz), "--device", "cpu",
                            "--min_size", "256", *FLAGS])
    ref_report = jax_export_cli.main(["--checkpoint", str(npz), "--out",
                                      str(tmp_path / "jax.pt"), *FLAGS])
    report = _export(npz, tmp_path / "port.pt")
    assert {k: v for k, v in report.items() if k not in ("out", "bytes")} == {
        k: v for k, v in ref_report.items() if k not in ("out", "bytes")}
    assert report["bytes"] == (tmp_path / "port.pt").stat().st_size
    ours = torch.load(tmp_path / "port.pt", weights_only=True)
    _same_file(ours, torch.load(tmp_path / "jax.pt", weights_only=True))
    source = torch.load(tiny_pt, weights_only=True)
    assert any(not torch.equal(ours[k], source[k]) for k in source)  # dequantized


def test_export_of_a_pt_round_trips(tiny_pt, tmp_path):
    """A `.pt` through both CLIs: the same file to the byte (one file name
    in two directories: torch.save records the name in the archive), whose
    tensors are the source's."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_export_cli.main(["--checkpoint", str(tiny_pt), "--out",
                         str(tmp_path / "jax" / "model.pt"), *FLAGS])
    _export(tiny_pt, tmp_path / "port" / "model.pt")
    assert ((tmp_path / "port" / "model.pt").read_bytes()
            == (tmp_path / "jax" / "model.pt").read_bytes())
    ours = torch.load(tmp_path / "port" / "model.pt", weights_only=True)
    source = torch.load(tiny_pt, weights_only=True)
    assert set(ours) == set(source) and all(torch.equal(ours[k], source[k]) for k in source)


def test_export_refuses_other_flags_and_defaults_to_cuda(tiny_pt, tmp_path, monkeypatch):
    """Weights that do not fit the flags' UNet (here the default attention
    resolutions 32 16 8) are refused before anything is written; without a
    GPU the default device raises."""
    flags = list(FLAGS)
    i = flags.index("--attention_resolutions")
    del flags[i:i + 2]
    with pytest.raises(RuntimeError, match="state_dict"):
        port_export_cli.main(["--checkpoint", str(tiny_pt), "--out", str(tmp_path / "x.pt"),
                              "--device", "cpu", *flags])
    assert not (tmp_path / "x.pt").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export_cli.main(["--checkpoint", str(tiny_pt), "--out", str(tmp_path / "y.pt"),
                              *FLAGS])


# ------------------------------------------------------- the small gaps


def test_noised_ground_truth_matches_jax():
    """On JAX's noise draw, the JAX function's value (float32 arithmetic in
    the same order); from a generator, q_sample of that generator's draw."""
    rng = np.random.default_rng(2)
    gt = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 71], np.int32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_noised_ground_truth(JaxSchedule.create("linear", 100),
                                             jnp.asarray(gt), jnp.asarray(t), key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, gt.shape, jnp.float32)))
    sched = DiffusionSchedule.create("linear", 100, device="cpu")
    ours = noised_ground_truth(sched, torch.from_numpy(gt), torch.from_numpy(t), noise)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    drawn = noised_ground_truth(sched, torch.from_numpy(gt), torch.from_numpy(t),
                                torch.Generator().manual_seed(8))
    expect = q_sample(sched, torch.from_numpy(gt), torch.from_numpy(t),
                      torch.randn(gt.shape, generator=torch.Generator().manual_seed(8)))
    assert torch.equal(drawn, expect)


def test_inception_pool3_matches_jax():
    """The functional pool3 network on seeded weights (the oracle's,
    randomised), an NHWC batch in [-1, 1]: within 1e-5 of the largest
    feature (float32 convolutions in another order), as the extractors are
    held in tests/test_torch_port_metrics.py."""
    sd = dict(randomize_inception(FIDInceptionOracle(), seed=1).state_dict())
    x = np.random.default_rng(3).uniform(-1, 1, (1, 299, 299, 3)).astype(np.float32)
    ref = np.asarray(jax_inception.inception_pool3(
        jax_inception.convert_torch_inception_weights(sd), jnp.asarray(x)))
    with torch.inference_mode():
        ours = port_inception.inception_pool3(
            port_inception.convert_torch_inception_weights(sd), torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (1, 2048) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    assert "inception_pool3" in port_inception.__all__
