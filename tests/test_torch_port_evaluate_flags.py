"""The port's evaluate CLI flags against the JAX CLI's (argument parsing, the
config defaults, the sampler flags and their refusals), FID's closed form
against the Frechet distance, and the step timer and image helpers. No model
runs here.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from fidm_tpu.cli import evaluate as jax_evaluate
from fidm_tpu_torch import metrics as port_metrics
from fidm_tpu_torch.cli import evaluate as port_evaluate

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_evaluate_common import MODEL, _fid_closed_form, REQUIRED


# --------------------------------------------------------------- arguments

ARGVS = [
    [],
    ["--preset", "ddim-50", "--eta", "0.3", "--ddim_timesteps", "20", "--seed", "7"],
    ["--preset", "ddim-100-deep", "--encoder_cache_tail", "5", "--batch_size", "2"],
    ["--encoder_cache", "3", "--cache_branch", "1", "--cache_keysteps", "17@1.0:2.0"],
    ["--no_injection", "--injection_schedule", "high", "--no_blend", "--time_spacing",
     "trailing", "--schedule", "linear", "--diffusion_steps", "500"],
    ["--timesteps", "999", "500", "0", "--mean_type", "velocity", "--quantize", "int8"],
    ["--preset", "dpm-25-sde", "--quick_test", "--no_save_images", "--dtype", "f32"],
    ["--fid_weights", "w.pth", "--fid_stats", "s.npz", "--lpips_alexnet", "a.pth",
     "--lpips_lin", "l.pt", "--checkpoint", "m.npz", *MODEL],
    ["--preset", "repaint-100-light", "--jump_length", "4", "--save_trajectory", "5"],
    ["--preset", "unipc-20", "--quick_test", "--save_trajectory", "3"],
]
ARGV_IDS = ["defaults", "ddim-50", "deep-tail", "keysteps", "injection", "student",
            "quick", "metrics", "repaint-trajectory", "unipc-trajectory"]


@pytest.mark.parametrize("argv", ARGVS, ids=ARGV_IDS)
def test_parse_args_matches_jax(argv):
    ours = vars(port_evaluate.parse_args(REQUIRED + argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_evaluate.parse_args(REQUIRED + argv))


def test_parse_args_config_defaults_match_jax(tmp_path):
    """A --config JSON sets defaults; flags on the command line win."""
    cfg = tmp_path / "eval.json"
    cfg.write_text(json.dumps({"preset": "ddim-50", "batch_size": 2, "eta": 0.5}))
    argv = REQUIRED + ["--config", str(cfg), "--eta", "0.1"]
    ours = vars(port_evaluate.parse_args(argv))
    ours.pop("device")
    assert ours == vars(jax_evaluate.parse_args(argv))
    assert (ours["preset"], ours["batch_size"], ours["eta"]) == ("ddim-50", 2, 0.1)


class _Built(Exception):
    """Raised in place of building the JAX pipeline, carrying its config."""


@pytest.mark.parametrize("argv", [a for a in ARGVS if "--checkpoint" not in a],
                         ids=[i for a, i in zip(ARGVS, ARGV_IDS) if "--checkpoint" not in a])
def test_sampler_flags_match_jax(argv, monkeypatch):
    """The sampler the port builds from the flags equals the one the JAX CLI
    hands its pipeline (its `create` is stopped there), field by field."""
    from fidm_tpu import pipeline as jax_pipeline

    def stop(config=None, **kw):
        raise _Built(config)

    monkeypatch.setattr(jax_pipeline.InpaintingPipeline, "create", staticmethod(stop))
    with pytest.raises(_Built) as built:
        jax_evaluate.main(REQUIRED + argv)
    ref = dataclasses.asdict(built.value.args[0].sampler)
    args = port_evaluate.parse_args(REQUIRED + argv)
    if args.quick_test:  # main applies it before the sampler is built
        args.ddim_timesteps = args.ddim_timesteps or 10
    ours = dataclasses.asdict(port_evaluate.build_sampler(args))
    for k in ("mean_type", "var_type"):
        assert ours.pop(k).name == ref.pop(k).name, k
    assert ours == ref


def test_cache_keysteps_refused_as_in_jax():
    argv = REQUIRED + ["--preset", "consistency-2", "--cache_keysteps", "0,1"]
    with pytest.raises(SystemExit, match="not supported with method='consistency'"):
        jax_evaluate.main(argv)
    with pytest.raises(SystemExit, match="not supported with method='consistency'"):
        port_evaluate.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("n,dim", [(40, 16), (8, 64)], ids=["full-rank", "singular"])
def test_fid_closed_form_equals_frechet_distance(n, dim):
    """The closed form against the CLIs' `frechet_distance` (scipy's sqrtm):
    to rounding at full rank, within scipy's approximation (1e-6
    relative) where the covariances are singular, as with 8 samples."""
    rng = np.random.default_rng(n)
    real = rng.standard_normal((n, dim))
    fake = rng.standard_normal((n, dim)) * 1.2 + 0.3
    tol = 1e-9 if n > dim else 1e-6
    assert _fid_closed_form(real, fake) == pytest.approx(
        port_metrics.fid_from_features(real, fake), rel=tol)


def test_step_timer_and_image_helpers_match_jax(tmp_path):
    """`to_uint8`, `save_png` and `save_comparison_grid` are copies of the
    JAX package's (the same bytes on disk); `StepTimer` keeps its API and
    waits for nothing on CPU tensors; `trace` writes a profiler trace."""
    from fidm_tpu import utils as jax_utils
    from fidm_tpu_torch import utils as port_utils

    rng = np.random.default_rng(1)
    img = rng.uniform(-1.2, 1.2, (16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_utils.to_uint8(img), jax_utils.to_uint8(img))
    rows = [[port_utils.to_uint8(img), (img[..., :1] > 0).astype(np.uint8) * 255]] * 2
    port_utils.save_comparison_grid(rows, str(tmp_path / "p" / "grid.png"))
    jax_utils.save_comparison_grid(rows, str(tmp_path / "j" / "grid.png"))
    assert (tmp_path / "p" / "grid.png").read_bytes() == (tmp_path / "j" / "grid.png").read_bytes()
    timer = port_utils.StepTimer()
    assert timer.summary() == "no steps timed"
    for _ in range(2):
        timer.start()
        timer.stop(torch.zeros(2))
    assert len(timer.times) == 2 and timer.mean >= 0
    assert timer.summary(per=2).startswith("2 steps, mean ")
    with port_utils.trace(str(tmp_path / "trace")):
        torch.ones(4) + 1
    assert list((tmp_path / "trace").glob("*.json"))
