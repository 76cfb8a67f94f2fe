"""The port's distillation (`fidm_tpu_torch.distill`, `cli.distill`) against
the JAX package's.

One float32 step of each kind on the small UNet of `_torch_port_common`
(16², width 32, every leaf drawn from numpy, no zero-initialised conv):
progressive distillation, consistency distillation and consistency
training, each against the jitted JAX step on JAX's draws (`JaxDistillDraws`,
the counterpart of the train-step tests' `JaxTrainDraws`: `fold_in(key,
step)` split into the segment and noise keys, `randint` and `normal` on
them). The loss within 1e-5 relative and every gradient within 2e-5 of its
tensor's largest plus 1e-7, the train step's bounds; the gradients come from
recording optimizers on both sides. The target network starts away from the
live weights (every EMA leaf shifted), so a target that mixed EMA and live
tensors would show. Three JAX steps are compiled here, and one
`consistency_sample` scan over a closed-form stand-in for the UNet.

Then the closed forms of `tests/test_distill.py` (a perfect teacher: the
target is x0 and the loss 0; a perfect model samples x0), the teacher left
as it was, the EMA update, the CLI's flags against the JAX CLI's, and the
CLI on a tiny model on the CPU: the 4 -> 2 -> 1 ladder read back by
`cli.evaluate`, consistency distillation read by `--preset consistency-2`,
consistency training from a fresh model read by `cli.generate`, and the
refusals. Torch runs on one intra-op thread.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from torch import nn

from fidm_tpu.cli import distill as jax_distill_cli
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.distill import consistency_grid as jax_consistency_grid
from fidm_tpu.distill import consistency_sample as jax_consistency_sample
from fidm_tpu.distill import distill_boundaries as jax_distill_boundaries
from fidm_tpu.distill import make_consistency_step as jax_make_consistency_step
from fidm_tpu.distill import make_distill_step as jax_make_distill_step
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.training import TrainState as JaxTrainState
from fidm_tpu.training import make_optimizer as jax_make_optimizer
from fidm_tpu_torch.cli import distill as port_distill_cli
from fidm_tpu_torch.cli import evaluate as port_evaluate
from fidm_tpu_torch.cli import generate as port_generate
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.distill import (consistency_grid, consistency_sample, distill_boundaries,
                                    make_consistency_step, make_distill_step)
from fidm_tpu_torch.distill.progressive import unet_apply
from fidm_tpu_torch.models import InpaintingUNet
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.sampling.sampler import GeneratorNoise
from fidm_tpu_torch.training import (CheckpointManager, TrainDraws, TrainState, init_ema,
                                     make_lr_schedule, make_optimizer)
from fidm_tpu_torch.training.train_state import Optimizer

from _torch_port_common import JCFG, PCFG, drawn_jax_variables, stub_base_model

B = 2
LR = 1e-3
TEACHER_STEPS = 4
GRID = 10
TINY = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
        "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
        "--diffusion_steps", "50"]
# the JAX CLI's metadata keys (`fidm_tpu/cli/distill.py`)
STUDENT_META = {"student_steps", "mean_type", "schedule", "diffusion_steps", "timesteps_grid"}
CONSISTENCY_META = {"mode", "mean_type", "schedule", "diffusion_steps", "sampler_method"}


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


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxDistillDraws:
    """`TrainDraws`' interface over a JAX key, drawing what the JAX distill
    and consistency steps draw: fold -> fold_in; on the step's key (the
    update count folded in) the segment and noise keys are its split, the
    segment index `randint(seg_key, (B,), 0, n)`, the noise
    `normal(noise_key)`."""

    def __init__(self, key):
        self.key = key

    def fold(self, index):
        return JaxDistillDraws(jax.random.fold_in(self.key, index))

    def timesteps(self, batch, n):
        seg_key, _ = jax.random.split(self.key)
        return _t(jax.random.randint(seg_key, (batch,), 0, n)).long()

    def noise(self, shape):
        _, noise_key = jax.random.split(self.key)
        return _t(jax.random.normal(noise_key, tuple(shape), jnp.float32))


class RecordingOptimizer(Optimizer):
    """The port's AdamW, keeping the gradients of its last update."""

    def update(self, grads, state, params, *args):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        super().update(grads, state, params, *args)


def _recording(tx):
    """`tx`, keeping in its state the gradients each update receives."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    s = JCFG.image_size
    img = np.clip(0.5 * rng.standard_normal((B, s, s, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((B, s, s, 1), np.float32)
    mask[0, 4:12, 2:10] = 1.0
    mask[1, :8] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


@pytest.fixture(scope="module")
def setup():
    """The JAX variables (drawn from numpy, no compile), an EMA tree with
    every leaf shifted, the schedules and a batch."""
    s = JCFG.image_size
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
    variables = drawn_jax_variables(JaxInpaintingUNet, JCFG, 3, *dummy)
    rng = np.random.default_rng(4)
    ema = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    return dict(variables=variables, ema=ema, batch=_batch(),
                jsched=JaxSchedule.create("quadratic", 1000),
                psched=DiffusionSchedule.create("quadratic", 1000, device="cpu"),
                key=jax.random.PRNGKey(11))


def _jax_apply(params, x, t, mi, m):
    return JaxInpaintingUNet(JCFG).apply({"params": params}, x, t, mi, m)


def _jax_step(setup, kind):
    """One jitted JAX step of `kind` at lr 1e-3: its metrics and gradients."""
    params = setup["variables"]["params"]
    tx = _recording(jax_make_optimizer(optax.constant_schedule(LR)))
    if kind == "progressive":
        state = JaxTrainState.create(apply_fn=None, params=params, tx=tx)
        step = jax_make_distill_step(setup["jsched"], _jax_apply, _jax_apply,
                                     teacher_steps=TEACHER_STEPS)
    else:
        state = JaxTrainState.create(apply_fn=None, params=params, ema_params=setup["ema"],
                                     tx=tx)
        step = jax_make_consistency_step(
            setup["jsched"], None if kind == "training" else _jax_apply, _jax_apply,
            grid_size=GRID)
    state, metrics = step(state, params, setup["batch"], setup["key"])
    grads = jax.tree_util.tree_map(np.asarray, state.opt_state[1])
    return {k: float(v) for k, v in metrics.items()}, grads


def _module(variables):
    model = InpaintingUNet(PCFG)
    model.load_state_dict(state_dict_from_jax(variables, PCFG), strict=True)
    return model


def _port_step(setup, kind):
    """One port step of `kind` on JAX's draws, the teacher a frozen copy:
    (metrics, gradients, state, teacher)."""
    student = _module(setup["variables"])
    teacher = _module(setup["variables"]).requires_grad_(False)
    params = dict(student.named_parameters())
    tx = RecordingOptimizer(make_lr_schedule("none", LR, 10))
    if kind == "progressive":
        state = TrainState.create(student, params, tx)
        step = make_distill_step(setup["psched"], unet_apply, unet_apply,
                                 teacher_steps=TEACHER_STEPS)
    else:
        ema = state_dict_from_jax({"params": setup["ema"]}, PCFG)
        state = TrainState.create(student, params, tx, ema_params=ema)
        step = make_consistency_step(setup["psched"], None if kind == "training" else unet_apply,
                                     unet_apply, grid_size=GRID)
        teacher = None if kind == "training" else teacher
    state, metrics = step(state, teacher, setup["batch"], JaxDistillDraws(setup["key"]))
    return metrics, tx.grads, state, teacher


@pytest.fixture(scope="module", params=["progressive", "distillation", "training"])
def jax_step(request, setup):
    """(kind, metrics, gradients) of one compiled JAX step of each kind."""
    return (request.param, *_jax_step(setup, request.param))


def test_step_matches_jax(setup, jax_step):
    """The loss and the gradient norm within 1e-5 relative; every gradient
    within 2e-5 of its tensor's largest (float32 sums in another order
    through the teacher's two forwards, the target network's and the
    student's) plus 1e-7. The 1e-7 is for the biases before a GroupNorm of
    one channel per group (width 32, 32 groups), whose gradient is 0 in
    exact arithmetic and rounding noise on both sides. That noise scales
    with the loss's gradients, which the pseudo-Huber metric makes 10x the
    MSE's (largest 0.75 against 0.07): there it reaches 2e-7, so a tensor
    may instead be noise on both sides, below 1e-6 of the step's largest
    gradient."""
    kind, ref_metrics, ref_grads = jax_step
    metrics, grads, state, _ = _port_step(setup, kind)
    assert set(metrics) == set(ref_metrics) == {"loss", "grad_norm"}
    assert all(m.ndim == 0 for m in metrics.values()) and state.step == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(metrics[k]) - ref_metrics[k]) <= 1e-5 * abs(ref_metrics[k]), k
    ref = state_dict_from_jax({"params": ref_grads}, PCFG)
    assert set(ref) == set(grads)
    noise = 1e-6 * max(r.abs().max().item() for r in ref.values())
    for name, g in grads.items():
        bound = 2e-5 * ref[name].abs().max().item() + 1e-7
        assert ((g - ref[name]).abs().max().item() <= bound
                or max(g.abs().max().item(), ref[name].abs().max().item()) <= noise), name


def test_boundaries_and_grids_match_jax():
    for T, K in ((1000, 16), (1000, 8), (50, 4), (100, 10)):
        np.testing.assert_array_equal(distill_boundaries(T, K), jax_distill_boundaries(T, K))
        np.testing.assert_array_equal(consistency_grid(T, K), jax_consistency_grid(T, K))
        assert (port_distill_cli.student_grid(T, K // 2)
                == jax_distill_cli.student_grid(T, K // 2))
    with pytest.raises(AssertionError):
        distill_boundaries(1000, 7)


def test_teacher_stays_and_the_ema_follows(setup):
    """Two steps of each kind: the frozen teacher is bit for bit as it
    was, the student moved; the target network is decay * itself + (1 -
    decay) * the updated student, tensor by tensor."""
    for kind in ("progressive", "distillation"):
        _, _, state, teacher = _port_step(setup, kind)
        before = {k: v.clone() for k, v in state.params.items()}
        ema0 = {k: v.clone() for k, v in (state.ema_params or {}).items()}
        step = (make_distill_step(setup["psched"], unet_apply, unet_apply,
                                  teacher_steps=TEACHER_STEPS) if kind == "progressive" else
                make_consistency_step(setup["psched"], unet_apply, unet_apply, grid_size=GRID,
                                      ema_decay=0.9))
        state, _ = step(state, teacher, setup["batch"], TrainDraws(5, "cpu"))
        ref = state_dict_from_jax(setup["variables"], PCFG)
        assert all(torch.equal(v, ref[k]) for k, v in teacher.state_dict().items())
        assert any(not torch.equal(before[k], v) for k, v in state.params.items())
        for k, e in (state.ema_params or {}).items():
            torch.testing.assert_close(e, 0.9 * ema0[k] + 0.1 * state.params[k].detach(),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ closed forms

SCHED = DiffusionSchedule.create("cosine", 100, device="cpu")


def _x0_true():
    g = torch.Generator().manual_seed(3)
    return torch.clamp(0.4 * torch.randn((4, 8, 8, 3), generator=g), -1, 1)


class Exact(nn.Module):
    """A perfect model of one x0: its exact eps ("eps"), or its exact v
    scaled by (1 + b) in the x0 term ("v"; exact at b = 0)."""

    def __init__(self, x0, kind):
        super().__init__()
        self.x0, self.kind = x0, kind
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x, t, mi=None, m=None):
        a = SCHED.sqrt_alphas_cumprod[t.long()][:, None, None, None]
        s = SCHED.sqrt_one_minus_alphas_cumprod[t.long()][:, None, None, None]
        if self.kind == "eps":
            return (x - a * self.x0) / s
        return (a * x - self.x0 * (1 + self.b)) / s


def _exact_state(x0, ema=False):
    student = Exact(x0, "v")
    params = dict(student.named_parameters())
    return TrainState.create(student, params, make_optimizer(lambda c: 0.0),
                             ema_params=init_ema(params) if ema else None)


def _exact_batch(x0):
    return {"image": x0, "masked_image": x0, "mask": torch.zeros((4, 8, 8, 1))}


def test_distill_target_equals_x0_for_perfect_teacher():
    """An exact-eps teacher without clipping: two DDIM steps are exactly
    consistent with one step predicting the true x0, so a student that
    predicts it has ~zero loss (`tests/test_distill.py`'s bound)."""
    x0 = _x0_true()
    step = make_distill_step(SCHED, unet_apply, unet_apply, teacher_steps=10,
                             clip_denoised=False)
    _, metrics = step(_exact_state(x0), Exact(x0, "eps"), _exact_batch(x0), 0)
    assert float(metrics["loss"]) < 1e-4


@pytest.mark.parametrize("teacher", [True, False], ids=["distillation", "training"])
def test_consistency_perfect_model_zero_loss(teacher):
    """A student and target that already predict the true x0: the
    objective is ~zero, with an exact-eps teacher or without one."""
    x0 = _x0_true()
    step = make_consistency_step(SCHED, unet_apply if teacher else None, unet_apply,
                                 grid_size=10, clip_denoised=False)
    _, metrics = step(_exact_state(x0, ema=True), Exact(x0, "eps") if teacher else None,
                      _exact_batch(x0), 0)
    assert float(metrics["loss"]) < 1e-4


def test_consistency_sample_perfect_model():
    """A perfect v-model samples the true x0 in one step and in four, the
    same source gives the same image, and injected known pixels come back
    exactly."""
    g = torch.Generator().manual_seed(0)
    x0 = torch.clamp(0.5 * torch.randn((2, 8, 8, 3), generator=g), -1, 1)
    model = Exact(x0, "v")

    def apply_fn(x, t):
        return model(x, t).detach()

    for steps in (1, 4):
        out = consistency_sample(apply_fn, SCHED, steps, x0.shape, GeneratorNoise(1, "cpu"))
        torch.testing.assert_close(out, x0, rtol=0, atol=5e-3)
    a = consistency_sample(apply_fn, SCHED, 4, x0.shape, GeneratorNoise(1, "cpu"))
    assert torch.equal(a, consistency_sample(apply_fn, SCHED, 4, x0.shape,
                                             GeneratorNoise(1, "cpu")))
    mask = torch.zeros((2, 8, 8, 1))
    mask[:, 2:6, 2:6] = 1.0
    out = consistency_sample(apply_fn, SCHED, 2, x0.shape, GeneratorNoise(1, "cpu"),
                             gt=x0, mask=mask)
    keep = mask[..., 0] < 0.5
    assert torch.equal(out[keep], x0[keep])


class JaxConsistencyNoise:
    """The draws of the JAX `consistency_sample` from one key: the initial
    state from split(fold_in(key, 0))[0], then at level i the injection and
    renoise keys of the i-th split(k, 3) of the loop key."""

    def __init__(self, key, num_steps):
        self.init_key, k = jax.random.split(jax.random.fold_in(key, 0))
        self.keys = []
        for _ in range(num_steps):
            k, k_inj, k_re = jax.random.split(k, 3)
            self.keys.append((k_inj, k_re))

    def init(self, shape):
        return _t(jax.random.normal(self.init_key, tuple(shape)))

    def inject(self, i, shape):
        return _t(jax.random.normal(self.keys[i][0], tuple(shape), jnp.float32))

    def step(self, i, shape):
        return _t(jax.random.normal(self.keys[i][1], tuple(shape), jnp.float32))


def test_consistency_sample_matches_jax():
    """Three levels with injection on the closed-form stand-in for the
    UNet, on JAX's keys: within 1e-5 of JAX's image (float32 arithmetic in
    another order), the known pixels exactly gt."""
    rng = np.random.default_rng(6)
    gt = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    mask = np.zeros((2, 8, 8, 1), np.float32)
    mask[0, 2:6, 1:7] = 1.0
    mask[1, 4:] = 1.0
    key = jax.random.PRNGKey(9)
    jsched = JaxSchedule.create("linear", 100)
    psched = DiffusionSchedule.create("linear", 100, device="cpu")
    ref = np.asarray(jax_consistency_sample(stub_base_model(jnp), jsched, 3, gt.shape, key,
                                            gt=jnp.asarray(gt), mask=jnp.asarray(mask)))
    ours = consistency_sample(stub_base_model(torch), psched, 3, gt.shape,
                              JaxConsistencyNoise(key, 3), gt=torch.from_numpy(gt),
                              mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    keep = mask[..., 0] < 0.5
    np.testing.assert_array_equal(ours[keep], gt[keep])


# ------------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    [],
    "config",
], ids=["defaults", "config-json"])
def test_parse_args_equal_to_jax(argv, tmp_path):
    base = ["--train_dir", "T"]
    if argv == "config":
        cfg = tmp_path / "c.json"
        cfg.write_text(json.dumps({"mode": "consistency", "grid_size": 20, "lr": 3e-5}))
        argv = ["--config", str(cfg), "--ema_decay", "0.99", "--use_ema", "--mean_type",
                "velocity"]
    ours = vars(port_distill_cli.parse_args(base + argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_distill_cli.parse_args(base + argv))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 training PNGs at 16², a mask root with train/ and test/ (black =
    hole), and a `.pt` of a seeded tiny model with every leaf perturbed."""
    from fidm_tpu_torch.models import ffhq256_config

    root = tmp_path_factory.mktemp("distill_data")
    rng = np.random.default_rng(0)
    (root / "train").mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            root / "train" / f"{i}.png")
    for split in ("train", "test"):
        (root / "masks" / split).mkdir(parents=True)
        for j in range(2):
            m = np.full((16, 16), 255, np.uint8)
            m[3 + j: 12, 2: 10 + j] = 0
            Image.fromarray(m).save(root / "masks" / split / f"m{j}.png")
    torch.manual_seed(0)
    model = InpaintingUNet(ffhq256_config(image_size=16, model_channels=32, channel_mult=(1, 2),
                                          num_heads=2, num_head_channels=16,
                                          attention_resolutions=(2,)))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    torch.save(model.state_dict(), root / "teacher.pt")
    return root


def _distill(tree, out, *extra):
    return port_distill_cli.main(
        ["--train_dir", str(tree / "train"), "--out", str(out), "--batch_size", "2",
         "--steps_per_round", "2", "--device", "cpu", *TINY, *extra])


def _evaluate(tree, ck, out, *extra):
    return port_evaluate.main(
        ["--data_dir", str(tree / "train"), "--mask_dir", str(tree / "masks"),
         "--checkpoint", str(ck), "--num_samples", "2", "--batch_size", "2",
         "--output_dir", str(out), "--device", "cpu", *TINY, *extra])


def test_cli_progressive_ladder_then_evaluate(tree, tmp_path, capsys):
    """4 -> 2 -> 1 from the `.pt`: two rounds with finite losses, each
    student in the checkpoint format with the JAX CLI's metadata and its
    grid; `cli.evaluate` reads student_2 with its grid and the metadata's
    mean_type."""
    out = tmp_path / "out"
    report = _distill(tree, out, "--checkpoint", str(tree / "teacher.pt"), "--mask_dir",
                      str(tree / "masks"), "--teacher_steps", "4", "--final_steps", "1")
    assert [r["student_steps"] for r in report["rounds"]] == [2, 1]
    assert all(np.isfinite(r["final_loss"]) for r in report["rounds"])
    for r in report["rounds"]:
        K = r["student_steps"]
        sdir = out / f"student_{K}"
        assert r["checkpoint"] == str(sdir) and sorted(os.listdir(sdir)) == ["grid.json",
                                                                              "steps"]
        grid = json.loads((sdir / "grid.json").read_text())
        assert grid == {"grid": jax_distill_cli.student_grid(50, K), "mean_type": "velocity"}
        assert r["grid"] == grid["grid"] and np.all(np.diff(grid["grid"]) < 0)
        meta = CheckpointManager(str(sdir)).restore_metadata("latest")
        assert set(meta) == STUDENT_META and meta["timesteps_grid"] == grid["grid"]
        tree_ = CheckpointManager(str(sdir)).restore("latest")[0]
        assert tree_["step"] == 2 and tree_["ema_params"] is None
    grid = json.loads((out / "student_2" / "grid.json").read_text())["grid"]
    capsys.readouterr()
    results = _evaluate(tree, out / "student_2", tmp_path / "ev", "--timesteps",
                        *map(str, grid))
    assert "mean_type 'velocity' from checkpoint metadata" in capsys.readouterr().out
    assert results["num_samples"] == 2 and np.isfinite(results["ssim_mean"])


def test_cli_consistency_then_preset(tree, tmp_path):
    """--mode consistency: consistency/ holds the EMA target network as its
    params, with the JAX CLI's metadata; `--preset consistency-2` reads it."""
    out = tmp_path / "out"
    report = _distill(tree, out, "--checkpoint", str(tree / "teacher.pt"), "--mode",
                      "consistency", "--grid_size", "10")
    sdir = out / "consistency"
    assert report == {"mode": "consistency", "final_loss": report["final_loss"],
                      "checkpoint": str(sdir), "out": str(out)}
    assert np.isfinite(report["final_loss"])
    saved, meta = CheckpointManager(str(sdir)).restore("latest")
    assert set(meta) == CONSISTENCY_META and meta["sampler_method"] == "consistency"
    assert all(torch.equal(saved["params"][k], saved["ema_params"][k]) for k in saved["params"])
    base = torch.load(tree / "teacher.pt", weights_only=True)
    assert any(not torch.equal(saved["params"][k], base[k]) for k in base)
    results = _evaluate(tree, sdir, tmp_path / "ev", "--preset", "consistency-2")
    assert results["preset"] == "consistency-2" and np.isfinite(results["psnr_mean"])


def test_cli_consistency_training_then_generate(tree, tmp_path):
    """--mode consistency-training without --checkpoint (a fresh model from
    --seed, procedural masks), then `cli.generate --method consistency`."""
    out = tmp_path / "out"
    report = _distill(tree, out, "--mode", "consistency-training", "--grid_size", "10")
    assert report["mode"] == "consistency-training" and np.isfinite(report["final_loss"])
    n = port_generate.main(["--checkpoint", str(out / "consistency"), "--method", "consistency",
                            "--num_samples", "2", "--batch_size", "2", "--output_dir",
                            str(tmp_path / "gen"), "--device", "cpu", *TINY])
    assert n == 2
    assert sorted(os.listdir(tmp_path / "gen")) == ["00000.png", "00001.png", "grid.png"]


@pytest.mark.parametrize("argv", [
    ["--checkpoint", "x.pt", "--teacher_steps", "12", "--final_steps", "4"],
    ["--checkpoint", "x.pt", "--teacher_steps", "64", "--final_steps", "4"],
    ["--checkpoint", "x.pt", "--mode", "consistency", "--grid_size", "50"],
    ["--mode", "consistency"],
], ids=["not-power-of-2", "duplicate-boundaries", "grid-size", "no-checkpoint"])
def test_cli_refusals_word_for_word(argv):
    """Each refusal of the JAX CLI, with its message, before anything is
    built (50 diffusion steps)."""
    full = ["--train_dir", "T", "--diffusion_steps", "50", *argv]
    with pytest.raises(SystemExit) as ref:
        jax_distill_cli.main(full)
    with pytest.raises(SystemExit) as ours:
        port_distill_cli.main(full)
    assert isinstance(ref.value.code, str) and ours.value.code == ref.value.code


def test_cli_refuses_fsdp_and_defaults_to_cuda(tree, tmp_path, monkeypatch):
    # --fsdp shards over ranks: one process without a process group has none
    with pytest.raises(ValueError, match="needs a process group"):
        _distill(tree, tmp_path / "f", "--checkpoint", str(tree / "teacher.pt"), "--fsdp", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_distill_cli.main(["--train_dir", str(tree / "train"), "--checkpoint",
                               str(tree / "teacher.pt"), "--out", str(tmp_path / "c")])
