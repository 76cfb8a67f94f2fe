"""Spatial partitioning where H does not split evenly, in OS processes over
gloo on the CPU, against the port's unmeshed calls and the JAX package's
spatial train step.

Two jobs (this file run as a script, `python test_torch_port_spatial_uneven.py
JOB RANK PORT WORKDIR`, each spawned once for the module under a 150 s
timeout; the jobs import no JAX):

  job "a", three ranks, mesh (1, 1, 3), the small float32 config of
      `tests/_torch_port_common.py` at H=16, which does not divide by 3:
      `shard_batch(spatial=True)` keeps the image whole and records so, and
      the spatial train, eval, LoRA, progressive, consistency-distillation
      steps and a 1-epoch `fit` each equal the unmeshed call (loss 1e-5
      relative and 1e-6 absolute, gradients 2e-5 of their tensor's largest
      plus 1e-7, parameters 2e-5: the bounds of
      `tests/test_torch_port_tp_train.py`), every rank of the group
      computing the whole image (its own gradients the same on each rank).
      The control at H=24 (blocks of 8 rows) runs split: its ranks' own
      gradients differ, their sum is the unmeshed step's;
  job "b", two ranks, mesh (1, 1, 2), that config with channel_mult
      (1, 2, 2) at H=W=20: the 10-row level's blocks of 5 are odd, so
      levels 1 and 2 and the middle block run whole on both ranks. The
      forward (2e-5), one train step on JAX's draws (the bounds above) and
      a 10-step DDIM through `InpaintingPipeline(shard_spatial=True)`,
      plain and feature-cached (1e-4, known pixels exact), against the
      unmeshed calls.

The JAX package's spatial `make_train_step` on its 8 CPU devices
(`create_mesh(data=4, model=2)`, as `tests/test_tp.py` builds it: GSPMD pads
the 5-row blocks) at job b's config, weights and draws (`JaxTrainDraws`) is
held to job b's train step at the same bounds. Torch and BLAS run on one
thread.
"""
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

B, S, S_CONTROL, S_UNEVEN = 2, 16, 24, 20
B_UNEVEN = 4
LR, DISTILL_LR, FIT_LR, CLIP = 1e-5, 1e-3, 1e-3, 1.0
UNEVEN_MULT = (1, 2, 2)
DDIM = dict(method="ddim", num_steps=10, eta=0.9, injection=True)
SAMPLERS = {"ddim": DDIM,
            "ddim_encoder_cache": dict(DDIM, encoder_cache_period=2, cache_branch=0),
            "ddim_deep_cache": dict(DDIM, encoder_cache_period=2, cache_branch=2)}
# `tests/_torch_port_common.py`'s SMALL (which imports JAX, and the jobs do not)
SMALL = dict(image_size=S, in_channels=9, model_channels=32, out_channels=6,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
             resblock_updown=True)
UNEVEN = dict(SMALL, image_size=S_UNEVEN, channel_mult=UNEVEN_MULT)
CASES_A = ("train", "eval", "lora", "progressive", "consistency", "fit")
RANKS = {"a": 3, "b": 2}
HERE = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------- the jobs' calls (no JAX)

def _sched():
    from fidm_tpu_torch.diffusion import DiffusionSchedule

    return DiffusionSchedule.create("quadratic", 1000, device="cpu")


def _model(cfg, state_dict=None):
    """The port's UNet of `cfg`: `state_dict`, or its own init with every
    parameter shifted by a seeded draw."""
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig

    torch.manual_seed(0)
    model = InpaintingUNet(UNetConfig(**cfg, dtype=torch.float32))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
        return model
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _batch(b, s, seed=1):
    rng = np.random.default_rng(seed)
    img = np.clip(0.5 * rng.standard_normal((b, s, s, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[0, s // 4:3 * s // 4, 2:s // 2 + 2] = mask[1, :s // 2] = 1.0
    if b > 2:
        mask[2, s // 2:, s // 2:] = mask[3, 2:s - 2, 3:s // 2] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _state(model, mesh, tx, **kw):
    from fidm_tpu_torch.parallel import shard_params
    from fidm_tpu_torch.training import TrainState

    params, specs = ((dict(model.named_parameters()), None) if mesh is None
                     else shard_params(model, mesh))
    return TrainState.create(model, params, tx, specs=specs, **kw)


def _recording_own(fn):
    """fn()'s value and the gradients of every call of `reduce_gradients`
    in it, as this rank computed them (before any reduction)."""
    from fidm_tpu_torch.parallel import collectives

    own, reduce_gradients = {}, collectives.reduce_gradients

    def recording(names, grads, *args):
        own.update((k, g.detach().clone()) for k, g in zip(names, grads))
        return reduce_gradients(names, grads, *args)

    collectives.reduce_gradients = recording
    try:
        return fn(), own
    finally:
        collectives.reduce_gradients = reduce_gradients


def train_case(cfg, batch, mesh, draws, state_dict=None, eval_first=False):
    """One train step (and before it, `eval_first`, an eval step on the same
    draws): metrics, the reduced gradients, the parameters after it, this
    rank's own gradients."""
    from test_torch_port_multiprocess import _recording_optimizer

    from fidm_tpu_torch.parallel import shard_batch
    from fidm_tpu_torch.training import make_eval_step, make_train_step

    model = _model(cfg, state_dict)
    tx = _recording_optimizer(LR, CLIP, None)
    state = _state(model, mesh, tx)
    spatial = mesh is not None
    part = batch if mesh is None else shard_batch(batch, mesh, spatial=True)
    out = {}
    if eval_first:
        evals = make_eval_step(_sched(), mesh=mesh, spatial=spatial)(state, part, draws)
        out["eval"] = {k: float(v) for k, v in evals.items()}
    step = make_train_step(_sched(), mesh=mesh, spatial=spatial)
    (_, metrics), own = _recording_own(lambda: step(state, part, draws))
    out.update(metrics={k: float(v) for k, v in metrics.items()}, grads=tx.grads, own=own,
               params={k: v.detach().clone() for k, v in state.params.items()})
    return out


def lora_case(cfg, batch, mesh):
    """One LoRA train step (the default attention targets, `b` drawn away
    from zero): metrics and the adapter's reduced gradients."""
    from test_torch_port_multiprocess import _recording_optimizer

    from fidm_tpu_torch.lora import init_lora, lora_weights
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.parallel import shard_batch
    from fidm_tpu_torch.training import TrainState, make_train_step

    ucfg = UNetConfig(**cfg, dtype=torch.float32)
    model = _model(cfg).requires_grad_(False)
    g = torch.Generator().manual_seed(6)
    adapter = {k: (v + 0.05 * torch.randn(v.shape, generator=g) if k.endswith("/b")
                   else v).requires_grad_(True)
               for k, v in init_lora(5, model, ucfg).items()}
    tx = _recording_optimizer(LR, CLIP, None)
    state = TrainState.create(model, adapter, tx)
    step = make_train_step(_sched(), mesh=mesh, spatial=mesh is not None,
                           param_transform=lambda l: lora_weights(model, ucfg, l, None, mesh))
    part = batch if mesh is None else shard_batch(batch, mesh, spatial=True)
    _, metrics = step(state, part, 0)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": tx.grads}


def distill_case(cfg, batch, mesh, kind):
    """One progressive or consistency-distillation step: metrics and the
    reduced gradients."""
    from test_torch_port_multiprocess import _recording_optimizer

    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.parallel import shard_batch
    from fidm_tpu_torch.training import init_ema

    student, teacher = _model(cfg), _model(cfg).requires_grad_(False)
    tx = _recording_optimizer(DISTILL_LR, CLIP, None)
    state = _state(student, mesh, tx, ema_params=(
        None if kind == "progressive" else init_ema(dict(student.named_parameters()))))
    spatial = mesh is not None
    step = (make_distill_step(_sched(), unet_apply, unet_apply, teacher_steps=4, mesh=mesh,
                              spatial=spatial) if kind == "progressive" else
            make_consistency_step(_sched(), unet_apply, unet_apply, grid_size=10, mesh=mesh,
                                  spatial=spatial))
    part = batch if mesh is None else shard_batch(batch, mesh, spatial=True)
    _, metrics = step(state, teacher, part, 0)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": tx.grads}


def fit_case(cfg, mesh):
    """A 1-epoch `fit` of 2 steps with validation: its history, the
    parameters after it and every update's gradients."""
    from _mh_train_common import SynthInpaintDataset

    from fidm_tpu_torch.data.dataset import DataLoader
    from fidm_tpu_torch.training import FitConfig, fit, make_eval_step, make_train_step
    from fidm_tpu_torch.training.train_state import Optimizer

    grads = []

    class Recording(Optimizer):  # make_optimizer's AdamW
        def update(self, g, *args):
            grads.append({k: v.detach().clone() for k, v in g.items()})
            return super().update(g, *args)

    state = _state(_model(cfg), mesh, Recording(lambda c: FIT_LR))
    spatial = mesh is not None
    state, history = fit(
        state, make_train_step(_sched(), mesh=mesh, spatial=spatial),
        make_eval_step(_sched(), mesh=mesh, spatial=spatial),
        DataLoader(SynthInpaintDataset(2 * B, S), batch_size=B, shuffle=True, seed=3,
                   drop_last=True),
        DataLoader(SynthInpaintDataset(B, S), batch_size=B), 7,
        FitConfig(num_epochs=1, log_fn=lambda *a, **k: None, handle_preemption=False),
        mesh=mesh)
    return {"history": history, "grads": grads,
            "params": {k: v.detach().clone() for k, v in state.params.items()}}


def part_a(mesh):
    """Job a's calls (the references without `mesh`)."""
    batch = _batch(B, S)
    train = train_case(SMALL, batch, mesh, 0, eval_first=True)
    out = {"train": train, "eval": train["eval"], "lora": lora_case(SMALL, batch, mesh),
           "fit": fit_case(SMALL, mesh),
           "control": train_case(dict(SMALL, image_size=S_CONTROL), _batch(B, S_CONTROL),
                                 mesh, 0)}
    for kind in ("progressive", "consistency"):
        out[kind] = distill_case(SMALL, batch, mesh, kind)
    if mesh is not None:
        from fidm_tpu_torch.parallel import shard_batch
        from fidm_tpu_torch.parallel.mesh import H_BLOCKS

        out["layout"] = {s: shard_batch(_batch(B, s), mesh, spatial=True)[H_BLOCKS]
                         for s in (S, S_CONTROL)}
    return out


def forward_case(inputs, mesh):
    """The UNet's output at job b's config, whole (every rank's block
    gathered under `mesh`)."""
    from fidm_tpu_torch.parallel import shard_batch
    from fidm_tpu_torch.parallel.collectives import gather_h, model_group
    from fidm_tpu_torch.parallel.tp import attach

    model, fwd = _model(UNEVEN, inputs["state_dict"]), inputs["forward"]
    if mesh is None:
        with torch.no_grad():
            return model(fwd["x"], fwd["t"], fwd["masked_image"], fwd["mask"])
    part = shard_batch(fwd, mesh, spatial=True)
    with torch.no_grad(), attach(model, mesh, "spatial"):
        out = model(part["x"], part["t"], part["masked_image"], part["mask"])
    return gather_h(out, model_group(mesh), dim=1)


def inpaint_case(inputs, mesh, sampler):
    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.sampling import SamplerConfig

    config = PipelineConfig(unet=UNetConfig(**UNEVEN, dtype=torch.float32),
                            sampler=SamplerConfig(**SAMPLERS[sampler]))
    pipe = InpaintingPipeline(_model(UNEVEN, inputs["state_dict"]).requires_grad_(False),
                              _sched(), config, mesh=mesh, shard_spatial=mesh is not None)
    return pipe.inpaint(inputs["gt"], inputs["mask"], 5)


def part_b(inputs, mesh):
    """Job b's calls (the references without `mesh`)."""
    from test_torch_port_multiprocess import RecordedDraws

    out = {"forward": forward_case(inputs, mesh),
           "train": train_case(UNEVEN, inputs["batch"], mesh, RecordedDraws(inputs["draws"]),
                               inputs["state_dict"])}
    for sampler in SAMPLERS:
        out[sampler] = inpaint_case(inputs, mesh, sampler)
    return out


def main():
    job, rank, port, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from fidm_tpu_torch.parallel import create_mesh, multihost

    assert multihost.initialize(f"127.0.0.1:{port}", RANKS[job], rank, device="cpu")
    mesh = create_mesh(data=1, fsdp=1, model=RANKS[job])
    if job == "a":
        out = part_a(mesh)
    else:
        out = part_b(torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False), mesh)
    torch.save(out, os.path.join(workdir, f"{job}{rank}.pt"))
    multihost.barrier("done")
    print("SU_OK", job, rank, flush=True)


# ------------------------------------------- the tests and their references

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _jax_inputs():
    """Job b's weights (every leaf of JAX's tree drawn from numpy, nothing
    compiled), inputs and JAX's train-step draws, for both packages."""
    import jax

    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.models import UNetConfig as JaxUNetConfig
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from test_torch_port_train_step import JaxTrainDraws

    from _torch_port_common import drawn_jax_variables
    import jax.numpy as jnp

    jcfg = JaxUNetConfig(**UNEVEN, dtype=jnp.float32)
    s = S_UNEVEN
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
    variables = drawn_jax_variables(JaxInpaintingUNet, jcfg, 3, *dummy)
    batch, key = _batch(B_UNEVEN, s, seed=4), jax.random.PRNGKey(7)
    # the JAX step's draws: fold_in(key, step 0), then fold_in(., 0) for its
    # one loss evaluation
    d = JaxTrainDraws(key).fold(0).fold(0)
    shape = batch["image"].shape
    draws = {((0, 0), "t"): d.timesteps(B_UNEVEN, 1000).numpy(),
             ((0, 0), "noise"): d.noise(shape).numpy(),
             ((0, 0), "inject"): d.inject(shape).numpy()}
    rng = np.random.default_rng(5)
    forward = {"x": rng.standard_normal(shape).astype(np.float32),
               "t": rng.integers(0, 1000, (B_UNEVEN,)).astype(np.int64),
               "masked_image": rng.standard_normal(shape).astype(np.float32),
               "mask": (rng.random(shape[:3] + (1,)) > 0.5).astype(np.float32)}
    inputs = {"state_dict": state_dict_from_jax(variables, UNetConfig(**UNEVEN,
                                                                      dtype=torch.float32)),
              "batch": batch, "draws": draws, "gt": batch["image"], "mask": batch["mask"],
              "forward": {k: torch.from_numpy(v) for k, v in forward.items()}}
    return inputs, variables, jcfg, key


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both jobs' ranks, started (job b's inputs in WORKDIR/inputs.pt), so
    that they run while the references are computed; killed at the end."""
    workdir = tmp_path_factory.mktemp("spatial_uneven")
    inputs, variables, jcfg, key = _jax_inputs()
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    logs, procs = {}, {}
    for job, n in RANKS.items():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        for r in range(n):
            logs[job, r] = open(workdir / f"{job}{r}.log", "w")
            procs[job, r] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r), port, str(workdir)],
                stdout=logs[job, r], stderr=subprocess.STDOUT, env=env)
    try:
        yield {"workdir": workdir, "procs": procs, "deadline": time.time() + 150,
               "inputs": inputs, "variables": variables, "jcfg": jcfg, "key": key}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
        for f in logs.values():
            f.close()


@pytest.fixture(scope="module")
def refs(started):
    """The port's unmeshed calls of both jobs, and the JAX package's
    spatial train step on its 8 CPU devices at job b's config."""
    import jax
    import jax.numpy as jnp
    import optax

    from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.parallel import create_mesh as jax_create_mesh
    from fidm_tpu.parallel import shard_batch as jax_shard_batch
    from fidm_tpu.training import TrainState as JaxTrainState
    from fidm_tpu.training import make_optimizer as jax_make_optimizer
    from fidm_tpu.training import make_train_step as jax_make_train_step
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from test_torch_port_multiprocess import _recording

    out = {"a": part_a(None), "b": part_b(started["inputs"], None)}
    model = JaxInpaintingUNet(started["jcfg"])
    tx = jax_make_optimizer(optax.constant_schedule(LR), grad_clip=CLIP)
    params = jax.tree_util.tree_map(jnp.asarray, started["variables"]["params"])
    state = JaxTrainState.create(apply_fn=model.apply, params=params, tx=_recording(tx))
    mesh = jax_create_mesh(data=4, model=2)
    step = jax_make_train_step(JaxSchedule.create("quadratic", 1000), mesh=mesh, donate=False,
                               spatial=True)
    with mesh:
        batch = jax_shard_batch(started["inputs"]["batch"], mesh, spatial=True)
        state, metrics = step.lower(state, batch, started["key"]).compile(
            compiler_options={"xla_backend_optimization_level": 0})(state, batch,
                                                                     started["key"])
    tree = {"params": jax.tree_util.tree_map(np.asarray, state.opt_state[1])}
    out["jax"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "grads": state_dict_from_jax(tree, UNetConfig(**UNEVEN, dtype=torch.float32))}
    return out


@pytest.fixture(scope="module")
def job(started, refs):
    """Every rank's results, by job (one spawn of each, 150 s at most from
    their start)."""
    workdir = started["workdir"]
    for p in started["procs"].values():
        try:
            p.wait(timeout=max(1.0, started["deadline"] - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for (j, r), p in started["procs"].items():
        log = (workdir / f"{j}{r}.log").read_text()
        assert p.returncode == 0 and f"SU_OK {j} {r}" in log, f"{j} rank {r}:\n{log[-4000:]}"
    return {j: [torch.load(workdir / f"{j}{r}.pt", weights_only=False) for r in range(n)]
            for j, n in RANKS.items()}


def _within(got, ref, rel, floor):
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item() + floor


def _metrics_close(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _fit_matches(got, ref):
    """The losses of each epoch, and the parameters after the fit, as
    `tests/test_torch_port_tp_train.py` holds them: AdamW moves an element
    by about lr per step, so within 0.01 lr of the reference's wherever no
    update's gradient was below 1% of its tensor's largest or 1e-5, and
    within 2 lr per step elsewhere (a bias before a norm layer, whose
    gradient is rounding noise, may move either way)."""
    assert len(got["history"]) == len(ref["history"]) == 1
    for g, w in zip(got["history"], ref["history"]):
        _metrics_close(g, w, ("train_loss", "val_loss"))
    steps = len(ref["grads"])
    assert steps == 2 and len(got["grads"]) == steps
    for k, p in got["params"].items():
        steady = ~torch.stack([g[k].abs() < torch.clamp(1e-2 * g[k].abs().max(), min=1e-5)
                               for g in ref["grads"]]).any(0)
        err = (p - ref["params"][k]).abs()
        assert err[steady].max().item() <= 1e-2 * FIT_LR if steady.any() else True, k
        assert err.max().item() <= 2 * FIT_LR * steps, k


def _grads_close(got, ref):
    assert set(got) == set(ref)
    for name, g in got.items():
        assert _within(g, ref[name], 2e-5, 1e-7), name


# ------------------------------------------------- job a: H kept whole

def test_an_image_that_does_not_split_is_recorded_whole(job):
    """shard_batch(spatial=True) over 3 ranks records the 16-row image as
    kept whole and the 24-row one as this rank's block of 8 rows."""
    for r, res in enumerate(job["a"]):
        whole, split = res["layout"][S], res["layout"][S_CONTROL]
        assert set(whole) == set(split) == {"image", "masked_image", "mask"}
        assert all(tuple(b) == (0, S, S) for b in whole.values())
        assert all(tuple(b) == (8 * r, 8 * r + 8, S_CONTROL) for b in split.values())


@pytest.mark.parametrize("case", CASES_A)
def test_steps_on_a_whole_image_are_the_unmeshed_steps(refs, job, case):
    """Each spatial step on the image kept whole equals the unmeshed step,
    on every rank."""
    ref = refs["a"][case]
    for res in job["a"]:
        got = res[case]
        if case == "eval":
            _metrics_close(got, ref, ("loss", "mse"))
            continue
        if case == "fit":
            _fit_matches(got, ref)
            continue
        _metrics_close(got["metrics"], ref["metrics"], ("loss", "grad_norm"))
        _grads_close(got["grads"], ref["grads"])
        if case == "train":
            for k, p in got["params"].items():
                np.testing.assert_allclose(p.numpy(), ref["params"][k].numpy(), rtol=2e-5,
                                           atol=2e-5, err_msg=k)


def test_a_whole_image_runs_batch_only_and_a_split_one_split(refs, job):
    """At H=16 every rank of the group computes the whole image: its own
    gradients, before any reduction, are the same on each rank (a split
    step's are partial sums). The control at H=24 runs split: the ranks'
    own gradients differ and the step equals the unmeshed one."""
    ranks = job["a"]
    own = [res["train"]["own"] for res in ranks]
    for k, g in own[0].items():
        for other in own[1:]:
            assert _within(other[k], g, 2e-5, 1e-7), k
    ctl = [res["control"] for res in ranks]
    differ = [k for k, g in ctl[0]["own"].items() if not torch.allclose(ctl[1]["own"][k], g)]
    assert len(differ) > len(ctl[0]["own"]) // 2
    for got in ctl:
        _metrics_close(got["metrics"], refs["a"]["control"]["metrics"], ("loss", "grad_norm"))
        _grads_close(got["grads"], refs["a"]["control"]["grads"])


def test_an_ambiguous_layout_raises():
    """Without a record, an image whose H does not divide by the axis size
    may be whole or a block of k·H: the step refuses it; an H that divides
    can only be a block."""
    from fidm_tpu_torch.parallel.mesh import H_BLOCKS, HBlock
    from fidm_tpu_torch.training.train_state import _spatial_layout

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"), shape=(1, 1, 3),
                                 get_coordinate=lambda: [0, 0, 1])
    image = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="no record of its layout"):
        _spatial_layout({"image": image}, mesh)
    assert _spatial_layout({"image": image[:, :12]}, mesh) == HBlock(12, 24, 36)
    assert _spatial_layout({"image": image, H_BLOCKS: {"image": HBlock(0, 16, 16)}},
                           mesh) is None


# ----------------------------------------- job b: an inner level whole

def test_split_levels_at_h20():
    """At H=20 over 2 ranks level 0 splits (blocks of 10) and the 10-row
    level would give odd blocks of 5: one split level, a ValueError only
    where H does not divide."""
    from fidm_tpu_torch.parallel.tp import check_spatial

    assert check_spatial(S_UNEVEN, 2, len(UNEVEN_MULT)) == 1
    assert check_spatial(S_UNEVEN, 4, len(UNEVEN_MULT)) == 0
    with pytest.raises(ValueError, match="must divide by the axis size"):
        check_spatial(S_UNEVEN, 3, len(UNEVEN_MULT))


def test_forward_with_a_whole_level_is_the_unmeshed_forward(refs, job):
    for res in job["b"]:
        np.testing.assert_allclose(res["forward"].numpy(), refs["b"]["forward"].numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_train_step_with_a_whole_level(refs, job, ref):
    """The spatial train step at H=20 against the port's unmeshed step and
    JAX's spatial step (data=4 x model=2, padded by GSPMD) on the same
    weights and draws."""
    want = refs["b"]["train"] if ref == "port" else refs["jax"]
    for res in job["b"]:
        got = res["train"]
        _metrics_close(got["metrics"], want["metrics"], ("loss", "mse", "grad_norm"))
        _grads_close(got["grads"], want["grads"])


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_shard_spatial_ddim_with_a_whole_level(refs, job, sampler):
    """A 10-step DDIM through InpaintingPipeline(shard_spatial=True) at
    H=20, plain and with the feature cache (the encoder's features, or the
    decoder feature entering level 1, where the cached call gathers and
    takes its rows again), against the unmeshed call: 1e-4, the known pixels
    exactly gt."""
    gt, mask = (torch.from_numpy(refs_input) for refs_input in (
        _batch(B_UNEVEN, S_UNEVEN, seed=4)["image"], _batch(B_UNEVEN, S_UNEVEN, seed=4)["mask"]))
    keep = mask[..., 0] < 0.5
    for res in job["b"]:
        out = res[sampler]
        np.testing.assert_allclose(out.numpy(), refs["b"][sampler].numpy(), rtol=0, atol=1e-4)
        assert torch.equal(out[keep], gt[keep])


if __name__ == "__main__":
    main()
