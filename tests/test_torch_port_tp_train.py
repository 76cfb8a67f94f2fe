"""The mesh's "model" axis through the rest of training (LoRA, progressive and
consistency distillation, `fit`) and classifier guidance under spatial
partitioning, against the JAX package's unsharded calls, in OS processes
over gloo on the CPU.

One job of four ranks (this file run as a script, `python
test_torch_port_tp_train.py RANK PORT WORKDIR`, spawned once for the module
under a 150 s timeout; it imports no JAX) runs every case on a data=2 x
model=2 mesh and writes its results, while the JAX references are computed
once here (four compiled steps and one guided pipeline), on the small
float32 config of `_torch_port_common.py` with every leaf drawn from numpy:

  - a LoRA train step and a LoRA eval step, tensor-parallel (the frozen base
    cut by `tp_shard_params`, each rank adding its slice of every delta) and
    spatial, against JAX's unsharded `make_train_step(param_transform=lambda
    l: merge_lora(frozen, l))` on JAX's adapter (`b` drawn away from zero,
    targets of every kind: split qkv and proj, column and row convs, a
    scale-shift emb_proj and whole convs); the eval step's reference is that
    step's loss, the eval loss of the same draws before the update. The
    adapter's reduced gradients are the same on every rank of a model
    group, exactly;
  - `make_distill_step` and `make_consistency_step` (distillation and
    training) under both layouts, against JAX's unsharded steps fed JAX's
    draws: under TP the progressive teacher is a `ShardedModule` of its own
    slices and the consistency teacher whole, and the target network runs on
    the EMA's slices;
  - `fit` under TP and under spatial partitioning, 2 epochs of 2 steps with
    validation and a checkpoint, then a restart restored from it and a
    third epoch, against the port's own unmeshed `fit` (which
    `tests/test_torch_port_training.py` holds to JAX), at a learning rate
    that moves the parameters far beyond their bound; the ranks of a model
    group read the same rows, and each checkpoint restores into one process
    here;
  - a guided 4-step DDIM `inpaint` under `shard_spatial`, whose `cond_fn`
    (an autograd gradient that mirrors H, so one block of rows alone would
    give another answer) sees every rank's rows whole, against JAX's
    unsharded guided pipeline on the same draws.

Bounds: loss 1e-5 relative and 1e-6 absolute, parameters 2e-5, gradients 2e-5
of their tensor's largest plus 1e-7 (for the distill steps also the noise
rule of `tests/test_torch_port_distill.py`), the pipeline 1e-4 with the known
pixels exact. Torch and BLAS run on one thread.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

B, S, LR, DISTILL_LR, FIT_LR, CLIP = 4, 16, 1e-5, 1e-3, 1e-3, 1.0
TEACHER_STEPS, GRID, LORA_RANK = 4, 10, 4
DDIM = dict(method="ddim", num_steps=4, eta=0.9, injection=True)
GUIDANCE = 0.5
KINDS = ("progressive", "distillation", "training")
LAYOUTS = ("tp", "spatial")
# the default attention targets and one layer of every other TP role
LORA_PATTERNS = (r".*_attn/(qkv|proj)$", r"mid_attn/(qkv|proj)$", r"in_0_conv$",
                 r"in_1_res/(in_conv|out_conv)$", r"mid_res0/emb_proj$",
                 r"in_3_res/skip_conv$")
HERE = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------- the four-rank job (no JAX)

def _model(inputs):
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig

    model = InpaintingUNet(UNetConfig(**inputs["cfg"], dtype=torch.float32))
    model.load_state_dict(inputs["state_dict"], strict=True)
    return model


def _lora(inputs, mesh, layout):
    """A LoRA eval step and then a train step on JAX's draws: the eval
    losses, the step's metrics, the reduced gradients and the adapter
    after it."""
    from test_torch_port_multiprocess import RecordedDraws, _recording_optimizer

    from fidm_tpu_torch.lora import lora_weights
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.parallel import shard_batch, tp_shard_params
    from fidm_tpu_torch.training import TrainState, make_eval_step, make_train_step

    cfg = UNetConfig(**inputs["cfg"], dtype=torch.float32)
    model = _model(inputs).requires_grad_(False)
    specs = tp_shard_params(model, mesh)[1] if layout == "tp" else None
    tx = _recording_optimizer(LR, CLIP, None)
    adapter = {k: v.clone().requires_grad_(True) for k, v in inputs["lora"].items()}
    state = TrainState.create(model, adapter, tx, model_specs=specs)
    spatial = layout == "spatial"
    kw = dict(mesh=mesh, spatial=spatial,
              param_transform=lambda l: lora_weights(model, cfg, l, specs, mesh))
    batch = shard_batch(inputs["batch"], mesh, spatial=spatial)
    draws = RecordedDraws(inputs["draws"])
    evals = make_eval_step(inputs["sched"], **kw)(state, batch, draws.fold(0))
    _, metrics = make_train_step(inputs["sched"], **kw)(state, batch, draws)
    return {"eval": {k: float(v) for k, v in evals.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tx.grads, "params": {k: v.detach().clone() for k, v in state.params.items()}}


def _distill(inputs, mesh, layout, kind):
    """One distillation step of `kind` on JAX's draws: its metrics and the
    reduced gradients, whole."""
    from test_torch_port_multiprocess import RecordedDraws, _recording_optimizer

    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.parallel import shard_batch, shard_params, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import ShardedModule, full_params
    from fidm_tpu_torch.parallel.mesh import ModelShard, local_slice, model_rank
    from fidm_tpu_torch.training import TrainState

    student, teacher = _model(inputs), _model(inputs).requires_grad_(False)
    if layout == "tp":
        params, specs = tp_shard_params(student, mesh)
        if kind == "progressive":  # a teacher of its own slices; else whole
            tparams, tspecs = tp_shard_params(teacher, mesh)
            teacher = ShardedModule(teacher, mesh, params=tparams, specs=tspecs)
    else:
        params, specs = shard_params(student, mesh)
    ema = {k: (local_slice(v, specs[k], 2, model_rank(mesh)).clone()
               if isinstance(specs[k], ModelShard) else v.clone())
           for k, v in inputs["ema"].items()}
    tx = _recording_optimizer(DISTILL_LR, CLIP, None)
    state = TrainState.create(student, params, tx, ema_params=ema, specs=specs)
    spatial = layout == "spatial"
    if kind == "progressive":
        step = make_distill_step(inputs["sched"], unet_apply, unet_apply,
                                 teacher_steps=TEACHER_STEPS, mesh=mesh, spatial=spatial)
    else:
        step = make_consistency_step(inputs["sched"],
                                     None if kind == "training" else unet_apply, unet_apply,
                                     grid_size=GRID, mesh=mesh, spatial=spatial)
        teacher = None if kind == "training" else teacher
    batch = shard_batch(inputs["batch"], mesh, spatial=spatial)
    draws = RecordedDraws(inputs["distill_draws"]["progressive" if kind == "progressive"
                                                  else "consistency"])
    _, metrics = step(state, teacher, batch, draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": full_params(tx.grads, specs, mesh)}


class _LoggedDataset:
    """`_mh_train_common.SynthInpaintDataset` that records the indices it
    is asked for."""

    def __init__(self, n):
        from _mh_train_common import SynthInpaintDataset

        self.data, self.read = SynthInpaintDataset(n, S), []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        self.read.append(int(i))
        return self.data[i]


def run_fit(inputs, mesh, ckpt_dir, layout="tp"):
    """`fit` for 2 epochs of 2 steps with validation and a checkpoint, then a
    fresh state restored from its latest and a third epoch; under a mesh TP
    (`layout` "tp") or spatial partitioning ("spatial"), the model whole
    without one. Returns the histories, the initial parameters, the
    parameters after each fit (whole), the train rows this rank read and,
    without a mesh, every update's gradients."""
    from fidm_tpu_torch.data.dataset import DataLoader
    from fidm_tpu_torch.parallel import shard_params, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import (CheckpointManager, FitConfig, TrainState, fit,
                                         make_eval_step, make_train_step)
    from fidm_tpu_torch.training.train_state import Optimizer

    spatial = mesh is not None and layout == "spatial"
    grads = []

    class Recording(Optimizer):  # make_optimizer's AdamW
        def update(self, g, *args):
            if mesh is None:
                grads.append({k: v.detach().clone() for k, v in g.items()})
            return super().update(g, *args)

    def fresh():
        model = _model(inputs)
        if mesh is None:
            params, specs = dict(model.named_parameters()), None
        else:
            params, specs = (shard_params if spatial else tp_shard_params)(model, mesh)
        return TrainState.create(model, params, Recording(lambda c: FIT_LR), specs=specs)

    train_ds = _LoggedDataset(8)

    def loaders():
        return (DataLoader(train_ds, batch_size=B, shuffle=True, seed=3, drop_last=True),
                DataLoader(_LoggedDataset(B), batch_size=B))

    def whole(state):
        return {k: v.detach().clone()
                for k, v in full_params(state.params, state.specs, mesh).items()}

    steps = (make_train_step(inputs["sched"], mesh=mesh, spatial=spatial),
             make_eval_step(inputs["sched"], mesh=mesh, spatial=spatial))
    quiet = dict(log_fn=lambda *a, **k: None, handle_preemption=False)
    mgr = CheckpointManager(ckpt_dir, keep_last_n=3, mesh=mesh)
    state = fresh()
    initial = whole(state)
    state, history = fit(state, *steps, *loaders(), 7, FitConfig(num_epochs=2, **quiet),
                         checkpoint_manager=mgr, mesh=mesh)
    first = whole(state)
    mgr.close()
    mgr = CheckpointManager(ckpt_dir, keep_last_n=3, mesh=mesh)
    restored, meta = mgr.restore("latest", fresh())
    state, resumed = fit(restored, *steps, *loaders(), 7, FitConfig(num_epochs=3, **quiet),
                         checkpoint_manager=mgr, mesh=mesh, start_epoch=meta["epoch"] + 1)
    mgr.close()
    return {"history": history, "resumed": resumed, "initial": initial, "first": first,
            "params": whole(state), "rows": train_ds.read, "restored_epoch": meta["epoch"],
            "grads": grads}


def _guided(inputs, mesh):
    from test_torch_port_multiprocess import ReplayNoise

    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.sampling import SamplerConfig

    config = PipelineConfig(unet=UNetConfig(**inputs["cfg"], dtype=torch.float32),
                            sampler=SamplerConfig(**DDIM))
    pipe = InpaintingPipeline(_model(inputs).requires_grad_(False), inputs["sched"], config,
                              mesh=mesh, shard_spatial=True)
    return pipe.inpaint(inputs["gt"], inputs["mask"], 0, noise=ReplayNoise(inputs["noise"]),
                        cond_fn=mirror_guidance)


def mirror_guidance(x, t):
    """grad of -GUIDANCE/2 · |x - x mirrored along H|^2, by autograd: every
    row's gradient needs its mirror row, held by another block."""
    energy = -0.5 * GUIDANCE * (x - torch.flip(x, dims=[1])).square().sum()
    return torch.autograd.grad(energy, x)[0]


def main():
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    from fidm_tpu_torch.parallel import create_mesh, multihost

    assert multihost.initialize(f"127.0.0.1:{port}", 4, rank, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = create_mesh(data=2, model=2)
    out = {"guided": _guided(inputs, mesh)}
    for layout in LAYOUTS:
        out[f"lora_{layout}"] = _lora(inputs, mesh, layout)
        for kind in KINDS:
            out[f"{kind}_{layout}"] = _distill(inputs, mesh, layout, kind)
    out["fit"] = run_fit(inputs, mesh, os.path.join(workdir, "fit_ckpt"))
    out["fit_spatial"] = run_fit(inputs, mesh, os.path.join(workdir, "fit_spatial_ckpt"),
                                 "spatial")
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.barrier("done")
    print("TPT_OK", rank, flush=True)


# ------------------------------------------- the tests and their JAX references

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.default_rng(1)
    img = np.clip(0.5 * rng.standard_normal((B, S, S, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((B, S, S, 1), np.float32)
    mask[0, 4:12, 2:10] = mask[1, :8] = mask[2, 8:, 8:] = mask[3, 2:14, 3:9] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _jax_adapter(params):
    """JAX's adapter on `params` for LORA_PATTERNS, `b` drawn from numpy."""
    import jax

    from fidm_tpu.lora import init_lora as jax_init_lora

    lora = jax_init_lora(jax.random.PRNGKey(9), params, rank=LORA_RANK, alpha=8.0,
                         patterns=LORA_PATTERNS)
    rng = np.random.default_rng(8)
    return {k: v if k == "__meta__" else
            {"a": np.asarray(v["a"]), "b": (0.05 * rng.standard_normal(v["b"].shape)
                                            ).astype(np.float32)}
            for k, v in lora.items()}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The job's inputs in WORKDIR/inputs.pt and its ranks, started, so that
    they run while the references are computed; killed at the end."""
    import jax
    import jax.numpy as jnp

    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.lora import flatten_lora
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from fidm_tpu_torch.sampling import SamplerConfig

    from _torch_port_common import JCFG, PCFG, SMALL, JaxKeyNoise, drawn_jax_variables
    workdir = tmp_path_factory.mktemp("tpt")
    dummy = (np.zeros((1, S, S, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, S, S, 3), np.float32), np.zeros((1, S, S, 1), np.float32))
    variables = drawn_jax_variables(JaxInpaintingUNet, JCFG, 3, *dummy)
    rng = np.random.default_rng(4)
    ema = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    lora = _jax_adapter(variables["params"])
    sd = state_dict_from_jax(variables, PCFG)
    batch, key = _batch(), jax.random.PRNGKey(7)
    shape = batch["image"].shape
    # the JAX train step's draws for the global batch (fold_in(key, 0), then
    # fold_in(., 0): the timestep and loss keys, the loss key's noise and
    # injection keys), and the distill steps' (fold_in(key, 0) split into the
    # segment and noise keys), recorded for the ranks, which import no JAX
    k = jax.random.fold_in(jax.random.fold_in(key, 0), 0)
    t_key, loss_key = jax.random.split(k)
    noise_key, inject_key = jax.random.split(loss_key)
    draws = {((0, 0), "t"): np.asarray(jax.random.randint(t_key, (B,), 0, 1000)),
             ((0, 0), "noise"): np.asarray(jax.random.normal(noise_key, shape, jnp.float32)),
             ((0, 0), "inject"): np.asarray(jax.random.normal(inject_key, shape, jnp.float32))}
    seg_key, dnoise_key = jax.random.split(jax.random.fold_in(key, 0))
    dnoise = np.asarray(jax.random.normal(dnoise_key, shape, jnp.float32))
    distill_draws = {
        name: {((0,), "t"): np.asarray(jax.random.randint(seg_key, (B,), 0, n)),
               ((0,), "noise"): dnoise}
        for name, n in (("progressive", TEACHER_STEPS // 2), ("consistency", GRID))}
    # the pipeline's noise: the JAX sampler's draws, recorded for the ranks
    gt, mask, ikey = batch["image"], batch["mask"], jax.random.PRNGKey(5)
    recorded = {}

    class Recorder(JaxKeyNoise):
        def init(self, shape):
            recorded["init"] = super().init(shape).numpy()
            return torch.from_numpy(recorded["init"])

        def step(self, index, shape):
            recorded[f"step{index}"] = super().step(index, shape).numpy()
            return torch.from_numpy(recorded[f"step{index}"])

        def inject(self, timestep, shape):
            recorded[f"inject{timestep}"] = super().inject(timestep, shape).numpy()
            return torch.from_numpy(recorded[f"inject{timestep}"])

    pipe = InpaintingPipeline.create(PipelineConfig(unet=PCFG, sampler=SamplerConfig(**DDIM)),
                                     device="cpu")
    pipe.model.load_state_dict(sd, strict=True)
    unguided = pipe.inpaint(gt, mask, 0, noise=Recorder(ikey)).numpy()
    inputs = {"cfg": SMALL, "state_dict": sd, "batch": batch, "draws": draws,
              "distill_draws": distill_draws,
              "ema": state_dict_from_jax({"params": ema}, PCFG),
              "lora": flatten_lora(lora),
              "sched": DiffusionSchedule.create("quadratic", 1000, device="cpu"),
              "gt": gt, "mask": mask, "noise": recorded}
    torch.save(inputs, workdir / "inputs.pt")

    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), port,
                               str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    try:
        yield {"workdir": workdir, "procs": procs, "deadline": time.time() + 150,
               "variables": variables, "ema": ema, "lora": lora, "key": key,
               "inputs": inputs, "ikey": ikey, "unguided": unguided}
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()


def _run(jitted, *args):
    """A jitted JAX step called on `args`, compiled without LLVM's
    optimisations (the same program; it compiles in about 20% less time)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _recording(tx):
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def refs(started):
    """The JAX package's unsharded LoRA step, distill steps and guided
    pipeline, and the port's unmeshed `fit`."""
    import jax
    import jax.numpy as jnp
    import optax

    from fidm_tpu import pipeline as jax_pipeline
    from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
    from fidm_tpu.distill import make_consistency_step as jax_make_consistency_step
    from fidm_tpu.distill import make_distill_step as jax_make_distill_step
    from fidm_tpu.lora import merge_lora as jax_merge_lora
    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
    from fidm_tpu.training import TrainState as JaxTrainState
    from fidm_tpu.training import make_optimizer as jax_make_optimizer
    from fidm_tpu.training import make_train_step as jax_make_train_step
    from fidm_tpu_torch.lora import flatten_lora
    from fidm_tpu_torch.models.weights import state_dict_from_jax

    from _torch_port_common import JCFG, PCFG
    inputs, key = started["inputs"], started["key"]
    model = JaxInpaintingUNet(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, started["variables"]["params"])
    jsched = JaxSchedule.create("quadratic", 1000)
    out = {}
    # LoRA: the adapter trained over the frozen base
    tx = _recording(jax_make_optimizer(optax.constant_schedule(LR), grad_clip=CLIP))
    state = JaxTrainState.create(apply_fn=model.apply,
                                 params=jax.tree_util.tree_map(jnp.asarray, started["lora"]),
                                 tx=tx)
    step = jax_make_train_step(jsched, param_transform=lambda l: jax_merge_lora(params, l),
                               donate=False)
    state, metrics = _run(step, state, inputs["batch"], key)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out["lora"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": flatten_lora(to_np(state.opt_state[1])),
                   "params": flatten_lora(to_np(state.params))}

    def apply(p, x, t, mi, m):
        return model.apply({"params": p}, x, t, mi, m)

    for kind in KINDS:
        tx = _recording(jax_make_optimizer(optax.constant_schedule(DISTILL_LR), grad_clip=CLIP))
        if kind == "progressive":
            state = JaxTrainState.create(apply_fn=None, params=params, tx=tx)
            step = jax_make_distill_step(jsched, apply, apply, teacher_steps=TEACHER_STEPS)
        else:
            state = JaxTrainState.create(apply_fn=None, params=params, tx=tx,
                                         ema_params=started["ema"])
            step = jax_make_consistency_step(jsched, None if kind == "training" else apply,
                                             apply, grid_size=GRID)
        state, metrics = _run(step, state, params, inputs["batch"], key)
        out[kind] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": state_dict_from_jax({"params": to_np(state.opt_state[1])}, PCFG)}

    def jax_guidance(x, t):
        return -2.0 * GUIDANCE * (x - x[:, ::-1])

    jpipe = jax_pipeline.InpaintingPipeline(
        model, jax.tree_util.tree_map(jnp.asarray, started["variables"]), jsched,
        jax_pipeline.PipelineConfig(unet=JCFG, sampler=JaxSamplerConfig(**DDIM)))
    out["guided"] = np.asarray(jpipe.inpaint(jnp.asarray(inputs["gt"]),
                                             jnp.asarray(inputs["mask"]), started["ikey"],
                                             cond_fn=jax_guidance))
    out["fit"] = run_fit(inputs, None, str(started["workdir"] / "fit_1p"))
    return out


@pytest.fixture(scope="module")
def job(started, refs):
    """Every rank's results (one spawn, 150 s at most from its start)."""
    workdir = started["workdir"]
    for p in started["procs"]:
        try:
            p.wait(timeout=max(1.0, started["deadline"] - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for r, p in enumerate(started["procs"]):
        log = (workdir / f"rank{r}.log").read_text()
        assert p.returncode == 0 and f"TPT_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _within(got, ref, rel, floor):
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item() + floor


def _metrics_close(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ LoRA

def test_lora_slices_join_to_the_whole_delta():
    """Under TP each rank's merged weight is its slice of the whole merged
    weight (the delta cut as the layer's spec cuts its weight), for every
    target kind at k = 2; a target the specs keep whole gets the whole
    delta on every rank, with a gradient on rank 0 only (zeros on the
    others, through the same graph)."""
    import types

    from fidm_tpu_torch.lora import init_lora, lora_weights
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.parallel import tp_param_specs
    from fidm_tpu_torch.parallel.mesh import ModelShard, join_slices, local_slice

    from _torch_port_common import PCFG
    torch.manual_seed(0)
    whole = InpaintingUNet(PCFG).requires_grad_(False)
    adapter = init_lora(1, whole, PCFG, rank=LORA_RANK, patterns=LORA_PATTERNS)
    adapter = {k: (v + 0.05 * torch.randn_like(v)).requires_grad_(True)
               for k, v in adapter.items()}
    def by_name(model, weights):
        names = {m: n for n, m in model.named_modules()}
        return {names[m] + ".weight": w for m, w in weights.items()}

    ref = {n: w.detach() for n, w in by_name(whole, lora_weights(whole, PCFG, adapter)).items()}
    specs = tp_param_specs(whole, types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"),
                                                        shape=(1, 1, 2)))
    kinds, pieces = set(), {}
    for r in range(2):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"), shape=(1, 1, 2),
                                     get_coordinate=lambda r=r: [0, 0, r])
        model = InpaintingUNet(PCFG).requires_grad_(False)
        model.load_state_dict(whole.state_dict())
        with torch.no_grad():
            for n, p in model.named_parameters():
                if isinstance(specs[n], ModelShard):
                    p.data = local_slice(p.data, specs[n], 2, r).clone()
        got = by_name(model, lora_weights(model, PCFG, adapter, specs, mesh))
        for name, w in got.items():
            pieces.setdefault(name, []).append(w)
            kinds.add(type(specs[name]).__name__)
            if not isinstance(specs[name], ModelShard):  # rank 0 alone has a gradient
                g = torch.autograd.grad(w.sum(), adapter["__meta__/scaling"])[0]
                assert (g.item() != 0) == (r == 0), name
    assert kinds == {"ModelShard", "Replicate"}
    for name, w in ref.items():
        joined = (join_slices([p.detach() for p in pieces[name]], specs[name])
                  if isinstance(specs[name], ModelShard) else pieces[name][1])
        assert torch.equal(joined, w), name
        if isinstance(specs[name], ModelShard):
            assert torch.equal(pieces[name][1].detach(),
                               local_slice(w, specs[name], 2, 1)), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lora_train_step_matches_jax(refs, job, layout):
    """The LoRA step's loss, its adapter's reduced gradients and the adapter
    after it against JAX's unsharded LoRA step on the same draws."""
    ref = refs["lora"]
    for res in job:
        got = res[f"lora_{layout}"]
        _metrics_close(got["metrics"], ref["metrics"], ("loss", "mse", "grad_norm"))
        assert set(got["grads"]) == set(ref["grads"]) == set(got["params"])
        for name, g in got["grads"].items():
            assert _within(g, ref["grads"][name], 2e-5, 1e-7), name
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       ref["params"][name].numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lora_eval_step_matches_jax(refs, job, layout):
    """The LoRA eval step on the step's draws: JAX's step loss before the
    update (the JAX eval step of the same key computes it)."""
    for res in job:
        _metrics_close(res[f"lora_{layout}"]["eval"], refs["lora"]["metrics"], ("loss", "mse"))


def test_lora_factor_gradients_equal_across_a_model_group(job):
    """The adapter's gradients after the reduction (each rank's partial sums
    over its slices, summed over the model axis) are the same tensors on
    every rank of each model group, bit for bit, under both layouts."""
    for layout in LAYOUTS:
        for ranks in ([0, 1], [2, 3]):
            res = [job[r][f"lora_{layout}"]["grads"] for r in ranks]
            for k, g in res[0].items():
                torch.testing.assert_close(res[1][k], g, rtol=0, atol=0, msg=f"{layout} {k}")
            assert any(g.abs().max() > 0 for g in res[0].values())


# ---------------------------------------------------------- distillation

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_distill_step_matches_jax(refs, job, kind, layout):
    """Progressive distillation, consistency distillation and consistency
    training under TP and spatial partitioning against JAX's unsharded step
    on JAX's draws: loss and grad_norm 1e-5 relative; each gradient within
    2e-5 of its tensor's largest plus 1e-7, or noise on both sides below
    1e-6 of the step's largest (the one-process distill test's rule)."""
    ref = refs[kind]
    noise = 1e-6 * max(r.abs().max().item() for r in ref["grads"].values())
    for res in job:
        got = res[f"{kind}_{layout}"]
        _metrics_close(got["metrics"], ref["metrics"], ("loss", "grad_norm"))
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in got["grads"].items():
            r = ref["grads"][name]
            assert (_within(g, r, 2e-5, 1e-7)
                    or max(g.abs().max().item(), r.abs().max().item()) <= noise), name


# ------------------------------------------------------------------- fit

def _fit_matches(ref, results):
    """2 epochs with validation, a restart from the checkpoint and a third
    epoch: the losses and the parameters after each fit against the port's
    unmeshed fit, the same on every rank. At FIT_LR AdamW moves an element
    by about lr per step, far beyond the parameters' bound, so a wrong
    update, or a resume without the optimizer's moments, shows in them: the
    parameters within 0.01 lr of the reference's wherever no update's
    gradient was below 1% of its tensor's largest or 1e-5 (elsewhere, as a
    bias before a norm layer, whose gradient is rounding noise, Adam's
    update of about lr can take either sign: within 2 lr per step)."""
    steps = len(ref["grads"])
    assert steps == 6
    steady = {k: ~torch.stack([g[k].abs() < torch.clamp(1e-2 * g[k].abs().max(), min=1e-5)
                               for g in ref["grads"]]).any(0) for k in ref["params"]}
    assert sum(v.sum().item() for v in steady.values()) > \
        0.5 * sum(v.numel() for v in steady.values())
    moved = torch.cat([(ref["params"][k] - p).abs().flatten()
                       for k, p in ref["initial"].items()])
    assert (moved > 100 * 1e-2 * FIT_LR).float().mean().item() > 0.5
    for got in results:
        assert got["restored_epoch"] == 1
        for k in ("history", "resumed"):
            assert [e["epoch"] for e in got[k]] == [e["epoch"] for e in ref[k]]
            for a, b in zip(got[k], ref[k]):
                _metrics_close(a, b, ("train_loss", "val_loss"))
        assert sorted(got["initial"]) == sorted(got["first"]) == sorted(got["params"]) \
            == sorted(ref["params"])
        for name, p in got["initial"].items():
            assert torch.equal(p, ref["initial"][name]), name
        for which in ("first", "params"):
            for name, p in got[which].items():
                d = (p - ref[which][name]).abs()
                if steady[name].any():
                    assert d[steady[name]].max().item() <= 1e-2 * FIT_LR, f"{which} {name}"
                assert d.max().item() <= 2 * FIT_LR * steps, f"{which} {name}"
    assert len({res["history"][1]["val_loss"] for res in results}) == 1


def test_fit_under_tp_matches_one_process(refs, job):
    """`fit` of a TP state (see `_fit_matches`)."""
    _fit_matches(refs["fit"], [res["fit"] for res in job])


def test_fit_under_spatial_matches_one_process(refs, job):
    """`fit` of spatial steps, each rank fed its block of H rows of its
    model group's rows (see `_fit_matches`)."""
    _fit_matches(refs["fit"], [res["fit_spatial"] for res in job])


def test_fit_model_group_reads_the_same_rows(refs, job):
    """Over the model axis a process-local loader gives the ranks of one
    model group the same rows: ranks (0, 1) and (2, 3) read the same
    indices, the two groups the halves of every global batch."""
    for case in ("fit", "fit_spatial"):
        rows = [res[case]["rows"] for res in job]
        assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2], case
        one = refs["fit"]["rows"]
        half = B // 2
        assert len(rows[0]) == len(one) // 2 == 12
        for i in range(len(one) // B):
            assert one[i * B: i * B + half] == rows[0][i * half:(i + 1) * half]
            assert one[i * B + half:(i + 1) * B] == rows[2][i * half:(i + 1) * half]


def test_fit_checkpoint_restores_into_one_process(started, job):
    """The TP and the spatial run's latest checkpoints, restored into a
    one-process state, are their parameters joined whole."""
    from fidm_tpu_torch.training import CheckpointManager, TrainState, make_optimizer

    for case in ("fit", "fit_spatial"):
        model = _model(started["inputs"])
        state = TrainState.create(model, dict(model.named_parameters()),
                                  make_optimizer(lambda c: FIT_LR))
        _, meta = CheckpointManager(str(started["workdir"] / f"{case}_ckpt")).restore(
            "latest", state)
        full = job[0][case]["params"]
        assert meta["epoch"] == 2 and state.step == 6 and sorted(state.params) == sorted(full)
        for k, p in state.params.items():
            assert torch.equal(p, full[k]), f"{case} {k}"


# -------------------------------------------------------------- guidance

def test_guided_spatial_pipeline_matches_jax(started, refs, job):
    """A guided DDIM call under shard_spatial against JAX's unsharded guided
    pipeline on the same draws (1e-4; the known pixels are gt exactly); the
    guidance moves the hole well beyond that bound (against the port's
    unguided call on the same draws)."""
    batch = _batch()
    keep = batch["mask"][..., 0] < 0.5
    assert np.abs(refs["guided"] - started["unguided"]).max() > 1e-2
    for res in job:
        out = res["guided"].numpy()
        np.testing.assert_allclose(out, refs["guided"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out[keep], batch["image"][keep])


if __name__ == "__main__":
    main()
