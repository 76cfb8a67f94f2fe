"""Two OS processes over gloo on the CPU (the port's process-per-rank
parallelism) against the JAX package on a 2-device mesh at the same global
batch, and against the port in one process.

One job of two ranks (this file run as a script, `python
test_torch_port_multiprocess.py RANK PORT WORKDIR`, spawned once for the
module under a 180 s timeout; the job imports no JAX) runs every case and
writes its results; the JAX references are computed once here, on the small
float32 config of `_torch_port_common.py` with every leaf perturbed:

  (a) three data=2 train steps on JAX's draws for the global batch: loss,
      mse and grad_norm within 1e-5 relative at the first step and 2e-5 at
      the next two; the first update's gradients within 2e-5 of their
      tensor's largest plus 1e-7 (as the one-process train-step test);
      AdamW's moments after the third, mu at the gradients' tolerance and
      nu (a square) at 4e-5 plus 1e-11; the parameters within 0.01 lr of
      JAX's wherever no step's gradient was below 1% of its tensor's
      largest or 1e-5 (there Adam's update of about lr * sign can flip: a
      bias before a norm layer has a gradient of rounding noise), and
      within 2 lr everywhere;
  (b) the same at fsdp=2 with min_size 4096, where most tensors are
      sharded (against JAX's data=2 step: JAX's fsdp=2 step computes the
      same function), and again with the biases frozen by a param_mask (the
      clip's norm is the trainable gradients'), held against JAX's masked
      optimizer on an fsdp=2 mesh in both ranks and in one unmeshed process;
  (c) train -> checkpoint -> restart -> resume through `fit` with
      process_local loaders, at data=2 and at fsdp=2 with min_size 4096:
      losses and the parameter sum within 2e-4 relative of the one-process
      port run (the JAX multi-process test's bound; the gradients of two
      half batches are summed in another order);
  (d) a meshed ddim `inpaint` (data=2, and fsdp=2 with the model's shards)
      within 2e-4 of the JAX meshed pipeline on the same draws (the
      one-process pipeline test's bound) and within 1e-5 of the one-process
      port call;
  (e) checkpoints with ranks that see the directory differently and hold
      different losses: the primary's decisions on both ranks, no deadlock;
      an fsdp checkpoint restored shard for shard and whole;
  (f) a stop asked on one rank in `train_epoch` stops both after the same
      step.

The JAX references are computed while the job runs.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

B, LR, MIN_SIZE, STEPS, CLIP = 4, 1e-3, 4096, 3, 1.0
DDIM = dict(method="ddim", num_steps=5, eta=0.9, injection=True)
HERE = os.path.dirname(os.path.abspath(__file__))


# --------------------------------------------- the two-rank job (no JAX here)

S = 16


def run_training(ckpt_dir: str, mesh, fsdp_min_size=None) -> dict:
    """2 epochs -> checkpoint -> restart (a fresh manager and state, restored)
    -> 1 more epoch, after `tests/_mh_train_common.py`. Returns
    {"history", "resumed", "param_sum"}; the same in any number of ranks up
    to float rounding, since every global batch has one composition."""
    from _mh_train_common import SynthInpaintDataset

    from fidm_tpu_torch.data.dataset import DataLoader
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig
    from fidm_tpu_torch.parallel import shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import (CheckpointManager, FitConfig, TrainState, fit,
                                         make_eval_step, make_lr_schedule, make_optimizer,
                                         make_train_step)

    cfg = UNetConfig(image_size=S, in_channels=9, model_channels=32, out_channels=6,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=2, num_head_channels=16, dtype=torch.float32)
    sched = DiffusionSchedule.create("linear", 50, device="cpu")

    def fresh_state():
        torch.manual_seed(0)
        model = InpaintingUNet(cfg)
        if mesh is None:
            params, specs = dict(model.named_parameters()), None
        elif fsdp_min_size is None:
            params, specs = shard_params(model, mesh)
        else:
            params, specs = shard_params(model, mesh, use_fsdp=True, min_size=fsdp_min_size)
        return TrainState.create(model, params,
                                 make_optimizer(make_lr_schedule("none", 1e-3, 100, 0)),
                                 specs=specs)

    def loaders():
        ds = SynthInpaintDataset(16, S)
        return (DataLoader(ds, batch_size=4, shuffle=True, seed=3, drop_last=True),
                DataLoader(SynthInpaintDataset(4, S), batch_size=4))

    train_step, eval_step = make_train_step(sched, mesh=mesh), make_eval_step(sched, mesh=mesh)
    quiet = dict(log_fn=lambda *a, **k: None, handle_preemption=False)
    mgr = CheckpointManager(ckpt_dir, keep_last_n=3, mesh=mesh)
    state, history = fit(fresh_state(), train_step, eval_step, *loaders(), 7,
                         FitConfig(num_epochs=2, **quiet), checkpoint_manager=mgr, mesh=mesh)
    mgr.close()
    mgr2 = CheckpointManager(ckpt_dir, keep_last_n=3, mesh=mesh)
    restored, meta = mgr2.restore("latest", fresh_state())
    assert meta["epoch"] == 1, meta
    state2, resumed = fit(restored, train_step, eval_step, *loaders(), 7,
                          FitConfig(num_epochs=3, **quiet), checkpoint_manager=mgr2,
                          mesh=mesh, start_epoch=meta["epoch"] + 1)
    mgr2.close()
    params = full_params(state2.params, state2.specs, mesh)
    return {"history": history, "resumed": resumed,
            "param_sum": float(sum(p.detach().abs().sum() for p in params.values())),
            "n_sharded": sum(type(s).__name__ == "Shard" for s in (state2.specs or {}).values())}


class RecordedDraws:
    """A draws object that returns the arrays recorded for its fold path."""

    def __init__(self, arrays, path=()):
        self.arrays, self.path = arrays, path

    def fold(self, index):
        return RecordedDraws(self.arrays, self.path + (int(index),))

    def _get(self, what, shape):
        a = torch.from_numpy(self.arrays[(self.path, what)])
        assert tuple(a.shape) == tuple(shape), (what, a.shape, shape)
        return a

    def timesteps(self, batch, num_timesteps):
        return self._get("t", (batch,)).long()

    def noise(self, shape):
        return self._get("noise", shape)

    def inject(self, shape):
        return self._get("inject", shape)


class ReplayNoise:
    """A sampler noise source that returns the recorded draws of each call."""

    def __init__(self, arrays):
        self.arrays = arrays

    def _get(self, key, shape):
        a = torch.from_numpy(self.arrays[key])
        assert tuple(a.shape) == tuple(shape), (key, a.shape, shape)
        return a

    def init(self, shape):
        return self._get("init", shape)

    def step(self, index, shape):
        return self._get(f"step{index}", shape)

    def inject(self, timestep, shape):
        return self._get(f"inject{timestep}", shape)


def _recording_optimizer(lr, clip, mask):
    from fidm_tpu_torch.training.train_state import Optimizer

    class Recording(Optimizer):
        def update(self, grads, state, params, *args):
            if not hasattr(self, "grads"):  # the first update's
                self.grads = {k: g.detach().clone() for k, g in grads.items()}
            super().update(grads, state, params, *args)

    return Recording(lambda count: lr, grad_clip=clip, param_mask=mask)


def _step(inputs, mesh, use_fsdp, masked=False):
    """STEPS train steps from the inputs' weights on JAX's recorded draws:
    the metrics of each, the first update's gradients, and the parameters
    and AdamW moments after the last, whole."""
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig
    from fidm_tpu_torch.parallel import shard_batch, shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import TrainState, make_train_step

    model = InpaintingUNet(UNetConfig(**inputs["cfg"], dtype=torch.float32))
    model.load_state_dict(inputs["state_dict"], strict=True)
    if mesh is None:
        params, specs, batch = dict(model.named_parameters()), None, inputs["batch"]
    else:
        params, specs = shard_params(model, mesh, use_fsdp=use_fsdp,
                                     min_size=inputs["min_size"])
        batch = shard_batch(inputs["batch"], mesh)
    tx = _recording_optimizer(inputs["lr"], inputs["clip"],
                              inputs["param_mask"] if masked else None)
    state = TrainState.create(model, params, tx, specs=specs)
    step = make_train_step(inputs["sched"], mesh=mesh)
    metrics = [{k: float(v) for k, v in step(state, batch, RecordedDraws(inputs["draws"]))[1]
                .items()} for _ in range(STEPS)]
    whole = lambda t: {k: v.detach().clone()  # noqa: E731
                       for k, v in full_params(t, specs, mesh).items()}
    return {"metrics": metrics, "grads": full_params(tx.grads, specs, mesh),
            "params": whole(state.params), "mu": whole(state.opt_state["mu"]),
            "nu": whole(state.opt_state["nu"]),
            "n_sharded": sum(type(s).__name__ == "Shard" for s in (specs or {}).values()),
            "local_shapes": {k: tuple(v.shape) for k, v in state.params.items()}}


def _stop_on_one_rank(rank, mesh):
    """`train_epoch` of 8 steps in which rank 1 asks to stop after its
    second: the number of steps each rank took."""
    from fidm_tpu_torch.training.loop import train_epoch

    class State:
        params = {"w": torch.zeros(1)}

    taken = []

    def step(state, batch, draws):
        taken.append(1)
        return state, {"loss": torch.tensor(float(len(taken)))}

    zeros = np.zeros((1, 4, 4, 3), np.float32)
    loader = [{"image": zeros, "masked_image": zeros, "mask": zeros[..., :1]}] * 8
    train_epoch(State(), step, loader, 0, mesh=mesh, log_every=0,
                should_stop=lambda: rank == 1 and len(taken) >= 2)
    return len(taken)


def _inpaint(inputs, mesh, **kw):
    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.pipeline import create_model_and_schedule
    from fidm_tpu_torch.sampling import SamplerConfig

    config = PipelineConfig(unet=UNetConfig(**inputs["cfg"], dtype=torch.float32),
                            sampler=SamplerConfig(**inputs["ddim"]))
    model, sched = create_model_and_schedule(config, device="cpu")
    model.load_state_dict(inputs["state_dict"], strict=True)
    pipe = InpaintingPipeline(model, sched, config, mesh=mesh, **kw)
    out = pipe.inpaint(inputs["gt"], inputs["mask"], 0, noise=ReplayNoise(inputs["noise"]))
    return out, pipe


def _disagreeing_checkpoints(workdir, rank):
    """The overwrite and is_best decisions when the ranks see the directory
    differently and hold different losses: every rank takes the primary's
    branch, and nobody waits forever."""
    from fidm_tpu_torch.training import CheckpointManager

    tree = {"params": {"w": torch.arange(4.0) + rank}, "step": 0,
            "opt_state": {"count": 0, "mu": {}, "nu": {}}, "ema_params": None}
    mgr = CheckpointManager(os.path.join(workdir, "disagree"), keep_last_n=2)
    out = {"first": mgr.save(0, tree, {"epoch": 0}, val_loss=1.0)}
    if rank == 1:  # rank 1 believes step 0 is not there, rank 0 that it is
        mgr.all_steps = lambda: []
    out["overwrite_not_best"] = mgr.save(0, tree, {"epoch": 0, "redo": True},
                                         val_loss=[2.0, 0.1][rank])
    if rank == 1:
        del mgr.all_steps
    out["best"] = mgr.save(1, tree, {"epoch": 1}, val_loss=[0.5, 5.0][rank])
    out["best_val_loss"] = mgr.best_val_loss
    mgr.close()
    return out


def _fsdp_checkpoint(inputs, mesh, workdir):
    """Save a state of fsdp shards, restore it into a fresh sharded state
    and into a whole tree."""
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig
    from fidm_tpu_torch.parallel import shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import CheckpointManager, TrainState, init_ema, make_optimizer

    def state(seed):
        torch.manual_seed(seed)
        model = InpaintingUNet(UNetConfig(**inputs["cfg"], dtype=torch.float32))
        params, specs = shard_params(model, mesh, use_fsdp=True, min_size=inputs["min_size"])
        return TrainState.create(model, params, make_optimizer(lambda c: 1e-3),
                                 ema_params=init_ema(params), specs=specs)

    a = state(1)
    with torch.no_grad():
        for v in a.opt_state["mu"].values():
            v.add_(0.5)
    mgr = CheckpointManager(os.path.join(workdir, "fsdp_ckpt"), mesh=mesh)
    mgr.save(3, a, {"epoch": 3}, val_loss=0.25)
    b, meta = mgr.restore("latest", state(2))
    same = all(torch.equal(a.params[k], b.params[k]) and
               torch.equal(a.opt_state["mu"][k], b.opt_state["mu"][k]) for k in a.params)
    whole = mgr.restore_params("best")
    full = full_params(a.params, a.specs, mesh)
    mgr.close()
    return {"same": same, "meta_epoch": meta["epoch"],
            "whole": all(torch.equal(whole[k], full[k]) for k in full),
            "files": sorted(os.listdir(os.path.join(workdir, "fsdp_ckpt", "steps", "3")))}


def main():
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    from fidm_tpu_torch.parallel import create_mesh, multihost

    assert multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    assert multihost.process_count() == 2 and multihost.process_index() == rank
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    data2, fsdp2 = create_mesh(data=2), create_mesh(data=1, fsdp=2)
    out = {"data2": _step(inputs, data2, False), "fsdp2": _step(inputs, fsdp2, True),
           "fsdp2_masked": _step(inputs, fsdp2, True, masked=True),
           "stop": _stop_on_one_rank(rank, data2)}
    out["inpaint"] = _inpaint(inputs, data2)[0]
    out["inpaint_fsdp"], pipe = _inpaint(inputs, fsdp2, fsdp_params=True,
                                         fsdp_min_size=inputs["min_size"])
    out["inpaint_fsdp_placeholders"] = sum(p.numel() == 0 for p in pipe.model.parameters())
    out["checkpoints"] = _disagreeing_checkpoints(workdir, rank)
    out["fsdp_checkpoint"] = _fsdp_checkpoint(inputs, fsdp2, workdir)
    out["training"] = run_training(os.path.join(workdir, "train_ckpt"), data2)
    out["training_fsdp"] = run_training(os.path.join(workdir, "train_ckpt_fsdp"), fsdp2,
                                        fsdp_min_size=inputs["min_size"])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.barrier("done")
    print("MP_OK", rank, flush=True)



# ------------------------------------------- the tests and their JAX references

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


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


def _masks(variables):
    """The biases frozen: the port's mask by name and JAX's mask tree, the
    same tensors (each JAX leaf traced to its port tensors by its index)."""
    import jax

    from fidm_tpu_torch.models.weights import state_dict_from_jax

    from _torch_port_common import PCFG
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    ids = treedef.unflatten([np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    trainable = {}
    for k, v in state_dict_from_jax({"params": ids}, PCFG).items():
        assert v.min() == v.max(), k
        trainable.setdefault(int(v.reshape(-1)[0]), set()).add(not k.endswith(".bias"))
    assert len(trainable) == len(leaves) and all(len(b) == 1 for b in trainable.values())
    port = {k: not k.endswith(".bias") for k in state_dict_from_jax(variables, PCFG)}
    return port, treedef.unflatten([trainable[i] == {True} for i in range(len(leaves))])


def _adam_moments(opt_state, params):
    """AdamW's (mu, nu) trees from a (masked) optax state, a frozen leaf's
    moments as zeros."""
    import jax
    import optax

    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    fill = lambda m, p: (np.zeros(np.shape(p), np.float32)  # noqa: E731
                         if isinstance(m, optax.MaskedNode) else np.asarray(m))
    leaf = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    return tuple(jax.tree_util.tree_map(fill, m, params, is_leaf=leaf)
                 for m in (adam[0].mu, adam[0].nu))


def _batch():
    rng = np.random.default_rng(1)
    s = 16
    img = (0.5 * rng.standard_normal((B, s, s, 3))).astype(np.float32)
    mask = np.zeros((B, s, s, 1), np.float32)
    mask[0, 4:12, 2:10] = mask[1, :8] = mask[2, 8:, 8:] = mask[3, 2:14, 3:9] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _jax_step(variables, batch, key, mesh, fsdp, mask=None):
    """STEPS JAX train steps on `mesh`: each step's metrics, every update's
    gradients, the parameters and AdamW moments after the last, as port
    state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.parallel import shard_params as jax_shard_params
    from fidm_tpu.training import TrainState as JaxTrainState
    from fidm_tpu.training import make_optimizer as jax_make_optimizer
    from fidm_tpu.training import make_train_step as jax_make_train_step
    from fidm_tpu_torch.models.weights import state_dict_from_jax

    from _torch_port_common import JCFG, PCFG
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    if fsdp:
        params, _ = jax_shard_params(params, mesh, use_fsdp=True, min_size=MIN_SIZE)
    tx = jax_make_optimizer(optax.constant_schedule(LR), grad_clip=CLIP, param_mask=mask)
    state = JaxTrainState.create(apply_fn=JaxInpaintingUNet(JCFG).apply, params=params,
                                 tx=_recording(tx))
    step = jax_make_train_step(JaxSchedule.create("quadratic", 1000), mesh=mesh, donate=False)
    tree = lambda t: {"params": jax.tree_util.tree_map(np.asarray, t)}  # noqa: E731
    metrics, grads = [], []
    for _ in range(STEPS):
        state, m = step(state, batch, key)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(state_dict_from_jax(tree(state.opt_state[1]), PCFG))
    mu, nu = _adam_moments(state.opt_state[0], state.params)
    return {"metrics": metrics, "grads": grads,
            "params": state_dict_from_jax(tree(state.params), PCFG),
            "mu": state_dict_from_jax(tree(mu), PCFG), "nu": state_dict_from_jax(tree(nu), PCFG)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The job's inputs in WORKDIR/inputs.pt and its two ranks, started, so
    that they run while the references are computed; killed at the end."""
    import jax
    import jax.numpy as jnp

    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from fidm_tpu_torch.sampling import SamplerConfig

    from _torch_port_common import JCFG, PCFG, SMALL, JaxKeyNoise, perturbed_jax_variables
    workdir = tmp_path_factory.mktemp("mp")
    variables = perturbed_jax_variables(JCFG, seed=3)
    sd = state_dict_from_jax(variables, PCFG)
    batch, key = _batch(), jax.random.PRNGKey(7)
    # the JAX step's draws for the global batch (fold_in(key, step s), then
    # fold_in(., 0): the timestep and loss keys, the loss key's noise and
    # injection keys), recorded for the ranks, which import no JAX
    shape = batch["image"].shape
    draws = {}
    for s in range(STEPS):
        k = jax.random.fold_in(jax.random.fold_in(key, s), 0)
        t_key, loss_key = jax.random.split(k)
        noise_key, inject_key = jax.random.split(loss_key)
        draws[((s, 0), "t")] = np.asarray(jax.random.randint(t_key, (B,), 0, 1000))
        draws[((s, 0), "noise")] = np.asarray(jax.random.normal(noise_key, shape, jnp.float32))
        draws[((s, 0), "inject")] = np.asarray(jax.random.normal(inject_key, shape,
                                                                 jnp.float32))
    port_mask, jax_mask = _masks(variables)

    # (d): the port's one-process call on the JAX sampler's draws, which are
    # recorded for the ranks
    gt, mask, ikey = np.clip(batch["image"], -1, 1), batch["mask"], jax.random.PRNGKey(5)
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
    port_inpaint = pipe.inpaint(gt, mask, 0, noise=Recorder(ikey)).numpy()
    inputs = {"cfg": SMALL, "state_dict": sd, "batch": batch, "draws": draws, "lr": LR,
              "clip": CLIP, "param_mask": port_mask, "min_size": MIN_SIZE,
              "sched": DiffusionSchedule.create("quadratic", 1000, device="cpu"),
              "ddim": DDIM, "gt": gt, "mask": mask, "noise": recorded}
    torch.save(inputs, workdir / "inputs.pt")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), port, str(workdir)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    try:
        yield {"workdir": workdir, "procs": procs, "deadline": time.time() + 180,
               "variables": variables, "key": key, "inputs": inputs, "jax_mask": jax_mask,
               "port_inpaint": port_inpaint, "ikey": ikey}
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()


@pytest.fixture(scope="module")
def refs(started):
    """The JAX references and the port's one-process references, computed
    while the job runs."""
    import jax
    import jax.numpy as jnp

    from fidm_tpu import pipeline as jax_pipeline
    from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.parallel import create_mesh as jax_create_mesh
    from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig

    from _torch_port_common import JCFG
    variables, key, inputs = started["variables"], started["key"], started["inputs"]
    batch = inputs["batch"]
    devices = jax.devices()[:2]
    fsdp_mesh = jax_create_mesh(data=1, fsdp=2, devices=devices)
    out = {"data2": _jax_step(variables, batch, key, jax_create_mesh(data=2, devices=devices),
                              False),
           "fsdp2_masked": _jax_step(variables, batch, key, fsdp_mesh, True,
                                     started["jax_mask"])}
    # JAX's unmasked fsdp=2 step is its data=2 step's function of the global
    # batch (another placement of the same arrays), so one compile serves
    # both; the masked case holds the port's fsdp=2 step to JAX's fsdp=2 mesh
    out["fsdp2"] = out["data2"]
    # (d): the JAX meshed pipeline
    jpipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG), jax.tree_util.tree_map(jnp.asarray, variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG, sampler=JaxSamplerConfig(**DDIM)),
        mesh=jax_create_mesh(data=2, devices=devices))
    out["jax_inpaint"] = np.asarray(jpipe.inpaint(jnp.asarray(inputs["gt"]),
                                                  jnp.asarray(inputs["mask"]), started["ikey"]))
    out["port_inpaint"] = started["port_inpaint"]
    # the port in one process, unmeshed, with the mask
    out["one_process_masked"] = _step(inputs, None, False, masked=True)
    out["training"] = run_training(str(started["workdir"] / "train_1p"), None)
    out["workdir"] = started["workdir"]
    out["initial"] = inputs["state_dict"]
    return out


@pytest.fixture(scope="module")
def job(started, refs):
    """Both ranks' results (one spawn of two processes, 180 s at most from
    their start)."""
    workdir = started["workdir"]
    try:
        for p in started["procs"]:
            p.wait(timeout=max(1.0, started["deadline"] - time.time()))
    except subprocess.TimeoutExpired:
        pass
    for r, p in enumerate(started["procs"]):
        log = (workdir / f"rank{r}.log").read_text()
        assert p.returncode == 0 and f"MP_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _close(a, b, rel):
    assert abs(a - b) <= rel * abs(b), (a, b)


def _within(got, ref, rel, floor):
    """Every element within `rel` of the reference tensor's largest plus
    `floor`."""
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item() + floor


@pytest.mark.parametrize("case", ["data2", "fsdp2", "fsdp2_masked"])
def test_meshed_step_matches_jax(refs, job, case):
    ref = refs[case]
    results = [res[case] for res in job]
    if case == "fsdp2_masked":  # and the port in one process, unmeshed
        results.append(refs["one_process_masked"])
    g0 = ref["grads"][0]
    trainable = [k for k in g0 if not (case == "fsdp2_masked" and k.endswith(".bias"))]
    # where a gradient is this small at some step (a bias before a norm layer
    # has one of rounding noise), Adam's update can take either sign
    steady = {k: ~torch.stack([g[k].abs() < torch.clamp(1e-2 * g[k].abs().max(), min=1e-5)
                               for g in ref["grads"]]).any(0) for k in trainable}
    assert sum(v.sum().item() for v in steady.values()) > \
        0.6 * sum(v.numel() for v in steady.values())
    for got in results:
        for i, (m, rm) in enumerate(zip(got["metrics"], ref["metrics"])):
            for k in ("loss", "mse", "grad_norm"):
                _close(m[k], rm[k], 1e-5 if i == 0 else 2e-5)
        assert set(got["grads"]) == set(g0)
        for name, g in got["grads"].items():
            assert _within(g, g0[name], 2e-5, 1e-7), name
        assert sorted(got["mu"]) == sorted(got["nu"]) == sorted(trainable)
        for name in trainable:
            assert _within(got["mu"][name], ref["mu"][name], 2e-5, 1e-7), name
            assert _within(got["nu"][name], ref["nu"][name], 4e-5, 1e-11), name
            d = (got["params"][name] - ref["params"][name]).abs()
            if steady[name].any():
                assert d[steady[name]].max().item() <= 1e-2 * LR, name
            assert d.max().item() <= 2 * LR, name
        for name in set(g0) - set(trainable):  # frozen
            assert torch.equal(got["params"][name], refs["initial"][name]), name
    # both ranks hold the same global metrics and parameters
    assert job[0][case]["metrics"] == job[1][case]["metrics"]
    assert all(torch.equal(job[0][case]["params"][k], job[1][case]["params"][k]) for k in g0)
    if case.startswith("fsdp2"):  # really sharded: halves on each rank
        assert job[0][case]["n_sharded"] >= 10
        sharded = [k for k, s in job[0][case]["local_shapes"].items()
                   if s != tuple(g0[k].shape)]
        assert len(sharded) == job[0][case]["n_sharded"]
    else:
        assert job[0][case]["n_sharded"] == 0


@pytest.mark.parametrize("case", ["training", "training_fsdp"])
def test_fit_resume_matches_one_process(refs, job, case):
    ref = refs["training"]
    for res in job:
        got = res[case]
        for k in ("history", "resumed"):
            assert [e["epoch"] for e in got[k]] == [e["epoch"] for e in ref[k]]
            for a, b in zip(got[k], ref[k]):
                _close(a["train_loss"], b["train_loss"], 2e-4)
                _close(a["val_loss"], b["val_loss"], 2e-4)
        _close(got["param_sum"], ref["param_sum"], 2e-4)
        assert (got["n_sharded"] >= 10) == (case == "training_fsdp")
    assert [e["val_loss"] for e in job[0][case]["history"]] == \
        [e["val_loss"] for e in job[1][case]["history"]]


def test_a_stop_on_one_rank_stops_both(job):
    """Rank 1 asks after its second step; both ranks read the vote after
    their third and stop there, of eight."""
    assert [res["stop"] for res in job] == [3, 3]


def test_meshed_inpaint_matches_jax_and_one_process(refs, job):
    hole = refs["port_inpaint"] != np.clip(_batch()["image"], -1, 1)
    for res in job:
        for key in ("inpaint", "inpaint_fsdp"):
            out = res[key].numpy()
            np.testing.assert_allclose(out, refs["jax_inpaint"], atol=2e-4, rtol=0)
            np.testing.assert_allclose(out, refs["port_inpaint"], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(out[~hole], refs["port_inpaint"][~hole])
        assert res["inpaint_fsdp_placeholders"] > 0
    assert torch.equal(job[0]["inpaint"], job[1]["inpaint"])


def test_checkpoints_with_ranks_that_disagree(refs, job):
    """The overwrite and is_best go the primary's way on both ranks, the
    directory holds one consistent layout, and the fsdp round trip is
    exact."""
    a, b = job[0]["checkpoints"], job[1]["checkpoints"]
    assert a == b == {"first": True, "overwrite_not_best": False, "best": True,
                      "best_val_loss": 0.5}
    root = refs["workdir"] / "disagree"
    assert sorted(os.listdir(root)) == ["best", "best.json", "steps"]
    assert sorted(os.listdir(root / "steps")) == ["0", "1"]
    meta = (root / "steps" / "0" / "meta.json").read_text()
    assert '"redo": true' in meta
    for res in job:
        f = res["fsdp_checkpoint"]
        assert f["same"] and f["whole"] and f["meta_epoch"] == 3
        assert f["files"] == ["meta.json", "shards.json", "state-fsdp0of2.pt",
                              "state-fsdp1of2.pt"]


if __name__ == "__main__":
    main()
