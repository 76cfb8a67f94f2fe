"""The mesh's "model" axis (tensor parallelism and spatial partitioning,
`fidm_tpu_torch/parallel/tp.py`) against the JAX package's unsharded calls,
in OS processes over gloo on the CPU.

Two jobs of four ranks (this file run as a script, `python
test_torch_port_tp.py JOB RANK PORT WORKDIR`, each spawned once for the
module under a 150 s timeout; the jobs import no JAX) run every case and
write their results, while the JAX references are computed once here, on
the small float32 config of `_torch_port_common.py` with every leaf
perturbed (JAX's own `tests/test_tp.py` holds its sharded calls to these):

  job "dm": meshes data=2 x model=2 and model=4 (H=16: spatial blocks of 4
      rows at the top level and 2 at the bottom; TP splits a head there, so
      the attention blocks gather their slices and compute whole): the TP
      and spatial forwards (2e-5), `shard_batch(spatial=True)` against JAX's
      layout, a spatial train step at data=2 x model=2 and a TP train step
      at model=4 (loss 1e-5 relative and 1e-6 absolute, updated parameters
      2e-5, the gradients 2e-5 of their tensor's largest plus 1e-7), the
      replicated gradients equal across each model group, and the TP and
      spatial `InpaintingPipeline`, plain and feature-cached (1e-4, known
      pixels exact);
  job "fm": mesh fsdp=2 x model=2 (min_size 1024): a TP+fsdp train step
      (the same bounds, the model slices still slices after it) and a
      checkpoint of that state restored into the same mesh, whole in the
      ranks, and into a one-process state here.

The parameter specs are held to `fidm_tpu.parallel.tp.tp_param_specs` on
JAX's 8 virtual devices (specs only, nothing compiled), and the slicing
pair is held to its inverse, in this process.
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

B, S, LR, CLIP, MIN_SIZE = 4, 16, 1e-5, 1.0, 1024
DDIM = dict(method="ddim", num_steps=4, eta=0.9, injection=True)
# a feature-cached DDIM (the decoder's level-1 skips reused between key steps)
CACHED = dict(DDIM, encoder_cache_period=2, cache_branch=1)
HERE = os.path.dirname(os.path.abspath(__file__))
JOBS = ("dm", "fm")


# ----------------------------------------------- the four-rank jobs (no JAX)

def _model(inputs):
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig

    model = InpaintingUNet(UNetConfig(**inputs["cfg"], dtype=torch.float32))
    model.load_state_dict(inputs["state_dict"], strict=True)
    return model


def _forward(inputs, mesh, mode):
    """The whole batch's output of a TP or spatial forward, on every rank."""
    from fidm_tpu_torch.parallel import shard_batch, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import gather_h, gather_rows, model_group
    from fidm_tpu_torch.parallel.tp import attach

    model, fwd = _model(inputs), inputs["forward"]
    specs = tp_shard_params(model, mesh)[1] if mode == "tp" else None
    part = shard_batch(fwd, mesh, spatial=mode == "spatial")
    with torch.no_grad(), attach(model, mesh, mode, specs):
        out = model(part["x"], part["t"], part["masked_image"], part["mask"])
    if mode == "spatial":
        out = gather_h(out, model_group(mesh), dim=1)
    return gather_rows(out, mesh)


def _train_step(inputs, mesh, mode, fsdp_min_size=None):
    """One train step on JAX's recorded draws: metrics, this rank's own
    gradients as they enter `reduce_gradients` (before any reduction over
    the ranks), the optimizer's gradients (this rank's layout and whole),
    the parameters after it (whole) and the local shapes of the state."""
    from test_torch_port_multiprocess import RecordedDraws, _recording_optimizer

    from fidm_tpu_torch.parallel import collectives, shard_batch, shard_params, tp_shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import TrainState, make_train_step

    model = _model(inputs)
    if mode == "tp":
        params, specs = tp_shard_params(model, mesh, fsdp_min_size=fsdp_min_size)
    else:
        params, specs = shard_params(model, mesh)
    tx = _recording_optimizer(LR, CLIP, None)
    state = TrainState.create(model, params, tx, specs=specs)
    step = make_train_step(inputs["sched"], mesh=mesh, spatial=mode == "spatial")
    batch = shard_batch(inputs["batch"], mesh, spatial=mode == "spatial")
    own, reduce_gradients = {}, collectives.reduce_gradients

    def recording(names, grads, *args):
        own.update((k, g.detach().clone()) for k, g in zip(names, grads))
        return reduce_gradients(names, grads, *args)

    collectives.reduce_gradients = recording
    try:
        _, metrics = step(state, batch, RecordedDraws(inputs["draws"]))
    finally:
        collectives.reduce_gradients = reduce_gradients
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "own_grads": own,
            "local_grads": {k: g.clone() for k, g in tx.grads.items()},
            "grads": full_params(tx.grads, specs, mesh),
            "params": {k: v.detach().clone()
                       for k, v in full_params(state.params, specs, mesh).items()},
            "local_shapes": {k: tuple(v.shape) for k, v in state.params.items()},
            "kinds": {k: type(s).__name__ for k, s in specs.items()}}, state


def _inpaint(inputs, mesh, sampler=DDIM, **kw):
    from test_torch_port_multiprocess import ReplayNoise

    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.sampling import SamplerConfig

    config = PipelineConfig(unet=UNetConfig(**inputs["cfg"], dtype=torch.float32),
                            sampler=SamplerConfig(**sampler))
    pipe = InpaintingPipeline(_model(inputs).requires_grad_(False),
                              DiffusionSchedule.create("quadratic", 1000, device="cpu"),
                              config, mesh=mesh, **kw)
    return pipe.inpaint(inputs["gt"], inputs["mask"], 0, noise=ReplayNoise(inputs["noise"]))


def _checkpoint(inputs, mesh, state, workdir):
    """The TP+fsdp state saved, restored into a fresh TP state of the same
    mesh and whole (`restore_params`)."""
    from fidm_tpu_torch.parallel import tp_shard_params
    from fidm_tpu_torch.parallel.collectives import full_params
    from fidm_tpu_torch.training import CheckpointManager, TrainState, make_optimizer

    mgr = CheckpointManager(os.path.join(workdir, "tp_ckpt"), mesh=mesh)
    mgr.save(1, state, {"epoch": 1}, val_loss=0.5)
    model = _model(inputs)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    params, specs = tp_shard_params(model, mesh, fsdp_min_size=MIN_SIZE)
    fresh = TrainState.create(model, params, make_optimizer(lambda c: LR), specs=specs)
    restored, meta = mgr.restore("latest", fresh)
    same = all(torch.equal(state.params[k], restored.params[k])
               and torch.equal(state.opt_state["mu"][k], restored.opt_state["mu"][k])
               and torch.equal(state.opt_state["nu"][k], restored.opt_state["nu"][k])
               for k in state.params) and restored.step == state.step
    whole = mgr.restore_params("best")
    full = full_params(state.params, state.specs, mesh)
    mgr.close()
    return {"same": same, "meta_epoch": meta["epoch"], "full": full,
            "whole": sorted(whole) == sorted(full)
            and all(torch.equal(whole[k], full[k]) for k in full),
            "files": sorted(os.listdir(os.path.join(workdir, "tp_ckpt", "steps", "1")))}


def main():
    job, rank, port, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from fidm_tpu_torch.parallel import create_mesh, multihost, shard_batch

    assert multihost.initialize(f"127.0.0.1:{port}", 4, rank, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    if job == "dm":
        dm, m4 = create_mesh(data=2, model=2), create_mesh(data=1, model=4)
        for name, mesh in (("d2m2", dm), ("m4", m4)):
            for mode in ("tp", "spatial"):
                out[f"forward_{mode}_{name}"] = _forward(inputs, mesh, mode)
        out["layout"] = {k: np.asarray(v) for k, v in
                         shard_batch(inputs["layout"], dm, spatial=True).items()}
        out["train_spatial_d2m2"] = _train_step(inputs, dm, "spatial")[0]
        out["train_tp_m4"] = _train_step(inputs, m4, "tp")[0]
        for name, sampler in (("", DDIM), ("_cached", CACHED)):
            out[f"inpaint_tp{name}"] = _inpaint(inputs, dm, sampler, tp_params=True)
            out[f"inpaint_spatial{name}"] = _inpaint(inputs, dm, sampler, shard_spatial=True)
    else:
        fm = create_mesh(data=1, fsdp=2, model=2)
        out["train_tp_fsdp"], state = _train_step(inputs, fm, "tp", MIN_SIZE)
        out["checkpoint"] = _checkpoint(inputs, fm, state, workdir)
    torch.save(out, os.path.join(workdir, f"{job}{rank}.pt"))
    multihost.barrier("done")
    print("TP_OK", job, rank, flush=True)


# ------------------------------------------- the tests and their JAX references

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _train_batch():
    rng = np.random.default_rng(1)
    img = (0.5 * rng.standard_normal((B, S, S, 3))).astype(np.float32)
    mask = np.zeros((B, S, S, 1), np.float32)
    mask[0, 4:12, 2:10] = mask[1, :8] = mask[2, 8:, 8:] = mask[3, 2:14, 3:9] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _layout_batch():
    """Image leaves, a rank-1 leaf and an H (5) that does not divide by 2."""
    return {"image": np.arange(8 * 16 * 16 * 3, dtype=np.float32).reshape(8, 16, 16, 3),
            "mask": np.arange(8 * 16 * 16, dtype=np.float32).reshape(8, 16, 16, 1),
            "label": np.arange(8, dtype=np.int32),
            "odd": np.arange(8 * 5 * 5 * 3, dtype=np.float32).reshape(8, 5, 5, 3)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The jobs' inputs in WORKDIR/inputs.pt and their ranks, started, so
    that they run while the references are computed; killed at the end."""
    import jax
    import jax.numpy as jnp

    from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from fidm_tpu_torch.sampling import SamplerConfig

    from _torch_port_common import JCFG, PCFG, SMALL, JaxKeyNoise, perturbed_jax_variables
    workdir = tmp_path_factory.mktemp("tp")
    variables = perturbed_jax_variables(JCFG, seed=3)
    sd = state_dict_from_jax(variables, PCFG)
    rng = np.random.default_rng(4)
    forward = {"x": rng.standard_normal((B, S, S, 3)).astype(np.float32),
               "t": rng.integers(0, 1000, (B,)).astype(np.int64),
               "masked_image": rng.standard_normal((B, S, S, 3)).astype(np.float32),
               "mask": (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)}
    forward = {k: torch.from_numpy(v) for k, v in forward.items()}
    batch, key = _train_batch(), jax.random.PRNGKey(7)
    # the JAX step's draws for the global batch, as test_torch_port_multiprocess
    k = jax.random.fold_in(jax.random.fold_in(key, 0), 0)
    t_key, loss_key = jax.random.split(k)
    noise_key, inject_key = jax.random.split(loss_key)
    shape = batch["image"].shape
    draws = {((0, 0), "t"): np.asarray(jax.random.randint(t_key, (B,), 0, 1000)),
             ((0, 0), "noise"): np.asarray(jax.random.normal(noise_key, shape, jnp.float32)),
             ((0, 0), "inject"): np.asarray(jax.random.normal(inject_key, shape, jnp.float32))}
    # the pipeline's noise: the JAX sampler's draws, recorded for the ranks
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
    pipe.inpaint(gt, mask, 0, noise=Recorder(ikey))
    inputs = {"cfg": SMALL, "state_dict": sd, "forward": forward, "batch": batch,
              "draws": draws, "sched": DiffusionSchedule.create("quadratic", 1000, device="cpu"),
              "gt": gt, "mask": mask, "noise": recorded, "layout": _layout_batch()}
    torch.save(inputs, workdir / "inputs.pt")

    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    logs, procs = {}, {}
    for job in JOBS:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        for r in range(4):
            logs[job, r] = open(workdir / f"{job}{r}.log", "w")
            procs[job, r] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r), port, str(workdir)],
                stdout=logs[job, r], stderr=subprocess.STDOUT, env=env)
    try:
        yield {"workdir": workdir, "procs": procs, "deadline": time.time() + 150,
               "variables": variables, "key": key, "inputs": inputs, "ikey": ikey}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
        for f in logs.values():
            f.close()


@pytest.fixture(scope="module")
def refs(started):
    """The JAX package's unsharded forward, train step and pipeline."""
    import jax
    import jax.numpy as jnp
    import optax

    from fidm_tpu import pipeline as jax_pipeline
    from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
    from fidm_tpu.training import TrainState as JaxTrainState
    from fidm_tpu.training import make_optimizer as jax_make_optimizer
    from fidm_tpu.training import make_train_step as jax_make_train_step
    from fidm_tpu_torch.models.weights import state_dict_from_jax
    from test_torch_port_multiprocess import _recording

    from _torch_port_common import JCFG, PCFG
    variables, inputs = started["variables"], started["inputs"]
    model = JaxInpaintingUNet(JCFG)
    fwd = {k: jnp.asarray(v.numpy()) for k, v in inputs["forward"].items()}
    out = {"forward": np.asarray(jax.jit(model.apply)(
        variables, fwd["x"], fwd["t"].astype(jnp.int32), fwd["masked_image"], fwd["mask"]))}
    tx = jax_make_optimizer(optax.constant_schedule(LR), grad_clip=CLIP)
    state = JaxTrainState.create(apply_fn=model.apply,
                                 params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                 tx=_recording(tx))
    step = jax_make_train_step(JaxSchedule.create("quadratic", 1000), donate=False)
    state, metrics = step(state, inputs["batch"], started["key"])
    tree = lambda t: {"params": jax.tree_util.tree_map(np.asarray, t)}  # noqa: E731
    out["train"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": state_dict_from_jax(tree(state.opt_state[1]), PCFG),
                    "params": state_dict_from_jax(tree(state.params), PCFG)}
    jpipe = jax_pipeline.InpaintingPipeline(
        model, jax.tree_util.tree_map(jnp.asarray, variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG, sampler=JaxSamplerConfig(**DDIM)))
    out["inpaint"] = np.asarray(jpipe.inpaint(jnp.asarray(inputs["gt"]),
                                              jnp.asarray(inputs["mask"]), started["ikey"]))
    out["inpaint_cached"] = np.asarray(jpipe.inpaint(
        jnp.asarray(inputs["gt"]), jnp.asarray(inputs["mask"]), started["ikey"],
        sampler=JaxSamplerConfig(**CACHED)))
    return out


@pytest.fixture(scope="module")
def job(started, refs):
    """Every rank's results, by job (one spawn of each job, 150 s at most
    from their start)."""
    workdir = started["workdir"]
    for p in started["procs"].values():
        try:
            p.wait(timeout=max(1.0, started["deadline"] - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for (j, r), p in started["procs"].items():
        log = (workdir / f"{j}{r}.log").read_text()
        assert p.returncode == 0 and f"TP_OK {j} {r}" in log, f"{j} rank {r}:\n{log[-4000:]}"
    return {j: [torch.load(workdir / f"{j}{r}.pt", weights_only=False) for r in range(4)]
            for j in JOBS}


# ------------------------------------------------------- specs and slicing

@pytest.fixture(scope="module")
def jax_shapes():
    """The Flax parameter shapes of the small config and of ffhq256_config()
    (`jax.eval_shape`, nothing compiled)."""
    import jax

    from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
    from fidm_tpu.models import UNetConfig as JaxUNetConfig
    from fidm_tpu.models import ffhq256_config as jax_ffhq256_config

    from _torch_port_common import SMALL
    out = {}
    for name, cfg in (("small", JaxUNetConfig(**SMALL)), ("ffhq256", jax_ffhq256_config())):
        s = cfg.image_size
        dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
                 np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
        out[name] = jax.eval_shape(JaxInpaintingUNet(cfg).init, jax.random.PRNGKey(0),
                                   *dummy)["params"]
    return out


def _stub_mesh(n):
    return types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"), shape=(1, 1, n))


# the torch axis that holds the JAX axis a of each kind's weight
_AXIS = {"conv": (2, 3, 1, 0), "linear": (1, 0), "qkv": (1, 0), "proj1d": (1, 0),
         "groupnorm": (0,), "embed": (0, 1)}


@pytest.mark.parametrize("config,n", [("small", 2), ("small", 4), ("ffhq256", 2),
                                      ("ffhq256", 4)])
def test_tp_param_specs_match_jax(jax_shapes, config, n):
    """For every parameter the port splits the torch axis that holds the
    axis JAX's `tp_param_specs` shards over "model" (qkv in 3 runs, a
    scale-shift emb_proj in 2), or neither splits it; the port's model on
    the meta device, JAX's specs on a data x model mesh of 8 virtual
    devices. An odd shape stays replicated in both."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fidm_tpu.parallel import create_mesh as jax_create_mesh
    from fidm_tpu.parallel import tp_param_specs as jax_tp_param_specs
    from fidm_tpu_torch.models import InpaintingUNet, UNetConfig, ffhq256_config
    from fidm_tpu_torch.models.weights import torch_key_map
    from fidm_tpu_torch.parallel import tp_param_specs
    from fidm_tpu_torch.parallel.tp import ModelShard
    from torch.distributed.tensor import Replicate

    from _torch_port_common import SMALL
    pcfg = UNetConfig(**SMALL) if config == "small" else ffhq256_config()
    with torch.device("meta"):
        model = InpaintingUNet(pcfg)
    specs = tp_param_specs(model, _stub_mesh(n))
    jspecs = jax_tp_param_specs(jax_shapes[config], jax_create_mesh(data=8 // n, model=n))
    checked, split = 0, 0
    for flax_path, prefix, kind in torch_key_map(pcfg):
        node = jspecs.get("base", jspecs)
        for p in flax_path:
            node = node[p]
        for leaf, suffix in (("kernel", "weight"), ("scale", "weight"),
                             ("embedding", "weight"), ("bias", "bias")):
            if leaf not in node:
                continue
            jspec = tuple(node[leaf])
            got = specs[f"{prefix}.{suffix}"]
            if "model" in jspec:
                axes = _AXIS[kind] if suffix == "weight" else (0,)
                parts = 3 if kind == "qkv" else (
                    2 if ".emb_layers." in prefix and pcfg.use_scale_shift_norm else 1)
                assert got == ModelShard(axes[jspec.index("model")], parts), (prefix, jspec)
                split += 1
            else:
                assert got == Replicate(), (prefix, suffix, jspec, got)
            checked += 1
    assert checked == len(specs) and split > 0
    odd = {"input_blocks.1.0.in_layers.2.weight": torch.zeros(10, 8, 3, 3)}
    assert tp_param_specs(odd, _stub_mesh(4))["input_blocks.1.0.in_layers.2.weight"] == \
        Replicate()
    jodd = jax_tp_param_specs({"base": {"x_res": {"in_conv": {"kernel": jnp.zeros((3, 3, 8, 10))}}}},
                              jax_create_mesh(data=2, model=4))
    assert jodd["base"]["x_res"]["in_conv"]["kernel"] == P()
    assert len(jax.devices()) == 8


def test_slices_and_their_inverse():
    """Every split tensor of the small model at k = 2 and 4: the k slices
    joined give the tensor bit for bit; qkv's slice holds rank r's channels
    of each of q, k and v, a scale-shift emb_proj's of scale and shift."""
    from fidm_tpu_torch.models import InpaintingUNet
    from fidm_tpu_torch.parallel import tp_param_specs
    from fidm_tpu_torch.parallel.tp import ModelShard, join_slices, local_slice

    from _torch_port_common import PCFG
    torch.manual_seed(0)
    params = dict(InpaintingUNet(PCFG).named_parameters())
    for k in (2, 4):
        specs = tp_param_specs(params, _stub_mesh(k))
        split = {n: s for n, s in specs.items() if isinstance(s, ModelShard)}
        assert {s.parts for s in split.values()} == {1, 2, 3}
        for name, spec in split.items():
            t = params[name].detach()
            pieces = [local_slice(t, spec, k, i) for i in range(k)]
            assert torch.equal(join_slices(pieces, spec), t), name
            runs = t.chunk(spec.parts, spec.dim)
            for i, piece in enumerate(pieces):
                want = torch.cat([r.chunk(k, spec.dim)[i] for r in runs], spec.dim)
                assert torch.equal(piece, want), (name, i)


# ------------------------------------------------------------- the jobs

def test_spatial_layout_matches_jax(job):
    """shard_batch(spatial=True) at data=2 x model=2: each rank holds JAX's
    shard of its device (rows over data, H blocks over model); a rank-1 leaf
    and an H that does not divide keep their rows only."""
    import jax

    from fidm_tpu.parallel import create_mesh as jax_create_mesh
    from fidm_tpu.parallel import shard_batch as jax_shard_batch

    devices = jax.devices()[:4]
    mesh = jax_create_mesh(data=2, model=2, devices=devices)
    sharded = jax_shard_batch(_layout_batch(), mesh, spatial=True)
    for r in range(4):
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(job["dm"][r]["layout"][k], np.asarray(shard.data),
                                          err_msg=f"rank {r} {k}")
    assert job["dm"][0]["layout"]["image"].shape == (4, 8, 16, 3)
    assert job["dm"][0]["layout"]["odd"].shape == (4, 5, 5, 3)


@pytest.mark.parametrize("case", ["forward_tp_d2m2", "forward_spatial_d2m2",
                                  "forward_tp_m4", "forward_spatial_m4"])
def test_forward_matches_jax(refs, job, case):
    """The whole batch's UNet output, gathered on every rank, against JAX's
    unsharded apply."""
    for res in job["dm"]:
        np.testing.assert_allclose(res[case].numpy(), refs["forward"], rtol=2e-5, atol=2e-5)


def _within(got, ref, rel, floor):
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item() + floor


@pytest.mark.parametrize("case", ["train_tp_fsdp", "train_spatial_d2m2", "train_tp_m4"])
def test_train_step_matches_jax(refs, job, case):
    """One step's loss, gradients and updated parameters against JAX's
    unsharded step on the same draws; the model slices stay slices."""
    ref = refs["train"]
    results = [res[case] for res in job["fm" if case == "train_tp_fsdp" else "dm"]]
    for got in results:
        for k in ("loss", "mse", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in got["grads"].items():
            assert _within(g, ref["grads"][name], 2e-5, 1e-7), name
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       ref["params"][name].numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=name)
    kinds = results[0]["kinds"]
    if case == "train_spatial_d2m2":
        assert set(kinds.values()) == {"Replicate"}
    else:
        split = [k for k, v in kinds.items() if v == "ModelShard"]
        assert len(split) >= 40
        for k in split:  # this rank's slice, after the step too
            whole = tuple(ref["params"][k].shape)
            assert results[0]["local_shapes"][k] != whole, k
        if case == "train_tp_fsdp":
            assert "Shard" in kinds.values()


def test_replicated_gradients_equal_across_a_model_group(job):
    """A replicated tensor's gradient is the same on every rank of a model
    group: as each rank computed it, before any reduction over the ranks
    (the replicated stream's, complete through copy_to_model's backward),
    and after the step's reduction (which also averages it over the group,
    so that the ranks keep one value where the card's cuDNN sums in
    another order on each rank); the split ones differ."""
    groups = {"train_tp_m4": ("dm", [[0, 1, 2, 3]]), "train_tp_fsdp": ("fm", [[0, 1], [2, 3]])}
    for case, (j, model_groups) in groups.items():
        for ranks in model_groups:
            res = [job[j][r][case] for r in ranks]
            kinds = res[0]["kinds"]
            replicated = [k for k, v in kinds.items() if v == "Replicate"]
            assert len(replicated) >= 10
            for k in replicated:
                for other in res[1:]:
                    for grads in ("own_grads", "local_grads"):
                        torch.testing.assert_close(other[grads][k], res[0][grads][k], rtol=0,
                                                   atol=0, msg=f"{case} {grads} {k}")
            split = [k for k, v in kinds.items() if v == "ModelShard"]
            for grads in ("own_grads", "local_grads"):
                assert any(not torch.equal(res[0][grads][k], res[1][grads][k]) for k in split)


@pytest.mark.parametrize("case", ["inpaint_tp", "inpaint_spatial", "inpaint_tp_cached",
                                  "inpaint_spatial_cached"])
def test_pipeline_matches_jax(refs, job, case):
    """InpaintingPipeline(tp_params=True) and (shard_spatial=True) at data=2 x
    model=2 against JAX's unsharded pipeline on the same draws, plain and
    feature-cached (the cache holding the replicated stream under TP and
    each rank's H blocks under spatial); the known pixels are gt exactly."""
    batch = _train_batch()
    gt, keep = np.clip(batch["image"], -1, 1), batch["mask"][..., 0] < 0.5
    ref = refs["inpaint_cached" if case.endswith("_cached") else "inpaint"]
    for res in job["dm"]:
        out = res[case].numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out[keep], gt[keep])


def test_tp_checkpoint_round_trip(started, job):
    """A TP+fsdp state saved and restored into the same mesh is the state
    bit for bit; restored whole, in the ranks and into a one-process state
    here, it is the state's slices joined."""
    from fidm_tpu_torch.training import CheckpointManager, TrainState, make_optimizer

    for res in job["fm"]:
        c = res["checkpoint"]
        assert c["same"] and c["whole"] and c["meta_epoch"] == 1
        assert c["files"] == ["meta.json", "shards.json", "state-fsdp0of2.pt",
                              "state-fsdp1of2.pt"]
    model = _model(started["inputs"])
    state = TrainState.create(model, dict(model.named_parameters()),
                              make_optimizer(lambda c: LR))
    _, meta = CheckpointManager(str(started["workdir"] / "tp_ckpt")).restore("latest", state)
    full = job["fm"][0]["checkpoint"]["full"]
    assert meta["epoch"] == 1 and state.step == 1 and sorted(state.params) == sorted(full)
    for k, p in state.params.items():
        assert torch.equal(p, full[k]), k


def test_model_axis_refusals():
    """JAX's ValueErrors come first, in JAX's words; LoRA, distillation and
    fit build under a model axis (the steps also with spatial=True), where
    they ran only unmeshed before. `check_spatial` counts the levels that
    run split and refuses only an H that does not divide."""
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.distill import make_consistency_step, make_distill_step
    from fidm_tpu_torch.distill.progressive import unet_apply
    from fidm_tpu_torch.parallel.tp import check_spatial
    from fidm_tpu_torch.training import FitConfig, fit, make_eval_step, make_train_step

    sched = DiffusionSchedule.create("linear", 50, device="cpu")
    two_axes = types.SimpleNamespace(mesh_dim_names=("data", "fsdp"), shape=(4, 2))
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_step(sched, spatial=True)
    with pytest.raises(ValueError, match=r"spatial=True needs a 'model' mesh axis > 1; mesh is "
                                         r"\{'data': 4, 'fsdp': 2\}"):
        make_train_step(sched, mesh=two_axes, spatial=True)
    model_mesh = _stub_mesh(2)
    for spatial in (False, True):
        for make in (lambda: make_train_step(sched, mesh=model_mesh, param_transform=dict,
                                             spatial=spatial),
                     lambda: make_eval_step(sched, mesh=model_mesh, param_transform=dict,
                                            spatial=spatial),
                     lambda: make_distill_step(sched, unet_apply, unet_apply, teacher_steps=4,
                                               mesh=model_mesh, spatial=spatial),
                     lambda: make_consistency_step(sched, unet_apply, unet_apply,
                                                   mesh=model_mesh, spatial=spatial)):
            assert callable(make())
    assert make_train_step(sched, mesh=model_mesh, spatial=True).spatial
    assert not make_eval_step(sched, mesh=model_mesh).spatial
    state = types.SimpleNamespace(params={"w": torch.zeros(1)})
    assert fit(state, None, None, [], None, 0, FitConfig(num_epochs=0),
               mesh=model_mesh) == (state, [])
    assert check_spatial(16, 4, 2) == 2
    assert check_spatial(256, 2, 6) == 6
    # the 2-row level's blocks of one row would be odd: levels 0 and 1 split,
    # levels 2 and 3 run whole
    assert check_spatial(16, 4, 4) == 2
    assert check_spatial(224, 2, 6) == 4
    with pytest.raises(ValueError, match="divisible by 2"):
        check_spatial(7, 2, 1)


if __name__ == "__main__":
    main()
