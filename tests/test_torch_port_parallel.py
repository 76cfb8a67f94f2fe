"""The port's parallel layer in one process: the launcher rules,
`host_local_slice` and `fsdp_param_specs` against the JAX package's, the
'model' axis's refusals (JAX's ValueErrors) and its layouts built without a
process group, and a one-rank gloo group, in
which a meshed train, eval and distill step, a meshed `inpaint` and a
checkpoint are the unmeshed ones bit for bit.

Several ranks run in `test_torch_port_multiprocess.py`. Torch runs on one
thread here.
"""
import socket
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import UNetConfig as JaxUNetConfig
from fidm_tpu.models import ffhq256_config as jax_ffhq256_config
from fidm_tpu.parallel import create_mesh as jax_create_mesh
from fidm_tpu.parallel import fsdp_param_specs as jax_fsdp_param_specs
from fidm_tpu.parallel import multihost as jax_multihost
from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.distill import make_distill_step
from fidm_tpu_torch.distill.progressive import unet_apply
from fidm_tpu_torch.models import InpaintingUNet, UNetConfig, ffhq256_config
from fidm_tpu_torch.models.weights import torch_key_map
from fidm_tpu_torch.parallel import (auto_mesh, create_mesh, fsdp_param_specs, multihost,
                                     shard_batch, shard_params)
from fidm_tpu_torch.sampling import SamplerConfig
from fidm_tpu_torch.serving import aot
from fidm_tpu_torch.training import (CheckpointManager, TrainState, make_eval_step,
                                     make_optimizer, make_train_step)

from _torch_port_common import PCFG, SMALL

_LAUNCH_VARS = ("TPU_WORKER_HOSTNAMES", "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "SLURM_STEP_NUM_TASKS", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "RANK", "SLURM_JOB_ID")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _env(monkeypatch, env):
    for v in _LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", [
    {},
    {"TPU_WORKER_HOSTNAMES": "localhost", "SLURM_JOB_ID": "7", "SLURM_NTASKS": "1"},
    {"TPU_WORKER_HOSTNAMES": "host-a,host-b"},
    {"SLURM_NTASKS": "4"},
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"OMPI_COMM_WORLD_SIZE": "x"},
], ids=["plain", "single-task", "pod", "slurm", "coordinator", "malformed"])
def test_launched_by_env_matches_jax(monkeypatch, env):
    _env(monkeypatch, env)
    assert multihost.launched_by_env() == jax_multihost.launched_by_env()


def test_launched_by_env_adds_torchrun_and_initialize_noops(monkeypatch):
    """torchrun's WORLD_SIZE > 1 is a launcher to the port (WORLD_SIZE=1
    is not); a single process and num_processes <= 1 are no-ops in both."""
    _env(monkeypatch, {"WORLD_SIZE": "1", "RANK": "0"})
    assert not multihost.launched_by_env()
    assert multihost.initialize() is False and jax_multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert jax_multihost.initialize(num_processes=1) is False
    assert not dist.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_primary()
    multihost.barrier("no-op")
    _env(monkeypatch, {"WORLD_SIZE": "2"})
    assert multihost.launched_by_env() and not jax_multihost.launched_by_env()
    with pytest.raises(RuntimeError, match="rank, size or coordinator"):
        multihost.initialize(device="cpu")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_host_local_slice_matches_jax(monkeypatch, n):
    """Every process index, global batch and array length; the ranks' rows
    of each global batch, in rank order, are that batch."""
    for i in range(n):
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        monkeypatch.setattr(multihost, "process_count", lambda: n)
        monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
        for length in (0, 5, 8, 17, 37):
            idx = np.random.default_rng(length).permutation(length)
            for B in (None, n, 2 * n, 4 * n, 3 * n):
                np.testing.assert_array_equal(
                    multihost.host_local_slice(idx, B),
                    jax_multihost.host_local_slice(idx, B))
        if n > 1:
            for bad in (n + 1, 2 * n - 1):
                with pytest.raises(ValueError):
                    jax_multihost.host_local_slice(np.arange(8), bad)
                with pytest.raises(ValueError, match="process count"):
                    multihost.host_local_slice(np.arange(8), bad)


# the torch axis that holds the JAX axis a of each kind's weight
_AXIS = {"conv": (2, 3, 1, 0), "linear": (1, 0), "qkv": (1, 0), "proj1d": (1, 0),
         "groupnorm": (0,), "embed": (0, 1)}


@pytest.fixture(scope="module")
def jax_shapes():
    """The Flax parameter shapes of the small config and of ffhq256_config()
    (`jax.eval_shape`, nothing compiled)."""
    out = {}
    for name, cfg in (("small", JaxUNetConfig(**SMALL)), ("ffhq256", jax_ffhq256_config())):
        s = cfg.image_size
        dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
                 np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
        out[name] = jax.eval_shape(JaxInpaintingUNet(cfg).init, jax.random.PRNGKey(0),
                                   *dummy)["params"]
    return out


@pytest.mark.parametrize("config,n,min_size", [
    ("small", 2, 1024), ("small", 4, 2048), ("ffhq256", 2, 2**18), ("ffhq256", 4, 2**18)])
def test_fsdp_param_specs_pick_jax_axis(jax_shapes, config, n, min_size):
    """For every parameter, the port shards the torch axis that holds the
    JAX package's sharded axis (or neither shards it); the port's model on
    the meta device, JAX's specs over an n-device fsdp mesh."""
    pcfg = UNetConfig(**SMALL) if config == "small" else ffhq256_config()
    with torch.device("meta"):
        model = InpaintingUNet(pcfg)
    specs = fsdp_param_specs(model, types.SimpleNamespace(mesh_dim_names=("data", "fsdp"),
                                                          shape=(1, n)), min_size)
    jmesh = jax_create_mesh(data=1, fsdp=n, devices=jax.devices()[:n])
    jspecs = jax_fsdp_param_specs(jax_shapes[config], jmesh, min_size)
    checked, sharded = 0, 0
    for flax_path, prefix, kind in torch_key_map(pcfg):
        node = jspecs.get("base", jspecs)
        for p in flax_path:
            node = node[p]
        for leaf, suffix in (("kernel", "weight"), ("scale", "weight"),
                             ("embedding", "weight"), ("bias", "bias")):
            if leaf not in node:
                continue
            jspec = tuple(node[leaf])
            axes = _AXIS[kind] if suffix == "weight" else (0,)
            want = (Shard(axes[jspec.index("fsdp")]) if "fsdp" in jspec else Replicate())
            assert specs[f"{prefix}.{suffix}"] == want, (prefix, suffix, jspec)
            checked += 1
            sharded += isinstance(want, Shard)
    assert checked == len(specs) and sharded > 0


def _model_stub(m=1, k=2):
    """Mesh (1, 1, k) seen from model rank m: what the specs, the slicing
    and shard_batch read of a mesh (no process group in this test)."""
    return types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"), shape=(1, 1, k),
                                 get_coordinate=lambda: [0, 0, m])


def test_model_axis_and_spatial_refused():
    """JAX's ValueErrors still come first; past them the 'model' axis now
    builds: shard_batch(spatial=True) keeps this rank's block of H rows, a
    spatial train step is made. A mesh needs the process group."""
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(model=2)
    two_axes = types.SimpleNamespace(mesh_dim_names=("data", "fsdp"), shape=(1, 1),
                                     get_coordinate=lambda: [0, 0])
    image = np.arange(2 * 4 * 3 * 1).reshape(2, 4, 3, 1)
    batch = {"image": image, "label": np.arange(2)}
    assert shard_batch(batch, two_axes, spatial=True)["image"].shape == (2, 4, 3, 1)
    out = shard_batch(batch, _model_stub(m=1), spatial=True)
    np.testing.assert_array_equal(out["image"], image[:, 2:])
    np.testing.assert_array_equal(out["label"], batch["label"])
    sched = DiffusionSchedule.create("linear", 100, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_step(sched, spatial=True)
    with pytest.raises(ValueError, match="'model' mesh axis > 1"):
        make_train_step(sched, mesh=two_axes, spatial=True)
    assert callable(make_train_step(sched, mesh=_model_stub(), spatial=True))
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh()


def _tiny_pipeline(**kw):
    return InpaintingPipeline.create(
        PipelineConfig(unet=PCFG, sampler=SamplerConfig(method="ddim", num_steps=3, eta=0.9,
                                                        injection=True)),
        device="cpu", **kw)


def test_pipeline_tp_and_spatial_refused(group):
    """JAX's two ValueErrors come first; with a 'model' axis both layouts
    build: tp_params keeps this rank's slices (qkv: its heads of q, k and
    v). A meshed pipeline's compile_batch builds the meshed call's program,
    equal to the eager call bit for bit (over two ranks of the 'model' axis
    in tests/test_torch_port_mesh_programs.py); under shard_spatial it
    refuses an H that does not divide by the axis size, as JAX's jit
    refuses that input."""
    with pytest.raises(ValueError, match="pick one"):
        _tiny_pipeline(tp_params=True, shard_spatial=True)
    for kw in (dict(tp_params=True), dict(shard_spatial=True)):
        with pytest.raises(ValueError, match="'model' axis"):
            _tiny_pipeline(**kw)
    whole = _tiny_pipeline().model.middle_block[1].qkv.weight.detach()
    pipe = _tiny_pipeline(mesh=_model_stub(m=1), tp_params=True)
    c = whole.shape[0] // 3
    want = torch.cat([whole[i * c + c // 2:(i + 1) * c] for i in range(3)])
    assert torch.equal(pipe.model.middle_block[1].qkv.weight, want)
    spatial = _tiny_pipeline(mesh=_model_stub(k=3), shard_spatial=True)
    with pytest.raises(ValueError, match="H=16 is not divisible by 3.*must divide by the axis"):
        spatial.compile_batch(2)
    gt, mask = _batch(b=2)["image"].clip(-1, 1), _batch(b=2)["mask"]
    meshed = _tiny_pipeline(seed=3, mesh=group)
    program = meshed.compile_batch(2)
    out = program(torch.from_numpy(gt), torch.from_numpy(mask), 4)
    assert torch.equal(out, meshed.inpaint(gt, mask, 4))


def test_program_cache_refuses_a_mesh(tmp_path):
    meshed = types.SimpleNamespace(mesh=object())
    for fn in (aot.save_programs, aot.load_programs):
        with pytest.raises(ValueError, match="single-host pipelines only"):
            fn(meshed, str(tmp_path), [1])


# -------------------------------------------------------- one-rank gloo group

@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group for the tests below, destroyed after
    them (other test files share this process)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    yield create_mesh(data=1, fsdp=1)
    dist.destroy_process_group()


def test_auto_mesh_rank_rule(group):
    mesh = auto_mesh(3)
    assert mesh.mesh_dim_names == ("data", "fsdp") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match=r"data axis of 1 and leave 1 device\(s\) idle"):
        auto_mesh(3, devices=[0, 1])
    with pytest.raises(ValueError, match="does not divide"):
        auto_mesh(4, fsdp=3, devices=[0, 1])
    with pytest.raises(ValueError, match="2x1 != 1"):
        create_mesh(data=2)
    batch = {"image": np.arange(6).reshape(3, 2), "n": 3}
    assert shard_batch(batch, mesh)["image"].shape == (3, 2)


def _model(seed=0):
    torch.manual_seed(seed)
    model = InpaintingUNet(PCFG)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _batch(b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    img = (0.5 * rng.standard_normal((b, s, s, 3))).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 4:12, 2:10] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _train(mesh, fsdp, masked=False):
    model = _model()
    params, specs = (shard_params(model, mesh, use_fsdp=fsdp, min_size=1024) if mesh
                     else (dict(model.named_parameters()), None))
    # masked: the biases frozen; their gradients are in grad_norm (above the
    # clip of 1 here) and out of the clip's norm
    mask = {k: not k.endswith(".bias") for k in params} if masked else None
    state = TrainState.create(model, params, make_optimizer(lambda c: 1e-3, param_mask=mask),
                              specs=specs)
    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    step = make_train_step(sched, mesh=mesh, accum_steps=2)
    metrics = [step(state, _batch(), 5)[1] for _ in range(2)]
    ev = make_eval_step(sched, mesh=mesh)(state, _batch(seed=2), 9)
    return metrics, ev, {k: v.detach().clone() for k, v in state.params.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_one_rank_mesh_step_is_the_unmeshed_step(group, fsdp, masked):
    """Two accumulated train steps and an eval step: metrics and parameters
    bit-equal with and without the mesh (the fsdp axis of one rank shards
    nothing), with and without a param_mask, and so is a progressive
    distillation step."""
    ref_metrics, ref_eval, ref_params = _train(None, False, masked)
    metrics, ev, params = _train(group, fsdp, masked)
    assert all(float(m["grad_norm"]) > 1.0 for m in metrics)  # the clip acts
    for a, b in zip(metrics, ref_metrics):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in ev:
        assert torch.equal(ev[k], ref_eval[k])
    for k in params:
        assert torch.equal(params[k], ref_params[k]), k
    if masked:
        frozen = _model()
        for k, p in frozen.named_parameters():
            assert torch.equal(params[k], p) == k.endswith(".bias"), k

    sched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    out = []
    for mesh in (None, group):
        teacher, student = _model(1).requires_grad_(False), _model(1)
        mask = ({k: not k.endswith(".bias") for k, _ in student.named_parameters()}
                if masked else None)
        state = TrainState.create(student, dict(student.named_parameters()),
                                  make_optimizer(lambda c: 1e-3, param_mask=mask))
        step = make_distill_step(sched, unet_apply, unet_apply, teacher_steps=4, mesh=mesh)
        out.append((step(state, teacher, _batch(), 3)[1],
                    [p.detach().clone() for p in student.parameters()]))
    assert all(torch.equal(out[0][0][k], out[1][0][k]) for k in out[0][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_one_rank_mesh_inpaint_is_the_unmeshed_call(group):
    gt, mask = _batch(b=2)["image"].clip(-1, 1), _batch(b=2)["mask"]
    plain = _tiny_pipeline(seed=3)
    ref = plain.inpaint(gt, mask, 4)
    for kw in (dict(), dict(fsdp_params=True, fsdp_min_size=1024)):
        pipe = _tiny_pipeline(seed=3, mesh=group, **kw)
        assert torch.equal(pipe.inpaint(gt, mask, 4), ref)
        rows = pipe.inpaint(gt, mask, [4, 5])
        assert torch.equal(rows, plain.inpaint(gt, mask, [4, 5]))
        # the meshed call's programs, installed: inpaint replays them
        for batched, seed, want in ((False, 4, ref), (True, [4, 5], rows)):
            pipe.install_program(2, pipe.config.sampler,
                                 pipe.compile_batch(2, batched_key=batched), batched)
            assert torch.equal(pipe.inpaint(gt, mask, seed), want)
        with pytest.raises(ValueError, match="single-host"):
            aot.save_programs(pipe, "unused", [2])


def test_one_rank_checkpoint_keeps_the_one_process_layout(group, tmp_path):
    """Under the group the manager writes what it writes without one: the
    same files and the same tensors, the overwrite and the best too."""
    trees = []
    for name in ("plain", "group"):
        root = tmp_path / name
        if name == "plain":
            dist.destroy_process_group()
        try:
            model = _model()
            state = TrainState.create(model, dict(model.named_parameters()),
                                      make_optimizer(lambda c: 1e-3))
            mgr = CheckpointManager(str(root), keep_last_n=2)
            assert mgr.save(0, state, {"epoch": 0}, val_loss=1.0)
            assert not mgr.save(0, state, {"epoch": 0}, val_loss=2.0)  # overwrite
            assert mgr.save(1, state, {"epoch": 1}, val_loss=0.5)
            mgr.close()
        finally:
            if name == "plain":
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                        world_size=1, rank=0)
        files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
        trees.append((files, CheckpointManager(str(root)).restore("best")[0]))
    assert trees[0][0] == trees[1][0]
    a, b = trees[0][1]["params"], trees[1][1]["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)
