"""Sampling programs of a meshed pipeline (`InpaintingPipeline.compile_batch`
under a mesh), in OS processes over gloo on the CPU.

One job of two ranks (this file run as a script, `python
test_torch_port_mesh_programs.py RANK PORT WORKDIR`, spawned once for the
module under a 150 s timeout; it imports no JAX) builds, for each layout of
the pipeline over a mesh, the program of a 4-step DDIM at batch 4, installs
it and calls `inpaint` through it:

  - "data": data=2, each rank 2 rows;
  - "fsdp": fsdp=2 with `fsdp_params` (min_size 1024), the model's shards
    gathered inside the program;
  - "tp": model=2 with `tp_params`;
  - "spatial": model=2 with `shard_spatial`, blocks of 8 of the 16 rows;
  - "spatial_cached": the same with a feature-cached DDIM (level-1 skips
    reused between key steps);
  - "spatial_uneven": `shard_spatial` on channel_mult (1, 2, 2) at H=20,
    whose 10-row level would split into odd blocks of 5 and runs whole.

Each with one seed for the batch and with per-row seeds: the installed
program's output is bit-equal to the meshed eager call, twice and for a
second seed that refills its noise buffers, and within 1e-4 of the
unmeshed call here (the pipeline bound of `tests/test_torch_port_tp.py`),
the known pixels exactly gt. `serving.aot.save_programs` still refuses a
mesh. The model is the port's own init with every parameter shifted by a
seeded draw (no zero-initialised conv hides a block); torch runs on one
thread.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

B, S, S_UNEVEN = 4, 16, 20
# `tests/_torch_port_common.py`'s SMALL (which imports JAX, and the ranks do not)
SMALL = dict(image_size=S, in_channels=9, model_channels=32, out_channels=6,
             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
             num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
             resblock_updown=True)
DDIM = dict(method="ddim", num_steps=4, eta=0.9, injection=True)
CACHED = dict(DDIM, encoder_cache_period=2, cache_branch=1)
UNEVEN_MULT = (1, 2, 2)
SEEDS = {"one_seed": (3, 8), "per_row_seeds": ([3, 4, 5, 6], [8, 9, 10, 11])}
LAYOUTS = ("data", "fsdp", "tp", "spatial", "spatial_cached", "spatial_uneven")
HERE = os.path.dirname(os.path.abspath(__file__))


def _config(layout):
    from fidm_tpu_torch import PipelineConfig
    from fidm_tpu_torch.models import UNetConfig
    from fidm_tpu_torch.sampling import SamplerConfig

    unet = dict(SMALL)
    if layout == "spatial_uneven":
        unet.update(image_size=S_UNEVEN, channel_mult=UNEVEN_MULT)
    return PipelineConfig(unet=UNetConfig(**unet, dtype=torch.float32),
                          sampler=SamplerConfig(**(CACHED if layout == "spatial_cached"
                                                   else DDIM)))


def _pipeline(layout, mesh=None):
    """The layout's pipeline (unmeshed without `mesh`) on the seeded model."""
    from fidm_tpu_torch import InpaintingPipeline

    config = _config(layout)
    pipe = InpaintingPipeline.create(config, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in pipe.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    if mesh is None:
        return pipe
    kw = {"data": {}, "fsdp": dict(fsdp_params=True, fsdp_min_size=1024),
          "tp": dict(tp_params=True)}.get(layout, dict(shard_spatial=True))
    return InpaintingPipeline(pipe.model, pipe.sched, config, mesh=mesh, **kw)


def _inputs(layout):
    s = S_UNEVEN if layout == "spatial_uneven" else S
    rng = np.random.default_rng(2)
    gt = np.clip(0.5 * rng.standard_normal((B, s, s, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((B, s, s, 1), np.float32)
    mask[0, 3:11, 2:9] = mask[1, :7] = mask[2, 9:, 8:] = mask[3, 2:13, 3:9] = 1.0
    return gt, mask


# ------------------------------------------------ the two-rank job (no JAX)

def _programs(layout, mesh):
    """For each seed layout: the meshed eager call, the installed
    program's two calls and its call with a second seed, and the eager
    call with that seed."""
    pipe = _pipeline(layout, mesh)
    gt, mask = _inputs(layout)
    cfg = pipe.config.sampler
    out = {}
    for name, (seed, other) in SEEDS.items():
        batched = name == "per_row_seeds"
        res = {"eager": pipe.inpaint(gt, mask, seed)}
        program = pipe.compile_batch(B, cfg, batched_key=batched)
        pipe.install_program(B, cfg, program, batched_key=batched)
        res["replay"] = pipe.inpaint(gt, mask, seed)
        res["again"] = pipe.inpaint(gt, mask, seed)
        res["other"] = pipe.inpaint(gt, mask, other)
        assert pipe.uninstall_program(B, cfg, batched_key=batched)
        res["other_eager"] = pipe.inpaint(gt, mask, other)
        res["draws"] = len(program.draws)
        out[name] = res
    return out


def main():
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    from fidm_tpu_torch.parallel import create_mesh, multihost
    from fidm_tpu_torch.serving import aot

    assert multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    meshes = {"data": create_mesh(data=2), "fsdp": create_mesh(data=1, fsdp=2),
              "model": create_mesh(data=1, model=2)}
    out = {}
    for layout in LAYOUTS:
        out[layout] = _programs(layout, meshes.get(layout, meshes["model"]))
    try:
        aot.save_programs(_pipeline("data", meshes["data"]), os.path.join(workdir, "aot"), [B])
        out["aot"] = "saved"
    except ValueError as e:
        out["aot"] = str(e)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.barrier("done")
    print("MP_OK", rank, flush=True)


# ------------------------------------------------------------- the tests

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both ranks' results, and the unmeshed calls computed here while the
    ranks run."""
    workdir = tmp_path_factory.mktemp("mesh_programs")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), port,
                               str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    deadline = time.time() + 150
    try:
        refs = {}
        for layout in LAYOUTS:
            pipe = _pipeline(layout)
            gt, mask = _inputs(layout)
            refs[layout] = {name: [pipe.inpaint(gt, mask, s) for s in seeds]
                            for name, seeds in SEEDS.items()}
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        for r, p in enumerate(procs):
            log = (workdir / f"rank{r}.log").read_text()
            assert p.returncode == 0 and f"MP_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
        yield refs, [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                     for r in range(2)]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()


@pytest.mark.parametrize("seeds", list(SEEDS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_installed_program_is_the_meshed_eager_call(job, layout, seeds):
    """On every rank the installed program gives the meshed eager call's
    whole batch bit for bit (twice, and refilled for a second seed), which
    is the unmeshed call's within 1e-4 with the known pixels exact."""
    refs, ranks = job
    gt, mask = (torch.from_numpy(a) for a in _inputs(layout))
    keep = mask[..., 0] < 0.5
    for res in ranks:
        got = res[layout][seeds]
        assert got["draws"] > 0
        for name in ("replay", "again"):
            assert torch.equal(got[name], got["eager"]), name
        assert torch.equal(got["other"], got["other_eager"])
        assert not torch.equal(got["other"], got["eager"])
        for out, ref in zip((got["eager"], got["other"]), refs[layout][seeds]):
            assert out.shape == ref.shape
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-4)
            assert torch.equal(out[keep], gt[keep])


def test_program_cache_still_refuses_a_mesh(job):
    """`serving.aot.save_programs` refuses a meshed pipeline, as the JAX
    package's program cache does, while `compile_batch` builds its
    programs."""
    for res in job[1]:
        assert "single-host pipelines only" in res["aot"], res["aot"]


if __name__ == "__main__":
    main()
