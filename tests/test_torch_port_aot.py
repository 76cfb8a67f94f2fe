"""The port's warm program cache (`fidm_tpu_torch/serving/aot.py`), the
server's warm-up over it and the CLIs' `--program_cache`, against the JAX
package's contract (tests/test_serving.py's AOT tests and
tests/test_batched_keys.py's key layouts).

The JAX cache holds executables; the port's holds one manifest per program,
since a CUDA graph does not outlive its process: `save_programs` builds and
installs a program and writes its manifest, `load_programs` builds the
programs its manifests list. On the CPU a program runs the eager call over
its static buffers, so that dispatch, manifests, fingerprints and healing
are all exercised here; the graphs are held on the card
(tests/test_torch_port_cuda.py, `chip_smoke.py` [11]).

The model is SMALL-width with its zero-initialised output convs re-drawn.
Torch and BLAS run one thread; every server is closed in `finally`.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.cli import evaluate as evaluate_cli
from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.sampling import SamplerConfig
from fidm_tpu_torch.sampling.program import SamplingProgram
from fidm_tpu_torch.serving import InpaintingServer, aot, serve

from _torch_port_common import PCFG, SMALL

S = SMALL["image_size"]
CONFIG = PipelineConfig(unet=PCFG, schedule="linear", num_timesteps=50,
                        sampler=SamplerConfig(method="ddim", num_steps=4, eta=0.9,
                                              injection=True))
RESULT_S = 120  # seconds a test waits for one result


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    pipe = InpaintingPipeline.create(CONFIG, device="cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        for m in pipe.model.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and not m.weight.any():
                m.reset_parameters()
    return pipe.model, pipe.sched


def _fresh(model, config=CONFIG):
    """A pipeline over the same model and schedule with no program installed:
    a process restarted on the same checkpoint."""
    return InpaintingPipeline(model[0], model[1], config)


def _inputs(seed, b=1):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, S, S, 3)).astype(np.float32)
    mask = np.zeros((b, S, S, 1), np.float32)
    mask[:, 4:12, 4:12] = 1.0
    return gt, mask


def _spy_programs(monkeypatch):
    """Count the calls of every program (each runs its `_run` once on the
    CPU)."""
    calls = []
    real = SamplingProgram.__call__

    def spy(self, *a, **kw):
        calls.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(SamplingProgram, "__call__", spy)
    return calls


def _manifests(directory):
    return sorted(p.name for p in directory.glob("prog_b*.json"))


def test_program_cache_round_trip(model, tmp_path, monkeypatch):
    """Save writes 1 manifest, then 0; a fresh pipeline over the same model
    loads 1, and `inpaint` dispatches to it, bit-equal to the eager call."""
    pipe1 = _fresh(model)
    gt, mask = _inputs(11)
    ref = pipe1.inpaint(gt, mask, 3)
    assert aot.save_programs(pipe1, str(tmp_path), [1]) == 1
    assert aot.save_programs(pipe1, str(tmp_path), [1]) == 0  # the manifest exists
    assert pipe1.installed_program(1, CONFIG.sampler) is not None  # save installs
    manifest = json.loads((tmp_path / _manifests(tmp_path)[0]).read_text())
    assert manifest["batch"] == 1 and manifest["key_layout"] == "single"
    assert manifest["device"] == "cpu" and manifest["torch"] == torch.__version__
    assert manifest["fingerprint"] in _manifests(tmp_path)[0]

    pipe2 = _fresh(model)
    assert aot.load_programs(pipe2, str(tmp_path), [1, 2]) == 1  # no batch-2 entry
    calls = _spy_programs(monkeypatch)
    out = pipe2.inpaint(gt, mask, 3)
    assert len(calls) == 1
    assert torch.equal(out, ref)
    # loading again keeps the installed program
    program = pipe2.installed_program(1, CONFIG.sampler)
    assert aot.load_programs(pipe2, str(tmp_path), [1]) == 1
    assert pipe2.installed_program(1, CONFIG.sampler) is program


def test_fingerprint_separates_sampler_dtype_and_seed_layout(model, tmp_path):
    """A manifest never loads for another sampler config, a cast_params(bf16)
    pipeline or the other seed layout: each is another program."""
    pipe = _fresh(model)
    assert aot.save_programs(pipe, str(tmp_path), [1]) == 1
    other = SamplerConfig(method="ddim", num_steps=3, eta=0.0)
    assert aot.load_programs(pipe, str(tmp_path), [1], sampler=other) == 0
    assert aot.load_programs(pipe, str(tmp_path), [1], batched_key=True) == 0
    paths = {aot.program_path(str(tmp_path), pipe, 1),
             aot.program_path(str(tmp_path), pipe, 1, sampler=other),
             aot.program_path(str(tmp_path), pipe, 1, batched_key=True),
             aot.program_path(str(tmp_path), pipe, 2)}
    assert len(paths) == 4
    unet = InpaintingPipeline.create(CONFIG, device="cpu").model
    unet.load_state_dict(model[0].state_dict())
    bf16 = InpaintingPipeline(unet, model[1], CONFIG).cast_params(torch.bfloat16)
    assert aot.program_path(str(tmp_path), bf16, 1) not in paths
    assert aot.load_programs(bf16, str(tmp_path), [1]) == 0
    assert _manifests(tmp_path) == [os.path.basename(aot.program_path(str(tmp_path), pipe, 1))]


def test_seed_layouts_are_separate_programs(model, tmp_path, monkeypatch):
    """A per-row-seed program loads and runs only for per-row seeds, bit-equal
    to the eager call; a one-seed call on the same pipeline runs eagerly."""
    pipe1 = _fresh(model)
    gt, mask = _inputs(12)
    ref = pipe1.inpaint(gt, mask, [9])
    assert aot.save_programs(pipe1, str(tmp_path), [1], batched_key=True) == 1
    assert aot.load_programs(pipe1, str(tmp_path), [1], batched_key=False) == 0

    pipe2 = _fresh(model)
    assert aot.load_programs(pipe2, str(tmp_path), [1], batched_key=True) == 1
    calls = _spy_programs(monkeypatch)
    assert torch.equal(pipe2.inpaint(gt, mask, [9]), ref)
    assert len(calls) == 1
    single = pipe2.inpaint(gt, mask, 9)
    assert len(calls) == 1  # the per-row-seed program did not take it
    assert torch.isfinite(single).all()


@pytest.mark.parametrize("damage", ["garbage", "wrong_content", "not_a_dict"])
def test_corrupt_entry_is_removed_and_healed(model, tmp_path, damage):
    """An unreadable or malformed manifest is removed, so the next save
    writes it again, and the load after that installs the program."""
    pipe = _fresh(model)
    assert aot.save_programs(pipe, str(tmp_path), [1]) == 1
    path = aot.program_path(str(tmp_path), pipe, 1)
    with open(path, "wb") as f:
        f.write({"garbage": b"\xff not json",
                 "wrong_content": json.dumps({"format": 1, "batch": 1}).encode(),
                 "not_a_dict": b"[1, 2]"}[damage])
    assert aot.load_programs(_fresh(model), str(tmp_path), [1]) == 0
    assert not os.path.exists(path)
    assert aot.save_programs(pipe, str(tmp_path), [1]) == 1
    assert aot.load_programs(_fresh(model), str(tmp_path), [1]) == 1


def test_server_restart_rides_program_cache(model, tmp_path, monkeypatch):
    """The first warm-up writes a manifest per (preset, batch size) and runs
    every batch through a program; a restarted server over the same model
    loads them all, writes none, and answers bit-equal to the eager
    pipeline at batch 1 with the request's seed."""
    presets = {"ddim": CONFIG.sampler,
               "dpm": SamplerConfig(method="dpm++2m-sde", num_steps=3, injection=True)}
    calls = _spy_programs(monkeypatch)
    s1 = InpaintingServer(_fresh(model), batch_size=2, max_wait_ms=5, presets=presets,
                          program_cache_dir=str(tmp_path))
    try:
        s1.warmup()
    finally:
        s1.close()
    written = _manifests(tmp_path)
    assert len(written) == 4 and len(calls) == 4  # 2 presets x batch sizes 1, 2
    stamps = {n: (tmp_path / n).stat().st_mtime_ns for n in written}

    pipe2 = _fresh(model)
    s2 = InpaintingServer(pipe2, batch_size=2, max_wait_ms=5, presets=presets,
                          program_cache_dir=str(tmp_path))
    try:
        s2.warmup()
        assert len(calls) == 8
        assert all(pipe2.installed_program(b, cfg, True) is not None
                   for b in (1, 2) for cfg in presets.values())
        gt, mask = _inputs(2)
        out = s2.submit(gt[0], mask[0], seed=3, preset="dpm").result(timeout=RESULT_S)
        assert len(calls) == 9
    finally:
        s2.close()
    assert _manifests(tmp_path) == written
    assert {n: (tmp_path / n).stat().st_mtime_ns for n in written} == stamps
    ref = _fresh(model).inpaint(gt, mask, [3], sampler=presets["dpm"]).numpy()[0]
    assert np.array_equal(out, ref)


def test_warmup_heals_a_program_that_fails_to_run(model, tmp_path, monkeypatch):
    """A loaded program that raises when it runs is uninstalled, its manifest
    removed and written again, and the program built once more; if the new
    one fails too, the warm-up raises."""
    aot.save_programs(_fresh(model), str(tmp_path), [1], batched_key=True)
    name = _manifests(tmp_path)
    failures = []
    real = SamplingProgram.__call__

    def flaky(self, *a, **kw):
        if len(failures) < budget[0]:
            failures.append(self)
            raise RuntimeError("replay failed")
        return real(self, *a, **kw)

    monkeypatch.setattr(SamplingProgram, "__call__", flaky)
    budget = [1]
    pipe = _fresh(model)
    server = InpaintingServer(pipe, batch_size=1, program_cache_dir=str(tmp_path))
    try:
        server.warmup()
    finally:
        server.close()
    healed = pipe.installed_program(1, CONFIG.sampler, True)
    assert len(failures) == 1 and healed is not None and healed is not failures[0]
    assert _manifests(tmp_path) == name

    budget[0] = 3  # the program built again fails as well
    server = InpaintingServer(_fresh(model), batch_size=1, program_cache_dir=str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="replay failed"):
            server.warmup()
    finally:
        server.close()
    assert len(failures) == 3


def test_serve_and_cli_take_the_program_cache(model, tmp_path):
    """`serve(..., program_cache_dir=)` warms through the directory, and
    `cli.serve --program_cache` parses to it."""
    args = serve_cli.parse_args(["--program_cache", str(tmp_path)])
    assert args.program_cache == str(tmp_path)
    httpd, dispatcher = serve(_fresh(model), port=0, batch_size=1, warmup=True,
                              program_cache_dir=args.program_cache)
    try:
        assert len(_manifests(tmp_path)) == 1
        assert dispatcher.program_cache_dir == str(tmp_path)
    finally:
        httpd.server_close()
        dispatcher.close()


TINY = ["--image_size", str(S), "--model_channels", str(SMALL["model_channels"]),
        "--channel_mult", *map(str, SMALL["channel_mult"]), "--num_heads",
        str(SMALL["num_heads"]), "--num_head_channels", str(SMALL["num_head_channels"]),
        "--attention_resolutions", "2", "--diffusion_steps", "50", "--dtype", "f32"]


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    """6 smooth PNGs and a `test/` mask dir with a box (black = hole)."""
    root = tmp_path_factory.mktemp("aot_eval_data")
    img_dir, mask_dir = root / "images", root / "masks" / "test"
    img_dir.mkdir()
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:S, :S] / S
    for i in range(6):
        base = np.stack([np.sin(3 * yy + i), np.cos(2 * xx - i), yy * xx], -1)
        arr = np.clip(127.5 + 90 * base + rng.normal(0, 12, base.shape), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(img_dir / f"img_{i}.png")
    box = np.full((S, S), 255, np.uint8)
    box[4:12, 3:11] = 0
    Image.fromarray(box).save(mask_dir / "mask_0.png")
    return str(img_dir), str(root / "masks")


def test_evaluate_cli_program_cache(data_tree, tmp_path, monkeypatch, capsys):
    """`cli.evaluate --program_cache` (no longer refused): the first run
    writes the program's manifest, a second loads it, and every batch, the
    padded last one too, runs through the program; `metrics.json` equals
    the run without the flag but for the timings."""
    img_dir, mask_dir = data_tree
    cache = tmp_path / "cache"

    def run(name, *extra):
        out = tmp_path / name
        evaluate_cli.main(["--data_dir", img_dir, "--mask_dir", mask_dir, "--output_dir",
                           str(out), "--no_save_images", "--num_samples", "6",
                           "--batch_size", "4", "--ddim_timesteps", "4", "--device", "cpu",
                           *TINY, *extra])
        blob = json.loads((out / "metrics.json").read_text())
        for k in ("time_per_sample_s", "time_per_sample_steady_s"):
            blob.pop(k)
        return blob

    plain = run("plain")
    calls = _spy_programs(monkeypatch)
    first = run("first", "--program_cache", str(cache))
    assert "program cache: 0 loaded, 1 compiled+saved" in capsys.readouterr().out
    second = run("second", "--program_cache", str(cache))
    assert "program cache: 1 loaded, 0 compiled+saved" in capsys.readouterr().out
    assert len(calls) == 4  # 2 batches (6 samples: 4, then 2 padded to 4) per run
    assert len(_manifests(cache)) == 1
    assert first == plain and second == plain
