"""The warm program cache of the serving layer (PyTorch port).

Counterpart of `fidm_tpu/serving/aot.py`, with its functions, signatures and
return counts. The JAX package pickles compiled XLA executables, so that a
restart loads them instead of compiling. The port's programs are CUDA graphs
(`InpaintingPipeline.compile_batch`, `sampling/program.py`), and a CUDA graph
does not outlive its process: it holds device addresses of this process's
allocations. So the directory holds no program. It holds one small JSON
manifest per program, `prog_b{batch}_{fp}.json`, whose `fp` and content are
the fingerprint of everything that would change the program or make it
unsafe to run: torch and CUDA versions, the device's name and count, the UNet
and sampler configs, schedule, `rescale_timesteps`, batch, seed layout and
every parameter's name, shape and dtype. There is no pickle.

What the directory saves a restart: the list of programs to build before the
first request, checked against this process's software, device and model.
What a restart still pays: the build of every listed program, one eager call
and one capture each. For the server of `chip_smoke.py` [11] (four presets at
batch sizes 1, 4 and 8 on the FFHQ-256 model) that was 68-76 s on an H100
80GB HBM3 at 700 W, against 23-24 s for its eager warm-up (PERF.md). The
kernels' nvcc libraries stay cached by `ops/build.py`, as before.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import torch

__all__ = ["program_path", "save_programs", "load_programs"]

_FORMAT_VERSION = 1


def _manifest(pipeline, batch: int, cfg, batched_key: bool = False) -> dict:
    """A program's entry: everything that would change the program, or make
    it unsafe to run, and the fingerprint of all that."""
    device = pipeline.device
    cuda = device.type == "cuda"
    payload = {
        "format": _FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(device) if cuda else device.type,
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "unet": repr(pipeline.config.unet),
        "schedule": [pipeline.config.schedule, pipeline.config.num_timesteps],
        "rescale_timesteps": pipeline.config.rescale_timesteps,
        "sampler": repr(cfg),
        "batch": batch,
        # per-row seeds and one seed are other programs
        "key_layout": "batched" if batched_key else "single",
        "variables": [[name, list(t.shape), str(t.dtype)]
                      for name, t in pipeline.model.state_dict().items()],
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return {**payload, "fingerprint": hashlib.sha256(blob).hexdigest()[:20]}


def _fingerprint(pipeline, batch: int, cfg, batched_key: bool = False) -> str:
    """Identity of one program (see `_manifest`)."""
    return _manifest(pipeline, batch, cfg, batched_key)["fingerprint"]


def program_path(cache_dir: str, pipeline, batch: int, sampler=None,
                 batched_key: bool = False) -> str:
    cfg = sampler or pipeline.config.sampler
    fp = _fingerprint(pipeline, batch, cfg, batched_key)
    return os.path.join(cache_dir, f"prog_b{batch}_{fp}.json")


def save_programs(pipeline, cache_dir: str, batch_sizes, sampler=None,
                  overwrite: bool = False, batched_key: bool = False) -> int:
    """Build and install the program of each batch size whose manifest is
    not on disk yet (or every one with `overwrite`), and write its manifest
    atomically. Returns the number of manifests written."""
    os.makedirs(cache_dir, exist_ok=True)
    cfg = sampler or pipeline.config.sampler
    written = 0
    for batch in batch_sizes:
        path = program_path(cache_dir, pipeline, batch, cfg, batched_key)
        if os.path.exists(path) and not overwrite:
            continue
        if overwrite or pipeline.installed_program(batch, cfg, batched_key) is None:
            pipeline.install_program(batch, cfg, pipeline.compile_batch(batch, cfg, batched_key),
                                     batched_key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_manifest(pipeline, batch, cfg, batched_key), f, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers never see a partial file
        written += 1
    return written


def load_programs(pipeline, cache_dir: str, batch_sizes, sampler=None,
                  batched_key: bool = False) -> int:
    """Build and install the program of every batch size whose manifest
    matches this pipeline (a program already installed is kept). A batch
    without an entry is skipped (another fingerprint is another file); an
    unreadable or malformed entry is removed,
    so that the next `save_programs` writes it again. Returns the number of
    programs installed from the directory."""
    cfg = sampler or pipeline.config.sampler
    loaded = 0
    for batch in batch_sizes:
        path = program_path(cache_dir, pipeline, batch, cfg, batched_key)
        if not os.path.exists(path):
            continue
        expect = _manifest(pipeline, batch, cfg, batched_key)
        problem: Optional[str] = None
        try:
            with open(path) as f:
                if json.load(f) != expect:
                    problem = "malformed"
        except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
            problem = f"unreadable ({e})"
        if problem is not None:
            print(f"program cache: dropping {problem} {path}")
            try:
                os.remove(path)
            except OSError:
                pass
            continue
        if pipeline.installed_program(batch, cfg, batched_key) is None:
            pipeline.install_program(batch, cfg, pipeline.compile_batch(batch, cfg, batched_key),
                                     batched_key)
        loaded += 1
    return loaded
