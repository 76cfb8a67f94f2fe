"""Sampling programs: one whole `inpaint_sample` call over static buffers,
captured as a CUDA graph.

The port's counterpart of the XLA executable that the JAX pipeline compiles
for one batch shape (`compile_batch`): a program is built for one (batch,
SamplerConfig, seed layout) and holds

- static `gt` and `mask` buffers;
- the sampler's tables on the device, uploaded once, outside any graph (a
  captured host-to-device copy would read the same pinned host buffer at
  every replay, long after the allocator has handed it to someone else);
- one buffer per noise draw the call makes, by (stream, index);
- on CUDA, a `torch.cuda.CUDAGraph` of the call and its output.

Building it runs the call once eagerly over the buffers, on CUDA on a side
stream (the warm-up that PyTorch's graph docs ask for: it also builds the
attention kernel's library and cuDNN's plans). That run records the draws:
every decision of the sampler loop is taken on the host from the tables, so
the same draws come at every call. On CUDA the call is then captured, in
`capture_error_mode="thread_local"`, so that another thread of the process (a
server's dispatcher) may use CUDA while this one captures. A failed capture
raises; nothing runs in its place.

Calling the program copies `gt` and `mask` in, fills every draw's buffer with
exactly the tensor `GeneratorNoise(seed)` gives for that (stream, index)
(`GeneratorNoise.fill`; the draws stay outside the graph, since each seeds a
fresh generator on the host), replays the graph and returns a clone of the
output, so that the next replay cannot overwrite what a caller still holds.
Every step of that is queued on the caller's current stream, in order. A
replay runs the same kernels on the same values as the eager call, so it
gives its output bit for bit. A replay adds to `ops.LAUNCHES` the launches its
capture recorded; the capture itself launches nothing and counts nothing. On
the CPU (only where a caller named it, as the tests do) there is no graph:
the call runs eagerly over the same buffers.

A graph holds the addresses of the model's parameters. A program stays valid
while they stay where they are: `load_state_dict` copies in place and keeps
them, `model.to(...)` moves them (`InpaintingPipeline.cast_params` drops
every program for that reason).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Tuple

import torch

from ..ops.registry import LAUNCHES
from .sampler import GeneratorNoise, _to_device_xs

__all__ = ["SamplingProgram"]


class _StaticNoise:
    """The noise source of a program's call: one buffer per (stream, index)
    draw. Recording, a draw not seen before gets a new buffer, filled by the
    GeneratorNoise `record`; otherwise such a draw raises."""

    def __init__(self, draws: Dict[Tuple[int, int], torch.Tensor], device,
                 record: GeneratorNoise = None):
        self.draws, self.device, self.record = draws, device, record

    def _get(self, stream: int, index: int, shape) -> torch.Tensor:
        key = (stream, int(index))
        buf = self.draws.get(key)
        if buf is None:
            if self.record is None:
                raise RuntimeError(f"the program's call asked for draw {key}, which its "
                                   "recording run did not make")
            buf = self.draws[key] = self.record.fill(
                stream, index, torch.empty(tuple(shape), device=self.device,
                                           dtype=torch.float32))
        elif buf.shape != tuple(shape):
            raise RuntimeError(f"draw {key}: shape {tuple(shape)}, recorded {tuple(buf.shape)}")
        return buf

    def init(self, shape):
        return self._get(0, 0, shape)

    def step(self, index, shape):
        return self._get(1, index, shape)

    def inject(self, timestep, shape):
        return self._get(2, timestep, shape)


def _clone(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class SamplingProgram:
    """`run(gt, mask, noise, device_tables)`, one `inpaint_sample` call,
    bound to static buffers for inputs of `gt_shape` and seeds of one
    layout (`batched_key`: B per-row seeds, else one int). `tables` are the
    sampler's host tables, `example_seed` the seed of the recording run."""

    def __init__(self, run: Callable, tables: Dict, gt_shape, device, batched_key: bool,
                 example_seed):
        self.batched_key = batched_key
        self.device = torch.device(device)
        self.graph = None
        self.launches: collections.Counter = collections.Counter()
        self._sample = run
        b, h, w, _ = gt_shape
        with torch.inference_mode():
            self.gt = torch.zeros(tuple(gt_shape), device=self.device)
            self.mask = torch.zeros((b, h, w, 1), device=self.device)
            self.tables = _to_device_xs(tables, self.device)
            self.draws: Dict[Tuple[int, int], torch.Tensor] = {}
            t0 = time.perf_counter()
            self._record(GeneratorNoise(example_seed, self.device))
            # seconds of the recording run, and of the capture
            self.record_s = time.perf_counter() - t0
            if self.device.type == "cuda":
                self._capture()
            self.capture_s = time.perf_counter() - t0 - self.record_s

    def _record(self, noise: GeneratorNoise):
        """The recording run: the call once, eagerly, over the buffers, each
        draw's buffer made and filled from `noise` when first asked for; on
        CUDA on a side stream."""
        record = _StaticNoise(self.draws, self.device, noise)
        if self.device.type != "cuda":
            self._run(record)
            return
        home = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(home)
        with torch.cuda.stream(side):
            self._run(record)
        home.wait_stream(side)
        # the draws were allocated on the side stream and are used on the
        # caller's: none is reused before that stream's work on it ends
        for buf in self.draws.values():
            buf.record_stream(home)
        torch.cuda.synchronize(self.device)

    def _capture(self):
        before = collections.Counter(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.out = self._run(_StaticNoise(self.draws, self.device))
        finally:
            # the capture launched nothing: what it counted is a replay's
            launched = collections.Counter(LAUNCHES)
            launched.subtract(before)
            self.launches = +launched
            LAUNCHES.clear()
            LAUNCHES.update(before)
        self.graph = graph

    def _run(self, noise):
        # a method, not a closure over self: a dropped program (uninstalled,
        # or by cast_params) frees its graph's pool at once, not at the next
        # garbage collection
        return self._sample(self.gt, self.mask, noise, self.tables)

    @property
    def static_bytes(self) -> int:
        """Bytes of the buffers the program holds outside its graph's pool:
        inputs, tables and draws."""
        return (self.gt.nbytes + self.mask.nbytes + sum(t.nbytes for t in self.tables.values())
                + sum(t.nbytes for t in self.draws.values()))

    def __call__(self, gt: torch.Tensor, mask: torch.Tensor, seed):
        """The call on `gt` [B,H,W,3] and `mask` [B,H,W,1], on the program's
        device, with the noise of `GeneratorNoise(seed)`; returns new tensors."""
        noise = GeneratorNoise(seed, self.device)
        if (noise.seeds is not None) != self.batched_key:
            layout = "per-row seeds" if self.batched_key else "one seed"
            raise ValueError(f"this program takes {layout}, got {seed!r}")
        with torch.inference_mode():
            self.gt.copy_(gt)
            self.mask.copy_(mask)
            for (stream, index), buf in self.draws.items():
                noise.fill(stream, index, buf)
            if self.graph is None:
                return _clone(self._run(_StaticNoise(self.draws, self.device)))
            self.graph.replay()
            LAUNCHES.update(self.launches)
            return _clone(self.out)
