"""Batched inpainting inference server (PyTorch port).

Counterpart of `fidm_tpu/serving/server.py`, with the same protocol and
behaviour: an HTTP endpoint that micro-batches concurrent inpainting requests
into device batches of a few fixed sizes, runs them through the pipeline, and
answers each request with its own result.

Protocol (POST /inpaint):
  body: npz with `image` [H,W,3] float32 in [-1,1] and `mask` [H,W,1]
        (1 = hole); optional scalar `seed`; optional string `preset`, one of
        the server's sampler presets (quality tiers from the same weights);
        optional `timeout_ms`, a deadline past which the request is shed.
  response: npz with `image` [H,W,3], the inpainted result, and `seed`, the
        seed that produced it (explicit or server-assigned): replaying
        (image, mask, seed, preset) reproduces the pixels. The image dtype
        follows the preset's SamplerConfig.output_dtype: float32 in [-1,1]
        (default), or uint8 in [0,255] (the reference's toU8, quantized on
        the device, so the download and the payload shrink 4x).
  errors: 400 for a malformed request, 429 when the queue is full, 504 when
        a request's deadline passes before it starts.
GET /healthz returns {"status": "ok", "batch_size": N, "presets": [...], ...}.

Design: request threads enqueue (arrays, Future); one dispatcher thread
drains up to `batch_size` requests OF ONE PRESET (other presets keep their
queue positions and form the next batches), picks the smallest size of the
`batch_sizes` ladder that fits, pads the tail with repeats, runs the
pipeline and resolves the futures. Seeds default to a per-request counter,
and every batch passes one seed per row (`GeneratorNoise` with a sequence of
seeds), so a request's noise depends only on its own seed, never on what
else shares its batch.

The batching wait is load-adaptive: the `max_wait_ms` window is armed only
while the previous dispatch filled the top batch size; at low load a lone
request dispatches at once.

Launch and download are decoupled: CUDA launches are asynchronous, so the
dispatcher launches up to `max_inflight` batches (assemble, upload by a
pinned non-blocking copy, enqueue every kernel) before it blocks on the
oldest one's download, the one `.cpu()` of a batch. Pad rows are sliced off
on the device. Response encoding runs on the HTTP handler threads.
`instrument=True` fences each phase with `torch.cuda.synchronize()` and times
it into stats["phases_ms"] (assemble / upload / dispatch / execute /
download); fencing serializes, so it forces max_inflight=1.

With `program_cache_dir` the warm-up installs a program (a CUDA graph of one
whole sampler call, `InpaintingPipeline.compile_batch`) for every (preset,
batch size) and keeps their manifests there (`serving/aot.py`); every batch
then replays one. The programs are captured in thread-local capture mode, so
the dispatcher thread may wait on its queue meanwhile.

The sampler loop is Python on the host, and the dispatcher, the HTTP handler
threads and any client threads in the same process share the interpreter
lock. The server never catches a launch failure to retry elsewhere: the
batch's requests fail with the error.
"""
from __future__ import annotations

import collections
import copy
import io
import itertools
import json
import os
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["InpaintingServer", "serve", "ServerOverloadedError",
           "DeadlineExceededError"]


class ServerOverloadedError(RuntimeError):
    """Queue depth hit max_queue — the request was REJECTED at submit time
    (HTTP 429), not silently enqueued behind an unbounded backlog."""


class DeadlineExceededError(RuntimeError):
    """The request waited in the queue past its deadline and was shed
    before running (HTTP 504) — stale work never occupies the device."""


class _Request:
    __slots__ = ("image", "mask", "seed", "preset", "future", "deadline")

    def __init__(self, image, mask, seed, preset, deadline=None):
        self.image = image
        self.mask = mask
        self.seed = seed
        self.preset = preset
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.future: Future = Future()


class InpaintingServer:
    """Micro-batching dispatcher around an InpaintingPipeline."""

    def __init__(self, pipeline, batch_size: int = 8,
                 max_wait_ms: float = 20.0,
                 batch_sizes: Optional[tuple] = None,
                 base_seed: int = 0,
                 program_cache_dir: Optional[str] = None,
                 compress_responses: bool = False,
                 adaptive_wait: bool = True,
                 presets: Optional[Dict] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 max_inflight: int = 2,
                 instrument: bool = False):
        self.pipeline = pipeline
        # warm programs (serving/aot.py): built and installed by warmup()
        self.program_cache_dir = program_cache_dir
        # sampler quality tiers served side by side: name -> SamplerConfig.
        # The FIRST entry is the default for requests that name none; a
        # device batch only ever carries one preset.
        if presets is None:
            presets = {"default": pipeline.config.sampler}
        if not presets:
            raise ValueError("presets must not be empty")
        for name, cfg in presets.items():
            if getattr(cfg, "trajectory_every", 0):
                # the sampler then returns (images, trajectory) and the
                # dispatcher's batch slicing would operate on the tuple —
                # a misconfiguration better rejected at construction than
                # surfaced as confusing 500s per request
                raise ValueError(
                    f"preset {name!r} sets trajectory_every="
                    f"{cfg.trajectory_every}; trajectory emission is not "
                    "servable (use the pipeline API for debugging runs)")
            if getattr(cfg, "output_dtype", "float32") not in ("float32",
                                                               "uint8"):
                # reject at construction instead of as a 500 at first
                # request
                raise ValueError(
                    f"preset {name!r}: output_dtype must be 'float32' or "
                    f"'uint8', got {cfg.output_dtype!r}")
        self.presets = dict(presets)
        self.default_preset = next(iter(self.presets))
        # zlib over float32 image data buys little (<2x) and costs tens of
        # ms of single-core CPU per response — off by default
        self.compress_responses = compress_responses
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        # batch-size ladder: the smallest size >= queue depth is used, so a
        # single shallow request runs at batch 1, not padded to batch 8
        if batch_sizes is None:
            batch_sizes, s = [], 1
            while s < batch_size:
                batch_sizes.append(s)
                s *= 2
            batch_sizes.append(batch_size)
        self.batch_sizes = tuple(sorted(set(batch_sizes)))
        if self.batch_sizes[-1] != batch_size:
            raise ValueError("batch_sizes must include batch_size")
        self.base_seed = base_seed
        self._seed_counter = itertools.count(1)  # atomic in CPython
        # OVERLOAD POLICY: the queue is bounded —
        # submit raises ServerOverloadedError (HTTP 429) past max_queue
        # instead of growing an unbounded backlog every client then waits
        # out; requests carry an optional deadline and are SHED (HTTP 504)
        # if they'd start past it, so a burst never makes the device chew
        # through work nobody is waiting for anymore.
        if max_queue is None:
            max_queue = max(64, 8 * batch_size)
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        # pending requests: a deque under a condition variable (instead of
        # queue.Queue) so the dispatcher can drain BY PRESET without
        # reordering other presets' requests
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._cv = threading.Condition()
        # stats are mutated by the dispatcher AND submit threads; the lock
        # keeps multi-key snapshots (healthz) from reading torn state
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "rejected": 0, "shed": 0,
                      "batches_by_size": {s: 0 for s in self.batch_sizes},
                      "requests_by_preset": {p: 0 for p in self.presets}}
        self._stop = threading.Event()
        # True while the dispatcher holds an accepted-but-unresolved batch
        # (set under _cv when the batch forms; cleared when its futures are
        # resolved) — drain() polls it to know "queue empty" means "done"
        self._busy = False
        # adaptive_wait=True arms the max_wait_ms window only under
        # saturation (see module docstring); False always waits it out,
        # useful when clients are known to arrive in synchronized bursts
        # from a cold dispatcher
        self.adaptive_wait = adaptive_wait
        # True after a dispatch that filled the top batch size — the signal
        # that arrivals outpace the device and the accumulation window pays
        self._saturated = False
        # DOUBLE-BUFFERED STAGING: CUDA launches are asynchronous; only the
        # result download blocks. The dispatcher therefore LAUNCHES up to
        # max_inflight batches (assemble + upload + enqueue, non-blocking)
        # before it sits down to download the oldest: batch i+1's host work
        # and upload overlap batch i's device execution. max_inflight=1 is
        # the serial loop. `instrument=True` fences every phase (upload /
        # execute / download become separately timed, reported in
        # stats["phases_ms"]), a measurement mode; fencing serializes, so it
        # forces max_inflight=1.
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.instrument = instrument
        self.max_inflight = 1 if instrument else max_inflight
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, mask: np.ndarray,
               seed: Optional[int] = None,
               preset: Optional[str] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request; returns its Future (whose `request_seed`
        attribute carries the assigned seed, the complete RNG contract under
        per-request seeds).

        Raises ServerOverloadedError when the queue is at max_queue.
        `deadline_s` (seconds from now; default = server default_deadline_s,
        None = never) sheds the request with DeadlineExceededError if it
        would START past the deadline."""
        S = self.pipeline.config.unet.image_size
        image = np.asarray(image)
        mask = np.asarray(mask)
        for name, a in (("image", image), ("mask", mask)):
            # dtype spoofing (strings/objects) would raise TypeError from
            # np.isfinite below — a 500 to the client instead of a 400
            if not np.issubdtype(a.dtype, np.number) or np.issubdtype(
                    a.dtype, np.complexfloating):
                raise ValueError(
                    f"{name} must be real numeric, got dtype {a.dtype}")
        if image.shape != (S, S, 3):
            raise ValueError(f"image must be [{S},{S},3], got {image.shape}")
        if mask.shape != (S, S, 1):
            raise ValueError(f"mask must be [{S},{S},1], got {mask.shape}")
        if not (np.isfinite(image).all() and np.isfinite(mask).all()):
            # NaN/Inf inputs would propagate through the sampler and come
            # back as a 200 full of NaNs — a client error, caught here
            raise ValueError("image/mask must be finite (no NaN/Inf)")
        if preset is None:
            preset = self.default_preset
        elif preset not in self.presets:
            raise ValueError(
                f"unknown preset {preset!r}; this server offers "
                f"{sorted(self.presets)}")
        if seed is None:
            # deterministic by default: base_seed + arrival index
            seed = self.base_seed + next(self._seed_counter)
        seed = int(seed)
        if not 0 <= seed < 2**32:
            # the documented client contract (the JAX server's PRNGKey seed
            # range); reject up front as a client error
            raise ValueError(f"seed must be in [0, 2**32), got {seed}")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _Request(np.asarray(image, np.float32),
                       np.asarray(mask, np.float32), seed, preset, deadline)
        # reproducibility echo: clients that let the server assign the
        # default (arrival-counter) seed can read it back and replay the
        # request (per-request seeds make the seed the complete RNG
        # contract). The HTTP layer returns it in the npz.
        req.future.request_seed = seed
        with self._cv:
            if len(self._pending) >= self.max_queue:
                # already-expired entries are dead weight (they would be
                # shed at dispatch anyway) — purge them NOW so corpses
                # never cause 429s for live requests
                now = time.monotonic()
                expired = [r for r in self._pending
                           if r.deadline is not None and now > r.deadline]
                if expired:
                    dead = set(map(id, expired))
                    self._pending = collections.deque(
                        r for r in self._pending if id(r) not in dead)
                    with self._stats_lock:
                        self.stats["shed"] += len(expired)
                    for r in expired:
                        if not r.future.done():
                            r.future.set_exception(DeadlineExceededError(
                                "request expired in queue; shed at "
                                "admission of newer work"))
            if len(self._pending) >= self.max_queue:
                with self._stats_lock:
                    self.stats["rejected"] += 1
                raise ServerOverloadedError(
                    f"queue full ({self.max_queue} pending); retry later")
            self._pending.append(req)
            self._cv.notify()
        return req.future

    def stats_snapshot(self) -> dict:
        """A consistent copy of the counters plus the live queue depth."""
        with self._stats_lock:
            # deep: phases_ms holds a dict per phase that later batches add to
            snap = copy.deepcopy(self.stats)
        with self._cv:
            snap["queue_depth"] = len(self._pending)
        return snap

    def _shed_expired(self, batch):
        """Fail (don't run) batch members already past their deadline;
        returns the still-live requests."""
        now = time.monotonic()
        live = []
        shed = 0
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                shed += 1
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        f"request waited {now - r.deadline:.3f}s past its "
                        "deadline; shed before running"))
            else:
                live.append(r)
        if shed:
            with self._stats_lock:
                self.stats["shed"] += shed
        return live

    def warmup(self):
        """Run every (preset, batch size) once, blocking, so that no client
        request pays a first run: the kernels' nvcc build, cuDNN's plans
        and the allocator's first blocks.

        With `program_cache_dir`, every (preset, batch size) first gets an
        installed program in the serving seed layout (per-row seeds):
        `aot.load_programs` builds those the directory lists and
        `aot.save_programs` the rest, writing their manifests; the runs
        below then replay them. A program that raises when it runs is
        uninstalled, its manifest removed, and built once more; if that
        fails too, warmup raises."""
        if self.program_cache_dir is not None:
            from . import aot

            for cfg in self.presets.values():
                n = aot.load_programs(self.pipeline, self.program_cache_dir,
                                      self.batch_sizes, sampler=cfg, batched_key=True)
                if n:
                    print(f"program cache: loaded {n}/{len(self.batch_sizes)} programs")
                aot.save_programs(self.pipeline, self.program_cache_dir,
                                  self.batch_sizes, sampler=cfg, batched_key=True)
        S = self.pipeline.config.unet.image_size
        img = np.zeros((S, S, 3), np.float32)
        msk = np.ones((S, S, 1), np.float32)

        def run(cfg, s):
            out = self.pipeline.inpaint(np.repeat(img[None], s, 0), np.repeat(msk[None], s, 0),
                                        [0] * s, sampler=cfg)
            # a one-element readback waits for the run; the batch itself
            # never crosses to the host
            out[(0,) * out.ndim].item()

        for cfg in self.presets.values():
            for s in self.batch_sizes:
                try:
                    run(cfg, s)
                except Exception as e:
                    if (self.program_cache_dir is None
                            or not self.pipeline.uninstall_program(s, cfg, batched_key=True)):
                        raise
                    from . import aot

                    try:
                        os.remove(aot.program_path(self.program_cache_dir, self.pipeline, s,
                                                   cfg, batched_key=True))
                    except OSError:
                        pass
                    print(f"program cache: the batch-{s} program failed to run ({e}); "
                          "building it again")
                    aot.save_programs(self.pipeline, self.program_cache_dir, (s,), sampler=cfg,
                                      overwrite=True, batched_key=True)
                    run(cfg, s)
        return self

    def _drain_matching(self, batch, preset):
        """Move pending same-preset requests into `batch` (caller holds
        self._cv); other presets keep their queue positions."""
        i = 0
        while len(batch) < self.batch_size and i < len(self._pending):
            if self._pending[i].preset == preset:
                batch.append(self._pending[i])
                del self._pending[i]
            else:
                i += 1

    def _dispatch_loop(self):
        # in-flight launched batches, oldest first: (batch, out_dev, n, size)
        inflight: collections.deque = collections.deque()
        while not self._stop.is_set():
            batch = None
            first = None
            with self._cv:
                if not self._pending and not inflight:
                    self._cv.wait(timeout=0.1)
                    if not self._pending:
                        continue
                if self._pending and len(inflight) < self.max_inflight:
                    first = self._pending.popleft()
                    batch = [first]
                    self._busy = True
                    # whatever already queued up (e.g. while the device ran
                    # the previous batch) joins for free, same preset only:
                    # one device batch runs one sampler configuration
                    self._drain_matching(batch, first.preset)
            if batch is not None:
                # queue drained: wait out the accumulation window only under
                # saturation — at low load an artificial wait just adds
                # max_wait_ms to every request's latency. With a batch
                # already in flight, skip it too: the device is the
                # backpressure and arrivals accumulate against it naturally.
                if len(batch) < self.batch_size and not inflight and (
                        not self.adaptive_wait or self._saturated):
                    deadline = time.perf_counter() + self.max_wait_ms / 1000.0
                    while len(batch) < self.batch_size:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            break
                        with self._cv:
                            self._drain_matching(batch, first.preset)
                            if len(batch) >= self.batch_size:
                                break
                            self._cv.wait(timeout=timeout)
                            self._drain_matching(batch, first.preset)
                self._saturated = len(batch) >= self.batch_size
                batch = self._shed_expired(batch)
                if batch:
                    # the dispatcher is the single point of failure for
                    # every in-flight request: it must survive ANY per-batch
                    # error (a dead loop would hang all future clients)
                    try:
                        inflight.append(self._launch(batch))
                    except Exception as e:
                        for r in batch:
                            if not r.future.done():
                                r.future.set_exception(e)
            if inflight:
                with self._cv:
                    more = bool(self._pending)
                # download the oldest batch when the launch pipe is full,
                # when nothing else is waiting to launch, or when this
                # iteration launched nothing — otherwise loop around and
                # overlap the next launch with this batch's execution
                if (len(inflight) >= self.max_inflight or not more
                        or batch is None):
                    self._resolve(*inflight.popleft())
            with self._cv:
                self._busy = bool(inflight)
        # shutdown: settle whatever is still in flight so no future hangs
        while inflight:
            self._resolve(*inflight.popleft())
        with self._cv:
            self._busy = False

    def _ladder_size(self, n: int) -> int:
        for s in self.batch_sizes:
            if s >= n:
                return s
        return self.batch_sizes[-1]

    def _phase(self, name: str, dt_s: float):
        with self._stats_lock:
            e = self.stats.setdefault("phases_ms", {}).setdefault(
                name, {"ms": 0.0, "n": 0})
            e["ms"] += dt_s * 1000.0
            e["n"] += 1

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device; to CUDA by a pinned,
        non-blocking copy, so that it queues behind the batch in flight
        instead of waiting for it."""
        t = torch.from_numpy(a)
        device = self.pipeline.device
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def _fence(self):
        """Wait for the device (a no-op on the CPU, whose work is done when
        its call returns)."""
        if self.pipeline.device.type == "cuda":
            torch.cuda.synchronize(self.pipeline.device)

    def _launch(self, batch):
        """Assemble, upload and enqueue one batch WITHOUT waiting for its
        execution (CUDA launches are asynchronous); returns (batch, out_dev,
        n, size) for a later `_resolve`. With instrument=True each phase is
        fenced and timed into stats["phases_ms"]."""
        t0 = time.perf_counter()
        n = len(batch)
        size = self._ladder_size(n)
        pad = size - n
        gt = np.stack([r.image for r in batch] + [batch[-1].image] * pad)
        mask = np.stack([r.mask for r in batch] + [batch[-1].mask] * pad)
        # one seed PER ROW: the sampler draws row i's noise from seed i
        # alone, so a request's noise never depends on its batch-mates.
        # Pad rows reuse the last request's seed (their output is sliced
        # off)
        seeds = [r.seed for r in batch] + [batch[-1].seed] * pad
        t1 = time.perf_counter()
        self._phase("assemble", t1 - t0)
        gt, mask = self._upload(gt), self._upload(mask)
        # the phases are fenced only without a mesh, as in the JAX server
        fence = self.instrument and getattr(self.pipeline, "mesh", None) is None
        if fence:
            self._fence()  # upload landed on the device
            t2 = time.perf_counter()
            self._phase("upload", t2 - t1)
        else:
            t2 = t1
        cfg = self.presets[batch[0].preset]
        out = self.pipeline.inpaint(gt, mask, seeds, sampler=cfg)
        if pad:
            # slice the pad rows off ON THE DEVICE: the download carries
            # only the real results
            out = out[:n]
        t3 = time.perf_counter()
        self._phase("dispatch", t3 - t2)
        if fence:
            self._fence()  # executed
            self._phase("execute", time.perf_counter() - t3)
        return batch, out, n, size

    def _resolve(self, batch, out, n, size):
        """Download one launched batch and settle its futures (blocks)."""
        t0 = time.perf_counter()
        try:
            res = out.cpu().numpy()
        except Exception as e:  # resolve every waiter with the error
            for r in batch:
                if not r.future.done():  # a cancelled future would raise
                    r.future.set_exception(e)
            return
        self._phase("download", time.perf_counter() - t0)
        for i, r in enumerate(batch):
            if not r.future.done():
                r.future.set_result(res[i])
        with self._stats_lock:
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["batches_by_size"][size] += 1
            self.stats["requests_by_preset"][batch[0].preset] += n

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until every accepted request has resolved (queue empty AND
        no batch in flight), up to timeout_s. Returns True when drained.

        The graceful-shutdown half of close(): stop admitting new work at
        the load balancer, drain(), then close() — queued clients get
        their results instead of shutdown errors. Requests submitted
        DURING the drain still run (gate your own callers)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                idle = not self._pending and not self._busy
            if idle:
                return True
            time.sleep(0.005)
        return False

    def close(self, drain_s: float = 0.0):
        """Stop the dispatcher and FAIL any still-pending requests — a
        hung client waiting out its full timeout against a dead dispatcher
        is worse than an immediate error. `drain_s` > 0 first waits up to
        that long for accepted work to finish (graceful shutdown)."""
        if drain_s > 0:
            self.drain(drain_s)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=2)
        with self._cv:
            while self._pending:
                req = self._pending.popleft()
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("server shutting down"))


def _make_handler(server: InpaintingServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({
                    "status": "ok",
                    "batch_size": server.batch_size,
                    "max_queue": server.max_queue,
                    "presets": sorted(server.presets),
                    "default_preset": server.default_preset,
                    **server.stats_snapshot(),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/inpaint":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(length)),
                               allow_pickle=False)
                seed = int(data["seed"]) if "seed" in data else None
                preset = str(data["preset"]) if "preset" in data else None
                # optional per-request deadline: queue wait past it sheds
                # the request with 504 instead of running stale work
                timeout_ms = (float(data["timeout_ms"])
                              if "timeout_ms" in data else None)
                if timeout_ms is not None and timeout_ms <= 0:
                    raise ValueError(
                        f"timeout_ms must be > 0, got {timeout_ms}")
                fut = server.submit(data["image"], data["mask"], seed,
                                    preset=preset,
                                    deadline_s=(timeout_ms / 1000.0
                                                if timeout_ms else None))
                result = fut.result(timeout=600)
                buf = io.BytesIO()
                # seed echo: with per-request seeds the seed is the
                # complete RNG contract; replaying (image, mask, seed,
                # preset) reproduces these pixels
                reply = {"image": result,
                         "seed": np.uint32(fut.request_seed)}
                if server.compress_responses:
                    np.savez_compressed(buf, **reply)
                else:
                    np.savez(buf, **reply)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except ServerOverloadedError as e:
                body = json.dumps({"error": str(e),
                                   "max_queue": server.max_queue}).encode()
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except DeadlineExceededError as e:
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(504)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (ValueError, KeyError) as e:
                # malformed request (bad shapes/seed, or a missing npz
                # entry like 'mask') — client error, not server error
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                # the status line is latin-1, single-line: a raw CUDA error
                # (multiline, arbitrary bytes) would split the response or
                # crash the handler; sanitize to one printable line
                msg = str(e).splitlines()[0][:200] if str(e) else "error"
                msg = msg.encode("latin-1", "replace").decode("latin-1")
                self.send_error(500, msg)

    return Handler


def serve(pipeline, host: str = "127.0.0.1", port: int = 8571,
          batch_size: int = 8, max_wait_ms: float = 20.0,
          batch_sizes: Optional[tuple] = None, base_seed: int = 0,
          warmup: bool = False, program_cache_dir: Optional[str] = None,
          compress_responses: bool = False,
          adaptive_wait: bool = True, presets: Optional[Dict] = None,
          max_queue: Optional[int] = None,
          default_deadline_s: Optional[float] = None,
          max_inflight: int = 2, instrument: bool = False):
    """Start the HTTP server; returns (httpd, dispatcher). Call
    httpd.serve_forever() (or run it in a thread), and on the way out
    httpd.shutdown(), httpd.server_close() and dispatcher.close().
    `program_cache_dir` is the warm-up's program cache (see
    `InpaintingServer.warmup`)."""
    dispatcher = InpaintingServer(pipeline, batch_size, max_wait_ms,
                                  batch_sizes=batch_sizes,
                                  base_seed=base_seed,
                                  program_cache_dir=program_cache_dir,
                                  compress_responses=compress_responses,
                                  adaptive_wait=adaptive_wait,
                                  presets=presets, max_queue=max_queue,
                                  default_deadline_s=default_deadline_s,
                                  max_inflight=max_inflight,
                                  instrument=instrument)
    try:
        if warmup:
            dispatcher.warmup()
        httpd = ThreadingHTTPServer((host, port), _make_handler(dispatcher))
    except BaseException:
        dispatcher.close()  # no dispatcher thread outlives a failed start
        raise
    return httpd, dispatcher
