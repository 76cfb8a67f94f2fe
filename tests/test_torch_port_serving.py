"""The port's serving layer: the micro-batching dispatcher, its HTTP server and
`cli.serve`, against the JAX package's contract (tests/test_serving.py, less
the AOT program cache, which the port leaves out).

The model is the tiny UNet of tests/test_serving.py with its zero-initialised
output convs re-drawn, so that the hole depends on the weights. Every wait is
bounded and every server is closed in `finally`, so no test can hang the run.
"""
import contextlib
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.models import UNetConfig
from fidm_tpu_torch.sampling import SamplerConfig
from fidm_tpu_torch.serving import (
    DeadlineExceededError,
    InpaintingServer,
    ServerOverloadedError,
    serve,
)
from fidm_tpu_torch.serving.server import _make_handler

S = 16
TINY_UNET = dict(image_size=S, in_channels=9, model_channels=32, out_channels=6,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_heads=2, num_head_channels=16)
TINY = PipelineConfig(
    unet=UNetConfig(**TINY_UNET, dtype=torch.float32),
    schedule="linear", num_timesteps=50,
    sampler=SamplerConfig(method="ddim", num_steps=5, eta=0.0),
)
FAST = SamplerConfig(method="ddim", num_steps=2, eta=1.0, injection=True)
RESULT_S = 120  # seconds a test waits for one result
HTTP_S = 60


def _redraw_zero_convs(model, seed=1):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and not m.weight.any():
                m.reset_parameters()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The model here is tiny, and the test run shares the CPU between its
    workers, where torch's default pool of one thread per core spins against
    the other workers: one intra-op thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipeline():
    pipe = InpaintingPipeline.create(TINY, device="cpu")
    _redraw_zero_convs(pipe.model)
    return pipe


@pytest.fixture(scope="module")
def zero_pipeline():
    """ADM's init as it comes: the zero output convs make the model's output
    exactly 0 at any batch size, so that a request's pixels depend on its
    seed's noise alone and the batch-size contract can be held bit for bit
    (the CPU's float32 convolutions sum differently at another batch size:
    up to 9e-5 apart after five DDIM steps of the tiny model)."""
    return InpaintingPipeline.create(TINY, device="cpu")


def _sample_input(seed=0):
    rng = np.random.default_rng(seed)
    image = np.clip(rng.standard_normal((S, S, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((S, S, 1), np.float32)
    mask[4:12, 4:12] = 1.0
    return image, mask


def _keep(mask):
    return mask[..., 0] < 0.5


@contextlib.contextmanager
def _closing(server, **close_kw):
    try:
        yield server
    finally:
        server.close(**close_kw)


@contextlib.contextmanager
def _http(dispatcher):
    """Serve `dispatcher` over HTTP on a free local port; yields the port."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(dispatcher))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        dispatcher.close()
        t.join(timeout=10)
        assert not t.is_alive()


def _post(port, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/inpaint", data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=HTTP_S) as r:
        return r.status, dict(np.load(io.BytesIO(r.read())))


def _post_error(port, **arrays):
    """(status, JSON body) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, **arrays)
    return exc.value.code, exc.value


def test_dispatcher_batches_concurrent_requests(pipeline):
    # adaptive_wait off: the burst comes from one thread into a cold
    # dispatcher, so grouping needs the unconditional window
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=200,
                                   adaptive_wait=False)) as server:
        inputs = [_sample_input(i) for i in range(4)]
        futures = [server.submit(im, m, seed=0) for im, m in inputs]
        results = [f.result(timeout=RESULT_S) for f in futures]
        for (im, m), out in zip(inputs, results):
            assert out.shape == (S, S, 3) and out.dtype == np.float32
            np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
        assert server.stats["batches"] == 1  # all four rode one batch
        assert server.stats["requests"] == 4


def test_dispatcher_pads_partial_batch(pipeline):
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=10,
                                   batch_sizes=(4,))) as server:
        im, m = _sample_input(9)
        out = server.submit(im, m, seed=1).result(timeout=RESULT_S)
        assert out.shape == (S, S, 3)
        assert server.stats["requests"] == 1
        assert server.stats["batches_by_size"] == {4: 1}  # padded 1 -> 4


def test_dispatcher_rejects_bad_inputs(pipeline):
    """Bad shapes, dtypes, non-finite values, unknown presets and seeds out
    of [0, 2**32) are client errors at submit time; nothing is enqueued."""
    with _closing(InpaintingServer(pipeline, batch_size=2)) as server:
        im, m = _sample_input()
        with pytest.raises(ValueError, match="image must be"):
            server.submit(np.zeros((8, 8, 3), np.float32), m)
        with pytest.raises(ValueError, match="mask must be"):
            server.submit(im, np.zeros((S, S, 3), np.float32))
        with pytest.raises(ValueError, match="real numeric"):
            server.submit(im.astype(np.complex64), m)
        with pytest.raises(ValueError, match="real numeric"):
            server.submit(np.full((S, S, 3), "x"), m)
        bad = im.copy()
        bad[0, 0, 0] = np.nan
        with pytest.raises(ValueError, match="finite"):
            server.submit(bad, m)
        with pytest.raises(ValueError, match="unknown preset"):
            server.submit(im, m, preset="nope")
        for seed in (-1, 2**32, 2**63):
            with pytest.raises(ValueError, match="seed"):
                server.submit(im, m, seed=seed)
        assert server.stats_snapshot()["queue_depth"] == 0


def test_http_round_trip(pipeline):
    httpd, dispatcher = serve(pipeline, port=0, batch_size=2, max_wait_ms=10)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=HTTP_S) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["presets"] == ["default"]
        image, mask = _sample_input(3)
        status, reply = _post(port, image=image, mask=mask, seed=7)
        assert status == 200 and set(reply) == {"image", "seed"}
        assert reply["image"].shape == (S, S, 3) and int(reply["seed"]) == 7
        np.testing.assert_array_equal(reply["image"][_keep(mask)], image[_keep(mask)])
        # a default-seeded request: the echoed seed replays its pixels
        _, first = _post(port, image=image, mask=mask)
        _, replay = _post(port, image=image, mask=mask, seed=int(first["seed"]))
        np.testing.assert_array_equal(replay["image"], first["image"])
        assert _post_error(port, image=image[:8], mask=mask)[0] == 400
        bad = image.copy()
        bad[0, 0, 0] = np.nan
        assert _post_error(port, image=bad, mask=mask, seed=1)[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        dispatcher.close()


def test_http_uint8_responses(pipeline):
    """A uint8 preset answers uint8: the float32 result's toU8, computed on
    the device."""
    u8 = dataclasses.replace(TINY.sampler, output_dtype="uint8")
    with _http(InpaintingServer(pipeline, batch_size=1,
                                presets={"f32": TINY.sampler, "u8": u8})) as port:
        image, mask = _sample_input(4)
        _, f32 = _post(port, image=image, mask=mask, seed=3, preset="f32")
        _, q = _post(port, image=image, mask=mask, seed=3, preset="u8")
        assert q["image"].dtype == np.uint8 and q["image"].shape == (S, S, 3)
        expect = torch.clamp((torch.from_numpy(f32["image"]) + 1.0) * 127.5, 0, 255)
        np.testing.assert_array_equal(q["image"], expect.to(torch.uint8).numpy())


def test_dispatcher_uses_small_batch_size(pipeline):
    """A lone request runs at batch 1, not padded to the top size; a burst
    runs at the top size."""
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=10,
                                   adaptive_wait=False)) as server:
        assert server.batch_sizes == (1, 2, 4)
        im, m = _sample_input(3)
        server.submit(im, m, seed=1).result(timeout=RESULT_S)
        assert server.stats["batches_by_size"][1] == 1
        assert server.stats["batches_by_size"][4] == 0
        server.max_wait_ms = 500
        futs = [server.submit(*_sample_input(i), seed=0) for i in range(4)]
        [f.result(timeout=RESULT_S) for f in futs]
        assert server.stats["batches_by_size"][4] == 1


def test_dispatcher_adaptive_wait_skips_window_at_low_load(pipeline):
    """With the adaptive default a lone request does not pay the window:
    even a 5 s max_wait_ms adds nothing."""
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=5000)) as server:
        im, m = _sample_input(5)
        server.submit(im, m, seed=1).result(timeout=RESULT_S)
        t0 = time.perf_counter()
        server.submit(im, m, seed=2).result(timeout=RESULT_S)
        assert time.perf_counter() - t0 < 4.0  # << the 5 s window
        assert server.stats["batches"] == 2


def test_dispatcher_deterministic_default_seeds(pipeline):
    """Two servers with the same base_seed give the same results for the
    same request stream (no wall-clock seeding)."""
    outs = []
    for _ in range(2):
        with _closing(InpaintingServer(pipeline, batch_size=1, base_seed=7)) as server:
            fut = server.submit(*_sample_input(5))
            outs.append(fut.result(timeout=RESULT_S))
            assert fut.request_seed == 8  # base_seed + arrival index 1
    np.testing.assert_array_equal(outs[0], outs[1])


def _count_runs(pipeline, monkeypatch):
    """Record (batch size, sampler config, seeds) of every pipeline run."""
    runs = []
    inpaint = pipeline.inpaint

    def counted(gt, mask, seed, sampler=None, **kw):
        runs.append((len(gt), sampler, list(seed)))
        return inpaint(gt, mask, seed, sampler=sampler, **kw)

    monkeypatch.setattr(pipeline, "inpaint", counted)
    return runs


def test_warmup_runs_every_shape(pipeline, monkeypatch):
    runs = _count_runs(pipeline, monkeypatch)
    with _closing(InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)) as server:
        assert server.warmup() is server
    assert [(b, c) for b, c, _ in runs] == [(1, TINY.sampler), (2, TINY.sampler)]
    assert [seeds for *_, seeds in runs] == [[0], [0, 0]]  # the serving seed layout


def test_multi_preset_warmup_runs_each_tier(pipeline, monkeypatch):
    runs = _count_runs(pipeline, monkeypatch)
    with _closing(InpaintingServer(pipeline, batch_size=2, max_wait_ms=5,
                                   presets={"final": TINY.sampler, "fast": FAST})) as server:
        server.warmup()
    assert sorted((b, c.num_steps) for b, c, _ in runs) == [(1, 2), (1, 5), (2, 2), (2, 5)]


def test_batch_passes_one_seed_per_row(pipeline, monkeypatch):
    """Each batch passes its requests' seeds, then the last one again for
    each pad row."""
    runs = _count_runs(pipeline, monkeypatch)
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=300,
                                   adaptive_wait=False, batch_sizes=(4,))) as server:
        futs = [server.submit(*_sample_input(i), seed=s) for i, s in enumerate((11, 22, 33))]
        [f.result(timeout=RESULT_S) for f in futs]
    assert [(b, seeds) for b, _, seeds in runs] == [(4, [11, 22, 33, 33])]


def test_explicit_request_seed_changes_batch_result(pipeline):
    """A request's seed sets ITS OWN output only: changing a batch-mate's
    seed changes that mate's result and not yours."""
    def run(seed_b):
        with _closing(InpaintingServer(pipeline, batch_size=2, max_wait_ms=500,
                                       adaptive_wait=False)) as server:
            f1 = server.submit(*_sample_input(0), seed=1)
            f2 = server.submit(*_sample_input(1), seed=seed_b)
            return f1.result(timeout=RESULT_S), f2.result(timeout=RESULT_S)

    a1, a2 = run(seed_b=2)
    b1, b2 = run(seed_b=999)
    assert not np.array_equal(a2, b2)
    np.testing.assert_array_equal(a1, b1)
    c1, c2 = run(seed_b=2)
    np.testing.assert_array_equal(a1, c1)
    np.testing.assert_array_equal(a2, c2)


def test_request_result_independent_of_batch_size(zero_pipeline):
    """The same (inputs, seed) alone at batch 1 and inside a batch of 2 give
    the same pixels: every noise draw of a row comes from its own seed."""
    im, m = _sample_input(0)
    with _closing(InpaintingServer(zero_pipeline, batch_size=1)) as solo:
        alone = solo.submit(im, m, seed=41).result(timeout=RESULT_S)
    with _closing(InpaintingServer(zero_pipeline, batch_size=2, max_wait_ms=500,
                                   adaptive_wait=False)) as batched:
        f1 = batched.submit(im, m, seed=41)
        f2 = batched.submit(*_sample_input(1), seed=77)
        together = f1.result(timeout=RESULT_S)
        f2.result(timeout=RESULT_S)
        assert batched.stats["batches_by_size"][2] == 1
    np.testing.assert_array_equal(together, alone)
    hole = ~_keep(m)
    assert np.abs(alone[hole] - im[hole]).mean() > 0.05


def test_server_rejects_unservable_presets(pipeline):
    with pytest.raises(ValueError, match="trajectory"):
        InpaintingServer(pipeline, batch_size=2, presets={
            "ok": TINY.sampler,
            "bad": dataclasses.replace(TINY.sampler, trajectory_every=2)})
    with pytest.raises(ValueError, match="output_dtype"):
        InpaintingServer(pipeline, batch_size=2, presets={
            "bad": dataclasses.replace(TINY.sampler, output_dtype="float16")})
    with pytest.raises(ValueError, match="batch_sizes must include"):
        InpaintingServer(pipeline, batch_size=4, batch_sizes=(1, 2))
    with pytest.raises(ValueError, match="max_inflight"):
        InpaintingServer(pipeline, batch_size=2, max_inflight=0)


def test_close_with_drain_resolves_queued_work(pipeline):
    """close(drain_s) lets every accepted request finish with a result."""
    server = InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)
    futs = [server.submit(*_sample_input(i), seed=i) for i in range(6)]
    server.close(drain_s=RESULT_S)
    for f in futs:
        assert np.isfinite(f.result(timeout=1)).all()  # already resolved
    snap = server.stats_snapshot()
    assert snap["requests"] == 6 and snap["queue_depth"] == 0
    assert not server._thread.is_alive()


def test_drain_reports_timeout(pipeline):
    with _closing(InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)) as server:
        assert server.drain(timeout_s=0.2) is True  # idle server
        futs = [server.submit(*_sample_input(i), seed=i) for i in range(4)]
        assert server.drain(timeout_s=0.0) in (False, True)  # no side effects
        for f in futs:
            assert np.isfinite(f.result(timeout=RESULT_S)).all()


def test_close_fails_pending_requests_fast(pipeline):
    server = InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)
    server._stop.set()
    server._thread.join(timeout=5)
    fut = server.submit(*_sample_input(), seed=1)
    server.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


def test_http_malformed_npz_returns_400(pipeline):
    with _http(InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)) as port:
        im, m = _sample_input()
        code, err = _post_error(port, image=im)  # no mask
        assert code == 400 and "mask" in json.loads(err.read())["error"]
        assert _post_error(port, image=im, mask=m, seed=np.uint64(2**63))[0] == 400
        # not an npz at all
        req = urllib.request.Request(f"http://127.0.0.1:{port}/inpaint",
                                     data=b"not an npz", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=HTTP_S)
        assert exc.value.code == 400


def test_multi_preset_serving(pipeline):
    """One deployment serves quality tiers: a device batch carries one
    preset; a mixed stream splits into per-preset batches in order."""
    with _closing(InpaintingServer(pipeline, batch_size=4, max_wait_ms=200,
                                   adaptive_wait=False,
                                   presets={"final": TINY.sampler, "fast": FAST})) as server:
        assert server.default_preset == "final"
        im, m = _sample_input(4)
        futs = [server.submit(im, m, seed=1, preset="fast"),
                server.submit(im, m, seed=1),
                server.submit(im, m, seed=1, preset="fast"),
                server.submit(im, m, seed=1, preset="final")]
        for out in (f.result(timeout=RESULT_S) for f in futs):
            np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
        assert server.stats["requests_by_preset"] == {"fast": 2, "final": 2}
        assert server.stats["batches"] == 2
        a = server.submit(im, m, seed=9, preset="fast").result(timeout=RESULT_S)
        b = server.submit(im, m, seed=9, preset="final").result(timeout=RESULT_S)
        c = server.submit(im, m, seed=9, preset="fast").result(timeout=RESULT_S)
        np.testing.assert_array_equal(a, c)
        assert not np.array_equal(a, b)


def test_serves_the_cli_default_dpm25_sde_and_refine_tier(pipeline):
    """The CLI's presets (dpm-25-sde and its refine tier) through the
    dispatcher: known pixels kept, hole filled, replay bit-equal, and the
    refine tier (strength 0.3) starts from the request's image."""
    presets = serve_cli.build_presets(serve_cli.parse_args(["--refine_tier", "0.3"]))
    assert list(presets) == ["dpm-25-sde", "refine"]
    with _closing(InpaintingServer(pipeline, batch_size=2, presets=presets)) as server:
        im, m = _sample_input(6)
        outs = [server.submit(im, m, seed=5, preset=p).result(timeout=RESULT_S)
                for p in ("dpm-25-sde", "refine", "dpm-25-sde")]
    for out in outs:
        np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
        assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
    np.testing.assert_array_equal(outs[0], outs[2])
    hole = ~_keep(m)
    full, refined = (np.abs(o[hole] - im[hole]).mean() for o in outs[:2])
    assert full > 0.05 and refined < full


def test_submit_rejects_when_queue_full(pipeline):
    server = InpaintingServer(pipeline, batch_size=2, max_queue=3)
    server._stop.set()  # a dispatcher that never drains
    server._thread.join(timeout=5)
    with _closing(server):
        im, m = _sample_input()
        for _ in range(3):
            server.submit(im, m, seed=1)
        with pytest.raises(ServerOverloadedError, match="queue full"):
            server.submit(im, m, seed=1)
        snap = server.stats_snapshot()
        assert snap["rejected"] == 1 and snap["queue_depth"] == 3


def test_expired_requests_are_shed_not_run(pipeline):
    server = InpaintingServer(pipeline, batch_size=2)
    server._stop.set()
    server._thread.join(timeout=5)
    with _closing(server):
        im, m = _sample_input()
        f_stale = server.submit(im, m, seed=1, deadline_s=0.01)
        f_live = server.submit(im, m, seed=1)
        time.sleep(0.05)
        with server._cv:
            batch = list(server._pending)
            server._pending.clear()
        live = server._shed_expired(batch)
        assert [r.future for r in live] == [f_live]
        with pytest.raises(DeadlineExceededError):
            f_stale.result(timeout=1)
        assert server.stats_snapshot()["shed"] == 1
        assert not f_live.done()


def test_http_overload_returns_429(pipeline):
    dispatcher = InpaintingServer(pipeline, batch_size=1, max_queue=1)
    with _http(dispatcher) as port:
        dispatcher._stop.set()  # the queue can never drain
        dispatcher._thread.join(timeout=5)
        im, m = _sample_input()
        dispatcher.submit(im, m, seed=1)
        code, err = _post_error(port, image=im, mask=m, seed=2)
        assert code == 429 and err.headers["Retry-After"] == "1"
        assert "queue full" in json.loads(err.read())["error"]
        snap = dispatcher.stats_snapshot()
        assert snap["rejected"] == 1 and snap["queue_depth"] == 1


def test_http_deadline_shed_returns_504(pipeline):
    dispatcher = InpaintingServer(pipeline, batch_size=1)
    with _http(dispatcher) as port:
        im, m = _sample_input()
        code, err = _post_error(port, image=im, mask=m, seed=1, timeout_ms=1e-6)
        assert code == 504 and "deadline" in json.loads(err.read())["error"]
        assert dispatcher.stats_snapshot()["shed"] == 1
        assert _post(port, image=im, mask=m, seed=1, timeout_ms=120000.0)[0] == 200
        assert _post_error(port, image=im, mask=m, timeout_ms=-1.0)[0] == 400


def test_overload_stress_mixed_presets(pipeline):
    """6 threads x 30 mixed-preset requests against max_queue=8, with a short
    switch interval: no hang, every future resolves (result, 429 or 504),
    and the counters reconcile exactly."""
    server = InpaintingServer(pipeline, batch_size=4, max_wait_ms=1.0,
                              presets={"final": TINY.sampler, "fast": FAST},
                              max_queue=8, default_deadline_s=60.0)
    im, m = _sample_input(3)
    ok, rejected, shed, errors = [], [], [], []
    lock = threading.Lock()

    def client(tid):
        for i in range(30):
            try:
                fut = server.submit(im, m, seed=tid * 1000 + i,
                                    preset=("fast", "final")[(tid + i) % 2])
            except ServerOverloadedError:
                with lock:
                    rejected.append((tid, i))
                time.sleep(0.002)
                continue
            try:
                out = fut.result(timeout=RESULT_S)
                with lock:
                    ok.append(out)
            except DeadlineExceededError:
                with lock:
                    shed.append((tid, i))
            except Exception as e:  # anything else is a real failure
                with lock:
                    errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "stress client hung"
        assert not errors, errors
        snap = server.stats_snapshot()
        assert len(ok) + len(rejected) + len(shed) == 180
        assert snap["requests"] == len(ok) and snap["rejected"] == len(rejected)
        assert snap["shed"] == len(shed) and snap["queue_depth"] == 0
        assert sum(snap["requests_by_preset"].values()) == len(ok)
        for out in ok[:8]:
            np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
    finally:
        sys.setswitchinterval(interval)
        server.close()


def test_full_queue_of_expired_entries_admits_live_work(pipeline):
    server = InpaintingServer(pipeline, batch_size=2, max_queue=3)
    server._stop.set()
    server._thread.join(timeout=5)
    with _closing(server):
        im, m = _sample_input()
        stale = [server.submit(im, m, seed=1, deadline_s=0.01) for _ in range(3)]
        time.sleep(0.05)
        f_live = server.submit(im, m, seed=1)  # admitted, not 429
        for f in stale:
            with pytest.raises(DeadlineExceededError):
                f.result(timeout=1)
        snap = server.stats_snapshot()
        assert snap["shed"] == 3 and snap["rejected"] == 0 and snap["queue_depth"] == 1
        assert not f_live.done()
        for _ in range(2):
            server.submit(im, m, seed=1)
        with pytest.raises(ServerOverloadedError):
            server.submit(im, m, seed=1)


def test_overlapped_dispatch_resolves_all_and_counts_phases(zero_pipeline):
    """max_inflight=2 (the default): a mixed-preset stream resolves every
    future, per-request seeds survive the overlap, and phases_ms records
    the unfenced phases."""
    with _closing(InpaintingServer(zero_pipeline, batch_size=2, max_wait_ms=1.0,
                                   presets={"final": TINY.sampler, "fast": FAST})) as server:
        assert server.max_inflight == 2
        im, m = _sample_input(5)
        futs = [server.submit(im, m, seed=i, preset=("fast", "final")[i % 2])
                for i in range(8)]
        outs = [f.result(timeout=RESULT_S) for f in futs]
        for out in outs:
            np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
        again = server.submit(im, m, seed=3, preset="final").result(timeout=RESULT_S)
        np.testing.assert_array_equal(again, outs[3])
        snap = server.stats_snapshot()
        ph = snap["phases_ms"]
        for name in ("assemble", "dispatch", "download"):
            assert ph[name]["n"] >= 1, ph
        assert ph["download"]["n"] == snap["batches"]
        assert "upload" not in ph and "execute" not in ph


def test_instrument_mode_fences_and_times_every_phase(pipeline):
    server = InpaintingServer(pipeline, batch_size=2, instrument=True, max_inflight=4)
    assert server.max_inflight == 1  # fencing serializes
    with _closing(server):
        im, m = _sample_input(6)
        out = server.submit(im, m, seed=7).result(timeout=RESULT_S)
        np.testing.assert_array_equal(out[_keep(m)], im[_keep(m)])
        ph = server.stats_snapshot()["phases_ms"]
        for name in ("assemble", "upload", "dispatch", "execute", "download"):
            assert ph[name]["n"] == 1 and ph[name]["ms"] >= 0.0, ph


def test_serial_max_inflight_one_still_works(pipeline):
    with _closing(InpaintingServer(pipeline, batch_size=2, max_inflight=1)) as server:
        im, m = _sample_input(8)
        futs = [server.submit(im, m, seed=i) for i in range(4)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=RESULT_S)[_keep(m)], im[_keep(m)])


def test_http_fuzz_shapes_dtypes_and_preset_flood(pipeline):
    """Oversized and zero-dim shapes, dtype spoofing, a NaN seed and an
    unknown-preset flood are all 400s, and the server still serves."""
    dispatcher = InpaintingServer(pipeline, batch_size=2, max_wait_ms=5)
    with _http(dispatcher) as port:
        im, m = _sample_input(11)
        cases = [dict(image=np.zeros((1024, 1024, 3), np.float32), mask=m),
                 dict(image=np.zeros((0, 0, 3), np.float32), mask=m),
                 dict(image=im, mask=np.zeros((1, S, S), np.float32)),
                 dict(image=np.array(["x"] * S * S * 3).reshape(S, S, 3), mask=m),
                 dict(image=im, mask=m, seed=np.float64("nan"))]
        cases += [dict(image=im, mask=m, preset=f"nope-{i}") for i in range(20)]
        for arrays in cases:
            assert _post_error(port, **arrays)[0] == 400, arrays.keys()
        assert dispatcher.stats_snapshot()["queue_depth"] == 0
        _, data = _post(port, image=im, mask=m, seed=3)
        np.testing.assert_array_equal(data["image"][_keep(m)], im[_keep(m)])


def test_drain_under_concurrent_submissions_and_preset_churn(pipeline):
    """close(drain_s) while clients keep submitting mixed presets: no hang;
    every accepted future settles (result or shutdown error)."""
    server = InpaintingServer(pipeline, batch_size=2, max_wait_ms=1.0,
                              presets={"final": TINY.sampler, "fast": FAST})
    im, m = _sample_input(12)
    futs, lock, stop = [], threading.Lock(), threading.Event()

    def client(tid):
        for i in range(30):
            if stop.is_set():
                return
            try:
                f = server.submit(im, m, seed=tid * 100 + i, preset=("fast", "final")[i % 2])
            except ServerOverloadedError:
                continue
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    server.close(drain_s=30.0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for f in futs:
        try:
            np.testing.assert_array_equal(f.result(timeout=60)[_keep(m)], im[_keep(m)])
        except RuntimeError as e:
            assert "shutting down" in str(e)


# ---------------------------------------------------------------------------
# The port's server against the JAX server, and the two CLIs
# ---------------------------------------------------------------------------

def test_protocol_matches_jax_server(pipeline):
    """The same requests to the JAX server and to the port's, at the same
    tiny configuration: status codes, response field names, dtypes and
    shapes, error bodies' keys and the /healthz keys agree."""
    import jax.numpy as jnp

    from fidm_tpu import pipeline as jax_pipeline
    from fidm_tpu.models import UNetConfig as JaxUNetConfig
    from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
    from fidm_tpu.serving import serve as jax_serve

    jax_pipe = jax_pipeline.InpaintingPipeline.create(jax_pipeline.PipelineConfig(
        unet=JaxUNetConfig(**TINY_UNET, dtype=jnp.float32), schedule="linear",
        num_timesteps=50, sampler=JaxSamplerConfig(method="ddim", num_steps=5, eta=0.0)))
    im, m = _sample_input(13)
    requests = [dict(image=im, mask=m, seed=7),            # valid
                dict(image=im),                            # malformed: no mask
                dict(image=im, mask=m, preset="nope"),     # unknown preset
                dict(image=im[:8], mask=m)]                # bad shape
    answers = {}
    for name, start, pipe in (("jax", jax_serve, jax_pipe), ("port", serve, pipeline)):
        httpd, dispatcher = start(pipe, port=0, batch_size=1)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        try:
            got = []
            for arrays in requests:
                try:
                    status, reply = _post(port, **arrays)
                    got.append((status, {k: (v.dtype.str, v.shape) for k, v in reply.items()}))
                except urllib.error.HTTPError as e:
                    got.append((e.code, sorted(json.loads(e.read()))))
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=HTTP_S) as r:
                health = json.loads(r.read())
            got.append(sorted(health))
            got.append((health["presets"], health["default_preset"], health["batch_size"]))
            answers[name] = got
        finally:
            httpd.shutdown()
            httpd.server_close()
            dispatcher.close()
    assert answers["port"] == answers["jax"]
    assert [a[0] for a in answers["port"][:4]] == [200, 400, 400, 400]
    assert answers["port"][0][1] == {"image": ("<f4", (S, S, 3)), "seed": ("<u4", ())}


CLI_ARGVS = [
    [],
    ["--presets", "ddim-100", "dpm-25-sde", "consistency-1"],
    ["--presets", "dpm-25-sde", "ddim-100", "--refine_tier", "0.3"],
    ["--preset", "dpm-25", "--timesteps", "999", "749", "499", "249", "0",
     "--mean_type", "velocity"],
    ["--output_dtype", "uint8", "--refine_tier", "0.5"],
]


@pytest.mark.parametrize("argv", CLI_ARGVS, ids=["default", "presets", "refine_tier",
                                                 "timesteps", "uint8"])
def test_build_presets_matches_jax_cli(argv):
    from fidm_tpu.cli import serve as jax_serve_cli

    ours = serve_cli.build_presets(serve_cli.parse_args(argv))
    ref = jax_serve_cli.build_presets(jax_serve_cli.parse_args(argv))
    assert list(ours) == list(ref)
    for name, cfg in ours.items():
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(ref[name])
        for k in ("mean_type", "var_type"):
            assert a.pop(k).name == b.pop(k).name, (name, k)
        assert a == b, name


def test_cli_defaults_and_left_out_flags():
    args = serve_cli.parse_args([])
    assert (args.preset, args.device, args.batch_size) == ("dpm-25-sde", "cuda", 8)
    assert list(serve_cli.build_presets(args)) == ["dpm-25-sde"]
    with pytest.raises(SystemExit):  # no AOT program cache in the port
        serve_cli.parse_args(["--program_cache", "/nowhere"])
    for bad in (["--refine_tier", "1.0"], ["--preset", "nope"],
                ["--preset", "consistency-1", "--refine_tier", "0.5"]):
        with pytest.raises(SystemExit):
            serve_cli.build_presets(serve_cli.parse_args(bad))


def test_cli_refine_tier_runs_on_the_student_grid():
    """`--timesteps` applies before the refine tier is derived, so a
    student's refine tier truncates the student's grid (the JAX CLI derives
    it from the preset's own grid first)."""
    presets = serve_cli.build_presets(serve_cli.parse_args(
        ["--timesteps", "999", "749", "499", "249", "0", "--refine_tier", "0.4"]))
    assert presets["refine"].timesteps == presets["dpm-25-sde"].timesteps
    assert presets["refine"].num_steps is None and presets["refine"].strength == 0.4


TINY_FLAGS = ["--image_size", "16", "--model_channels", "32", "--channel_mult", "1", "2",
              "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2",
              "--schedule", "linear", "--diffusion_steps", "50"]


def test_cli_serve_raises_without_gpu(monkeypatch):
    """`--device` defaults to cuda, and without a GPU the CLI raises before
    it builds anything; it never moves to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(TINY_FLAGS + ["--port", "0"])


def test_cli_pipeline_loads_the_checkpoint_on_cpu(tmp_path):
    """`build_pipeline` with `--device cpu`, the model-shape flags and an ADM
    checkpoint: the weights are the checkpoint's, the sampler the default
    preset, and the server it feeds answers."""
    args = serve_cli.parse_args(TINY_FLAGS + ["--device", "cpu", "--checkpoint",
                                              str(tmp_path / "m.pt"), "--batch_sizes", "1"])
    presets = serve_cli.build_presets(args)
    donor = InpaintingPipeline.create(TINY, seed=3, device="cpu")
    _redraw_zero_convs(donor.model)
    torch.save(donor.model.state_dict(), tmp_path / "m.pt")
    pipe = serve_cli.build_pipeline(args, presets)
    assert pipe.device.type == "cpu" and pipe.config.sampler == presets["dpm-25-sde"]
    for k, v in donor.model.state_dict().items():
        assert torch.equal(pipe.model.state_dict()[k], v), k
    with _http(InpaintingServer(pipe, batch_size=1, presets=presets)) as port:
        im, m = _sample_input(14)
        status, reply = _post(port, image=im, mask=m, seed=2)
    assert status == 200 and reply["image"].dtype == np.float32
    np.testing.assert_array_equal(reply["image"][_keep(m)], im[_keep(m)])
