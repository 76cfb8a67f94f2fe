"""The port's serving layer under load and at shutdown: closing with and
without a drain, a full queue, expired requests shed, HTTP 400, 429 and 504,
overlapped dispatch and its phase counters, and floods of mixed presets,
against the JAX package's contract (tests/test_serving.py).

The model is the tiny UNet of tests/test_serving.py with its zero-initialised
output convs re-drawn. Every wait is bounded and every server is closed in
`finally`, so no test can hang the run.
"""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from fidm_tpu_torch.serving import (
    DeadlineExceededError,
    InpaintingServer,
    ServerOverloadedError,
)

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_serving_common import (  # noqa: F401
    S,
    TINY,
    FAST,
    RESULT_S,
    HTTP_S,
    pipeline,
    zero_pipeline,
    _sample_input,
    _keep,
    _closing,
    _http,
    _post,
    _post_error,
)


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
