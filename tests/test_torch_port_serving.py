"""The port's serving layer: the micro-batching dispatcher, its HTTP server and
`cli.serve`, against the JAX package's contract (tests/test_serving.py; its
AOT program cache is held in tests/test_torch_port_aot.py).

The model is the tiny UNet of tests/test_serving.py with its zero-initialised
output convs re-drawn, so that the hole depends on the weights. Every wait is
bounded and every server is closed in `finally`, so no test can hang the run.

The server under load and at shutdown is in `test_torch_port_serving_load.py`,
`cli.serve` and the wire protocol in `test_torch_port_serving_cli.py`: port
test files hold at most 25 cases (ROADMAP.md).
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.serving import InpaintingServer, serve

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
