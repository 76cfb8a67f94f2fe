"""Shared pieces of the serving tests (`test_torch_port_serving*.py`): the tiny
UNet of tests/test_serving.py and its pipelines, request inputs, and servers
and HTTP fronts that are always closed, with every wait bounded.
"""
import contextlib
import io
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from fidm_tpu_torch import InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.models import UNetConfig
from fidm_tpu_torch.sampling import SamplerConfig
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
