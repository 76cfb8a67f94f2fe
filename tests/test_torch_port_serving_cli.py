"""`cli.serve` of the port against the JAX package's: the wire protocol against
the JAX server's, the presets each command line builds, the defaults, the
refine tier, and the pipeline the CLI loads.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fidm_tpu_torch import InpaintingPipeline
from fidm_tpu_torch.cli import serve as serve_cli
from fidm_tpu_torch.serving import InpaintingServer, serve

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_serving_common import (  # noqa: F401
    S,
    TINY_UNET,
    TINY,
    HTTP_S,
    _redraw_zero_convs,
    pipeline,
    _sample_input,
    _keep,
    _http,
    _post,
)


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
    # the program cache takes a directory (tests/test_torch_port_aot.py)
    assert args.program_cache is None
    assert serve_cli.parse_args(["--program_cache", "/nowhere"]).program_cache == "/nowhere"
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
