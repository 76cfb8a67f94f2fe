"""The port's pipeline: the slice as a whole against the JAX package, its
contract (known pixels, determinism, devices, presets) and its imports.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidm_tpu import pipeline as jax_pipeline
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models.torch_import import save_torch_checkpoint
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu_torch import SAMPLER_PRESETS, InpaintingPipeline, PipelineConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import ffhq256_config
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.ops import build
from fidm_tpu_torch.sampling import SamplerConfig

from _torch_port_common import JCFG, PCFG, JaxKeyNoise, perturbed_jax_variables

DDIM = dict(method="ddim", num_steps=5, eta=0.9, injection=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module: the test
    run shares the CPU between its workers, where torch's default pool of one
    thread per core spins against the others (the full-step presets below
    took minutes that way)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)
CONFIG = PipelineConfig(unet=PCFG, sampler=SamplerConfig(**DDIM))


def _inputs(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, 3:11, 5:13] = 1.0
    return gt, mask


@pytest.fixture(scope="module")
def jax_variables():
    return perturbed_jax_variables()


@pytest.fixture(scope="module")
def pipe(jax_variables):
    p = InpaintingPipeline.create(CONFIG, device="cpu")
    p.model.load_state_dict(state_dict_from_jax(jax_variables, PCFG), strict=True)
    return p


def test_inpaint_matches_jax_pipeline(pipe, jax_variables):
    """The slice end to end: the same weights, inputs and noise through the
    JAX pipeline and the port, DDIM with eta 0.9 and post-step injection."""
    gt, mask = _inputs(0)
    key = jax.random.PRNGKey(5)
    ref_pipe = jax_pipeline.InpaintingPipeline(
        JaxInpaintingUNet(JCFG), jax.tree_util.tree_map(jnp.asarray, jax_variables),
        JaxSchedule.create("quadratic", 1000),
        jax_pipeline.PipelineConfig(unet=JCFG, sampler=JaxSamplerConfig(**DDIM)))
    ref = np.asarray(ref_pipe.inpaint(jnp.asarray(gt), jnp.asarray(mask), key))
    out = pipe.inpaint(gt, mask, 0, noise=JaxKeyNoise(key)).numpy()
    hole = mask[..., 0] > 0.5
    assert np.abs(ref[hole]).max() > 0.3  # the model's output reaches the hole
    # float32 UNets whose sums run in another order (test_torch_port_unet);
    # six steps leave about 2e-5 between the images, the bound allows 10x
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(out[~hole], gt[~hole])


def test_known_pixels_exact_and_seed_deterministic(pipe):
    gt, mask = _inputs(1)
    a = pipe.inpaint(gt, mask, 3)
    b = pipe.inpaint(torch.from_numpy(gt), torch.from_numpy(mask), 3)
    c = pipe.inpaint(gt, mask, 4)
    keep = mask[..., 0] < 0.5
    assert a.dtype == torch.float32 and a.shape == gt.shape
    assert torch.isfinite(a).all()
    np.testing.assert_array_equal(a.numpy()[keep], gt[keep])
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    np.testing.assert_array_equal(c.numpy()[keep], gt[keep])


def test_uint8_output(pipe):
    gt, mask = _inputs(2)
    cfg = SamplerConfig(**DDIM, output_dtype="uint8")
    u8 = pipe.inpaint(gt, mask, 0, sampler=cfg)
    f32 = pipe.inpaint(gt, mask, 0)
    assert u8.dtype == torch.uint8
    assert torch.equal(u8, torch.clamp((f32 + 1) * 127.5, 0, 255).to(torch.uint8))


def test_cuda_default_raises_without_gpu(monkeypatch):
    """Entry points default to the card and never move to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InpaintingPipeline.create(CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionSchedule.create("quadratic", 1000)


def test_bad_shapes_raise(pipe):
    gt, mask = _inputs(0)
    with pytest.raises(ValueError):
        pipe.inpaint(gt, mask[:, :8], 0)
    with pytest.raises(ValueError):
        pipe.inpaint(gt[..., :1], mask, 0)


def test_presets_mirror_jax():
    assert list(SAMPLER_PRESETS) == list(jax_pipeline.SAMPLER_PRESETS)
    for name, cfg in SAMPLER_PRESETS.items():
        ref = dataclasses.asdict(jax_pipeline.SAMPLER_PRESETS[name])
        ours = dataclasses.asdict(cfg)
        for k in ("mean_type", "var_type"):
            assert ours.pop(k).name == ref.pop(k).name
        assert ours == ref, name


def test_default_config_is_ddim100_on_ffhq256():
    cfg = PipelineConfig()
    assert cfg.unet == ffhq256_config()
    assert cfg.sampler == SAMPLER_PRESETS["ddim-100"]
    assert (cfg.sampler.method, cfg.sampler.num_steps, cfg.sampler.eta) == ("ddim", 100, 0.9)
    assert (cfg.schedule, cfg.num_timesteps) == ("quadratic", 1000)


@pytest.mark.parametrize("name", ["unipc-20", "consistency-2", "repaint-100-light"])
def test_unported_presets_raise(pipe, name):
    """Presets that raised NotImplementedError before the rest of sampling
    was ported now run through `inpaint` at their full step counts: the
    model evaluations their host tables give (21, 2 and 301, repaint's 200
    renoise rows running none), known pixels equal to gt, the output finite
    and in [-1, 1], the same seed the same image."""
    gt, mask = _inputs(0)
    calls = []
    hook = pipe.model.register_forward_hook(lambda m, args, out: calls.append(1))
    try:
        out = pipe.inpaint(gt, mask, 0, sampler=SAMPLER_PRESETS[name])
    finally:
        hook.remove()
    assert len(calls) == {"unipc-20": 21, "consistency-2": 2, "repaint-100-light": 301}[name]
    keep = mask[..., 0] < 0.5
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
    np.testing.assert_array_equal(out.numpy()[keep], gt[keep])
    if name == "consistency-2":
        assert torch.equal(pipe.inpaint(gt, mask, 0, sampler=SAMPLER_PRESETS[name]), out)


def test_create_from_adm_checkpoint(jax_variables, tmp_path):
    path = str(tmp_path / "model.pt")
    save_torch_checkpoint(path, jax_variables, JCFG)
    p = InpaintingPipeline.create(CONFIG, checkpoint=path, device="cpu")
    ours = p.model.state_dict()
    for k, v in state_dict_from_jax(jax_variables, PCFG).items():
        assert torch.equal(ours[k], v), k


def test_random_init_is_seeded_with_zero_output_convs():
    a = InpaintingPipeline.create(CONFIG, seed=1, device="cpu").model.state_dict()
    b = InpaintingPipeline.create(CONFIG, seed=1, device="cpu").model.state_dict()
    c = InpaintingPipeline.create(CONFIG, seed=2, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_blocks.0.0.weight"], c["input_blocks.0.0.weight"])
    for k in ("out.2.weight", "input_blocks.1.0.out_layers.3.weight",
              "input_blocks.3.1.proj_out.weight"):
        assert not a[k].any(), k


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means no kernel: the build raises and nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_package_imports_no_jax():
    """`fidm_tpu_torch` stands alone: importing every module of it (the
    quantization, data, native, parallel and CLI modules included) loads no
    JAX, Flax or `fidm_tpu` module."""
    code = (
        "import importlib, pkgutil, sys, fidm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fidm_tpu_torch.__path__, "
        "'fidm_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert {'fidm_tpu_torch.quant.int8', 'fidm_tpu_torch.quant.calibrate', "
        "'fidm_tpu_torch.ops.quantize', 'fidm_tpu_torch.data.dataset', "
        "'fidm_tpu_torch.cli.quantize', 'fidm_tpu_torch.serving.server', "
        "'fidm_tpu_torch.cli.serve', 'fidm_tpu_torch.distill', "
        "'fidm_tpu_torch.distill.progressive', 'fidm_tpu_torch.distill.consistency', "
        "'fidm_tpu_torch.cli.distill', 'fidm_tpu_torch.cli.export_torch', "
        "'fidm_tpu_torch.native.build', 'fidm_tpu_torch.native.imgload', "
        "'fidm_tpu_torch.parallel.mesh', 'fidm_tpu_torch.parallel.multihost', "
        "'fidm_tpu_torch.parallel.collectives'} <= set(names), "
        "names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fidm_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
