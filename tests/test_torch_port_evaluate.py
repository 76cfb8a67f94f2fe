"""The port's evaluate, fid_stats and pack_data CLIs against the JAX
package's.

Both evaluate CLIs run one ADM `.pt` (written by `fidm_tpu`'s exporter from
seeded parameters in the JAX model's tree, none of them zero, so that the
output is not identically 0) of a 32² model, in float32, on one PNG data
tree of 8 images with box and brush masks, with Inception, AlexNet and
LPIPS-head state dicts from the seeded oracles in the published key
layouts. The port's per-batch noise is the JAX CLI's key draws
(`JaxKeyNoise(fold_in(PRNGKey(seed), bi))`) and its proxy-FID extractor
holds the JAX extractor's weights, so the two runs differ only by float32
rounding. FID's 2048² sqrtm is not run here (see FID_RECORDED): the
distance is held on the features each CLI extracted. The other evaluate
branches run the port alone and are held to what they must equal;
`fid_stats` and `pack_data` run in both packages. Torch runs on one
intra-op thread here.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fidm_tpu import metrics as jax_metrics
from fidm_tpu.cli import evaluate as jax_evaluate
from fidm_tpu.cli import fid_stats as jax_fid_stats
from fidm_tpu.cli import pack_data as jax_pack_data
from fidm_tpu.metrics import RandomConvFeatureExtractor as JaxRandomConv
from fidm_tpu.metrics import fid as jax_fid
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.models import ffhq256_config as jax_ffhq256_config
from fidm_tpu.models.torch_import import save_torch_checkpoint
from fidm_tpu_torch import metrics as port_metrics
from fidm_tpu_torch.cli import evaluate as port_evaluate
from fidm_tpu_torch.cli import fid_stats as port_fid_stats
from fidm_tpu_torch.cli import pack_data as port_pack_data
from fidm_tpu_torch.metrics import fid as port_fid

from _torch_port_common import JaxKeyNoise
from oracle_fid_inception import FIDInceptionOracle
from oracle_fid_inception import randomize as randomize_inception
from oracle_lpips import LPIPSOracle
from oracle_lpips import randomize as randomize_lpips

SIZE = 32
SHAPE = dict(image_size=SIZE, model_channels=32, channel_mult=(1, 2), num_heads=2,
             num_head_channels=16, attention_resolutions=(2,))
MODEL = ["--image_size", "32", "--model_channels", "32", "--channel_mult", "1", "2",
         "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2"]
RUN = ["--quick_test", "--diffusion_steps", "100", *MODEL]
N_IMAGES = 8
N_FAKE = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny, and the test run shares the CPU between its
    workers, where torch's default pool of one thread per core spins against
    the other workers: one intra-op thread for this module. The same for
    BLAS: scipy's sqrtm of a 2048² covariance took 20 s of wall and 47 s of
    CPU on eight threads, 34 s of both on one, and its threads slowed the
    other workers' files."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _brush(rng, size):
    """A random walk of disks, 1 = hole."""
    m = np.zeros((size, size), bool)
    yy, xx = np.mgrid[:size, :size]
    y, x = rng.uniform(size / 4, 3 * size / 4, 2)
    for _ in range(8):
        m |= (yy - y) ** 2 + (xx - x) ** 2 <= rng.uniform(2, 4) ** 2
        a = rng.uniform(0, 2 * np.pi)
        y, x = np.clip(y + 3 * np.sin(a), 0, size - 1), np.clip(x + 3 * np.cos(a), 0, size - 1)
    return m


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    """8 smooth 32² PNGs (gradients plus noise) and a `test/` mask dir of a
    box and a brush mask (black = hole, the dataset's convention)."""
    root = tmp_path_factory.mktemp("eval_data")
    img_dir, mask_dir = root / "images", root / "masks" / "test"
    img_dir.mkdir()
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    for i in range(N_IMAGES):
        base = np.stack([np.sin(3 * yy + i), np.cos(2 * xx - i), yy * xx], -1)
        arr = np.clip(127.5 + 90 * base + rng.normal(0, 12, base.shape), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(img_dir / f"img_{i}.png")
    box = np.full((SIZE, SIZE), 255, np.uint8)
    box[8:24, 6:22] = 0
    Image.fromarray(box).save(mask_dir / "mask_0.png")
    Image.fromarray(np.where(_brush(rng, SIZE), 0, 255).astype(np.uint8)).save(
        mask_dir / "mask_1.png")
    return str(img_dir), str(root / "masks")


def _drawn_jax_variables(cfg, seed):
    """The JAX model's variable tree (`jax.eval_shape` of its `init`, which
    compiles nothing) filled from numpy draws: kernels normal over
    sqrt(fan-in), norm scales 1 + 0.05·normal, biases 0.05·normal.
    Compiling the init, as `perturbed_jax_variables` does, took 7 s on an
    8-core CPU."""
    s = cfg.image_size
    dummy = (np.zeros((1, s, s, 3), np.float32), np.zeros((1,), np.int32),
             np.zeros((1, s, s, 3), np.float32), np.zeros((1, s, s, 1), np.float32))
    shapes = jax.eval_shape(JaxInpaintingUNet(cfg).init, jax.random.PRNGKey(seed), *dummy)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return (1 + 0.05 * z) if name == "scale" else 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eval_ckpt") / "model.pt")
    cfg = jax_ffhq256_config(**SHAPE, dtype=jnp.float32)
    save_torch_checkpoint(path, _drawn_jax_variables(cfg, seed=5), cfg)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded Inception (pt_inception layout, non-trivial BN statistics),
    AlexNet and LPIPS-head state dicts, as files."""
    root = tmp_path_factory.mktemp("eval_weights")
    paths = {k: str(root / f) for k, f in (("fid", "pt_inception.pth"),
                                           ("alex", "alexnet.pth"), ("lin", "lpips_lin.pt"))}
    torch.save(randomize_inception(FIDInceptionOracle(), seed=0).state_dict(), paths["fid"])
    oracle = randomize_lpips(LPIPSOracle(), seed=0)
    torch.save(oracle.alexnet_state_dict(), paths["alex"])
    torch.save(oracle.lpips_state_dict(), paths["lin"])
    return paths


def _jax_noise(seed, bi, device):
    return JaxKeyNoise(jax.random.fold_in(jax.random.PRNGKey(seed), bi))


@functools.lru_cache(maxsize=None)
def _jax_proxy_weights():
    jax_proxy = JaxRandomConv()
    return [np.asarray(w) for w in (jax_proxy.w1, jax_proxy.w2, jax_proxy.w3)]


def _use_jax_draws(mp):
    """The port's evaluate with the JAX CLI's noise and proxy weights."""
    mp.setattr(port_evaluate, "batch_noise", _jax_noise)
    mp.setattr(port_metrics, "RandomConvFeatureExtractor", functools.partial(
        port_metrics.RandomConvFeatureExtractor, weights=_jax_proxy_weights()))


def _port(argv):
    return port_evaluate.main(argv + ["--device", "cpu"])


def _metrics_json(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return json.load(f)


def _spy(mp, module, name, calls, result=None):
    """Replace `module.name` by a function that records its arguments and
    returns `result`, or calls through when `result` is None."""
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(args)
        return real(*args, **kw) if result is None else result

    mp.setattr(module, name, spy)


# What both CLIs' Frechet distance returns in the parity runs: the 2048²
# scipy sqrtm took 20 s (8 threads) to 34 s (one) on an 8-core CPU, and
# beside the test run's other workers several times that, enough to push
# the whole run past its time limit. The distance is taken instead from the features each CLI
# extracted, by `_fid_closed_form`; `frechet_distance` itself is the JAX
# package's code, held equal to it in test_torch_port_metrics.py, and
# `chip_smoke.py` [8] runs it at 2048² on the card's host.
FID_RECORDED = 7.5


def _fid_closed_form(real, fake):
    """The Frechet distance of two feature sets with the sqrtm term in closed
    form: with S = AᵀA (A the centred features over sqrt(n - 1)), tr sqrt(S1
    S2) is the sum of the singular values of A1 A2ᵀ, an n1 × n2 matrix. Exact
    at any dimension; scipy's sqrtm of the singular 2048² product came within
    7.7e-7 of it."""
    def centred(f):
        f = np.asarray(f, np.float64)
        return f.mean(0), (f - f.mean(0)) / np.sqrt(len(f) - 1)

    (mu1, a1), (mu2, a2) = centred(real), centred(fake)
    diff = mu1 - mu2
    return float(diff @ diff + (a1**2).sum() + (a2**2).sum()
                 - 2 * np.linalg.svd(a1 @ a2.T, compute_uv=False).sum())


@pytest.fixture(scope="module")
def parity_runs(data_tree, checkpoint, weights, tmp_path_factory):
    """One float32 run with FID, KID and LPIPS by each CLI: {"jax"/"port":
    metrics.json, "jax_dir"/"port_dir": output dirs, "jax_fd"/"port_fd":
    the Frechet distance's arguments (recorded, FID_RECORDED returned),
    "jax_feats"/"port_feats": (real, fake) Inception features, as KID
    received them}."""
    img_dir, mask_dir = data_tree
    root = tmp_path_factory.mktemp("eval_runs")
    argv = ["--data_dir", img_dir, "--mask_dir", mask_dir, "--checkpoint", checkpoint,
            "--dtype", "f32", "--fid_weights", weights["fid"],
            "--lpips_alexnet", weights["alex"], "--lpips_lin", weights["lin"], *RUN]
    runs = {}
    for pkg, metrics, main in (("jax", jax_metrics, jax_evaluate.main), ("port", port_metrics,
                                                                        _port)):
        fd, kid = [], []
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "port":
                _use_jax_draws(mp)
            _spy(mp, metrics, "frechet_distance", fd, result=FID_RECORDED)
            _spy(mp, metrics, "kid_from_features", kid)
            main(argv + ["--output_dir", str(root / pkg)])
        runs.update({pkg: _metrics_json(root / pkg), f"{pkg}_dir": root / pkg,
                     f"{pkg}_fd": fd[0], f"{pkg}_feats": kid[0][:2]})
    return runs


# --------------------------------------------------------------- arguments

ARGVS = [
    [],
    ["--preset", "ddim-50", "--eta", "0.3", "--ddim_timesteps", "20", "--seed", "7"],
    ["--preset", "ddim-100-deep", "--encoder_cache_tail", "5", "--batch_size", "2"],
    ["--encoder_cache", "3", "--cache_branch", "1", "--cache_keysteps", "17@1.0:2.0"],
    ["--no_injection", "--injection_schedule", "high", "--no_blend", "--time_spacing",
     "trailing", "--schedule", "linear", "--diffusion_steps", "500"],
    ["--timesteps", "999", "500", "0", "--mean_type", "velocity", "--quantize", "int8"],
    ["--preset", "dpm-25-sde", "--quick_test", "--no_save_images", "--dtype", "f32"],
    ["--fid_weights", "w.pth", "--fid_stats", "s.npz", "--lpips_alexnet", "a.pth",
     "--lpips_lin", "l.pt", "--checkpoint", "m.npz", *MODEL],
]
ARGV_IDS = ["defaults", "ddim-50", "deep-tail", "keysteps", "injection", "student",
            "quick", "metrics"]
REQUIRED = ["--data_dir", "d", "--mask_dir", "m"]


@pytest.mark.parametrize("argv", ARGVS, ids=ARGV_IDS)
def test_parse_args_matches_jax(argv):
    ours = vars(port_evaluate.parse_args(REQUIRED + argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_evaluate.parse_args(REQUIRED + argv))


def test_parse_args_config_defaults_match_jax(tmp_path):
    """A --config JSON sets defaults; flags on the command line win."""
    cfg = tmp_path / "eval.json"
    cfg.write_text(json.dumps({"preset": "ddim-50", "batch_size": 2, "eta": 0.5}))
    argv = REQUIRED + ["--config", str(cfg), "--eta", "0.1"]
    ours = vars(port_evaluate.parse_args(argv))
    ours.pop("device")
    assert ours == vars(jax_evaluate.parse_args(argv))
    assert (ours["preset"], ours["batch_size"], ours["eta"]) == ("ddim-50", 2, 0.1)


class _Built(Exception):
    """Raised in place of building the JAX pipeline, carrying its config."""


@pytest.mark.parametrize("argv", [a for a in ARGVS if "--checkpoint" not in a],
                         ids=[i for a, i in zip(ARGVS, ARGV_IDS) if "--checkpoint" not in a])
def test_sampler_flags_match_jax(argv, monkeypatch):
    """The sampler the port builds from the flags equals the one the JAX CLI
    hands its pipeline (its `create` is stopped there), field by field."""
    from fidm_tpu import pipeline as jax_pipeline

    def stop(config=None, **kw):
        raise _Built(config)

    monkeypatch.setattr(jax_pipeline.InpaintingPipeline, "create", staticmethod(stop))
    with pytest.raises(_Built) as built:
        jax_evaluate.main(REQUIRED + argv)
    ref = dataclasses.asdict(built.value.args[0].sampler)
    args = port_evaluate.parse_args(REQUIRED + argv)
    if args.quick_test:  # main applies it before the sampler is built
        args.ddim_timesteps = args.ddim_timesteps or 10
    ours = dataclasses.asdict(port_evaluate.build_sampler(args))
    for k in ("mean_type", "var_type"):
        assert ours.pop(k).name == ref.pop(k).name, k
    assert ours == ref


def test_cache_keysteps_refused_as_in_jax():
    argv = REQUIRED + ["--preset", "consistency-2", "--cache_keysteps", "0,1"]
    with pytest.raises(SystemExit, match="not supported with method='consistency'"):
        jax_evaluate.main(argv)
    with pytest.raises(SystemExit, match="not supported with method='consistency'"):
        port_evaluate.main(argv + ["--device", "cpu"])


# ----------------------------------------------------------- whole-CLI parity
# Both CLIs in float32 on the same checkpoint, data and noise: the images
# differ by float32 rounding carried through 10 DDIM steps. Per sample:
# SSIM and hole SSIM 5e-5 absolute, PSNR and hole PSNR 5e-5 dB (measured up
# to 6.3e-6 and 2.9e-6); LPIPS 1e-5 relative plus 1e-8 absolute (measured
# 6e-9 absolute on values near 5e-3). The proxy FID (256-d features, the
# JAX extractor's weights) 1e-5 relative (measured 1.3e-7).
# FID and KID: with 8 samples the 2048-d covariances are singular, and the
# Inception features (up to about 340 here) differ between the packages by
# up to 1.5e-4 (rms 1.6e-5). Each is held to a witness taken in the test:
# five times the relative move of JAX's value when JAX's own features get
# gaussian noise of the largest measured feature gap (measured: the noise
# moves FID by 5.7e-5 and KID by 4.4e-5; the packages differ by 1.7e-5 and
# 4.3e-5).
SSIM_TOL, PSNR_TOL = 5e-5, 5e-5


def _witness_bound(statistic, ours, ref):
    """Five times the relative move of `statistic(real, fake)` on JAX's
    features when they get gaussian noise of the largest feature gap."""
    gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(ours, ref))
    real, fake = (np.asarray(f, np.float64) for f in ref)
    value = statistic(real, fake)
    rng = np.random.default_rng(0)
    moved = statistic(real + rng.normal(0, gap, real.shape),
                      fake + rng.normal(0, gap, fake.shape))
    return 5 * abs(moved - value) / abs(value)


def _kid(real, fake):
    return port_metrics.kid_from_features(real, fake)[0]


def test_metrics_json_matches_jax(parity_runs):
    ref, ours = parity_runs["jax"], parity_runs["port"]
    assert set(ours) == set(ref)
    assert set(ours["per_sample"]) == set(ref["per_sample"]) == {
        "ssim", "psnr", "hole_ssim", "hole_psnr", "lpips", "hole_lpips"}
    assert ours["num_samples"] == ref["num_samples"] == N_IMAGES
    assert ours["preset"] == ref["preset"] == "ddim-100"
    assert ours["backend"] == "cpu" and ref["backend"] == "cpu"
    assert ours["sampler"].startswith("SamplerConfig(method='ddim', num_steps=10,")
    for k in ("time_per_sample_s", "time_per_sample_steady_s"):
        assert ours[k] > 0
    for k, tol in (("ssim", SSIM_TOL), ("hole_ssim", SSIM_TOL), ("psnr", PSNR_TOL),
                   ("hole_psnr", PSNR_TOL)):
        a, b = ours["per_sample"][k], ref["per_sample"][k]
        assert len(a) == len(b) == N_IMAGES
        assert [v is None for v in a] == [v is None for v in b], k
        np.testing.assert_allclose([v for v in a if v is not None],
                                   [v for v in b if v is not None], atol=tol, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(ours[f"{k}_mean"], ref[f"{k}_mean"], atol=tol, rtol=0)
    for k in ("lpips", "hole_lpips"):
        np.testing.assert_allclose(ours["per_sample"][k], ref["per_sample"][k],
                                   rtol=1e-5, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(ours[f"{k}_mean"], ref[f"{k}_mean"], rtol=1e-5, atol=1e-8)
    assert ours["fid_proxy"] == pytest.approx(ref["fid_proxy"], rel=1e-5)
    feats, ref_feats = parity_runs["port_feats"], parity_runs["jax_feats"]
    for a, b in zip(feats, ref_feats):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    # each CLI hands the Frechet distance its own features' statistics
    assert ours["fid"] == ref["fid"] == FID_RECORDED
    for run, f in (("port_fd", feats), ("jax_fd", ref_feats)):
        (mu_r, sig_r), (mu_f, sig_f) = (port_metrics.compute_statistics(x) for x in f)
        for x, y in zip(parity_runs[run], (mu_r, sig_r, mu_f, sig_f)):
            np.testing.assert_array_equal(x, y)
    assert _fid_closed_form(*feats) == pytest.approx(
        _fid_closed_form(*ref_feats), rel=_witness_bound(_fid_closed_form, feats, ref_feats))
    assert ours["kid_mean"] == pytest.approx(
        ref["kid_mean"], rel=_witness_bound(_kid, feats, ref_feats))
    assert ours["kid_std"] == ref["kid_std"] == 0.0  # 8 samples: one exact MMD²


@pytest.mark.parametrize("n,dim", [(40, 16), (8, 64)], ids=["full-rank", "singular"])
def test_fid_closed_form_equals_frechet_distance(n, dim):
    """The closed form against the CLIs' `frechet_distance` (scipy's sqrtm):
    to rounding at full rank, within scipy's approximation (1e-6
    relative) where the covariances are singular, as with 8 samples."""
    rng = np.random.default_rng(n)
    real = rng.standard_normal((n, dim))
    fake = rng.standard_normal((n, dim)) * 1.2 + 0.3
    tol = 1e-9 if n > dim else 1e-6
    assert _fid_closed_form(real, fake) == pytest.approx(
        port_metrics.fid_from_features(real, fake), rel=tol)


def _pngs(directory):
    return sorted(str(p.relative_to(directory)) for p in directory.rglob("*.png"))


def _png(path):
    return np.asarray(Image.open(path))


def test_outputs_written_in_the_jax_layout(parity_runs):
    """The same files, each within one level of JAX's (`to_uint8`
    truncates, and the JAX package normalises images in its native library
    when it is built, to within 1e-6 of numpy's, so a value at a level
    boundary can fall to the level below); inpainted images equal to the
    originals outside the hole."""
    jax_dir, port_dir = parity_runs["jax_dir"], parity_runs["port_dir"]
    names = _pngs(port_dir)
    assert names == _pngs(jax_dir)
    assert len(names) == 2 * N_IMAGES + 2  # inpainted/, original/, two grids
    for name in names:
        a, b = _png(port_dir / name), _png(jax_dir / name)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, name
        assert np.abs(a.astype(int) - b).max() <= 1, name
    for i in range(N_IMAGES):  # the box and the brush mask hold the border rows
        out = _png(port_dir / "inpainted" / f"{i:05d}.png")
        gt = _png(port_dir / "original" / f"{i:05d}.png")
        np.testing.assert_array_equal(out[0], gt[0])
        assert not np.array_equal(out, gt)
    with open(port_dir / "metrics.txt") as f, open(jax_dir / "metrics.txt") as g:
        assert [ln.split(":")[0] for ln in f] == [ln.split(":")[0] for ln in g]


# ---------------------------------------------------------------- branches


def _quick(data_tree, out_dir, *extra):
    img_dir, mask_dir = data_tree
    argv = ["--data_dir", img_dir, "--mask_dir", mask_dir, "--output_dir", str(out_dir),
            "--no_save_images", *RUN, *extra]
    results = _port(argv)
    return results, _metrics_json(out_dir)


def test_npz_checkpoint_equals_quantize_int8(data_tree, checkpoint, parity_runs, tmp_path):
    """An int8 `.npz` (the port's quantize CLI, rounded to nearest on the
    CPU as the JAX CLI is, which writes the same file bit for bit:
    test_torch_port_quantize_cli.py) and `--quantize int8` on the `.pt`
    (also nearest on the CPU) give the same weights, so the same metrics
    bit for bit; both differ from the float weights."""
    from fidm_tpu_torch.cli import quantize as port_quantize

    npz = str(tmp_path / "int8.npz")
    port_quantize.main(["--checkpoint", checkpoint, "--out", npz, *MODEL, "--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        _use_jax_draws(mp)  # the parity run's draws: it ran the float weights
        _, from_npz = _quick(data_tree, tmp_path / "npz", "--checkpoint", npz, "--dtype", "f32")
        _, quantized = _quick(data_tree, tmp_path / "q", "--checkpoint", checkpoint,
                              "--quantize", "int8", "--dtype", "f32")
    assert from_npz["per_sample"] == quantized["per_sample"]
    assert from_npz["fid_proxy"] == quantized["fid_proxy"]
    assert from_npz["per_sample"]["ssim"] != parity_runs["port"]["per_sample"]["ssim"]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_dtype_sets_the_unet_activations(dtype, checkpoint):
    args = port_evaluate.parse_args(REQUIRED + ["--checkpoint", checkpoint, "--dtype", dtype,
                                                "--device", "cpu", *MODEL])
    pipe = port_evaluate.build_pipeline(args, port_evaluate.build_sampler(args))
    assert pipe.config.unet.dtype == {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    assert all(p.dtype == torch.float32 for p in pipe.model.parameters())
    assert pipe.config.unet.image_size == SIZE and pipe.device.type == "cpu"


@pytest.fixture(scope="module")
def bf16_run(data_tree, checkpoint, tmp_path_factory):
    """A quick run at the default dtype (bf16 activations) from the PNGs,
    on the JAX draws: its metrics.json."""
    with pytest.MonkeyPatch.context() as mp:
        _use_jax_draws(mp)
        _, blob = _quick(data_tree, tmp_path_factory.mktemp("eval_bf16"), "--checkpoint",
                         checkpoint)
    return blob


def test_bf16_run_stays_near_the_float32_run(bf16_run, parity_runs):
    """The default dtype on the JAX draws: per-sample SSIM within 2e-2 of
    the float32 run's (bf16 keeps 8 bits of mantissa through 10 steps of a
    32² model)."""
    f32 = parity_runs["port"]["per_sample"]["ssim"]
    np.testing.assert_allclose(bf16_run["per_sample"]["ssim"], f32, atol=2e-2, rtol=0)
    assert bf16_run["per_sample"]["ssim"] != f32


def test_fid_stats_branch(data_tree, checkpoint, weights, parity_runs, fid_stats_runs,
                          tmp_path):
    """`--fid_stats`, on the port's `fid_stats` file of the 8 images: the
    Frechet distance is taken against the file's (mu, sigma) and the fakes'
    statistics (the same as the parity run's: same checkpoint, draws and
    network), KID against the file's float16 features. The distance itself
    is a recorder here, as in the parity test."""
    stats = fid_stats_runs["port"]["npz"]
    calls, kid_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        _use_jax_draws(mp)
        _spy(mp, port_metrics, "frechet_distance", calls, result=1.5)
        _spy(mp, port_metrics, "kid_from_features", kid_calls)
        results, blob = _quick(data_tree, tmp_path / "ev", "--checkpoint", checkpoint,
                               "--dtype", "f32", "--fid_weights", weights["fid"],
                               "--fid_stats", stats)
    assert results["fid"] == blob["fid"] == 1.5 and len(calls) == 1
    mu, sigma, mu_f, sig_f = calls[0]
    with np.load(stats) as ref:
        np.testing.assert_array_equal(mu, ref["mu"])
        np.testing.assert_array_equal(sigma, ref["sigma"])
        np.testing.assert_array_equal(kid_calls[0][0], ref["features"].astype(np.float64))
    par_mu_r, _, par_mu_f, par_sig_f = parity_runs["port_fd"]
    np.testing.assert_array_equal(mu_f, par_mu_f)
    np.testing.assert_array_equal(sig_f, par_sig_f)
    for a, b in zip(port_metrics.compute_statistics(kid_calls[0][1]), (mu_f, sig_f)):
        np.testing.assert_array_equal(a, b)
    # the stats file's real side is the parity run's (the same 8 images),
    # the features extracted in another batch: 1e-6 of the largest mean
    np.testing.assert_allclose(mu, par_mu_r, rtol=0, atol=1e-6 * np.abs(par_mu_r).max())
    assert results["kid_mean"] > 0 and results["kid_std"] == 0.0


def test_evaluate_empty_mask_samples_stay_aligned(tmp_path):
    """Samples whose mask has no hole get None in the per-sample hole
    arrays (keeping dataset alignment) and are excluded from the means."""
    img_dir = tmp_path / "imgs"
    mask_dir = tmp_path / "masks" / "test"
    img_dir.mkdir()
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
    # mask 0: normal box hole; mask 1: all-white = NO hole
    m = np.full((32, 32), 255, np.uint8)
    m[8:24, 8:24] = 0
    Image.fromarray(m).save(mask_dir / "mask_0.png")
    Image.fromarray(np.full((32, 32), 255, np.uint8)).save(mask_dir / "mask_1.png")
    results, blob = _quick((str(img_dir), str(tmp_path / "masks")), tmp_path / "res")
    hole = blob["per_sample"]["hole_psnr"]
    assert len(hole) == 4
    # ordered masks cycle 0,1,0,1 -> samples 1 and 3 unscorable
    assert hole[1] is None and hole[3] is None
    assert hole[0] is not None and hole[2] is not None
    assert blob["per_sample"]["hole_ssim"][1] is None
    assert np.isfinite(results["hole_psnr_mean"])
    assert results["hole_psnr_mean"] == pytest.approx(np.mean([hole[0], hole[2]]), abs=1e-9)
    # json must be strictly valid (no NaN tokens)
    json.loads((tmp_path / "res" / "metrics.json").read_text(), parse_constant=None)


# ---------------------------------------------------------------- refusals


def test_unported_branches_raise_before_building(data_tree, tmp_path, monkeypatch):
    """Orbax directories, trajectories, the program cache and unported
    presets raise NotImplementedError naming what is missing, before a model
    is built; `--fid_stats` without `--fid_weights` raises ValueError as in
    JAX."""
    def never(*a, **kw):
        raise AssertionError("built a pipeline")

    monkeypatch.setattr(port_evaluate, "build_pipeline", never)
    img_dir, mask_dir = data_tree
    base = ["--data_dir", img_dir, "--mask_dir", mask_dir, "--output_dir",
            str(tmp_path / "never"), *RUN]
    (tmp_path / "orbax").mkdir()
    cases = [(["--checkpoint", str(tmp_path / "orbax")], NotImplementedError, "orbax"),
             (["--checkpoint", str(tmp_path / "orbax"), "--use_ema"], NotImplementedError,
              "orbax"),
             (["--save_trajectory", "2"], NotImplementedError, "--save_trajectory"),
             (["--program_cache", str(tmp_path / "aot")], NotImplementedError,
              "--program_cache"),
             (["--preset", "repaint-100-light"], NotImplementedError, "not ported"),
             (["--preset", "unipc-20"], NotImplementedError, "not ported"),
             (["--fid_stats", "s.npz"], ValueError, "--fid_weights")]
    for extra, exc, match in cases:
        with pytest.raises(exc, match=match):
            _port(base + extra)
    assert not (tmp_path / "never").exists()


def test_cli_defaults_to_cuda_and_raises_without_gpu(data_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img_dir, mask_dir = data_tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_evaluate.main(["--data_dir", img_dir, "--mask_dir", mask_dir, "--output_dir",
                            str(tmp_path / "x"), *RUN])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fid_stats.main(["--data_dir", img_dir, "--fid_weights", "w.pth", "--out",
                             str(tmp_path / "s.npz")])


# ------------------------------------------------------ fid_stats, pack_data


@pytest.fixture(scope="module")
def fake_dir(tmp_path_factory):
    """4 generated-looking 32² PNGs (another seed's smooth images): one
    batch of 4, the shape the JAX package's eager Inception has already
    compiled its operations for."""
    d = tmp_path_factory.mktemp("eval_fake")
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    for i in range(N_FAKE):
        base = np.stack([np.cos(4 * xx + i), np.sin(yy - 2 * i), xx], -1)
        arr = np.clip(127.5 + 80 * base + rng.normal(0, 20, base.shape), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(d / f"gen_{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def fid_stats_runs(data_tree, fake_dir, weights, tmp_path_factory):
    """Each CLI in directory-compare mode with `--out` (so also stats
    mode's file). The Inception features each extracts are recorded (at
    `compute_statistics`), and its Frechet distance is recorded in place of
    the 2048² sqrtm (the parity test computes that one at full size):
    {pkg: {"report", "npz", "feats": [real, fake], "fd": its arguments}}."""
    root = tmp_path_factory.mktemp("fid_stats")
    img_dir, _ = data_tree
    argv = ["--data_dir", img_dir, "--fake_dir", fake_dir, "--fid_weights", weights["fid"],
            "--image_size", str(SIZE), "--batch_size", "4"]
    runs = {}
    for pkg, cli, module, extra in (("jax", jax_fid_stats, jax_fid, []),
                                    ("port", port_fid_stats, port_fid, ["--device", "cpu"])):
        feats, fd = [], []
        with pytest.MonkeyPatch.context() as mp:
            _spy(mp, module, "compute_statistics", feats)
            _spy(mp, module, "frechet_distance", fd, result=2.5)
            report = cli.main(argv + ["--out", str(root / f"{pkg}.npz"), *extra])
        runs[pkg] = {"report": report, "npz": str(root / f"{pkg}.npz"),
                     "feats": [f[0] for f in feats[:2]], "fd": fd[0]}
    return runs


def test_fid_stats_features_match_jax(fid_stats_runs):
    """The real and fake Inception features of both CLIs (1e-5 of the
    largest, as in the metric tests), and each CLI's file and Frechet
    arguments exactly its own features' statistics."""
    ref, ours = fid_stats_runs["jax"], fid_stats_runs["port"]
    assert [f.shape for f in ours["feats"]] == [f.shape for f in ref["feats"]] == [
        (N_IMAGES, 2048), (N_FAKE, 2048)]
    for a, b in zip(ours["feats"], ref["feats"]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for run in (ours, ref):
        (mu, sigma), (mu_f, sig_f) = (port_metrics.compute_statistics(f) for f in run["feats"])
        for x, y in zip(run["fd"], (mu, sigma, mu_f, sig_f)):
            np.testing.assert_array_equal(x, y)
        with np.load(run["npz"]) as npz:
            assert sorted(npz.files) == ["dim", "features", "mu", "num_images", "sigma"]
            assert (int(npz["num_images"]), int(npz["dim"])) == (N_IMAGES, 2048)
            np.testing.assert_array_equal(npz["mu"], mu)
            np.testing.assert_array_equal(npz["sigma"], sigma)
            np.testing.assert_array_equal(npz["features"], run["feats"][0].astype(np.float16))


def test_fid_stats_fake_dir_report_matches_jax(fid_stats_runs):
    """Directory against directory: the same report. KID is held to a
    witness taken here: JAX's KID on its own features plus gaussian noise
    of the measured feature gap; the bound is five times what that moves."""
    ref, ours = fid_stats_runs["jax"], fid_stats_runs["port"]
    assert set(ours["report"]) == set(ref["report"]) == {
        "fid", "num_real", "num_fake", "kid_mean", "kid_std"}
    assert ours["report"]["fid"] == ref["report"]["fid"] == 2.5
    assert ((ours["report"]["num_real"], ours["report"]["num_fake"])
            == (ref["report"]["num_real"], ref["report"]["num_fake"]) == (N_IMAGES, N_FAKE))
    assert ours["report"]["kid_mean"] == pytest.approx(
        ref["report"]["kid_mean"], rel=_witness_bound(_kid, ours["feats"], ref["feats"]))
    assert ours["report"]["kid_std"] == ref["report"]["kid_std"] == 0.0


def test_fid_stats_modes_agree(fid_stats_runs, data_tree, fake_dir, weights, tmp_path):
    """Stats mode alone writes the file directory-compare mode wrote, and
    directory-against-stats takes its real side from that file: the
    Frechet arguments (mu, sigma) are the file's, KID uses its float16
    features."""
    img_dir, _ = data_tree
    flags = ["--fid_weights", weights["fid"], "--image_size", str(SIZE), "--batch_size", "4",
             "--device", "cpu"]
    run = fid_stats_runs["port"]
    info = port_fid_stats.main(["--data_dir", img_dir, "--out", str(tmp_path / "s.npz"),
                                *flags])
    assert info == {"num_images": N_IMAGES, "dim": 2048, "out": str(tmp_path / "s.npz")}
    with np.load(tmp_path / "s.npz") as a, np.load(run["npz"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fd, kid = [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, port_fid, "frechet_distance", fd, result=3.5)
        _spy(mp, port_metrics, "kid_from_features", kid)
        report = port_fid_stats.main(["--fake_dir", fake_dir, "--fid_stats", run["npz"],
                                      *flags])
    assert report["fid"] == 3.5 and report["num_real"] == N_IMAGES
    for a, b in zip(fd[0], run["fd"]):
        np.testing.assert_array_equal(a, b)
    with np.load(run["npz"]) as npz:
        np.testing.assert_array_equal(kid[0][0], npz["features"].astype(np.float64))
    np.testing.assert_array_equal(kid[0][1], run["feats"][1])
    assert report["kid_mean"] == port_metrics.kid_from_features(kid[0][0], kid[0][1])[0]


def test_pack_data_matches_jax_and_feeds_evaluate(data_tree, checkpoint, bf16_run, tmp_path):
    """The packed index and shards equal the JAX CLI's, and a quick run from
    the packed directory equals the same run from the PNGs (`bf16_run`)."""
    img_dir, mask_dir = data_tree
    argv = ["--data_dir", img_dir, "--image_size", str(SIZE), "--shard_size", "3"]
    ours = port_pack_data.main(argv + ["--out", str(tmp_path / "port")])
    ref = jax_pack_data.main(argv + ["--out", str(tmp_path / "jax")])
    assert {**ours, "out": None} == {**ref, "out": None}
    assert ours["num_images"] == N_IMAGES and ours["num_shards"] == 3
    assert (json.loads((tmp_path / "port" / "index.json").read_text())
            == json.loads((tmp_path / "jax" / "index.json").read_text()))
    for shard in sorted((tmp_path / "jax").glob("shard_*.npy")):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / shard.name), np.load(shard))
    with pytest.MonkeyPatch.context() as mp:
        _use_jax_draws(mp)
        _, packed = _quick((str(tmp_path / "port"), mask_dir), tmp_path / "ev_packed",
                           "--checkpoint", checkpoint)
    assert packed["per_sample"] == bf16_run["per_sample"]
    assert packed["fid_proxy"] == bf16_run["fid_proxy"]


def test_step_timer_and_image_helpers_match_jax(tmp_path):
    """`to_uint8`, `save_png` and `save_comparison_grid` are copies of the
    JAX package's (the same bytes on disk); `StepTimer` keeps its API and
    waits for nothing on CPU tensors; `trace` writes a profiler trace."""
    from fidm_tpu import utils as jax_utils
    from fidm_tpu_torch import utils as port_utils

    rng = np.random.default_rng(1)
    img = rng.uniform(-1.2, 1.2, (16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_utils.to_uint8(img), jax_utils.to_uint8(img))
    rows = [[port_utils.to_uint8(img), (img[..., :1] > 0).astype(np.uint8) * 255]] * 2
    port_utils.save_comparison_grid(rows, str(tmp_path / "p" / "grid.png"))
    jax_utils.save_comparison_grid(rows, str(tmp_path / "j" / "grid.png"))
    assert (tmp_path / "p" / "grid.png").read_bytes() == (tmp_path / "j" / "grid.png").read_bytes()
    timer = port_utils.StepTimer()
    assert timer.summary() == "no steps timed"
    for _ in range(2):
        timer.start()
        timer.stop(torch.zeros(2))
    assert len(timer.times) == 2 and timer.mean >= 0
    assert timer.summary(per=2).startswith("2 steps, mean ")
    with port_utils.trace(str(tmp_path / "trace")):
        torch.ones(4) + 1
    assert list((tmp_path / "trace").glob("*.json"))
