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

The flag parsing and the host helpers are in
`test_torch_port_evaluate_flags.py`: port test files hold at most 25 cases
(ROADMAP.md).
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

from _torch_port_common import JaxKeyNoise, one_torch_thread  # noqa: F401
from _torch_port_evaluate_common import MODEL, _fid_closed_form, REQUIRED
from oracle_fid_inception import FIDInceptionOracle
from oracle_fid_inception import randomize as randomize_inception
from oracle_lpips import LPIPSOracle
from oracle_lpips import randomize as randomize_lpips


SIZE = 32
SHAPE = dict(image_size=SIZE, model_channels=32, channel_mult=(1, 2), num_heads=2,
             num_head_channels=16, attention_resolutions=(2,))
RUN = ["--quick_test", "--diffusion_steps", "100", *MODEL]
N_IMAGES = 8
N_FAKE = 4


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
# package's code, held equal to it in test_torch_port_metrics_fid.py, and
# `chip_smoke.py` [8] runs it at 2048² on the card's host.
FID_RECORDED = 7.5


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
    """A checkpoint directory without a checkpoint raises FileNotFoundError
    before a model is built (training checkpoint directories are read since
    training was ported: tests/test_torch_port_training_cli.py); `--fid_stats`
    without `--fid_weights` raises ValueError as in JAX. (`--save_trajectory`
    and the repaint and unipc presets run since the rest of sampling was
    ported: test_save_trajectory_and_the_new_presets; `--program_cache` since
    the warm program cache was: tests/test_torch_port_aot.py.)"""
    def never(*a, **kw):
        raise AssertionError("built a pipeline")

    monkeypatch.setattr(port_evaluate, "build_pipeline", never)
    img_dir, mask_dir = data_tree
    base = ["--data_dir", img_dir, "--mask_dir", mask_dir, "--output_dir",
            str(tmp_path / "never"), *RUN]
    (tmp_path / "orbax").mkdir()
    cases = [(["--checkpoint", str(tmp_path / "orbax")], FileNotFoundError, "no checkpoints"),
             (["--checkpoint", str(tmp_path / "orbax"), "--use_ema"], FileNotFoundError,
              "no checkpoints"),
             (["--fid_stats", "s.npz"], ValueError, "--fid_weights")]
    for extra, exc, match in cases:
        with pytest.raises(exc, match=match):
            _port(base + extra)
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("preset,k", [("unipc-20", 4), ("repaint-100-light", 2)])
def test_save_trajectory_and_the_new_presets(data_tree, checkpoint, tmp_path, preset, k):
    """`--save_trajectory K` with a unipc and a repaint preset (once refused
    as not ported): the JAX CLI's files, `trajectory/{index:05d}_strip.png`
    for the first 4 samples of each batch, each strip the masked input, the
    N = (rows - 1)//K + 1 frames and the output side by side."""
    from fidm_tpu_torch.diffusion import DiffusionSchedule
    from fidm_tpu_torch.pipeline import SAMPLER_PRESETS
    from fidm_tpu_torch.sampling import sampler as port_sampler

    out_dir = tmp_path / "traj"
    results, blob = _quick(data_tree, out_dir, "--checkpoint", checkpoint, "--preset", preset,
                           "--save_trajectory", str(k), "--dtype", "f32", "--jump_length",
                           "3")
    assert results["num_samples"] == N_IMAGES and results["preset"] == preset
    assert set(blob) == set(results) | {"per_sample"}
    cfg = dataclasses.replace(SAMPLER_PRESETS[preset], num_steps=10, jump_length=3)
    sched = DiffusionSchedule.create("quadratic", 100, device="cpu")
    rows = len(port_sampler._method_tables(sched, cfg)["t"])
    n_frames = (rows - 1) // k + 1
    # 8 samples in 2 batches of 4: every sample gets a strip
    names = sorted(p.name for p in (out_dir / "trajectory").iterdir())
    assert names == [f"{i:05d}_strip.png" for i in range(N_IMAGES)]
    for name in names:
        strip = np.asarray(Image.open(out_dir / "trajectory" / name))
        assert strip.shape == (SIZE, (n_frames + 2) * SIZE, 3)
        frames = strip.reshape(SIZE, n_frames + 2, SIZE, 3).transpose(1, 0, 2, 3)
        assert len({f.tobytes() for f in frames}) == n_frames + 2


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
