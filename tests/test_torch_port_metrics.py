"""The port's metric modules against the JAX package's, on the same numpy
inputs from a seed.

SSIM/PSNR (whole image and hole region), the FID InceptionV3 (weights folded
by both converters from one seeded oracle state dict in the
pt_inception layout), LPIPS (the oracle's AlexNet and linear-head state
dicts, and the proxy weights both packages draw from numpy), the proxy-FID
extractor on the JAX extractor's weights carried across, and the numpy
statistics (FID, KID). JAX runs at "highest" matmul precision (conftest),
torch in float32 on one intra-op thread. Each tolerance is stated beside its
test.
"""
import importlib

import numpy as np
import pytest
import torch

from fidm_tpu import metrics as J
from fidm_tpu.metrics import fid as jax_fid
from fidm_tpu.metrics.lpips import convert_torch_lpips_weights as jax_convert_lpips
from fidm_tpu_torch import metrics as P
from fidm_tpu_torch.metrics import fid as port_fid
from fidm_tpu_torch.metrics import inception as port_inception
from fidm_tpu_torch.metrics.lpips import convert_torch_lpips_weights as port_convert_lpips

from oracle_fid_inception import FIDInceptionOracle
from oracle_fid_inception import randomize as randomize_inception
from oracle_lpips import LPIPSOracle
from oracle_lpips import randomize as randomize_lpips

# the modules (each package's `metrics.ssim` attribute is the function)
jax_ssim = importlib.import_module("fidm_tpu.metrics.ssim")
port_ssim = importlib.import_module("fidm_tpu_torch.metrics.ssim")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small forwards under the test run's parallel workers: one torch
    intra-op thread, and one BLAS thread, for this module (the default
    pools, one thread per core, thrash against the other workers)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _images(seed, b, size, lo=0.0):
    """A pair of [b, size, size, 3] float32 images in [lo, 1], the second
    the first plus noise."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1, (b, size, size, 3)).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.15, a.shape), lo, 1).astype(np.float32)


def _mask(kind, b=2, size=48):
    m = np.zeros((b, size, size, 1), np.float32)
    if kind == "box":
        m[0, 10:30, 6:40] = 1.0
        m[1, 20:44, 24:46] = 1.0
    elif kind == "brush":
        rng = np.random.default_rng(3)
        yy, xx = np.mgrid[:size, :size]
        for i in range(b):
            y, x = rng.uniform(8, size - 8, 2)
            for _ in range(10):
                m[i, (yy - y) ** 2 + (xx - x) ** 2 <= rng.uniform(2, 5) ** 2] = 1.0
                a = rng.uniform(0, 2 * np.pi)
                y = np.clip(y + 4 * np.sin(a), 0, size - 1)
                x = np.clip(x + 4 * np.cos(a), 0, size - 1)
    elif kind == "border":  # inside the (win-1)/2 band of windows 7 and 11 only
        m[:, :3] = 1.0
        m[:, :, -2:] = 1.0
    return m


# ----------------------------------------------------------------- SSIM / PSNR
# float32 on both sides; the 11x11 window means are sums in another order
# (avg_pool2d against XLA's convolution). SSIM lies in [-1, 1]: 2e-6
# absolute (measured up to about 3e-7). PSNR is in dB (10-40 here), where
# one float32 ulp of the log is about 2e-6: 2e-5 absolute.
SSIM_TOL = 2e-6
PSNR_TOL = 2e-5
MASKS = ["box", "brush", "empty", "border"]


@pytest.mark.parametrize("win", [7, 11])
def test_ssim_matches_jax(win):
    a, b = _images(0, 2, 48)
    ref = np.asarray(jax_ssim.ssim(a, b, win_size=win))
    ours = port_ssim.ssim(a, b, win_size=win)
    assert ours.dtype == torch.float32 and ours.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=SSIM_TOL, rtol=0)


@pytest.mark.parametrize("win", [7, 11])
@pytest.mark.parametrize("kind", MASKS)
def test_masked_ssim_matches_jax(kind, win):
    a, b = _images(1, 2, 48)
    m = _mask(kind)
    ref = np.asarray(jax_ssim.masked_ssim(a, b, m, win_size=win))
    ours = port_ssim.masked_ssim(a, b, m, win_size=win).numpy()
    np.testing.assert_allclose(ours, ref, atol=SSIM_TOL, rtol=0)
    if kind in ("empty", "border"):  # no centred window in the hole: 0
        assert np.all(ours == 0.0) and np.all(ref == 0.0)


def test_psnr_matches_jax():
    a, b = _images(2, 2, 48)
    np.testing.assert_allclose(port_ssim.psnr(a, b).numpy(), np.asarray(jax_ssim.psnr(a, b)),
                               atol=PSNR_TOL, rtol=0)
    # identical images: the 1e-12 floor on the mse, 120 dB
    np.testing.assert_allclose(port_ssim.psnr(a, a).numpy(), np.asarray(jax_ssim.psnr(a, a)),
                               atol=PSNR_TOL, rtol=0)


@pytest.mark.parametrize("kind", MASKS)
def test_masked_psnr_matches_jax(kind):
    a, b = _images(3, 2, 48)
    m = _mask(kind)
    np.testing.assert_allclose(port_ssim.masked_psnr(a, b, m).numpy(),
                               np.asarray(jax_ssim.masked_psnr(a, b, m)), atol=PSNR_TOL, rtol=0)


@pytest.mark.parametrize("win", [1, 4, 10])
def test_ssim_rejects_what_jax_rejects(win):
    a, b = _images(4, 1, 24)
    with pytest.raises(ValueError, match="win_size must be odd"):
        jax_ssim.ssim(a, b, win_size=win)
    with pytest.raises(ValueError, match="win_size must be odd"):
        port_ssim.ssim(a, b, win_size=win)


def test_ssim_default_window_and_tensor_inputs():
    assert port_ssim.DEFAULT_WIN_SIZE == jax_ssim.DEFAULT_WIN_SIZE == 11
    a, b = _images(5, 2, 32)
    from_numpy = port_ssim.ssim(a, b)
    from_tensor = port_ssim.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(from_numpy, from_tensor)


# ------------------------------------------------------------ FID Inception


@pytest.fixture(scope="module")
def inception_sd():
    sd = dict(randomize_inception(FIDInceptionOracle(), seed=0).state_dict())
    # the real pt_inception checkpoint carries fc/AuxLogits keys the pool3
    # path never uses: both converters ignore them
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    return sd


@pytest.fixture(scope="module")
def jax_inception(inception_sd):
    return J.InceptionFeatureExtractor(J.convert_torch_inception_weights(inception_sd), jit=False)


@pytest.fixture(scope="module")
def port_inception_ext(inception_sd):
    return P.InceptionFeatureExtractor(P.convert_torch_inception_weights(inception_sd),
                                       device="cpu")


def test_inception_weights_fold_bit_equal(inception_sd):
    """BN folded in float64 then cast: the two packages' weights agree to
    the last bit."""
    ref = J.convert_torch_inception_weights(inception_sd)
    ours = P.convert_torch_inception_weights(inception_sd)
    assert list(ours) == list(ref)
    for name in ref:
        subs = ref[name] if "kernel" not in ref[name] else {"": ref[name]}
        mine = ours[name] if "kernel" not in ours[name] else {"": ours[name]}
        assert list(mine) == list(subs), name
        for sub, leaves in subs.items():
            for k in ("kernel", "bias"):
                assert mine[sub][k].dtype == np.float32
                np.testing.assert_array_equal(mine[sub][k], leaves[k], err_msg=f"{name}.{sub}.{k}")


# The features reach a few hundred with these weights; float32 convolutions
# in another order: 1e-5 of the largest feature (measured about 5e-7).
def _close_features(ours, ref, tol=1e-5):
    assert ours.shape == ref.shape and ours.dtype == np.float32
    err = np.abs(ours - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("b,size", [(2, 32), (1, 512)], ids=["2x32", "1x512"])
def test_inception_features_match_jax(jax_inception, port_inception_ext, b, size):
    """Upsampled (32 -> 299) and downsampled (512 -> 299, bilinear without
    antialiasing) inputs through the whole pool3 network."""
    x = np.random.default_rng(size).random((b, size, size, 3)).astype(np.float32)
    _close_features(port_inception_ext(x), jax_inception(x))


def test_inception_matches_the_torch_oracle(inception_sd, port_inception_ext):
    """The folded network against the oracle's unfolded BasicConv2d+BN
    forward on the same state dict."""
    oracle = FIDInceptionOracle()
    oracle.load_state_dict({k: v for k, v in inception_sd.items()
                            if not k.startswith(("fc.", "AuxLogits."))})
    oracle.eval()
    x = np.random.default_rng(7).random((2, 40, 40, 3)).astype(np.float32)
    ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    _close_features(port_inception_ext(x), ref)


@pytest.mark.parametrize("pickled", [False, True], ids=["state_dict", "module"])
def test_inception_from_torch_file(inception_sd, port_inception_ext, tmp_path, pickled):
    oracle = FIDInceptionOracle()
    oracle.load_state_dict({k: v for k, v in inception_sd.items()
                            if not k.startswith(("fc.", "AuxLogits."))})
    path = str(tmp_path / "pt_inception.pth")
    torch.save(oracle if pickled else inception_sd, path)
    ext = P.InceptionFeatureExtractor.from_torch_file(path, device="cpu")
    x = np.random.default_rng(8).random((1, 32, 32, 3)).astype(np.float32)
    assert ext.dim == 2048
    np.testing.assert_array_equal(ext(x), port_inception_ext(x))


def test_inception_entry_points_default_to_cuda(inception_sd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = P.convert_torch_inception_weights(inception_sd)
    for make in (lambda: P.InceptionFeatureExtractor(params), lambda: P.LPIPS(),
                 lambda: P.RandomConvFeatureExtractor()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_full_float32_restores_the_callers_settings():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with port_inception.full_float32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


# -------------------------------------------------------------------- LPIPS
# float32 convolutions in another order; LPIPS is 3e-3 to 3e-2 here, a sum
# over five taps of spatial means (up to 63² positions) of channel sums (up
# to 384): 1e-5 relative plus 1e-9 absolute (measured up to 1.9e-6
# relative).
LPIPS_RTOL, LPIPS_ATOL = 1e-5, 1e-9


@pytest.fixture(scope="module")
def lpips_sds():
    oracle = randomize_lpips(LPIPSOracle(), seed=0)
    return oracle.alexnet_state_dict(), oracle.lpips_state_dict()


@pytest.fixture(scope="module")
def lpips_pairs(lpips_sds):
    """{"oracle weights" / "proxy": (JAX LPIPS, port LPIPS)}."""
    to_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    alex, lin = (to_np(sd) for sd in lpips_sds)
    return {"oracle": (J.LPIPS(jax_convert_lpips(alex, lin)),
                       P.LPIPS(port_convert_lpips(alex, lin), device="cpu")),
            "proxy": (J.LPIPS(), P.LPIPS(device="cpu"))}


def _lpips_inputs(seed, size):
    a, b = _images(seed, 2, size)
    return a * 2 - 1, b * 2 - 1


@pytest.mark.parametrize("weights", ["oracle", "proxy"])
def test_lpips_matches_jax(lpips_pairs, weights):
    """At 64²; the masked test below runs the same taps at 256²."""
    jax_fn, port_fn = lpips_pairs[weights]
    assert port_fn.is_proxy == jax_fn.is_proxy == (weights == "proxy")
    x, y = _lpips_inputs(64, 64)
    np.testing.assert_allclose(port_fn(x, y), jax_fn(x, y), rtol=LPIPS_RTOL, atol=LPIPS_ATOL)


@pytest.mark.parametrize("weights", ["oracle", "proxy"])
@pytest.mark.parametrize("kind", ["box", "brush"])
def test_masked_lpips_matches_jax(lpips_pairs, weights, kind):
    """The mask resized to each tap's grid (63², 31², 15² at 256²) with
    antialiasing, as jax.image.resize "linear" does; without it the result
    moves by far more than this tolerance."""
    jax_fn, port_fn = lpips_pairs[weights]
    x, y = _lpips_inputs(11, 256)
    m = np.kron(_mask(kind, size=64), np.ones((1, 4, 4, 1), np.float32))
    np.testing.assert_allclose(port_fn.masked(x, y, m), jax_fn.masked(x, y, m),
                               rtol=LPIPS_RTOL, atol=LPIPS_ATOL)


def test_masked_lpips_full_mask_equals_unmasked(lpips_pairs):
    """A mask of ones reduces the weighted mean to the plain spatial mean
    (the tolerance of the JAX package's own test of the same identity)."""
    _, port_fn = lpips_pairs["oracle"]
    x, y = _lpips_inputs(12, 64)
    np.testing.assert_allclose(port_fn.masked(x, y, np.ones((2, 64, 64, 1), np.float32)),
                               port_fn(x, y), rtol=1e-5, atol=1e-6)


def test_lpips_from_torch_files(lpips_sds, lpips_pairs, tmp_path):
    alex, lin = lpips_sds
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(lin, tmp_path / "lpips_lin.pt")
    fn = P.LPIPS.from_torch_files(str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_lin.pt"),
                                  device="cpu")
    x, y = _lpips_inputs(13, 64)
    assert not fn.is_proxy
    np.testing.assert_array_equal(fn(x, y), lpips_pairs["oracle"][1](x, y))


def test_lpips_proxy_weights_are_the_jax_draws(lpips_pairs):
    jax_fn, port_fn = lpips_pairs["proxy"]
    for a, b in zip(port_fn.weights["convs"], jax_fn.weights["convs"]):
        np.testing.assert_array_equal(a["kernel"], np.asarray(b["kernel"]))
        np.testing.assert_array_equal(a["bias"], np.asarray(b["bias"]))
    for a, b in zip(port_fn.weights["lins"], jax_fn.weights["lins"]):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------ proxy FID
# Three float32 convs of at most 576 terms: 1e-5 of the largest feature
# (measured about 2.5e-7).


@pytest.fixture(scope="module")
def proxy_pair():
    ref = J.RandomConvFeatureExtractor()
    ours = P.RandomConvFeatureExtractor(
        weights=[np.asarray(w) for w in (ref.w1, ref.w2, ref.w3)], device="cpu")
    return ref, ours


@pytest.mark.parametrize("size", [256, 33, 32])
def test_proxy_features_match_jax_on_carried_weights(proxy_pair, size):
    """XLA's "SAME" padding with stride 2 puts the odd pixel after: at even
    sizes (256 -> 128 -> 64 -> 32) the pad is 0 before and 1 after, which a
    symmetric padding=1 gets wrong; at odd sizes it is 1 and 1."""
    ref, ours = proxy_pair
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    _close_features(ours(x), ref(x))


def test_same_padding_puts_the_odd_pixel_after():
    assert port_fid._same_pad(256, 3, 2) == (0, 1)
    assert port_fid._same_pad(33, 3, 2) == (1, 1)
    assert port_fid._same_pad(1, 3, 2) == (1, 1)


def test_proxy_weights_are_seeded_numpy_draws():
    a = P.RandomConvFeatureExtractor(seed=3, device="cpu")
    b = P.RandomConvFeatureExtractor(seed=3, device="cpu")
    c = P.RandomConvFeatureExtractor(seed=4, dim=128, device="cpu")
    assert [w.shape for w in a.weights] == [(3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 256)]
    assert c.dim == 128 and a.dim == 256
    for wa, wb in zip(a.weights, b.weights):
        np.testing.assert_array_equal(wa, wb)
    assert not np.array_equal(a.weights[0], c.weights[0])


def test_fid_between_image_sets_matches_jax(proxy_pair):
    """The proxy FID of two image sets (256-d features, so the sqrtm is
    small): equal up to the features' float32 gap."""
    ref, ours = proxy_pair
    rng = np.random.default_rng(9)
    real = [rng.random((6, 33, 33, 3)).astype(np.float32) for _ in range(2)]
    fake = [np.clip(r + 0.2 * rng.random(r.shape), 0, 1).astype(np.float32) for r in real]
    a = port_fid.fid_between_image_sets(real, fake, extractor=ours, batch_size=4)
    b = jax_fid.fid_between_image_sets(real, fake, extractor=ref, batch_size=4)
    assert a == pytest.approx(b, rel=1e-4)


# ------------------------------------------------- numpy statistics, FID, KID
# The same numpy and scipy code on identical float inputs: equal results.


def test_statistics_and_frechet_distance_equal_jax():
    rng = np.random.default_rng(10)
    f1 = rng.standard_normal((40, 16)).astype(np.float32)
    f2 = (rng.standard_normal((30, 16)) * 1.3 + 0.2).astype(np.float32)
    for a, b in zip(P.compute_statistics(f1), J.compute_statistics(f1)):
        np.testing.assert_array_equal(a, b)
    assert P.fid_from_features(f1, f2) == J.fid_from_features(f1, f2)
    mu1, s1 = J.compute_statistics(f1)
    mu2, s2 = J.compute_statistics(f2)
    assert P.frechet_distance(mu1, s1, mu2, s2) == J.frechet_distance(mu1, s1, mu2, s2)


def test_frechet_distance_singular_retry_equals_jax():
    """Fewer samples than dims: singular covariances (the eps retry path
    where sqrtm fails)."""
    rng = np.random.default_rng(11)
    f1, f2 = rng.standard_normal((3, 24)), rng.standard_normal((4, 24))
    assert P.fid_from_features(f1, f2) == J.fid_from_features(f1, f2)
    z = np.zeros((24, 24))
    assert (P.frechet_distance(np.zeros(24), z, np.ones(24), z)
            == J.frechet_distance(np.zeros(24), z, np.ones(24), z))


@pytest.mark.parametrize("n_real,n_fake,max_subset", [(12, 9, 1000), (40, 35, 16)],
                         ids=["exact", "subsets"])
def test_kid_equals_jax(n_real, n_fake, max_subset):
    rng = np.random.default_rng(12)
    real = rng.standard_normal((n_real, 32))
    fake = rng.standard_normal((n_fake, 32)) + 0.3
    ours = P.kid_from_features(real, fake, n_subsets=20, max_subset_size=max_subset, seed=5)
    assert ours == J.kid_from_features(real, fake, n_subsets=20, max_subset_size=max_subset,
                                       seed=5)
    assert P.polynomial_mmd2(real, fake) == J.polynomial_mmd2(real, fake)
    with pytest.raises(ValueError, match="at least 2"):
        P.polynomial_mmd2(real[:1], fake)


def test_metrics_exports_match_jax():
    assert set(P.__all__) >= {n for n in dir(J) if not n.startswith("_")
                              and callable(getattr(J, n))}
