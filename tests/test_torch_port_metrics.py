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

This file holds InceptionV3 and LPIPS; SSIM and PSNR are in
`test_torch_port_metrics_ssim.py`, the proxy FID and the statistics in
`test_torch_port_metrics_fid.py`: port test files hold at most 25 cases
(ROADMAP.md).
"""
import numpy as np
import pytest
import torch

from fidm_tpu import metrics as J
from fidm_tpu.metrics.lpips import convert_torch_lpips_weights as jax_convert_lpips
from fidm_tpu_torch import metrics as P
from fidm_tpu_torch.metrics import inception as port_inception
from fidm_tpu_torch.metrics.lpips import convert_torch_lpips_weights as port_convert_lpips

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_metrics_common import _images, _mask, _close_features
from oracle_fid_inception import FIDInceptionOracle
from oracle_fid_inception import randomize as randomize_inception
from oracle_lpips import LPIPSOracle
from oracle_lpips import randomize as randomize_lpips


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
