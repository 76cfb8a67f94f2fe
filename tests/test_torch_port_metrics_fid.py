"""The port's proxy-FID extractor (on the JAX extractor's weights carried
across), its numpy statistics (FID, the Frechet distance and its singular
retry, KID) and the metrics package's exports, against the JAX package's.
"""
import numpy as np
import pytest

from fidm_tpu import metrics as J
from fidm_tpu.metrics import fid as jax_fid
from fidm_tpu_torch import metrics as P
from fidm_tpu_torch.metrics import fid as port_fid

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_metrics_common import _close_features


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
