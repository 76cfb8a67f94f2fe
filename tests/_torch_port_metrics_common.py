"""Shared pieces of the metric tests (`test_torch_port_metrics*.py`): seeded
images, the hole masks they are scored on, and the features' tolerance.
"""
import numpy as np


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


# The features reach a few hundred with these weights; float32 convolutions
# in another order: 1e-5 of the largest feature (measured about 5e-7).
def _close_features(ours, ref, tol=1e-5):
    assert ours.shape == ref.shape and ours.dtype == np.float32
    err = np.abs(ours - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())
