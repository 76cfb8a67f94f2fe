"""Shared pieces of the DPM-Solver tests (`test_torch_port_dpm*.py`): the
shape and seeded inputs of a trajectory.
"""
import numpy as np


SHAPE = (2, 8, 8, 3)


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:-1] + (1,), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    return gt, mask
