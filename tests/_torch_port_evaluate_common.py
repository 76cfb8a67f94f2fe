"""Shared pieces of the evaluate tests (`test_torch_port_evaluate*.py`): the
model flags of the 32² UNet, the flags every evaluate command line needs, and
the Frechet distance in closed form.
"""
import numpy as np


MODEL = ["--image_size", "32", "--model_channels", "32", "--channel_mult", "1", "2",
         "--num_heads", "2", "--num_head_channels", "16", "--attention_resolutions", "2"]


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


REQUIRED = ["--data_dir", "d", "--mask_dir", "m"]
