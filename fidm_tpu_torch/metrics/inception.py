"""FID InceptionV3 (pool3, 2048-d) in PyTorch, with torch-weight import
(port of `fidm_tpu/metrics/inception.py`).

FID is defined by a specific network: the TF-ported "FID Inception" that
`pytorch_fid` evaluates (the reference shells out to it,
`test_inpainting_better.py:151-223`) — torchvision InceptionV3 topology with
`count_include_pad=False` average pools inside the mixed blocks and a
max-pool branch in Mixed_7c, fed inputs resized bilinearly to 299x299 and
scaled to [-1,1]. `InceptionPool3` is that network up to the pool3 tap.

Weights come from the standard `pt_inception-2015-12-05` torch state dict
(torchvision-style keys), supplied locally by the user: nothing is
downloaded and no pretrained default ships. `convert_torch_inception_weights`
folds each BatchNorm (inference mode, eps=1e-3) into its conv in float64 and
casts the result to float32, exactly as the JAX package does, so the two
packages hold bit-equal weights; the forward is then conv+bias+relu chains.

Precision: cuDNN runs float32 convolutions in TF32 by default on an NVIDIA
GPU (`torch.backends.cudnn.allow_tf32`), which would move the features about
1e-3 relative from their float32 values. The metric networks run their
forwards inside `full_float32()`, which turns TF32 off for the call and
restores the caller's setting after; nothing is set globally.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

__all__ = [
    "convert_torch_inception_weights",
    "full_float32",
    "InceptionPool3",
    "inception_pool3",
    "preprocess",
    "InceptionFeatureExtractor",
]

_BN_EPS = 1e-3

# (module, stride, padding) for the stem convs
_STEM = [
    ("Conv2d_1a_3x3", 2, 0),
    ("Conv2d_2a_3x3", 1, 0),
    ("Conv2d_2b_3x3", 1, 1),
    # maxpool 3x3/2 here
    ("Conv2d_3b_1x1", 1, 0),
    ("Conv2d_4a_3x3", 1, 0),
    # maxpool 3x3/2 here
]

# submodule names per mixed-block type (for the converter)
_BLOCK_SUBS = {
    "a": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "b": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "c": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "d": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
          "branch7x7x3_3", "branch7x7x3_4"],
    "e": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
          "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
          "branch3x3dbl_3b", "branch_pool"],
}

_MIXED = [
    ("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"),
    ("Mixed_6a", "b"),
    ("Mixed_6b", "c"), ("Mixed_6c", "c"), ("Mixed_6d", "c"),
    ("Mixed_6e", "c"),
    ("Mixed_7a", "d"),
    ("Mixed_7b", "e"), ("Mixed_7c", "e"),
]


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and products in full float32 (TF32 off in
    cuDNN and cuBLAS) inside the block; the caller's settings after."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _fold_bn(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """One BasicConv2d (conv no-bias + BN eval) -> folded conv kernel+bias."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float64)  # OIHW
    gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float64)
    beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float64)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float64)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float64)
    scale = gamma / np.sqrt(var + _BN_EPS)
    kernel = (w * scale[:, None, None, None]).transpose(2, 3, 1, 0)  # HWIO
    bias = beta - mean * scale
    return {"kernel": kernel.astype(np.float32),
            "bias": bias.astype(np.float32)}


def convert_torch_inception_weights(state_dict: Dict) -> Dict:
    """Torch state dict (torchvision inception / `pt_inception-2015-12-05`
    key layout) -> folded params: {module: {"kernel": HWIO float32, "bias"}},
    the mixed blocks one level deeper by branch, as in the JAX package.
    `fc.*` / `AuxLogits.*` are ignored (the pool3 features never reach them)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    params: Dict = {}
    for name, _, _ in _STEM:
        params[name] = _fold_bn(sd, name)
    for name, kind in _MIXED:
        params[name] = {sub: _fold_bn(sd, f"{name}.{sub}")
                        for sub in _BLOCK_SUBS[kind]}
    return params


class _Conv(nn.Module):
    """A BasicConv2d with its BatchNorm folded in: conv + bias + relu."""

    def __init__(self, p: Dict[str, np.ndarray]):
        super().__init__()
        kernel = np.ascontiguousarray(np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        self.weight = nn.Parameter(torch.from_numpy(kernel), requires_grad=False)
        self.bias = nn.Parameter(torch.from_numpy(np.asarray(p["bias"], np.float32).copy()),
                                 requires_grad=False)

    def forward(self, x, stride=1, padding=0):
        return F.relu(F.conv2d(x, self.weight, self.bias, stride, padding))


def _max_pool(x, stride=2, padding=0):
    return F.max_pool2d(x, 3, stride, padding)


def _avg_pool3_no_pad_count(x):
    """3x3/1 pad-1 average pool with count_include_pad=False — the defining
    quirk of the FID Inception's mixed-block pool branches."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _inception_a(p, x):
    b1 = p["branch1x1"](x)
    b5 = p["branch5x5_2"](p["branch5x5_1"](x), padding=2)
    b3 = p["branch3x3dbl_3"](p["branch3x3dbl_2"](p["branch3x3dbl_1"](x), padding=1),
                             padding=1)
    bp = p["branch_pool"](_avg_pool3_no_pad_count(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x):
    b3 = p["branch3x3"](x, stride=2)
    bd = p["branch3x3dbl_3"](p["branch3x3dbl_2"](p["branch3x3dbl_1"](x), padding=1),
                             stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p, x):
    b1 = p["branch1x1"](x)
    b7 = p["branch7x7_1"](x)
    b7 = p["branch7x7_2"](b7, padding=(0, 3))
    b7 = p["branch7x7_3"](b7, padding=(3, 0))
    bd = p["branch7x7dbl_1"](x)
    bd = p["branch7x7dbl_2"](bd, padding=(3, 0))
    bd = p["branch7x7dbl_3"](bd, padding=(0, 3))
    bd = p["branch7x7dbl_4"](bd, padding=(3, 0))
    bd = p["branch7x7dbl_5"](bd, padding=(0, 3))
    bp = p["branch_pool"](_avg_pool3_no_pad_count(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x):
    b3 = p["branch3x3_2"](p["branch3x3_1"](x), stride=2)
    b7 = p["branch7x7x3_1"](x)
    b7 = p["branch7x7x3_2"](b7, padding=(0, 3))
    b7 = p["branch7x7x3_3"](b7, padding=(3, 0))
    b7 = p["branch7x7x3_4"](b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p, x, pool):
    b1 = p["branch1x1"](x)
    h = p["branch3x3_1"](x)
    b3 = torch.cat([p["branch3x3_2a"](h, padding=(0, 1)),
                    p["branch3x3_2b"](h, padding=(1, 0))], dim=1)
    h = p["branch3x3dbl_2"](p["branch3x3dbl_1"](x), padding=1)
    bd = torch.cat([p["branch3x3dbl_3a"](h, padding=(0, 1)),
                    p["branch3x3dbl_3b"](h, padding=(1, 0))], dim=1)
    pooled = (_avg_pool3_no_pad_count(x) if pool == "avg"
              else _max_pool(x, stride=1, padding=1))
    bp = p["branch_pool"](pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


_BLOCK_FNS = {"a": _inception_a, "b": _inception_b, "c": _inception_c,
              "d": _inception_d}


class InceptionPool3(nn.Module):
    """The FID InceptionV3 up to pool3, built from folded params
    (`convert_torch_inception_weights`): [B,3,299,299] in [-1,1] (NCHW) ->
    [B,2048]."""

    def __init__(self, params: Dict):
        super().__init__()
        self.stem = nn.ModuleDict({name: _Conv(params[name]) for name, _, _ in _STEM})
        self.mixed = nn.ModuleDict({
            name: nn.ModuleDict({sub: _Conv(params[name][sub]) for sub in _BLOCK_SUBS[kind]})
            for name, kind in _MIXED})

    def forward(self, x):
        s = self.stem
        x = s["Conv2d_1a_3x3"](x, stride=2)
        x = s["Conv2d_2a_3x3"](x)
        x = s["Conv2d_2b_3x3"](x, padding=1)
        x = _max_pool(x)
        x = s["Conv2d_3b_1x1"](x)
        x = s["Conv2d_4a_3x3"](x)
        x = _max_pool(x)
        for name, kind in _MIXED:
            fn = _BLOCK_FNS.get(kind)
            if fn is not None:
                x = fn(self.mixed[name], x)
            else:
                x = _inception_e(self.mixed[name], x,
                                 pool="max" if name == "Mixed_7c" else "avg")
        return x.mean(dim=(2, 3))


def inception_pool3(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's functional form: folded params
    (`convert_torch_inception_weights`) and [B,299,299,3] NHWC in [-1,1] ->
    [B,2048] pool3 features, on x's device in full float32."""
    model = InceptionPool3(params).to(x.device)
    with full_float32():
        return model(x.permute(0, 3, 1, 2))


def preprocess(images01: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] in [0,1] -> NCHW bilinear 299x299 in [-1,1] (pytorch-fid's
    resize_input/normalize_input semantics: align_corners=False, no
    antialias)."""
    x = images01.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                      antialias=False)
    return x * 2.0 - 1.0


class InceptionFeatureExtractor:
    """Pool3 (2048-d) feature extractor for real FID numbers.

    Construct from folded params (`convert_torch_inception_weights`) or
    `from_torch_file` with a local `pt_inception-2015-12-05`-layout
    checkpoint. It runs on `device` ("cuda" by default; raises without a
    GPU), in full float32 (`full_float32`)."""

    dim = 2048

    def __init__(self, params: Dict, device="cuda"):
        self.device = resolve_device(device)
        self.model = InceptionPool3(params).to(self.device).eval()

    def __call__(self, images01) -> np.ndarray:
        """[B,H,W,3] in [0,1] (numpy or a tensor) -> float32 [B, 2048]."""
        x = torch.as_tensor(images01, dtype=torch.float32, device=self.device)
        with torch.inference_mode(), full_float32():
            return self.model(preprocess(x)).cpu().numpy()

    @classmethod
    def from_torch_file(cls, path: str, device="cuda") -> "InceptionFeatureExtractor":
        device = resolve_device(device)
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):  # a full module was pickled
            sd = sd.state_dict()
        return cls(convert_torch_inception_weights(sd), device=device)
