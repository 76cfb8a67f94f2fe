"""Building blocks of the ADM-style inpainting UNet (PyTorch port, NCHW inside).

Counterpart of `fidm_tpu/models/layers.py`. Module and parameter names are
the ADM torch ones (`in_layers.2`, `emb_layers.1`, `out_layers.3`,
`skip_connection`, `qkv`, `proj_out`, ...), so an ADM state dict loads with
`strict=True`.

Dtype policy, as in the JAX package: parameters are float32, activations run
in the model's compute dtype (bf16 on the card), and each layer casts its
parameters to that dtype when it runs. GroupNorm statistics and the
attention softmax are float32.

`conv` and `linear` apply every convolution and dense layer of the model;
inside `capture_inputs(fn)` each of them first hands its module and input to
`fn` (calibration records input statistics there).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import qkv_attention

__all__ = [
    "capture_inputs",
    "timestep_embedding",
    "GroupNorm32",
    "Upsample",
    "Downsample",
    "ResBlock",
    "AttentionBlock",
]


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embeddings, [cos | sin] order, float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


# fn(module, input, channel_dim), or None: see `capture_inputs`
_capture: Optional[Callable[[nn.Module, torch.Tensor, int], None]] = None


@contextlib.contextmanager
def capture_inputs(fn: Callable[[nn.Module, torch.Tensor, int], None]):
    """Inside the block, `conv` and `linear` call fn(module, x, channel_dim)
    with their input before applying the module: channel_dim is 1 for a
    conv (NCHW) and -1 for a dense layer ([..., C])."""
    global _capture
    prev, _capture = _capture, fn
    try:
        yield
    finally:
        _capture = prev


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied in the dtype of `x`."""
    if _capture is not None:
        _capture(m, x, 1)
    return F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), m.stride, m.padding)


def linear(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An nn.Linear, or a kernel-size-1 nn.Conv1d as ADM stores qkv and
    proj_out, applied to the last axis of `x` in its dtype."""
    if _capture is not None:
        _capture(m, x, -1)
    w = m.weight if m.weight.ndim == 2 else m.weight[..., 0]
    return F.linear(x, w.to(x.dtype), m.bias.to(x.dtype))


def zero_module(m: nn.Module) -> nn.Module:
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in float32, returned in the input dtype."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsampling with an optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        x = _upsample(x)
        return conv(self.conv, x) if self.use_conv else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, or 2x2 average pooling when use_conv=False."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)
        elif out_channels not in (None, channels):
            raise ValueError("average-pool downsampling keeps the channel count")

    def forward(self, x):
        return conv(self.op, x) if self.use_conv else F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block with optional scale-shift norm and
    up/down sampling."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False,
                 up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
            zero_module(nn.Conv2d(out_ch, out_ch, 3, padding=1)))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = _upsample(h), _upsample(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = conv(self.in_layers[2], h)

        emb_out = linear(self.emb_layers[1], F.silu(emb)).to(h.dtype)[..., None, None]
        out_norm = self.out_layers[0]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = out_norm(h) * (1 + scale) + shift
        else:
            h = out_norm(h + emb_out)
        h = self.out_layers[2](F.silu(h))
        h = conv(self.out_layers[3], h)

        skip = self.skip_connection
        return (x if isinstance(skip, nn.Identity) else conv(skip, x)) + h


class AttentionBlock(nn.Module):
    """Global spatial self-attention with a residual."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by head "
                                 f"channels {num_head_channels}")
            self.heads = channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))

    def forward(self, x):
        b, c, hh, ww = x.shape
        s, heads = hh * ww, self.heads
        tokens = self.norm(x).reshape(b, c, s).transpose(1, 2)  # [B, S, C]
        qkv = linear(self.qkv, tokens)
        # channel split as a 1x1 conv over 3C channels, chunk(3) order: all
        # of q, then all of k, then all of v; each then splits into heads.
        # The attention kernel reads these strided views in place (s-stride
        # 3C, h-stride D), so no copy is made
        q, k, v = qkv.chunk(3, dim=-1)

        def heads_first(a):
            return a.reshape(b, s, heads, c // heads).transpose(1, 2)

        out = qkv_attention(heads_first(q), heads_first(k), heads_first(v))
        out = linear(self.proj_out, out.transpose(1, 2).reshape(b, s, c))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)
