"""Building blocks of the ADM-style inpainting UNet (PyTorch port, NCHW inside).

Counterpart of `fidm_tpu/models/layers.py`. Module and parameter names are
the ADM torch ones (`in_layers.2`, `emb_layers.1`, `out_layers.3`,
`skip_connection`, `qkv`, `proj_out`, ...), so an ADM state dict loads with
`strict=True`.

Dtype policy, as in the JAX package: parameters are float32, activations run
in the model's compute dtype (bf16 on the card), and each layer casts its
parameters to that dtype when it runs. GroupNorm statistics and the
attention softmax are float32. Parameters cast to bf16 (`cast_params`) keep
that arithmetic: each layer upcasts what it computes in float32.

A decoder ResBlock called with `skip` (`UNetConfig.split_decoder_skips`)
computes the function of its call on `cat([x, skip])` without building the
concatenation, as the JAX package's `ResBlock(skip=...)`: GroupNorm + SiLU
over both halves from per-channel float32 sums (`_split_groupnorm_silu`), the
input and skip convolutions as two half-kernel convolutions summed. The
parameters are the same modules either way.

`conv` and `linear` apply every convolution and dense layer of the model
(`conv_halves` a convolution of a channel concatenation it never builds);
inside `capture_inputs(fn)` each of them first hands its module and input to
`fn` (calibration records input statistics there), and inside
`weight_overrides(mapping)` a module found in `mapping` applies that weight
in place of its own (LoRA training merges its factors so, `lora/lora.py`).

Dropout is off unless a forward passes `deterministic=False`, whatever the
module's train/eval mode, as in the JAX package, whose train step never
turns it on.

Under the mesh's "model" axis (`parallel/tp.py`) a layer may hold a context
in `model_axis` (set by `tp.attach` for a call, absent otherwise): `conv`,
`linear` and GroupNorm32 then hand the layer to it (a column- or
row-parallel layer, a norm of this rank's groups, halo rows or statistics
over the whole image); an AttentionBlock under spatial partitioning gathers
its normed input and keeps its rows of the output, and a ResBlock builds a
decoder skip's concatenation. Without a context every module runs exactly
as it does without a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import qkv_attention

__all__ = [
    "capture_inputs",
    "weight_overrides",
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


# module -> the weight `conv` / `linear` apply in its place: see `weight_overrides`
_weights: Dict[nn.Module, torch.Tensor] = {}


@contextlib.contextmanager
def weight_overrides(mapping: Dict[nn.Module, torch.Tensor]):
    """Inside the block, `conv` and `linear` apply `mapping[m]`, a tensor of
    m.weight's shape, in place of m.weight. Gradients flow into the mapped
    tensors. A backward that recomputes a checkpointed block must run
    inside the same block, so that the recompute sees the same weights."""
    global _weights
    prev, _weights = _weights, {**_weights, **mapping}
    try:
        yield
    finally:
        _weights = prev


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied in the dtype of `x` (by its model-axis context, when it
    holds one)."""
    if _capture is not None:
        _capture(m, x, 1)
    w = _weights.get(m, m.weight)
    ctx = m.__dict__.get("model_axis")
    if ctx is not None:
        return ctx.conv(m, x, w.to(x.dtype), m.bias.to(x.dtype))
    return F.conv2d(x, w.to(x.dtype), m.bias.to(x.dtype), m.stride, m.padding)


def linear(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An nn.Linear, or a kernel-size-1 nn.Conv1d as ADM stores qkv and
    proj_out, applied to the last axis of `x` in its dtype."""
    if _capture is not None:
        _capture(m, x, -1)
    w = _weights.get(m, m.weight)
    if w.ndim == 3:
        w = w[..., 0]
    ctx = m.__dict__.get("model_axis")
    if ctx is not None:
        return ctx.linear(x, w.to(x.dtype), m.bias.to(x.dtype))
    return F.linear(x, w.to(x.dtype), m.bias.to(x.dtype))


def conv_halves(m: nn.Conv2d, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`m` applied to the channel concatenation [a | b], in the dtype of `a`,
    without building it: two convolutions with the halves of its kernel,
    summed, then its bias (the JAX package's `_conv_half`). Inside
    `capture_inputs` the hook is handed the concatenation, the input the
    concatenating path gives `m`."""
    if _capture is not None:
        _capture(m, torch.cat([a, b], dim=1), 1)
    ca = a.shape[1]
    w = _weights.get(m, m.weight).to(a.dtype)
    h = (F.conv2d(a, w[:, :ca], None, m.stride, m.padding)
         + F.conv2d(b, w[:, ca:], None, m.stride, m.padding))
    return h + m.bias.to(a.dtype)[:, None, None]


def zero_module(m: nn.Module) -> nn.Module:
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


def group_norm_f32(x, groups: int, weight, bias, eps: float) -> torch.Tensor:
    """GroupNorm computed in float32, returned in the dtype of `x`."""
    return F.group_norm(x.float(), groups, weight.float(), bias.float(), eps).to(x.dtype)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in float32, returned in the input dtype."""

    model_axis = None

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x):
        if self.model_axis is not None:
            return self.model_axis.group_norm(self, x)
        return group_norm_f32(x, self.num_groups, self.weight, self.bias, self.eps)


def _split_groupnorm_silu(a: torch.Tensor, b: torch.Tensor, norm: GroupNorm32):
    """GroupNorm(32) + SiLU over the virtual concatenation [a | b] on the
    channel axis, without building it (the JAX package's
    `_split_groupnorm_silu`): group statistics from per-channel float32 sums
    of each half, one-pass E[x^2] - E[x]^2 as there, a group may straddle the
    boundary; then each half is normalised in its own dtype. Returns the two
    halves."""
    B, ca = a.shape[:2]
    c = ca + b.shape[1]
    groups = norm.num_groups
    n = a.shape[2] * a.shape[3] * (c // groups)

    def channel_sums(x):
        x32 = x.float()
        return x32.sum(dim=(2, 3)), x32.square().sum(dim=(2, 3))

    sa, qa = channel_sums(a)
    sb, qb = channel_sums(b)
    mean = torch.cat([sa, sb], 1).reshape(B, groups, -1).sum(-1) / n
    var = torch.clamp(torch.cat([qa, qb], 1).reshape(B, groups, -1).sum(-1) / n
                      - mean.square(), min=0.0)
    inv = torch.rsqrt(var + norm.eps)
    mean_c = mean.repeat_interleave(c // groups, 1)[:, :, None, None]
    inv_c = inv.repeat_interleave(c // groups, 1)[:, :, None, None]
    scale = norm.weight.float()[:, None, None]
    bias = norm.bias.float()[:, None, None]

    def half(x, lo, hi):
        m = (inv_c[:, lo:hi] * scale[lo:hi]).to(x.dtype)
        o = (bias[lo:hi] - mean_c[:, lo:hi] * inv_c[:, lo:hi] * scale[lo:hi]).to(x.dtype)
        return F.silu(x * m + o)

    return half(a, 0, ca), half(b, ca, c)


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

    # set under the mesh's model axis (`tp.attach`): a decoder skip is then
    # concatenated (its split path sums statistics and convolutions of one
    # rank's part only)
    model_axis = None

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

    def forward(self, x, emb, deterministic: bool = True, skip=None):
        """With `skip`, the block's function of cat([x, skip]) on the channel
        axis, the concatenation never built where the residual is a 1x1
        convolution (an identity residual needs it anyway); plain blocks
        only, as in the JAX package. Under the model axis the concatenation
        is built."""
        if skip is not None:
            if self.up or self.down:
                raise ValueError("split-skip path supports plain blocks only "
                                 "(no up/down)")
            if self.model_axis is not None or isinstance(self.skip_connection, nn.Identity):
                x = torch.cat([x, skip], dim=1)
            else:
                a, b = _split_groupnorm_silu(x, skip, self.in_layers[0])
                h = self._out(conv_halves(self.in_layers[2], a, b), emb, deterministic)
                return conv_halves(self.skip_connection, x, skip) + h
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = _upsample(h), _upsample(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self._out(conv(self.in_layers[2], h), emb, deterministic)
        skip = self.skip_connection
        return (x if isinstance(skip, nn.Identity) else conv(skip, x)) + h

    def _out(self, h, emb, deterministic):
        """The timestep embedding, the output norm and the output conv."""
        emb_out = linear(self.emb_layers[1], F.silu(emb)).to(h.dtype)[..., None, None]
        out_norm = self.out_layers[0]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = out_norm(h) * (1 + scale) + shift
        else:
            h = out_norm(h + emb_out)
        h = F.dropout(F.silu(h), self.out_layers[2].p, training=not deterministic)
        return conv(self.out_layers[3], h)


class AttentionBlock(nn.Module):
    """Global spatial self-attention with a residual."""

    # set under spatial partitioning (`tp.attach`): the attention then runs
    # on every rank's rows and keeps this rank's
    model_axis = None

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
        ax = self.model_axis
        h = self.norm(x)
        if ax is not None:  # every rank's rows
            h = ax.gather(h)
        tokens = h.reshape(b, c, -1).transpose(1, 2)  # [B, S, C]
        qkv = linear(self.qkv, tokens)
        # channel split as a 1x1 conv over 3C channels, chunk(3) order: all
        # of q, then all of k, then all of v; each then splits into heads
        # (this rank's heads of each, under tensor parallelism). The
        # attention kernel reads these strided views in place (s-stride 3C,
        # h-stride D), so no copy is made
        q, k, v = qkv.chunk(3, dim=-1)
        d = c // self.heads

        def heads_first(a):
            return a.reshape(b, a.shape[1], -1, d).transpose(1, 2)

        out = qkv_attention(heads_first(q), heads_first(k), heads_first(v)).transpose(1, 2)
        if ax is not None:  # this rank's rows
            out = ax.own(out, hh * ww)
        out = linear(self.proj_out, out.reshape(b, hh * ww, -1))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)
