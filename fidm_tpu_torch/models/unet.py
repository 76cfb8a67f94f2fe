"""ADM-style UNet and the 9-channel mask-aware inpainting model (PyTorch port).

Counterpart of `fidm_tpu/models/unet.py`. The block topology and its
bookkeeping follow the JAX `UNet` line for line; the modules are laid out as
ADM's `input_blocks` / `middle_block` / `output_blocks` lists so that the
state dict carries the ADM torch keys. The public contract is the JAX one:
NHWC inputs, NHWC float32 output; inside, the model runs NCHW.

Rematerialisation (`UNetConfig.remat`, under autograd only) wraps each
ResBlock and AttentionBlock in `torch.utils.checkpoint` (non-reentrant):
`remat_policy="full"` recomputes the whole block in the backward;
`"convs"` saves every convolution's output and recomputes the GroupNorm,
SiLU, embedding and attention glue around them. The JAX policy also saves
the attention block's output projection, whose backward needs only its
input, so there too the attention itself runs again: both policies launch
the attention kernel once more per block in the backward.

Under spatial partitioning (`parallel/tp.py`, the UNet's `model_axis`) the
levels whose rows do not split into even blocks run whole on every rank:
the activation entering the first such level is gathered whole, and the
decoder takes this rank's rows again where it leaves them (`_whole_span`).

`UNetConfig.split_decoder_skips` hands each decoder ResBlock its skip feature
beside h instead of their concatenation (`layers.ResBlock.forward`); the
modules, and so the state dict, are the same either way, and it composes with
the feature cache and with remat.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from .layers import (
    AttentionBlock,
    Downsample,
    GroupNorm32,
    ResBlock,
    Upsample,
    conv,
    linear,
    timestep_embedding,
    zero_module,
)

__all__ = ["UNetConfig", "UNet", "InpaintingUNet", "ffhq256_config"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 256
    in_channels: int = 9
    model_channels: int = 128
    out_channels: int = 6
    num_res_blocks: int = 1
    attention_resolutions: Tuple[int, ...] = (16,)  # downsample factors
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    # activation dtype; parameters stay float32 and the final conv runs in
    # float32 whatever this is
    dtype: torch.dtype = torch.bfloat16
    # rematerialisation of each ResBlock and AttentionBlock under autograd;
    # remat_policy "full" or "convs" (see the module docstring)
    remat: bool = False
    remat_policy: str = "full"
    # decoder skip connections without building the channel concatenation:
    # each output ResBlock with a 1x1 residual conv takes (h, emb, skip) and
    # computes the same function (up to the order of float sums) on the same
    # parameters (see `ResBlock.forward`); opt-in, as in the JAX package
    split_decoder_skips: bool = False


def ffhq256_config(**overrides) -> UNetConfig:
    """The canonical FFHQ-256 fine-tuning architecture."""
    return dataclasses.replace(UNetConfig(), **overrides)


def _save_convolutions(ctx, op, *args, **kwargs):
    """The "convs" policy: keep convolution outputs, recompute the rest."""
    if op is torch.ops.aten.convolution.default:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class UNet(nn.Module):
    """The full UNet with attention and timestep embedding."""

    # the model axis's context under spatial partitioning (`parallel/tp.py`)
    model_axis = None

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.remat and cfg.remat_policy not in ("full", "convs"):
            raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")
        mc = cfg.model_channels
        ted = mc * 4
        heads_up = cfg.num_heads if cfg.num_heads_upsample == -1 else cfg.num_heads_upsample

        def res(ch, out_ch=None, **kw):
            return ResBlock(ch, ted, out_ch, dropout=cfg.dropout,
                            use_scale_shift_norm=cfg.use_scale_shift_norm, **kw)

        def attn(ch, heads):
            return AttentionBlock(ch, heads, cfg.num_head_channels)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, ted)

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(cfg.in_channels, ch, 3, padding=1)])])
        input_block_chans = [ch]
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, int(mult * mc))]
                ch = int(mult * mc)
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, cfg.num_heads))
                self.input_blocks.append(nn.ModuleList(layers))
                input_block_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                down = (res(ch, ch, down=True) if cfg.resblock_updown
                        else Downsample(ch, cfg.conv_resample, ch))
                self.input_blocks.append(nn.ModuleList([down]))
                input_block_chans.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([res(ch), attn(ch, cfg.num_heads), res(ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                ich = input_block_chans.pop()
                layers = [res(ch + ich, int(mc * mult))]
                ch = int(mc * mult)
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, heads_up))
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, up=True) if cfg.resblock_updown
                                  else Upsample(ch, cfg.conv_resample, ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 zero_module(nn.Conv2d(ch, cfg.out_channels, 3, padding=1)))

    def _run(self, block: nn.ModuleList, h, emb, deterministic: bool = True, skip=None):
        """The block's layers in order; `skip`, a decoder skip feature, goes
        to its first layer, a ResBlock, which takes the concatenation."""
        cfg = self.config
        for layer in block:
            if isinstance(layer, ResBlock):
                args = (h, emb, deterministic) + (() if skip is None else (skip,))
                skip = None
            elif isinstance(layer, AttentionBlock):
                args = (h,)
            else:
                h = layer(h)
                continue
            if cfg.remat and torch.is_grad_enabled():
                context = (functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                             _save_convolutions)
                           if cfg.remat_policy == "convs" else torch_checkpoint.noop_context_fn)
                h = torch_checkpoint.checkpoint(layer, *args, use_reentrant=False,
                                                context_fn=context)
            else:
                h = layer(*args)
        return h

    def _whole_span(self, split: Optional[int]):
        """(gather_at, own_at) under spatial partitioning with `split`
        levels split (`parallel.tp.check_spatial`): the input block after
        which the activation is gathered whole, and the output block after
        which this rank takes its rows again; (None, None) when every level
        splits, or without the axis. Block 0 is the input conv; level l's
        downsample is input block (l + 1) * per_level, and output block
        (L - l) * per_level - 1 its decoder's upsample."""
        n_levels = len(self.config.channel_mult)
        if split is None or split >= n_levels:
            return None, None
        per_level = self.config.num_res_blocks + 1
        return split * per_level, (n_levels - split) * per_level - 1

    def whole_modules(self, split: int):
        """The modules that run whole on every rank when `split` levels
        split: the input blocks after the gather, the middle block and the
        output blocks up to the one after which rows are taken again."""
        gather_at, own_at = self._whole_span(split)
        if gather_at is None:
            return []
        blocks = (list(self.input_blocks[gather_at + 1:]) + [self.middle_block]
                  + list(self.output_blocks[:own_at + 1]))
        return [m for block in blocks for m in block.modules()]

    def forward(self, x, timesteps, y=None, *, deterministic: bool = True, cache=None,
                return_cache: bool = False, cache_depth: Optional[int] = None):
        """x: [B, H, W, C] NHWC; timesteps: [B]. Returns [B, H, W, out] float32,
        or (output, cache) with `return_cache=True`. `deterministic=False`
        turns dropout on.

        Cross-step feature reuse, as the JAX `UNet`: `return_cache=True` makes
        a key call publish its features and `cache=...` makes a call consume
        them; the timestep embedding is always fresh.

        - `cache_depth=None` (encoder reuse): the cache is `(h_mid, skips)`; a
          cached call runs no input or middle block, only the decoder.
        - `cache_depth=b` (DeepCache deep-trunk reuse): the cache is the
          decoder feature entering level b-1. A cached call runs the input
          blocks of levels 0..b-1 (the downsamples between them, not the one
          that feeds level b) and the output blocks of levels b-1..0.

        The cache is this port's own structure, NCHW tensors in the activation
        dtype; callers pass it back as they got it. A cached call at the
        key call's (x, t) runs the same kernels on the same tensors as the
        plain forward, so it gives its output bit for bit.
        """
        cfg = self.config
        n_levels = len(cfg.channel_mult)
        if cache_depth is not None and not 1 <= cache_depth < n_levels:
            raise ValueError(
                f"cache_depth must be in [1, {n_levels - 1}] for "
                f"channel_mult={cfg.channel_mult}; got {cache_depth}")
        if (y is not None) != (cfg.num_classes is not None):
            raise ValueError(
                f"labels and num_classes must come together: y is "
                f"{'set' if y is not None else 'None'} but num_classes={cfg.num_classes}")
        ax = self.model_axis
        gather_at, own_at = self._whole_span(None if ax is None else ax.check(self, x))
        dtype = cfg.dtype
        per_level = cfg.num_res_blocks + 1
        deep_cached = cache is not None and cache_depth is not None

        emb = timestep_embedding(timesteps, cfg.model_channels).to(dtype)
        emb = linear(self.time_embed[0], emb)
        emb = linear(self.time_embed[2], F.silu(emb))
        if y is not None:
            emb = emb + self.label_emb(y).to(dtype)

        if cache is None or deep_cached:
            stop = cache_depth * per_level if deep_cached else len(self.input_blocks)
            h = conv(self.input_blocks[0][0], x.permute(0, 3, 1, 2).to(dtype))
            hs = []
            for i in range(stop):
                if i:
                    h = self._run(self.input_blocks[i], h, emb, deterministic)
                if i == gather_at:  # the next level does not split: whole from here
                    h = ax.gather(h)
                hs.append(h)
            if not deep_cached:
                h = self._run(self.middle_block, h, emb, deterministic)
        else:
            h_mid, skips = cache
            # a new list: the decoder pops it, and the cache serves every
            # cached step until the next key step
            h, hs = h_mid.to(dtype), [s.to(dtype) for s in skips]

        new_cache = (h, tuple(hs)) if return_cache and cache_depth is None else None
        # the output block where the decoder enters level cache_depth - 1
        branch = None if cache_depth is None else (n_levels - cache_depth) * per_level
        start = 0
        if deep_cached:
            h, start = cache.to(dtype), branch
        for i in range(start, len(self.output_blocks)):
            if return_cache and i == branch:
                new_cache = h
            if cfg.split_decoder_skips:
                h = self._run(self.output_blocks[i], h, emb, deterministic, skip=hs.pop())
            else:
                h = self._run(self.output_blocks[i], torch.cat([h, hs.pop()], dim=1), emb,
                              deterministic)
            if i == own_at:  # back at a level that splits: this rank's rows
                h = ax.own_rows(h)
        assert not hs

        h = F.silu(self.out[0](h))
        h = conv(self.out[2], h.float()).permute(0, 2, 3, 1)
        return (h, new_cache) if return_cache else h


class InpaintingUNet(UNet):
    """Mask-aware 9-channel UNet: the input is [noisy(3) | masked(3) | mask x3]
    on the channel axis. Its state dict is the base UNet's, with ADM keys."""

    def forward(self, x, t, masked_image, mask, y=None, *, deterministic: bool = True,
                cache=None, return_cache: bool = False, cache_depth: Optional[int] = None):
        mask3 = mask.expand(*mask.shape[:-1], 3)
        inp = torch.cat([x, masked_image.to(x.dtype), mask3.to(x.dtype)], dim=-1)
        return super().forward(inp, t, y, deterministic=deterministic, cache=cache,
                               return_cache=return_cache, cache_depth=cache_depth)
