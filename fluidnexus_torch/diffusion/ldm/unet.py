"""SD-class UNet for the novel-view latent diffusion model (counterpart of
``fluidnexus_tpu/diffusion/ldm/unet.py``).

The FluidNexus config: in_channels 8 (4 latent + 4 cond-image latent), out 4,
model_channels 320, channel_mult (1, 2, 4, 4), num_res_blocks 2, attention at
downsample rates (4, 2, 1), spatial transformer depth 1 with context_dim 768,
8 heads; f32 throughout.

``UNet.forward`` takes and returns the JAX package's channel-last (B, H, W,
C); inside, tensors are (B, C, H, W). Module and parameter names follow the
flax tree, flax's auto-names included (``GroupNorm32_0.GroupNorm_0.scale``,
``block_0.LayerNorm_1``): a flax Dense or Conv ``kernel`` is the ``weight``
of an ``nn.Linear`` or ``nn.Conv2d`` here, so ``convert.load_flax_params``
carries a JAX tree over with no key map. The numerics the JAX package fixes:
GroupNorm at eps 1e-5 over ``min(32, c)`` groups, the transformer's
LayerNorms at 1e-5, the GEGLU's tanh-approximated gelu (flax's ``nn.gelu``),
the stride-2 downsample padded (1, 1) on each side, the nearest x2
upsample, and the ``[cos, sin]`` timestep embedding in f32. Attention is
``F.scaled_dot_product_attention`` (the JAX package leaves it to XLA).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768


# ----------------------- flax-named building blocks -----------------------


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over (B, C, H, W): ``min(32, c)`` groups,
    parameters ``scale`` and ``bias``."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.groups, self.eps = min(32, c), eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.scale, self.bias, self.eps)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, parameters ``scale`` and
    ``bias``; flax's default eps is 1e-6."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


def conv3x3(c_in, c_out, stride=1):
    """flax ``Conv((3, 3), padding="SAME")`` at stride 1, or the UNet's
    stride-2 downsample padded (1, 1) on each side."""
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1)


def conv1x1(c_in, c_out):
    return nn.Conv2d(c_in, c_out, 1)


def attention(q, k, v, heads):
    """``jax.nn.dot_product_attention`` of (B, S, D) projections split into
    ``heads`` heads: softmax(q k^T / sqrt(D / heads)) v, as (B, S, D)."""
    b, s, d = q.shape
    hd = d // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, hd).transpose(1, 2)

    o = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return o.transpose(1, 2).reshape(b, s, d)


def upsample_nearest(x):
    """``jax.image.resize(..., "nearest")`` to twice the size: output pixel
    i reads input pixel i // 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# --------------------------------- UNet ----------------------------------


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class GroupNorm32(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(c, 1e-5)

    def forward(self, x):
        return self.GroupNorm_0(x)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, emb_dim: int):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(c_in)
        self.conv1 = conv3x3(c_in, c_out)
        self.emb_proj = nn.Linear(emb_dim, c_out)
        self.GroupNorm32_1 = GroupNorm32(c_out)
        self.conv2 = conv3x3(c_out, c_out)
        if c_in != c_out:
            self.skip = conv1x1(c_in, c_out)

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.GroupNorm32_0(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.GroupNorm32_1(h)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, d: int, heads: int, context_dim: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(d, d, bias=False)
        self.to_k = nn.Linear(context_dim, d, bias=False)
        self.to_v = nn.Linear(context_dim, d, bias=False)
        self.to_out = nn.Linear(d, d)

    def forward(self, x, context=None):
        context = x if context is None else context
        return self.to_out(attention(self.to_q(x), self.to_k(context), self.to_v(context),
                                     self.heads))


class TransformerBlock(nn.Module):
    def __init__(self, d: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(d, heads, d)
        self.LayerNorm_0 = LayerNorm(d, 1e-5)
        self.attn2 = CrossAttention(d, heads, context_dim)
        self.LayerNorm_1 = LayerNorm(d, 1e-5)
        self.LayerNorm_2 = LayerNorm(d, 1e-5)
        # GEGLU feed-forward (ldm/modules/attention.py FeedForward)
        self.ff_in = nn.Linear(d, 8 * d)
        self.ff_out = nn.Linear(4 * d, d)

    def forward(self, x, context):
        x = x + self.attn1(self.LayerNorm_0(x))
        x = x + self.attn2(self.LayerNorm_1(x), context)
        a, g = torch.chunk(self.ff_in(self.LayerNorm_2(x)), 2, -1)
        return x + self.ff_out(a * F.gelu(g, approximate="tanh"))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, heads: int, depth: int, context_dim: int):
        super().__init__()
        self.depth = depth
        self.GroupNorm32_0 = GroupNorm32(c)
        self.proj_in = conv1x1(c, c)
        for i in range(depth):
            setattr(self, f"block_{i}", TransformerBlock(c, heads, context_dim))
        self.proj_out = conv1x1(c, c)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.GroupNorm32_0(x)).flatten(2).transpose(1, 2)   # (B, HW, C)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = c = cfg
        mc, emb = c.model_channels, 4 * c.model_channels
        self.time_fc1 = nn.Linear(mc, emb)
        self.time_fc2 = nn.Linear(emb, emb)
        self.conv_in = conv3x3(c.in_channels, mc)

        def attn(name, ch):
            setattr(self, name, SpatialTransformer(ch, c.num_heads, c.transformer_depth,
                                                   c.context_dim))

        skips, h, ds = [mc], mc, 1
        for i, mult in enumerate(c.channel_mult):
            ch = mc * mult
            for j in range(c.num_res_blocks):
                setattr(self, f"down_{i}_res_{j}", ResBlock(h, ch, emb))
                h = ch
                if ds in c.attention_resolutions:
                    attn(f"down_{i}_attn_{j}", ch)
                skips.append(h)
            if i != len(c.channel_mult) - 1:
                setattr(self, f"down_{i}_downsample", conv3x3(ch, ch, stride=2))
                skips.append(ch)
                ds *= 2
        ch = mc * c.channel_mult[-1]
        self.mid_res_1 = ResBlock(h, ch, emb)
        attn("mid_attn", ch)
        self.mid_res_2 = ResBlock(ch, ch, emb)
        h = ch
        for i, mult in reversed(list(enumerate(c.channel_mult))):
            ch = mc * mult
            for j in range(c.num_res_blocks + 1):
                setattr(self, f"up_{i}_res_{j}", ResBlock(h + skips.pop(), ch, emb))
                h = ch
                if ds in c.attention_resolutions:
                    attn(f"up_{i}_attn_{j}", ch)
            if i != 0:
                setattr(self, f"up_{i}_upsample", conv3x3(ch, ch))
                ds //= 2
        self.GroupNorm32_0 = GroupNorm32(h)
        self.conv_out = conv3x3(h, c.out_channels)

    def forward(self, x, timesteps, context):
        """x (B, H, W, Cin), timesteps (B,), context (B, L, context_dim) ->
        (B, H, W, Cout)."""
        c = self.cfg
        temb = timestep_embedding(timesteps, c.model_channels).to(self.time_fc1.weight.dtype)
        emb = self.time_fc2(F.silu(self.time_fc1(temb)))

        def attn(name, h):
            return getattr(self, name)(h, context) if hasattr(self, name) else h

        h = self.conv_in(x.permute(0, 3, 1, 2))
        hs = [h]
        for i in range(len(c.channel_mult)):
            for j in range(c.num_res_blocks):
                h = attn(f"down_{i}_attn_{j}", getattr(self, f"down_{i}_res_{j}")(h, emb))
                hs.append(h)
            if i != len(c.channel_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                hs.append(h)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h, emb), context), emb)
        for i in reversed(range(len(c.channel_mult))):
            for j in range(c.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, hs.pop()], 1), emb)
                h = attn(f"up_{i}_attn_{j}", h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(upsample_nearest(h))
        h = self.conv_out(F.silu(self.GroupNorm32_0(h)))
        return h.permute(0, 2, 3, 1)
