"""KL autoencoder (f = 8, z = 4) for the novel-view LDM (counterpart of
``fluidnexus_tpu/diffusion/ldm/autoencoder.py``): the SD-standard encoder and
decoder, ch 128, ch_mult (1, 2, 4, 4), 2 res blocks, mid attention, double z.

``encode`` and ``decode`` take and return channel-last (B, H, W, C) tensors,
as in the JAX package; inside they are (B, C, H, W). Names follow the flax
tree (``GroupNorm_0``, ``nin_shortcut``, ``quant_conv``). Every GroupNorm
runs at eps 1e-6; the encoder's stride-2 downsample pads (0, 1), bottom and
right only, then convolves unpadded; the decoder upsamples nearest x2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fluidnexus_torch.diffusion.ldm.unet import (
    GroupNorm, attention, conv1x1, conv3x3, upsample_nearest,
)


@dataclasses.dataclass(frozen=True)
class KLVAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    in_channels: int = 3
    out_channels: int = 3
    scale_factor: float = 0.18215


def _norm(c):
    return GroupNorm(c, 1e-6)


class ResBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.GroupNorm_0 = _norm(c_in)
        self.conv1 = conv3x3(c_in, c_out)
        self.GroupNorm_1 = _norm(c_out)
        self.conv2 = conv3x3(c_out, c_out)
        if c_in != c_out:
            self.nin_shortcut = conv1x1(c_in, c_out)

    def forward(self, x):
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        h = self.conv2(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head self-attention over the H x W positions."""

    def __init__(self, c: int):
        super().__init__()
        self.GroupNorm_0 = _norm(c)
        self.q, self.k, self.v = conv1x1(c, c), conv1x1(c, c), conv1x1(c, c)
        self.proj_out = conv1x1(c, c)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x)

        def tokens(conv):
            return conv(h).flatten(2).transpose(1, 2)   # (B, HW, C)

        o = attention(tokens(self.q), tokens(self.k), tokens(self.v), 1)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, hh, ww))


class KLEncoder(nn.Module):
    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.conv_in = conv3x3(c.in_channels, c.ch)
        h = c.ch
        for i, mult in enumerate(c.ch_mult):
            for j in range(c.num_res_blocks):
                setattr(self, f"down_{i}_block_{j}", ResBlock2D(h, c.ch * mult))
                h = c.ch * mult
            if i != len(c.ch_mult) - 1:
                setattr(self, f"down_{i}_downsample", nn.Conv2d(h, h, 3, stride=2))
        self.mid_block_1 = ResBlock2D(h, h)
        self.mid_attn = AttnBlock2D(h)
        self.mid_block_2 = ResBlock2D(h, h)
        self.GroupNorm_0 = _norm(h)
        self.conv_out = conv3x3(h, 2 * c.z_channels)

    def forward(self, x):
        c = self.cfg
        h = self.conv_in(x)
        for i in range(len(c.ch_mult)):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(c.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


class KLDecoder(nn.Module):
    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        c = self.cfg = cfg
        h = c.ch * c.ch_mult[-1]
        self.conv_in = conv3x3(c.z_channels, h)
        self.mid_block_1 = ResBlock2D(h, h)
        self.mid_attn = AttnBlock2D(h)
        self.mid_block_2 = ResBlock2D(h, h)
        for i in reversed(range(len(c.ch_mult))):
            for j in range(c.num_res_blocks + 1):
                setattr(self, f"up_{i}_block_{j}", ResBlock2D(h, c.ch * c.ch_mult[i]))
                h = c.ch * c.ch_mult[i]
            if i != 0:
                setattr(self, f"up_{i}_upsample", conv3x3(h, h))
        self.GroupNorm_0 = _norm(h)
        self.conv_out = conv3x3(h, c.out_channels)

    def forward(self, z):
        c = self.cfg
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(z))))
        for i in reversed(range(len(c.ch_mult))):
            for j in range(c.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(upsample_nearest(h))
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = KLEncoder(cfg)
        self.decoder = KLDecoder(cfg)
        # 1x1 moment/latent convs (AutoencoderKL quant_conv/post_quant_conv)
        self.quant_conv = conv1x1(2 * cfg.z_channels, 2 * cfg.z_channels)
        self.post_quant_conv = conv1x1(cfg.z_channels, cfg.z_channels)

    def encode(self, x, noise: Optional[torch.Tensor] = None):
        """(B, H, W, 3) in [-1, 1] -> the (B, h, w, z) latent times
        ``scale_factor``: the posterior mode, or with ``noise`` (the latent's
        shape, standard normal) a posterior sample."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = torch.chunk(moments, 2, -1)
        z = mean
        if noise is not None:
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
        return z * self.cfg.scale_factor

    def decode(self, z):
        """(B, h, w, z) latent -> (B, H, W, 3)."""
        h = self.post_quant_conv((z / self.cfg.scale_factor).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)
