"""Causal 3D video VAE (CogVideoX class): 8x spatial and 4x temporal
compression to 16-channel latents (counterpart of
``fluidnexus_tpu/diffusion/video/vae3d.py``, its serial path).

The public functions keep the JAX package's channel-last layout (B, T, H, W,
C); inside, tensors are (B, C, T, H, W) for ``conv3d``. The flax ``cache``
collection of the chunked decode is an explicit dict here: ``encode`` and
``decode`` take the cache of the previous chunk and return the next one's, one
entry per causal 3D conv (the last k_t - 1 frames of its padded input). The
spatial-only convs run as ``conv3d`` with a 1 x 3 x 3 kernel, the per-frame
``conv2d`` of the JAX package. Module and parameter names follow the flax
tree (a conv ``kernel`` is a ``weight`` here); the context-parallel branches
and the width-tiled decode are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fluidnexus_torch.diffusion.video import sampling


@dataclasses.dataclass(frozen=True)
class VAE3DConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 3
    in_channels: int = 3
    out_channels: int = 3
    z_channels: int = 16
    double_z: bool = True
    temporal_compress_times: int = 4
    dtype: torch.dtype = torch.float32
    scale_factor: float = 1.15258426   # engine latent scale (cogvideox yaml)

    @property
    def temporal_compress_level(self):
        return int(np.log2(self.temporal_compress_times))

    @property
    def num_resolutions(self):
        return len(self.ch_mult)


class _Chunk:
    """One chunk's view of the conv cache: whether it is the first chunk,
    the cache it reads and the cache it leaves for the next chunk."""

    def __init__(self, first_chunk, cache):
        self.first = first_chunk
        self.cache_in = cache or {}
        self.cache_out = {}


class _Weights(nn.Module):
    """A flax Conv or Dense's parameters: ``weight`` (out, in, *kernel) and
    ``bias`` (out,)."""

    def __init__(self, c_in, c_out, kernel, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_out, c_in) + tuple(kernel), dtype=dtype))
        self.bias = nn.Parameter(torch.empty((c_out,), dtype=dtype))


class CausalConv3d(nn.Module):
    """3D conv, causal in time: k_t - 1 frames padded on the left with a
    replicate of the first frame (first chunk) or the previous chunk's cache."""

    def __init__(self, c_in, c_out, kernel_size=(3, 3, 3), dtype=torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.conv = _Weights(c_in, c_out, kernel_size, dtype)
        self.key = None  # set by VideoVAE: this conv's entry in the cache

    def forward(self, x, st: _Chunk):
        kt, kh, kw = self.kernel_size
        pad_t = kt - 1
        if pad_t > 0:
            front = x[:, :, :1].expand(-1, -1, pad_t, -1, -1) if st.first else st.cache_in[self.key]
            x = torch.cat([front, x], 2)
            st.cache_out[self.key] = x[:, :, -pad_t:].clone()
        return F.conv3d(x, self.conv.weight, self.conv.bias, padding=(0, kh // 2, kw // 2))


def group_norm(x, scale, bias, groups=32, eps=1e-6):
    """GroupNorm over (c // groups, t, h, w), statistics in f32."""
    c = x.shape[1]
    return F.group_norm(x.to(torch.float32), min(groups, c), scale.to(torch.float32),
                        bias.to(torch.float32), eps).to(x.dtype)


def resize_nearest(x, size):
    """``jax.image.resize(..., "nearest")`` over (t, h, w) of a (B, C, T, H,
    W) tensor: output index i reads floor((i + 0.5) in / out)."""
    for dim, n in zip((2, 3, 4), size):
        m = x.shape[dim]
        if m != n:
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                           / np.float32(n)).astype(np.int64)
            x = x.index_select(dim, torch.as_tensor(np.minimum(idx, m - 1), device=x.device))
    return x


class Norm3D(nn.Module):
    """GroupNorm(32), zq-conditioned when built with ``zq_ch``."""

    def __init__(self, c, zq_ch=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((c,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty((c,), dtype=torch.float32))
        if zq_ch is not None:
            self.conv_y = CausalConv3d(zq_ch, c, (1, 1, 1), dtype)
            self.conv_b = CausalConv3d(zq_ch, c, (1, 1, 1), dtype)

    def forward(self, x, zq, st: _Chunk):
        h = group_norm(x, self.scale, self.bias)
        if zq is None:
            return h
        # zq resized to x's (t, h, w); the first frame kept apart when the
        # temporal sizes differ on an odd length
        zt, xt = zq.shape[2], x.shape[2]
        if tuple(zq.shape[2:]) != tuple(x.shape[2:]):
            if xt > zt and xt % 2 == 1:
                zq = torch.cat([resize_nearest(zq[:, :, :1], (1,) + tuple(x.shape[3:])),
                                resize_nearest(zq[:, :, 1:], (xt - 1,) + tuple(x.shape[3:]))], 2)
            else:
                zq = resize_nearest(zq, tuple(x.shape[2:]))
        return h * self.conv_y(zq, st) + self.conv_b(zq, st)


class ResnetBlock3D(nn.Module):
    def __init__(self, c_in, c_out, zq_ch=None, dtype=torch.float32):
        super().__init__()
        self.norm1 = Norm3D(c_in, zq_ch, dtype)
        self.conv1 = CausalConv3d(c_in, c_out, dtype=dtype)
        self.norm2 = Norm3D(c_out, zq_ch, dtype)
        self.conv2 = CausalConv3d(c_out, c_out, dtype=dtype)
        if c_in != c_out:
            self.nin_shortcut = _Weights(c_in, c_out, (), dtype)

    def forward(self, x, zq, st: _Chunk):
        h = self.conv1(F.silu(self.norm1(x, zq, st)), st)
        h = self.conv2(F.silu(self.norm2(h, zq, st)), st)
        if hasattr(self, "nin_shortcut"):
            w = self.nin_shortcut.weight
            x = F.conv3d(x, w[:, :, None, None, None], self.nin_shortcut.bias)
        return x + h


class DownSample3D(nn.Module):
    """Spatial stride-2 conv after a (0, 1) pad; temporal average-pool of 2
    with the first frame kept apart on odd lengths of the first chunk."""

    def __init__(self, c, compress_time=False, dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = _Weights(c, c, (3, 3), dtype)

    def forward(self, x, st: _Chunk):
        if self.compress_time and x.shape[2] > 1:
            if x.shape[2] % 2 == 1 and st.first:
                first, rest = x[:, :, :1], x[:, :, 1:]
                if rest.shape[2] > 0:
                    rest = (rest[:, :, 0::2] + rest[:, :, 1::2]) / 2.0
                x = torch.cat([first, rest], 2)
            else:
                x = (x[:, :, 0::2] + x[:, :, 1::2]) / 2.0
        x = F.pad(x, (0, 1, 0, 1))
        return F.conv3d(x, self.conv.weight[:, :, None], self.conv.bias, stride=(1, 2, 2))


class Upsample3D(nn.Module):
    """Nearest 2x spatial; temporal 2x, the first frame not doubled on an odd
    first chunk."""

    def __init__(self, c, compress_time=False, dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = _Weights(c, c, (3, 3), dtype)

    def forward(self, x, st: _Chunk):
        t, h, w = x.shape[2:]
        if self.compress_time and t > 1:
            if t % 2 == 1 and st.first:
                x = torch.cat([resize_nearest(x[:, :, :1], (1, 2 * h, 2 * w)),
                               resize_nearest(x[:, :, 1:], (2 * (t - 1), 2 * h, 2 * w))], 2)
            else:
                x = resize_nearest(x, (2 * t, 2 * h, 2 * w))
        else:
            x = resize_nearest(x, (t, 2 * h, 2 * w))
        return F.conv3d(x, self.conv.weight[:, :, None], self.conv.bias, padding=(0, 1, 1))


class Encoder3D(nn.Module):
    def __init__(self, cfg: VAE3DConfig):
        super().__init__()
        c = self.cfg = cfg
        self.conv_in = CausalConv3d(c.in_channels, c.ch, dtype=c.dtype)
        cur = c.ch
        for i_level in range(c.num_resolutions):
            block_out = c.ch * c.ch_mult[i_level]
            for i_block in range(c.num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}",
                                ResnetBlock3D(cur, block_out, dtype=c.dtype))
                cur = block_out
            if i_level != c.num_resolutions - 1:
                self.add_module(f"down_{i_level}_downsample",
                                DownSample3D(cur, i_level < c.temporal_compress_level, c.dtype))
        self.mid_block_1 = ResnetBlock3D(cur, cur, dtype=c.dtype)
        self.mid_block_2 = ResnetBlock3D(cur, cur, dtype=c.dtype)
        self.norm_out = Norm3D(cur, dtype=c.dtype)
        self.conv_out = CausalConv3d(cur, 2 * c.z_channels if c.double_z else c.z_channels,
                                     dtype=c.dtype)

    def forward(self, x, st: _Chunk):
        c = self.cfg
        h = self.conv_in(x, st)
        for i_level in range(c.num_resolutions):
            for i_block in range(c.num_res_blocks):
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h, None, st)
            if i_level != c.num_resolutions - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h, st)
        h = self.mid_block_2(self.mid_block_1(h, None, st), None, st)
        return self.conv_out(F.silu(self.norm_out(h, None, st)), st)


class Decoder3D(nn.Module):
    """zq-conditioned norms throughout."""

    def __init__(self, cfg: VAE3DConfig):
        super().__init__()
        c = self.cfg = cfg
        z = c.z_channels
        cur = c.ch * c.ch_mult[-1]
        self.conv_in = CausalConv3d(z, cur, dtype=c.dtype)
        self.mid_block_1 = ResnetBlock3D(cur, cur, z, c.dtype)
        self.mid_block_2 = ResnetBlock3D(cur, cur, z, c.dtype)
        for i_level in reversed(range(c.num_resolutions)):
            block_out = c.ch * c.ch_mult[i_level]
            for i_block in range(c.num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}",
                                ResnetBlock3D(cur, block_out, z, c.dtype))
                cur = block_out
            if i_level != 0:
                compress = i_level >= c.num_resolutions - c.temporal_compress_level
                self.add_module(f"up_{i_level}_upsample", Upsample3D(cur, compress, c.dtype))
        self.norm_out = Norm3D(cur, z, c.dtype)
        self.conv_out = CausalConv3d(cur, c.out_channels, dtype=c.dtype)

    def forward(self, z, st: _Chunk):
        c = self.cfg
        zq = z
        h = self.conv_in(z, st)
        h = self.mid_block_2(self.mid_block_1(h, zq, st), zq, st)
        for i_level in reversed(range(c.num_resolutions)):
            for i_block in range(c.num_res_blocks + 1):
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h, zq, st)
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h, st)
        return self.conv_out(F.silu(self.norm_out(h, zq, st)), st)


def _to_cf(x):
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_cl(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


class VideoVAE(nn.Module):
    """Encode/decode wrapper: latents scaled by ``cfg.scale_factor`` on
    encode and unscaled on decode. Channel-last in and out; each call takes
    the previous chunk's cache and returns its own."""

    def __init__(self, cfg: VAE3DConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3D(cfg)
        self.decoder = Decoder3D(cfg)
        for name, mod in self.named_modules():
            if isinstance(mod, CausalConv3d):
                mod.key = name

    def encode(self, x, rng: Optional[torch.Generator] = None, first_chunk=True, sample=True,
               cache=None):
        """x (B, T, H, W, C) -> (z (B, T', H', W', Cz), cache)."""
        st = _Chunk(first_chunk, cache)
        mean, logvar = torch.chunk(self.encoder(_to_cf(x.to(self.cfg.dtype)), st), 2, dim=1)
        if sample and rng is not None:
            # drawn channel-last, the JAX package's layout, so the draws match
            noise = _to_cf(sampling._normal(_to_cl(mean).shape, rng, mean.device).to(mean.dtype))
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
        else:
            z = mean
        return _to_cl(z * self.cfg.scale_factor), st.cache_out

    def decode(self, z, first_chunk=True, cache=None):
        """z (B, T, H, W, Cz) -> (frames (B, T', H', W', C), cache)."""
        st = _Chunk(first_chunk, cache)
        out = self.decoder(_to_cf(z.to(self.cfg.dtype) / self.cfg.scale_factor), st)
        return _to_cl(out), st.cache_out


def chunked_decode(vae: VideoVAE, z, chunk: int = 2):
    """Serial chunked decode with the conv cache carried across chunks.
    z: (B, T, H, W, C). The first chunk takes ``chunk`` + the remainder
    latents, so the first-frame split happens once."""
    t = z.shape[1]
    first = chunk + t % chunk
    outs, cache, start = [], None, 0
    while start < t:
        end = min(first if start == 0 else start + chunk, t)
        out, cache = vae.decode(z[:, start:end], first_chunk=start == 0, cache=cache)
        outs.append(out)
        start = end
    return torch.cat(outs, 1)


def chunked_encode(vae: VideoVAE, x, chunk: int = 2, rng: Optional[torch.Generator] = None,
                   sample: bool = False):
    """Serial chunked encode, the mirror of ``chunked_decode``: ``chunk``
    counts output latent frames (4 input frames each); the first chunk takes
    the 4k+1 head frame plus the remainder."""
    t = x.shape[1]
    ct = vae.cfg.temporal_compress_times
    if (t - 1) % ct:
        raise ValueError(f"clip length {t} is not {ct}k+1")
    t_lat = (t - 1) // ct + 1
    first = chunk + t_lat % chunk
    bounds = [(0, 1 + (first - 1) * ct)]
    while bounds[-1][1] < t:
        s = bounds[-1][1]
        bounds.append((s, s + chunk * ct))
    outs, cache = [], None
    for s, e in bounds:
        out, cache = vae.encode(x[:, s:e], rng, first_chunk=s == 0, sample=sample, cache=cache)
        outs.append(out)
    return torch.cat(outs, 1)


def init_vae(cfg: VAE3DConfig, generator: torch.Generator) -> VideoVAE:
    """A ``VideoVAE`` on the generator's device, drawn as the flax init
    draws: every conv and Dense kernel lecun-normal (fan_in = kernel volume
    x input channels), biases 0, norm scales 1 and biases 0."""
    from fluidnexus_torch.diffusion.video.dit import lecun_normal_

    with torch.device(generator.device):
        vae = VideoVAE(cfg)
    with torch.no_grad():
        for mod in vae.modules():
            if isinstance(mod, _Weights):
                lecun_normal_(mod.weight, math.prod(mod.weight.shape[1:]), generator)
                mod.bias.zero_()
            elif isinstance(mod, Norm3D):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
    return vae.to(generator.device)
