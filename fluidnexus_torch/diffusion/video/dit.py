"""Video diffusion transformer (CogVideoX class) as torch modules
(counterpart of ``fluidnexus_tpu/diffusion/video/dit.py``).

- 2x2 patch embed over latent frames; text projected and prepended to the
  token sequence (joint text + video full self-attention);
- factorized 3D RoPE on the image tokens only (head dim split d/4 | 3d/8 |
  3d/8 over t/h/w, interleaved pair rotation);
- per-layer adaLN with 12-way modulation: shift/scale/gate for the text and
  image streams in both attention and MLP;
- qk layer-norm per head;
- final layer: 2-way adaLN modulate, linear, unpatchify.

Module and parameter names follow the flax tree (``block_{i}``, ``attn.qkv``,
``q_ln_scale``, ...; a flax Dense ``kernel`` (in, out) is a ``weight`` (out,
in) here), so ``fluidnexus_torch.convert.video_dit_from_numpy`` maps one onto
the other. Weights that the JAX package casts to ``cfg.dtype`` at use are
stored in ``cfg.dtype``; the adaLN projections and the time MLP stay f32, as
they compute in f32. The attention goes through
``fluidnexus_torch.ops.attention_cuda.joint_attention``: the CUDA kernel on
the card, its plain version on the CPU. LoRA adapters (rank > 0), int8 base
weights and rematerialization are training features and are not ported here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fluidnexus_torch.ops.attention_cuda import joint_attention


@dataclasses.dataclass(frozen=True)
class VideoDiTConfig:
    hidden_size: int = 3072
    num_layers: int = 42
    num_heads: int = 48
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    text_hidden_size: int = 4096     # T5-XXL
    text_length: int = 226
    latent_frames: int = 13          # compressed_num_frames
    latent_height: int = 60
    latent_width: int = 90
    # 512 in the released 5B; None falls back to hidden_size
    time_embed_dim: Optional[int] = 512
    mlp_ratio: int = 4
    lora_rank: int = 0               # only 0: the adapters come with training
    dtype: torch.dtype = torch.bfloat16
    ln_affine: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def temb_dim(self):
        return self.time_embed_dim or self.hidden_size


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal embedding [cos | sin], f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def make_3d_rope(cfg: VideoDiTConfig, theta: float = 10000.0):
    """Factorized t/h/w rotary tables, (T*H*W, head_dim) cos and sin, f32;
    each frequency repeated to adjacent pairs."""
    d = cfg.head_dim
    dim_t, dim_h, dim_w = d // 4, d // 8 * 3, d // 8 * 3
    t_sz = cfg.latent_frames
    h_sz = cfg.latent_height // cfg.patch_size
    w_sz = cfg.latent_width // cfg.patch_size

    def freqs(dim, size):
        f = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
        out = np.einsum("s,f->sf", np.arange(size, dtype=np.float64), f)
        return np.repeat(out, 2, axis=-1)  # (size, dim)

    ft = freqs(dim_t, t_sz)[:, None, None, :]
    fh = freqs(dim_h, h_sz)[None, :, None, :]
    fw = freqs(dim_w, w_sz)[None, None, :, :]
    f = np.concatenate(
        [np.broadcast_to(ft, (t_sz, h_sz, w_sz, ft.shape[-1])),
         np.broadcast_to(fh, (t_sz, h_sz, w_sz, fh.shape[-1])),
         np.broadcast_to(fw, (t_sz, h_sz, w_sz, fw.shape[-1]))], -1
    ).reshape(t_sz * h_sz * w_sz, d)
    return (torch.as_tensor(np.cos(f), dtype=torch.float32),
            torch.as_tensor(np.sin(f), dtype=torch.float32))


def rotate_half_interleaved(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], -1).reshape(x.shape)


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (S, D)."""
    return x * cos[None, None] + rotate_half_interleaved(x) * sin[None, None]


def _ln(x, eps=1e-6):
    """LayerNorm without affine, statistics in f32, result in x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _empty(*shape, dtype):
    return nn.Parameter(torch.empty(shape, dtype=dtype))


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype)``: input, weight and bias cast to
    ``dtype`` at use. The weight is stored (out, in) in ``dtype``. It is also
    the JAX ``LoRADense`` at rank 0 (``qkv``, ``out``, ``fc1``, ``fc2``),
    whose input always arrives in ``dtype``."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(out_features, in_features, dtype=dtype)
        self.bias = _empty(out_features, dtype=dtype)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class AffineLN(nn.Module):
    """LayerNorm with learned scale/bias (the released 5B's
    elementwise_affine); the plain ``_ln`` when the config disables affine."""

    def __init__(self, dim, affine, dtype, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _empty(dim, dtype=dtype) if affine else None
        self.bias = _empty(dim, dtype=dtype) if affine else None

    def forward(self, x):
        y = _ln(x, self.eps)
        if self.scale is None:
            return y
        return y * self.scale.to(y.dtype) + self.bias.to(y.dtype)


class JointAttention(nn.Module):
    def __init__(self, cfg: VideoDiTConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.head_dim
        self.qkv = Dense(c.hidden_size, 3 * c.hidden_size, c.dtype)
        self.q_ln_scale = _empty(d, dtype=c.dtype)
        self.k_ln_scale = _empty(d, dtype=c.dtype)
        if c.ln_affine:  # the 5B qk-LNs are full affine LayerNorms
            self.q_ln_bias = _empty(d, dtype=c.dtype)
            self.k_ln_bias = _empty(d, dtype=c.dtype)
        self.out = Dense(c.hidden_size, c.hidden_size, c.dtype)

    def forward(self, x, rope_cos, rope_sin):
        c = self.cfg
        b, s, _ = x.shape
        q, k, v = torch.split(self.qkv(x), c.hidden_size, dim=-1)

        def heads(t):
            return t.reshape(b, s, c.num_heads, c.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)   # v stays a strided view
        q = _ln(q) * self.q_ln_scale.to(c.dtype)
        k = _ln(k) * self.k_ln_scale.to(c.dtype)
        if c.ln_affine:
            q = q + self.q_ln_bias.to(c.dtype)
            k = k + self.k_ln_bias.to(c.dtype)

        tl = c.text_length
        q = torch.cat([q[:, :, :tl], apply_rope(q[:, :, tl:], rope_cos, rope_sin).to(q.dtype)], 2)
        k = torch.cat([k[:, :, :tl], apply_rope(k[:, :, tl:], rope_cos, rope_sin).to(k.dtype)], 2)

        attn = joint_attention(q, k, v)  # (b, s, h, d)
        return self.out(attn.reshape(b, s, c.hidden_size))


class MLP(nn.Module):
    def __init__(self, cfg: VideoDiTConfig):
        super().__init__()
        c = cfg
        self.fc1 = Dense(c.hidden_size, c.mlp_ratio * c.hidden_size, c.dtype)
        self.fc2 = Dense(c.mlp_ratio * c.hidden_size, c.hidden_size, c.dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, cfg: VideoDiTConfig):
        super().__init__()
        c = self.cfg = cfg
        self.adaLN = Dense(c.temb_dim, 12 * c.hidden_size, torch.float32)
        self.ln1 = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.ln2 = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.attn = JointAttention(c)
        self.mlp = MLP(c)

    def forward(self, x, emb, rope_cos, rope_sin):
        c = self.cfg
        tl = c.text_length
        mod = self.adaLN(F.silu(emb))
        (s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp,
         ts_msa, tsc_msa, tg_msa, ts_mlp, tsc_mlp, tg_mlp) = torch.chunk(mod.to(c.dtype), 12, -1)

        # the input and post-attention layernorms are shared between the text
        # and image streams and applied before modulate
        xt, xi = x[:, :tl], x[:, tl:]
        h = torch.cat([modulate(self.ln1(xt), ts_msa, tsc_msa),
                       modulate(self.ln1(xi), s_msa, sc_msa)], 1)
        a = self.attn(h, rope_cos, rope_sin)
        xt = xt + tg_msa[:, None] * a[:, :tl]
        xi = xi + g_msa[:, None] * a[:, tl:]

        h = torch.cat([modulate(self.ln2(xt), ts_mlp, tsc_mlp),
                       modulate(self.ln2(xi), s_mlp, sc_mlp)], 1)
        mo = self.mlp(h)
        xt = xt + tg_mlp[:, None] * mo[:, :tl]
        xi = xi + g_mlp[:, None] * mo[:, tl:]
        return torch.cat([xt, xi], 1)


class VideoDiT(nn.Module):
    """Denoiser network: (latents, timesteps, text_emb) -> prediction."""

    def __init__(self, cfg: VideoDiTConfig):
        super().__init__()
        if cfg.lora_rank:
            raise ValueError("LoRA adapters are not ported yet: use lora_rank=0")
        c = self.cfg = cfg
        p = c.patch_size
        self.patch_proj = Dense(p * p * c.in_channels, c.hidden_size, c.dtype)
        self.text_proj = Dense(c.text_hidden_size, c.hidden_size, c.dtype)
        self.time_fc1 = Dense(c.hidden_size, c.temb_dim, torch.float32)
        self.time_fc2 = Dense(c.temb_dim, c.temb_dim, torch.float32)
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", DiTBlock(c))
        self.final_ln = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.final_adaLN = Dense(c.temb_dim, 2 * c.hidden_size, torch.float32)
        self.norm_final = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.final_linear = Dense(c.hidden_size, p * p * c.out_channels, c.dtype)
        cos, sin = make_3d_rope(c)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, latents, timesteps, text_emb):
        """latents: (B, T, C, H, W); timesteps: (B,); text_emb: (B, L, text_hidden)."""
        c = self.cfg
        b, t, ch, hh, ww = latents.shape
        p = c.patch_size

        x = latents.to(c.dtype).permute(0, 1, 3, 4, 2)  # b t h w c
        x = x.reshape(b, t, hh // p, p, ww // p, p, ch).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, t * (hh // p) * (ww // p), p * p * ch)
        x = torch.cat([self.text_proj(text_emb), self.patch_proj(x)], 1)

        temb = timestep_embedding(timesteps, c.hidden_size)
        temb = self.time_fc2(F.silu(self.time_fc1(temb)))

        n_img = x.shape[1] - c.text_length
        rope_cos = self.rope_cos.to(c.dtype)[:n_img]
        rope_sin = self.rope_sin.to(c.dtype)[:n_img]
        for blk in self.blocks():
            x = blk(x, temb, rope_cos, rope_sin)

        x = self.final_ln(x)
        xi = x[:, c.text_length:]
        shift, scale = torch.chunk(self.final_adaLN(F.silu(temb)).to(c.dtype), 2, -1)
        xi = modulate(self.norm_final(xi), shift, scale)
        xi = self.final_linear(xi)

        hp, wp = hh // p, ww // p
        out = xi.reshape(b, t, hp, wp, p, p, c.out_channels)
        out = out.permute(0, 1, 6, 2, 4, 3, 5).reshape(b, t, c.out_channels, hh, ww)
        return out.to(torch.float32)


def init_video_dit(cfg: VideoDiTConfig, generator: torch.Generator) -> VideoDiT:
    """A ``VideoDiT`` on the generator's device, drawn as the flax init draws:
    Dense kernels lecun-normal (a normal truncated at +-2 std, std
    sqrt(1/fan_in) / .8796), biases 0, LayerNorm scales 1 and biases 0, and
    every adaLN projection (``block_{i}.adaLN``, ``final_adaLN``) 0."""
    with torch.device(generator.device):
        model = VideoDiT(cfg)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                if name.endswith("adaLN"):
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, AffineLN) and mod.scale is not None:
                mod.scale.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, JointAttention):
                mod.q_ln_scale.fill_(1.0)
                mod.k_ln_scale.fill_(1.0)
                if cfg.ln_affine:
                    mod.q_ln_bias.zero_()
                    mod.k_ln_bias.zero_()
    return model.to(generator.device)


def lecun_normal_(w, fan_in, generator):
    """flax's lecun_normal in place: a unit normal truncated to [-2, 2]
    times sqrt(1/fan_in) / .87962566103423978, drawn in f32 row block by
    row block (so a 5B-size kernel needs no f32 copy of itself)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    flat = w.view(w.shape[0], -1)
    rows = max(1, (1 << 24) // flat.shape[1])
    for i in range(0, flat.shape[0], rows):
        part = torch.empty(flat[i:i + rows].shape, dtype=torch.float32, device=w.device)
        nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0, generator=generator)
        flat[i:i + rows].copy_(part * std)
    return w
