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
``q_ln_scale``, ...; every Dense is a ``LoRADense``, whose flax ``kernel``
(in, out) is a ``weight`` (out, in) here), so
``fluidnexus_torch.convert.video_dit_from_numpy`` maps one onto the other.
Weights that the JAX package casts to ``cfg.dtype`` at use are stored in
``cfg.dtype``; the adaLN projections and the time MLP stay f32, as they
compute in f32. The attention goes through
``fluidnexus_torch.ops.attention_cuda.joint_attention``: the CUDA kernels on
the card (forward, and backward when a gradient is wanted), the plain version
on the CPU.

Training (``pipelines/train_video``): every attention and MLP projection is a
``LoRADense``, with f32 adapters ``lora_a`` (in, rank) and ``lora_b`` (rank,
out) at rank > 0, stored in the flax layout and cast to ``cfg.dtype`` at use.
``base_quant`` stores the frozen block projections, the adaLN one included,
as int8 ``kernel_q`` (in, out) with an f32 per-column ``kernel_scale``.
``remat`` recomputes each block (or, with ``remat_group`` g > 1, each group of
g blocks, nesting a scope per block) in the backward with
``torch.utils.checkpoint``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    lora_rank: int = 0               # 0 disables the LoRA adapters
    dtype: torch.dtype = torch.bfloat16
    ln_affine: bool = True
    # recompute each block in the backward (the reference finetunes with
    # checkpoint_activations); g > 1 blocks per outer scope
    remat: bool = True
    remat_group: int = 1
    # int8 frozen base projections with per-column f32 scales (QLoRA style)
    base_quant: bool = False

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


LORA_ALPHA = 1.0   # the JAX LoRADense's lora_alpha, which no caller sets


class LoRADense(nn.Module):
    """flax ``nn.Dense(features, dtype)`` and the JAX ``LoRADense``: ``x @
    kernel`` (or, with ``quant``, ``(x @ kernel_q) * kernel_scale``, the
    scale applied after the product, as JAX does) plus the bias, plus ``((x
    @ lora_a) @ lora_b) * LORA_ALPHA`` at rank > 0; input, weights and bias
    cast to ``dtype`` at use. The float kernel is stored as a (out, in)
    ``weight`` in ``dtype``; ``kernel_q`` (int8), ``lora_a`` and ``lora_b``
    (f32) keep the flax (in, out) layout."""

    def __init__(self, in_features, out_features, dtype, rank=0, quant=False):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        if quant:
            self.kernel_q = nn.Parameter(torch.empty((in_features, out_features), dtype=torch.int8),
                                         requires_grad=False)
            self.kernel_scale = _empty(out_features, dtype=torch.float32)
        else:
            self.weight = _empty(out_features, in_features, dtype=dtype)
        self.bias = _empty(out_features, dtype=dtype)
        if rank > 0:
            self.lora_a = _empty(in_features, rank, dtype=torch.float32)
            self.lora_b = _empty(rank, out_features, dtype=torch.float32)
        else:
            self.lora_a = self.lora_b = None

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.quant:
            y = torch.matmul(x, self.kernel_q.to(dt)) * self.kernel_scale.to(dt) + self.bias.to(dt)
        else:
            y = F.linear(x, self.weight.to(dt), self.bias.to(dt))
        if self.lora_a is not None:
            y = y + torch.matmul(torch.matmul(x, self.lora_a.to(dt)), self.lora_b.to(dt)) \
                * LORA_ALPHA
        return y


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
        self.qkv = LoRADense(c.hidden_size, 3 * c.hidden_size, c.dtype, c.lora_rank, c.base_quant)
        self.q_ln_scale = _empty(d, dtype=c.dtype)
        self.k_ln_scale = _empty(d, dtype=c.dtype)
        if c.ln_affine:  # the 5B qk-LNs are full affine LayerNorms
            self.q_ln_bias = _empty(d, dtype=c.dtype)
            self.k_ln_bias = _empty(d, dtype=c.dtype)
        self.out = LoRADense(c.hidden_size, c.hidden_size, c.dtype, c.lora_rank, c.base_quant)

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
        self.fc1 = LoRADense(c.hidden_size, c.mlp_ratio * c.hidden_size, c.dtype, c.lora_rank,
                             c.base_quant)
        self.fc2 = LoRADense(c.mlp_ratio * c.hidden_size, c.hidden_size, c.dtype, c.lora_rank,
                             c.base_quant)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, cfg: VideoDiTConfig):
        super().__init__()
        c = self.cfg = cfg
        # the int8 adaLN projection computes in f32 like the float one
        self.adaLN = LoRADense(c.temb_dim, 12 * c.hidden_size, torch.float32, quant=c.base_quant)
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
        c = self.cfg = cfg
        p = c.patch_size
        self.patch_proj = LoRADense(p * p * c.in_channels, c.hidden_size, c.dtype)
        self.text_proj = LoRADense(c.text_hidden_size, c.hidden_size, c.dtype)
        self.time_fc1 = LoRADense(c.hidden_size, c.temb_dim, torch.float32)
        self.time_fc2 = LoRADense(c.temb_dim, c.temb_dim, torch.float32)
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", DiTBlock(c))
        self.final_ln = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.final_adaLN = LoRADense(c.temb_dim, 2 * c.hidden_size, torch.float32)
        self.norm_final = AffineLN(c.hidden_size, c.ln_affine, c.dtype)
        self.final_linear = LoRADense(c.hidden_size, p * p * c.out_channels, c.dtype)
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
        blocks = self.blocks()
        if not (c.remat and torch.is_grad_enabled()):
            for blk in blocks:
                x = blk(x, temb, rope_cos, rope_sin)
        elif c.remat_group > 1:
            # one outer scope per group of g blocks keeps only the group
            # boundaries; the inner scope per block keeps the group's
            # recomputation from holding every block's internals at once
            def run_group(xg, group):
                for blk in group:
                    xg = checkpoint(blk, xg, temb, rope_cos, rope_sin, use_reentrant=False)
                return xg

            g = c.remat_group
            for lo in range(0, len(blocks), g):
                x = checkpoint(run_group, x, blocks[lo:lo + g], use_reentrant=False)
        else:
            for blk in blocks:
                x = checkpoint(blk, x, temb, rope_cos, rope_sin, use_reentrant=False)

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
    every adaLN projection (``block_{i}.adaLN``, ``final_adaLN``) 0; LoRA
    ``lora_a`` lecun-normal and ``lora_b`` 0; int8 ``kernel_q`` 0 and
    ``kernel_scale`` 1 (convert float weights with ``quantize_dit_params``)."""
    with torch.device(generator.device):
        model = VideoDiT(cfg)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, LoRADense):
                if mod.quant:
                    mod.kernel_q.zero_()
                    mod.kernel_scale.fill_(1.0)
                elif name.endswith("adaLN"):
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
                if mod.lora_a is not None:
                    lecun_normal_(mod.lora_a, mod.lora_a.shape[0], generator)
                    mod.lora_b.zero_()
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


QUANT_MODULES = ("qkv", "out", "fc1", "fc2", "adaLN")


def quantize_dit_params(params):
    """A float DiT param tree (the JAX layout, numpy leaves) -> the
    ``base_quant`` layout: every block projection ``kernel`` becomes int8
    ``kernel_q`` and a per-output-column f32 ``kernel_scale`` (symmetric
    absmax, q = round(w / scale) clamped to +-127, scale = max(absmax, 1e-8)
    / 127, computed in f32 as the JAX package does). Other leaves pass
    through unchanged."""
    def quant_mod(d):
        w = torch.as_tensor(np.asarray(d["kernel"], np.float32))
        scale = torch.clamp(w.abs().amax(0), min=1e-8) / 127.0
        q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
        out = {k: walk(v) for k, v in d.items() if k != "kernel"}
        out["kernel_q"] = q.numpy()
        out["kernel_scale"] = scale.numpy()
        return out

    def walk(tree):
        if not hasattr(tree, "items"):
            return tree
        return {k: (quant_mod(v) if k in QUANT_MODULES and hasattr(v, "items") and "kernel" in v
                    else walk(v)) for k, v in tree.items()}

    return walk(params)


def lora_param_filter(name: str) -> bool:
    """True for the LoRA params (a dotted parameter name), the only
    trainables of the reference finetune."""
    return name.split(".")[-1] in ("lora_a", "lora_b")
