"""CLIP ViT image embedder for view conditioning (counterpart of
``fluidnexus_tpu/diffusion/ldm/clip.py``): the CLIP ViT-L/14 vision tower's
pooled class-token embedding projected to 768, after CLIP's pixel
normalisation.

Names follow the flax tree (``patch_embed``, ``class_embedding``,
``positional_embedding``, ``ln1_{i}``, ``attn_{i}.qkv``, ``proj``). The
numerics the JAX package fixes: every LayerNorm at flax's default eps 1e-6,
the MLP's quick-gelu ``h * sigmoid(1.702 h)``, and the resize to the tower's
size as ``jax.image.resize(..., "bilinear")`` does it: a triangle kernel
stretched by the shrink factor when it shrinks (antialiased), each output's
weights divided by their sum (``utils/resize``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from fluidnexus_torch.diffusion.ldm.unet import LayerNorm, attention
from fluidnexus_torch.utils.resize import resize_bilinear

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768


class MHA(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)

    def forward(self, x):
        q, k, v = torch.chunk(self.qkv(x), 3, -1)
        return self.out(attention(q, k, v, self.heads))


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.width
        n_tok = (c.image_size // c.patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, d, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tok, d))
        self.ln_pre = LayerNorm(d)
        for i in range(c.layers):
            setattr(self, f"ln1_{i}", LayerNorm(d))
            setattr(self, f"attn_{i}", MHA(d, c.heads))
            setattr(self, f"ln2_{i}", LayerNorm(d))
            setattr(self, f"mlp_fc_{i}", nn.Linear(d, 4 * d))
            setattr(self, f"mlp_proj_{i}", nn.Linear(4 * d, d))
        self.ln_post = LayerNorm(d)
        self.proj = nn.Parameter(torch.zeros(d, c.output_dim))

    def forward(self, images):
        """images (B, H, W, 3) in [0, 1] -> the (B, output_dim) pooled
        embedding."""
        c = self.cfg
        mean = torch.as_tensor(CLIP_MEAN, device=images.device)
        std = torch.as_tensor(CLIP_STD, device=images.device)
        x = (images - mean) / std
        if x.shape[1] != c.image_size:
            x = resize_bilinear(x, c.image_size)
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)   # (B, N, D)
        b, _, d = x.shape
        x = torch.cat([self.class_embedding.expand(b, 1, d), x], 1) + self.positional_embedding
        x = self.ln_pre(x)
        for i in range(c.layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            h = getattr(self, f"mlp_fc_{i}")(getattr(self, f"ln2_{i}")(x))
            h = h * torch.sigmoid(1.702 * h)   # quick-gelu
            x = x + getattr(self, f"mlp_proj_{i}")(h)
        return self.ln_post(x[:, 0]) @ self.proj
