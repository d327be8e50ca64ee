"""``jax.image.resize(x, shape, "linear")`` (alias "bilinear") as weight
matrices: one (n_in, n_out) matrix an axis, a triangle kernel stretched by
the shrink factor when it shrinks (antialiased), each output's weights
divided by their sum. The Zero123 CLIP tower's resize to 224 and the metrics'
resizes (``utils/adm_metrics``, ``utils/video_metrics``, ``utils/i3d``) all
go through it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s "bilinear" along
    one axis (``compute_weight_mat`` with antialiasing): output j samples
    input position (j + 0.5) n_in / n_out - 0.5 with the triangle kernel,
    widened by n_in / n_out when that exceeds 1."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def resize_linear(x, shape):
    """``jax.image.resize(x, shape, "linear")``: every axis whose size
    differs from ``shape``'s is resized, the others are left as they are."""
    for axis, size in enumerate(shape):
        n = x.shape[axis]
        if n != size:
            w = torch.as_tensor(resize_weights(n, size), dtype=x.dtype, device=x.device)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


def resize_bilinear(x, size: int):
    """(B, H, W, C) -> (B, size, size, C) as ``jax.image.resize(x, (B, size,
    size, C), "bilinear")``."""
    return resize_linear(x, (x.shape[0], size, size, x.shape[3]))
