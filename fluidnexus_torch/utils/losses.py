"""Training losses and image metrics (counterpart of
``fluidnexus_tpu/utils/losses.py``; reference FluidDynamics/utils/loss_utils.py
and image_utils.py).

SSIM keeps the JAX package's banded blur-matrix form: two float32 matrix
products per map, never a convolution, so on the card it does not go through
cuDNN's TF32 convolutions and stays comparable with the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred, gt):
    return torch.abs(pred - gt).mean()


def _blur_matrix_np(n: int, window_size: int, sigma: float):
    """(n, n) banded Toeplitz blur: (A @ v)[i] = sum_k g[k] v[i + k - ws//2]
    with out-of-range taps dropped — exactly SAME zero padding."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    a = np.zeros((n, n), np.float32)
    half = window_size // 2
    for k in range(window_size):
        d = k - half
        idx = np.arange(max(0, -d), min(n, n - d))
        a[idx, idx + d] = g[k]
    return a


@functools.lru_cache(maxsize=8)
def _blur_matrix(n: int, window_size: int, sigma: float, device: torch.device):
    return torch.as_tensor(_blur_matrix_np(n, window_size, sigma), device=device)


def ssim(img1, img2, window_size: int = 11):
    """SSIM over (C,H,W) or (N,C,H,W) images (loss_utils.py:33-69), as a
    scalar mean. The 11x11 sigma-1.5 window is applied as A_h @ img @ A_w."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    h, w = img1.shape[-2], img1.shape[-1]
    ah = _blur_matrix(h, window_size, 1.5, img1.device)
    aw = _blur_matrix(w, window_size, 1.5, img1.device)

    def conv(x):  # einsum("hH,ncHW,Ww->nchw") of the JAX package
        return torch.matmul(torch.matmul(ah, x), aw)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def psnr(img1, img2):
    """PSNR per image over flattened pixels (image_utils.py:8-10)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def scale_ratio_penalty(log_scales, alive, threshold: float):
    """The scale-anisotropy regulariser of stages 1 and 3 (the JAX package's
    ``train_background.py:80-84`` and ``train_visual_particle.py:98-101``):
    the sum over the alive rows of max(max(s) / max(min(s), 1e-12) -
    threshold, 0), s = exp(log_scales), over max(#alive, 1). ``amax`` and
    ``amin`` share the gradient among tied scales, as ``jnp.max`` does
    (``torch.max`` gives it to one of them): stage 3's knn init writes one
    value to all three axes."""
    s = torch.exp(log_scales)
    ratio = torch.amax(s, -1) / torch.clamp(torch.amin(s, -1), min=1e-12)
    reg = torch.where(alive, torch.clamp(ratio - threshold, min=0.0), 0.0)
    return reg.sum() / torch.clamp(alive.sum(), min=1)
