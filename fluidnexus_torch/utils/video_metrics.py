"""Offline video/image evaluation metrics (counterpart of
``fluidnexus_tpu/utils/video_metrics.py``).

Parity role: Zero123/ldm/modules/evaluate/{ssim.py, frechet_video_distance.py,
torch_frechet_video_distance.py, evaluate_perceptualsim.py} — SSIM lives in
utils/losses.py; this module provides the Fréchet-distance machinery.

The reference FVD uses an I3D network's features; pretrained I3D weights are
not shippable here, so `frechet_distance` takes a pluggable `feature_fn`
(``i3d_feature_fn`` with a pytorch-i3d checkpoint for real FVD). The default
`pixel_feature_fn` (downsampled pixel statistics per clip) gives a
deterministic, weight-free distributional distance useful for regression
tracking; it is NOT numerically comparable to published FVD values. The
features are computed on ``device`` (``cuda`` unless the caller passes
``"cpu"``); the Fréchet distance on the host in float64.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import float_tensors
from fluidnexus_torch.utils.resize import resize_linear


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pixel_feature_fn(videos, grid: int = 8, device="cuda") -> torch.Tensor:
    """videos: (N, T, H, W, C) in [0,1] -> (N, D) mean/std pooled features
    (the std over time is the population std, as ``jnp.std``'s)."""
    v = torch.as_tensor(videos, dtype=torch.float32, device=resolve_device(device))
    n, t, h, w, c = v.shape
    v = resize_linear(v, (n, t, grid, grid, c))
    mean_t = v.mean(1).reshape(n, -1)
    std_t = v.std(1, correction=0).reshape(n, -1)
    return torch.cat([mean_t, std_t], -1)


def _sqrtm_psd(mat):
    """Matrix square root of a symmetric PSD matrix via eigendecomposition.
    Negative eigenvalues (numerical noise on rank-deficient inputs) clip to
    zero — adding a floor instead injects O(dim * sqrt(floor)) trace error."""
    w, v = np.linalg.eigh(mat)
    return (v * np.sqrt(np.clip(w, 0, None))) @ v.T


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two feature sets —
    the FVD/FID formula: |mu_a-mu_b|^2 + tr(Sa + Sb - 2 (Sa Sb)^{1/2})."""
    a = np.asarray(_host(feats_a), np.float64)
    b = np.asarray(_host(feats_b), np.float64)
    mu_a, mu_b = a.mean(0), b.mean(0)
    sa = np.cov(a, rowvar=False) + 1e-8 * np.eye(a.shape[1])
    sb = np.cov(b, rowvar=False) + 1e-8 * np.eye(b.shape[1])
    sqrt_ab = _sqrtm_psd(_sqrtm_psd(sa) @ sb @ _sqrtm_psd(sa))
    # the analytic distance is >= 0; tiny negatives are eigensolver noise on
    # rank-deficient covariances (few clips, many features)
    return float(max(0.0, np.sum((mu_a - mu_b) ** 2) + np.trace(sa + sb - 2 * sqrt_ab)))


def frechet_video_distance(videos_a, videos_b,
                           feature_fn: Optional[Callable] = None,
                           i3d_ckpt: Optional[str] = None, device="cuda") -> float:
    """FVD-style distance between two sets of clips (N,T,H,W,C in [0,1]).

    Pass ``i3d_ckpt`` (path to a pytorch-i3d checkpoint) or
    ``feature_fn=i3d_feature_fn(...)`` for real I3D-feature FVD; the default
    pixel features are a weight-free stand-in (see module docstring)."""
    if i3d_ckpt and feature_fn is None:
        feature_fn = i3d_feature_fn(ckpt_path=i3d_ckpt, device=device)
    fn = feature_fn or (lambda v: pixel_feature_fn(v, device=device))
    return frechet_distance(_host(fn(videos_a)), _host(fn(videos_b)))


def perceptual_similarity(img_a, img_b, feature_fn: Optional[Callable] = None,
                          device="cuda") -> float:
    """Feature-space L2 between two images (evaluate_perceptualsim parity
    shape; plug a VGG/CLIP feature_fn for LPIPS-class numbers)."""
    if feature_fn is None:
        feature_fn = lambda x: pixel_feature_fn(x[:, None], device=device)  # noqa: E731
    fa = _host(feature_fn(np.asarray(img_a)[None]))
    fb = _host(feature_fn(np.asarray(img_b)[None]))
    return float(np.sqrt(((fa - fb) ** 2).sum()))


def i3d_feature_fn(i3d_params=None, batch: int = 8,
                   ckpt_path: Optional[str] = None, device="cuda") -> Callable:
    """Kinetics-I3D logits as FVD features — the reference detector
    (torch_frechet_video_distance.py:60-100). Pass a loaded param dict OR
    ``ckpt_path`` (pytorch-i3d .pt state dict / converted .npz —
    utils.i3d.load_params) for numbers comparable to published FVD; with
    neither, a deterministic random I3D (regression tracking only). The
    clips run ``batch`` at a time on ``device``; the features come back as
    numpy."""
    from fluidnexus_torch.utils import i3d as i3d_mod

    dev = resolve_device(device)
    if i3d_params is None:
        i3d_params = i3d_mod.load_params(ckpt_path) if ckpt_path else i3d_mod.random_params(0)
    weights = float_tensors(i3d_params, dev)

    def fn(videos):
        v = np.asarray(videos, np.float32)
        with torch.no_grad():
            outs = [_host(i3d_mod.i3d_logits(weights, v[i:i + batch], dev))
                    for i in range(0, len(v), batch)]
        return np.concatenate(outs, 0)

    return fn


def fvd_i3d(videos_a, videos_b, i3d_params, device="cuda") -> float:
    """Real FVD: Frechet distance over I3D Kinetics-400 logits
    (frechet_video_distance.py / torch_frechet_video_distance.py parity)."""
    return frechet_video_distance(videos_a, videos_b,
                                  feature_fn=i3d_feature_fn(i3d_params, device=device))
