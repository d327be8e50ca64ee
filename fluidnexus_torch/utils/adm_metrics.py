"""ADM-evaluator parity: Inception Score, FID, sFID, improved precision/recall
(counterpart of ``fluidnexus_tpu/utils/adm_metrics.py``; the
``evaluate_adm`` stage).

Parity role: Zero123/ldm/modules/evaluate/adm_evaluator.py (the openai/
guided-diffusion evaluator). The reference downloads a frozen TF-1
InceptionV3 graph at runtime and feeds it uint8 [0,255] NHWC batches to get
pool_3 (2048-d), "spatial" features (first 7 channels of an intermediate
mixed conv map — adm_evaluator.py:622) and a softmax head
(logits = pool3 @ w — adm_evaluator.py:625-636). Pretrained Inception
weights are not shippable, so the network is pluggable (``feature_fn``;
plug :func:`vgg_feature_fn` for a conv-net embedding via utils.perceptual's
torchvision-VGG16 loader, or any (images)->(pool, spatial) callable); the
METRIC MATH is exact parity:

- FID / sFID      adm_evaluator.py:93-136  (TTUR scipy.linalg.sqrtm form,
                  incl. the eps-diagonal singular fallback and the
                  imaginary-component guard), on the host in float64
- Inception Score adm_evaluator.py:201-214 (split KL, split_size 5000)
- precision/recall adm_evaluator.py:227-381 (kNN manifold radii over
                  SQUARED euclidean distances, nhood_sizes=(3,))

On the card the hot op is the (N1, N2) pairwise squared-distance block: one
f32 ``U @ V^T`` (``torch.matmul``; the CLI turns TF32 off) plus rank-1 norm
updates. The feature functions and the distance blocks run on ``device``
(``cuda`` unless the caller passes ``"cpu"``); the statistics stay numpy.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import float_tensors
from fluidnexus_torch.utils.resize import resize_linear


# ----------------------------- FID statistics -------------------------------


class ADMStatistics:
    """FIDStatistics parity (adm_evaluator.py:88-136)."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = np.atleast_1d(np.asarray(mu))
        self.sigma = np.atleast_2d(np.asarray(sigma))

    def frechet_distance(self, other: "ADMStatistics", eps: float = 1e-6) -> float:
        from scipy import linalg

        mu1, sigma1 = self.mu, self.sigma
        mu2, sigma2 = other.mu, other.sigma
        assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape
        diff = mu1 - mu2
        # the reference passes disp=False and unpacks (sqrt, errest); that
        # kwarg is deprecated in scipy>=1.17 — a plain call returns the array
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(
                    f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                     - 2 * np.trace(covmean))


def compute_statistics(activations: np.ndarray) -> ADMStatistics:
    """adm_evaluator.py:196-199."""
    acts = np.asarray(activations, np.float64)
    return ADMStatistics(acts.mean(0), np.cov(acts, rowvar=False))


# ----------------------------- Inception Score ------------------------------


def inception_score(probs: np.ndarray, split_size: int = 5000) -> float:
    """IS over class probabilities (adm_evaluator.py:201-214: split KL
    exp(E[KL(p(y|x) || p(y))]) averaged over splits of `split_size`)."""
    preds = np.asarray(probs, np.float64)
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i:i + split_size]
        kl = part * (np.log(part) - np.log(part.mean(0, keepdims=True)))
        scores.append(np.exp(np.mean(kl.sum(1))))
    return float(np.mean(scores))


def softmax_probs(activations: np.ndarray, w: np.ndarray,
                  batch_size: int = 512, device="cuda") -> np.ndarray:
    """The reference softmax head: probs = softmax(acts @ w)
    (adm_evaluator.py:625-636; w is the Inception output-layer weight)."""
    dev = resolve_device(device)
    acts = torch.as_tensor(np.asarray(activations, np.float32), device=dev)
    wt = torch.as_tensor(np.asarray(w, np.float32), device=dev)
    out = [torch.softmax(acts[i:i + batch_size] @ wt, -1).cpu().numpy()
           for i in range(0, acts.shape[0], batch_size)]
    return np.concatenate(out, 0)


# --------------------------- pairwise distances -----------------------------


def pairwise_sq_distances(u, v, device="cuda") -> torch.Tensor:
    """SQUARED euclidean distance block (adm_evaluator.py:436-452 — the
    manifold metrics operate on squared distances throughout), f32 on
    ``device``: max(|u|^2 - 2 u v^T + |v|^2, 0)."""
    dev = resolve_device(device)
    u = torch.as_tensor(np.asarray(u, np.float32), device=dev)
    v = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    nu = torch.sum(u * u, 1)[:, None]
    nv = torch.sum(v * v, 1)[None, :]
    return torch.clamp(nu - 2.0 * (u @ v.T) + nv, min=0.0)


# --------------------------- manifold estimation ----------------------------


def manifold_radii(features: np.ndarray,
                   nhood_sizes: Sequence[int] = (3,),
                   row_batch_size: int = 10000,
                   col_batch_size: int = 10000,
                   clamp_to_percentile: Optional[float] = None,
                   device="cuda") -> np.ndarray:
    """Per-point manifold radii: squared distance to the k-th nearest
    neighbor (self included at rank 0) for each k in nhood_sizes
    (ManifoldEstimator.manifold_radii, adm_evaluator.py:270-303)."""
    features = np.asarray(features, np.float32)
    num = len(features)
    nhood = list(nhood_sizes)
    radii = np.zeros([num, len(nhood)], np.float32)
    for b1 in range(0, num, row_batch_size):
        e1 = min(b1 + row_batch_size, num)
        row = features[b1:e1]
        dist = np.concatenate(
            [pairwise_sq_distances(row, features[b2:min(b2 + col_batch_size, num)],
                                   device).cpu().numpy()
             for b2 in range(0, num, col_batch_size)], axis=1)
        # partition at EVERY rank 0..max(nhood) (the reference's seq —
        # adm_evaluator.py:276) so each requested rank is in sorted position
        seq = np.arange(min(max(nhood), dist.shape[1] - 1) + 1)
        radii[b1:e1] = np.partition(dist, seq, axis=1)[:, nhood]
    if clamp_to_percentile is not None:
        max_d = np.percentile(radii, clamp_to_percentile, axis=0)
        radii[radii > max_d] = 0
    return radii


def evaluate_pr(features_1: np.ndarray, radii_1: np.ndarray,
                features_2: np.ndarray, radii_2: np.ndarray,
                row_batch_size: int = 10000,
                col_batch_size: int = 10000,
                device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(precision per K, recall per K): a sample point counts as precise if
    it falls inside ANY reference hypersphere, and vice versa for recall
    (ManifoldEstimator.evaluate_pr, adm_evaluator.py:347-381). The sphere
    tests run on ``device`` beside the distance block."""
    dev = resolve_device(device)
    status_1 = np.zeros([len(features_1), radii_2.shape[1]], bool)
    status_2 = np.zeros([len(features_2), radii_1.shape[1]], bool)
    for b1 in range(0, len(features_1), row_batch_size):
        e1 = b1 + row_batch_size
        batch_1 = features_1[b1:e1]
        r1 = torch.as_tensor(np.asarray(radii_1[b1:e1]), device=dev)
        for b2 in range(0, len(features_2), col_batch_size):
            e2 = b2 + col_batch_size
            batch_2 = features_2[b2:e2]
            r2 = torch.as_tensor(np.asarray(radii_2[b2:e2]), device=dev)
            d = pairwise_sq_distances(batch_1, batch_2, dev)[:, :, None]
            # ref point inside any sample sphere -> recall side
            status_1[b1:e1] |= torch.any(d <= r2[None], dim=1).cpu().numpy()
            # sample point inside any ref sphere -> precision side
            status_2[b2:e2] |= torch.any(d <= r1[:, None, :], dim=0).cpu().numpy()
    return status_2.mean(0).astype(np.float64), status_1.mean(0).astype(np.float64)


def precision_recall(acts_ref: np.ndarray, acts_sample: np.ndarray,
                     nhood_sizes: Sequence[int] = (3,),
                     row_batch_size: int = 10000,
                     col_batch_size: int = 10000,
                     device="cuda") -> Tuple[float, float]:
    """Evaluator.compute_prec_recall (adm_evaluator.py:216-224)."""
    r1 = manifold_radii(acts_ref, nhood_sizes, row_batch_size, col_batch_size, device=device)
    r2 = manifold_radii(acts_sample, nhood_sizes, row_batch_size, col_batch_size, device=device)
    prec, rec = evaluate_pr(np.asarray(acts_ref, np.float32), r1,
                            np.asarray(acts_sample, np.float32), r2,
                            row_batch_size, col_batch_size, device)
    return float(prec[0]), float(rec[0])


# ------------------------------ feature fns ---------------------------------


def default_feature_fn(images: np.ndarray, grid: int = 8, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Weight-free (pool, spatial) stand-in features from uint8 [0,255] NHWC
    images. Deterministic and useful for regression tracking; NOT numerically
    comparable to Inception-based published numbers (same caveat as
    video_metrics.pixel_feature_fn). The std is the population std (ddof 0),
    as ``jnp.std``'s."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images), device=dev).to(torch.float32) / 255.0
    n, h, w, c = x.shape
    small = resize_linear(x, (n, grid, grid, c))
    pool = torch.cat([small.reshape(n, -1),
                      x.mean((1, 2)), x.std((1, 2), correction=0)], -1)
    # "spatial": a coarse map's first channels, flattened — mirrors the
    # reference's spatial[..., :7] slice of an intermediate conv map
    spatial = small[..., :min(c, 7)].reshape(n, -1)
    return pool.cpu().numpy(), spatial.cpu().numpy()


def vgg_feature_fn(vgg_params=None, batch: int = 32, device="cuda") -> Callable:
    """Conv-net (pool, spatial) features via utils.perceptual's VGG16 (load
    torchvision weights with load_torch_vgg16), as the JAX package's
    ``vgg_feature_fn``: the images are scaled to [-1, 1] and handed to the
    network as they are, which reads them as (N, C, H, W); pool = the
    deepest feature map averaged over its axes 1 and 2, spatial = the first
    7 entries of the last axis of the middle map, flattened."""
    from fluidnexus_torch.utils import perceptual

    dev = resolve_device(device)
    w = float_tensors(perceptual.random_params(0) if vgg_params is None else vgg_params,
                              dev)

    def fn(images):
        x = np.asarray(images, np.float32) / 127.5 - 1.0
        pools, spatials = [], []
        with torch.no_grad():
            for i in range(0, len(x), batch):
                feats = perceptual.vgg16_features(w, torch.as_tensor(x[i:i + batch], device=dev))
                deep, mid = feats[-1], feats[len(feats) // 2]
                pools.append(deep.mean((1, 2)).cpu().numpy())
                spatials.append(mid[..., :7].reshape(mid.shape[0], -1).cpu().numpy())
        return np.concatenate(pools, 0), np.concatenate(spatials, 0)

    return fn


# ------------------------------- evaluator ----------------------------------


def evaluate_activations(ref_pool: np.ndarray, sample_pool: np.ndarray,
                         ref_spatial: Optional[np.ndarray] = None,
                         sample_spatial: Optional[np.ndarray] = None,
                         sample_probs: Optional[np.ndarray] = None,
                         ref_stats: Optional[Tuple[ADMStatistics, ADMStatistics]] = None,
                         device="cuda") -> Dict[str, float]:
    """The reference main() metric block (adm_evaluator.py:58-79): IS on
    sample probs (when a softmax head is available), FID on pool features,
    sFID on spatial features, precision/recall on pool features."""
    out: Dict[str, float] = {}
    if sample_probs is not None:
        out["IS"] = inception_score(sample_probs)
    rs = ref_stats[0] if ref_stats else compute_statistics(ref_pool)
    out["FID"] = compute_statistics(sample_pool).frechet_distance(rs)
    if sample_spatial is not None and (ref_spatial is not None or ref_stats):
        rss = ref_stats[1] if ref_stats else compute_statistics(ref_spatial)
        out["sFID"] = compute_statistics(sample_spatial).frechet_distance(rss)
    prec, rec = precision_recall(ref_pool, sample_pool, device=device)
    out["Precision"] = prec
    out["Recall"] = rec
    return out


def _read_batch_npz(path: str) -> np.ndarray:
    with np.load(path) as z:
        return np.asarray(z["arr_0"])


def evaluate_npz(ref_batch: str, sample_batch: str,
                 feature_fn: Optional[Callable] = None,
                 write_results: bool = True, device="cuda") -> Dict[str, float]:
    """File-level parity with the reference CLI: npz batches of uint8
    [0,255] NHWC images under 'arr_0'; the ref npz may instead carry
    precomputed mu/sigma/mu_s/sigma_s (adm_evaluator.py:186-194); results
    land in evaluation_metrics.yaml next to the sample batch
    (adm_evaluator.py:69-82). ``feature_fn`` defaults to
    ``default_feature_fn`` on ``device``."""
    fn = feature_fn or (lambda images: default_feature_fn(images, device=device))
    sample_pool, sample_spatial = fn(_read_batch_npz(sample_batch))

    ref_stats = None
    ref_pool = ref_spatial = None
    with np.load(ref_batch) as z:
        if "mu" in z.files:
            ref_stats = (ADMStatistics(z["mu"], z["sigma"]),
                         ADMStatistics(z["mu_s"], z["sigma_s"]))
            # P/R needs raw ref features; fall back to images when present
            ref_pool, ref_spatial = (fn(np.asarray(z["arr_0"]))
                                     if "arr_0" in z.files else (None, None))
        else:
            ref_pool, ref_spatial = fn(np.asarray(z["arr_0"]))

    out: Dict[str, float] = {}
    ss = compute_statistics(sample_pool)
    out["FID"] = ss.frechet_distance(ref_stats[0] if ref_stats
                                     else compute_statistics(ref_pool))
    if sample_spatial is not None:
        sss = compute_statistics(sample_spatial)
        if ref_stats is not None:
            out["sFID"] = sss.frechet_distance(ref_stats[1])
        elif ref_spatial is not None:
            out["sFID"] = sss.frechet_distance(compute_statistics(ref_spatial))
    if ref_pool is not None:
        out["Precision"], out["Recall"] = precision_recall(ref_pool, sample_pool, device=device)

    if write_results:
        results_file = os.path.join(os.path.dirname(sample_batch) or ".",
                                    "evaluation_metrics.yaml")
        import yaml
        with open(results_file, "w") as f:
            yaml.dump({k: float(v) for k, v in out.items()}, f,
                      default_flow_style=False)
    return out


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ref_batch", required=True,
                   help="npz of reference images (arr_0) or mu/sigma stats")
    p.add_argument("--sample_batch", required=True,
                   help="npz of sample images (arr_0)")
    p.add_argument("--vgg16", default="",
                   help="torchvision vgg16 state-dict path -> real conv-net "
                        "features (default: weight-free pixel features)")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = None
    if args.vgg16:
        from fluidnexus_torch.utils.perceptual import load_torch_vgg16
        fn = vgg_feature_fn(load_torch_vgg16(args.vgg16), device=dev)
    results = evaluate_npz(args.ref_batch, args.sample_batch, feature_fn=fn, device=dev)
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
