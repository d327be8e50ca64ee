"""K-nearest-neighbour mean distance (counterpart of
``fluidnexus_tpu/ops/knn.py``), the ``simple-knn`` extension's ``distCUDA2``:
per point, the mean squared distance to its k nearest neighbours, which
initialises Gaussian scales.

The JAX package computes this outside any Pallas kernel (an exact chunked
brute force under ``lax.scan``), so the port keeps it in plain torch, with
the same semantics:

- the mean of the k smallest squared distances, the point itself and dead
  rows excluded;
- a missing neighbour (fewer than k live others) adds 0, and the sum is
  still divided by k;
- dead rows output 0.

d2 is the sum of the squared coordinate differences, as the JAX package
forms it: ``torch.cdist`` or the |a|^2 + |b|^2 - 2ab expansion would lose
the small distances the scales are taken from at world-unit coordinates.
Only the live rows take part (a dead row is never a neighbour and outputs
0), so the queries and the neighbours are the live rows alone, gathered
once; they are taken in chunks of ``chunk`` query rows, so no (N, N) matrix
is formed.
"""
from __future__ import annotations

from typing import Optional

import torch


def mean_dist_to_knn(points: torch.Tensor, alive: Optional[torch.Tensor] = None, k: int = 3,
                     chunk: int = 256) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest (excluding
    itself). points: (N, 3). alive: optional (N,) bool mask for padded
    buffers. Returns (N,) float32 on the points' device: result[i] =
    mean over j in kNN(i) of |p_i - p_j|^2, 0 at dead rows."""
    pts = points.detach().to(torch.float32)
    n = pts.shape[0]
    out = torch.zeros((n,), dtype=torch.float32, device=pts.device)
    if alive is None:
        rows = torch.arange(n, device=pts.device)
    else:
        rows = torch.nonzero(alive, as_tuple=True)[0]
    live = pts[rows]
    m = live.shape[0]
    if m == 0:
        return out
    x, y, z = live[:, 0], live[:, 1], live[:, 2]
    inf = torch.tensor(float("inf"), device=pts.device)
    pad = max(k - (m - 1), 0)   # fewer live others than k: inf columns add 0 below
    for s in range(0, m, chunk):
        q = live[s:s + chunk]
        dx = q[:, 0:1] - x[None]
        dy = q[:, 1:2] - y[None]
        dz = q[:, 2:3] - z[None]
        d2 = dx * dx + dy * dy + dz * dz
        own = torch.arange(s, s + q.shape[0], device=pts.device)
        d2[torch.arange(q.shape[0], device=pts.device), own] = inf
        if pad:
            d2 = torch.cat([d2, inf.expand(q.shape[0], pad)], 1)
        smallest = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        total = torch.zeros((q.shape[0],), dtype=torch.float32, device=pts.device)
        for j in range(k):   # ascending, as the JAX package's min extraction adds them
            v = smallest[:, j]
            total = total + torch.where(torch.isfinite(v), v, 0.0)
        out[rows[s:s + chunk]] = total / k
    return out
