"""Fixed-radius neighbor search (counterpart of ``fluidnexus_tpu/ops/neighbors.py``).

Only the padded ``radius_graph`` so far, as plain torch (the JAX package
leaves it to XLA too). It keeps the JAX grid's exact semantics, so both
packages keep the same neighbors:

- points are binned into cells of edge ``r`` in a ``grid^3`` box anchored at
  the live-point minimum; points beyond the box clamp into its boundary cells;
- each cell holds at most ``cell_capacity`` points, the lowest indices first
  (a stable sort by cell id); the rest are dropped and counted in ``overflow``;
- a query gathers the 27 surrounding cells, dropping out-of-box offsets, and
  keeps the ``k`` nearest within ``r`` (a stable sort by distance).

Only live queries are evaluated; dead rows come back fully masked, as they do
from the JAX grid.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NeighborList(NamedTuple):
    idx: torch.Tensor       # (Nq, K) int64 indices into the data set (0 where invalid)
    mask: torch.Tensor      # (Nq, K) bool
    overflow: torch.Tensor  # () points dropped from over-full cells (diagnostic)


_OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                    -1).reshape(27, 3).astype(np.int64)


def _build_grid(x, alive_x, origin, r, grid, m):
    """Bucket tables (C+1, M) of point ids (-1 = empty) and their coordinates;
    row C is the sentinel that invalid cell ids index."""
    n = x.shape[0]
    ncells = grid ** 3
    cell = torch.clamp(torch.floor(x / r).to(torch.int64) - origin, 0, grid - 1)
    cid = cell[:, 0] + grid * (cell[:, 1] + grid * cell[:, 2])
    cid = torch.where(alive_x, cid, torch.full_like(cid, ncells))
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    rank = torch.arange(n, device=x.device) - torch.searchsorted(cid_sorted, cid_sorted)
    ok = (rank < m) & (cid_sorted < ncells)
    bidx = torch.full((ncells + 1, m), -1, dtype=torch.int64, device=x.device)
    bidx[cid_sorted[ok], rank[ok]] = order[ok]
    bxyz = torch.zeros((ncells + 1, m, 3), dtype=x.dtype, device=x.device)
    bxyz[cid_sorted[ok], rank[ok]] = x[order[ok]]
    overflow = ((rank >= m) & (cid_sorted < ncells)).sum()
    return bidx, bxyz, overflow


def radius_graph(x, r, k, loop=False, alive=None, cell_capacity=32, grid_cells=32):
    """All-pairs fixed-radius neighbors of ``x`` with itself, as a padded
    (N, K) list: ``torch_cluster.radius_graph(x, r, loop=loop,
    max_num_neighbors=k)`` (gm_dynamics.py:1081) keeping the K nearest.
    ``alive`` masks padding rows of static-capacity buffers."""
    n = x.shape[0]
    dev = x.device
    m = cell_capacity
    grid = grid_cells
    ncells = grid ** 3
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    r_t = torch.as_tensor(r, dtype=x.dtype, device=dev)

    big = torch.finfo(x.dtype).max
    lo = torch.where(alive[:, None], x, torch.full_like(x, big)).amin(0)
    origin = torch.floor(lo / r_t).to(torch.int64)
    bidx, bxyz, overflow = _build_grid(x, alive, origin, r_t, grid, m)

    q = torch.nonzero(alive).squeeze(1)
    y = x[q]
    qcell = torch.clamp(torch.floor(y / r_t).to(torch.int64) - origin, 0, grid - 1)
    off = torch.as_tensor(_OFFSETS, device=dev)
    nc = qcell[:, None, :] + off[None]                                   # (Q,27,3)
    # a non-zero offset whose cell lies outside the box could only alias a
    # clamped boundary cell, whose points are already covered: drop it
    off_ok = torch.all((off[None] == 0) | ((nc >= 0) & (nc < grid)), dim=-1)
    nid = nc[..., 0] + grid * (nc[..., 1] + grid * nc[..., 2])
    nid = torch.where(off_ok, nid, torch.full_like(nid, ncells))
    cand = bidx[nid].reshape(q.shape[0], 27 * m)
    cxyz = bxyz[nid].reshape(q.shape[0], 27 * m, 3)
    d2 = torch.sum((y[:, None, :] - cxyz) ** 2, -1)
    good = (cand >= 0) & (d2 <= r_t * r_t)
    if not loop:
        good = good & (cand != q[:, None])
    inf = torch.full_like(d2, float("inf"))
    sel = torch.argsort(torch.where(good, d2, inf), dim=1, stable=True)[:, :k]
    qidx = torch.gather(torch.clamp(cand, min=0), 1, sel)
    qmsk = torch.gather(good, 1, sel)

    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    idx[q] = torch.where(qmsk, qidx, torch.zeros_like(qidx))
    mask[q] = qmsk
    return NeighborList(idx=idx, mask=mask, overflow=overflow)
