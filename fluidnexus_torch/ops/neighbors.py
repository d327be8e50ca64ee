"""Fixed-radius neighbor search (counterpart of ``fluidnexus_tpu/ops/neighbors.py``).

Two structures, both plain torch (the JAX package leaves them to XLA too):
the padded lists of ``radius_graph`` and ``radius_query`` and the compacted
``DenseGrid`` that the pair kernels walk (``build_dense_grid``,
``bin_queries`` for a second point set on the same lattice, ``slot_gather``,
``point_gather``), and ``sort_queries``, the second set as one cell-sorted
``QueryList`` with no capacity a cell, which the splat kernels take.

The padded lists keep the JAX grid's exact semantics, so both packages keep
the same neighbors:

- points are binned into cells of edge ``r`` in a ``grid^3`` box anchored at
  the minimum over the live points and live queries; points beyond the box
  clamp into its boundary cells;
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


def _radius_impl(x, y, alive_x, alive_y, r, k, loop, cell_capacity, grid_cells):
    """The K nearest live points of ``x`` within ``r`` of each live query
    ``y`` (the JAX package's ``_radius_impl``, ops/neighbors.py:101-140), in
    a box anchored at the minimum over the live data and the live queries.
    Without ``loop`` the queries are ``x`` itself and a point is not its own
    neighbour."""
    n = y.shape[0]
    dev = x.device
    m = cell_capacity
    grid = grid_cells
    ncells = grid ** 3
    r_t = torch.as_tensor(r, dtype=x.dtype, device=dev)

    big = torch.finfo(x.dtype).max
    lo = torch.minimum(torch.where(alive_x[:, None], x, torch.full_like(x, big)).amin(0),
                       torch.where(alive_y[:, None], y, torch.full_like(y, big)).amin(0))
    origin = torch.floor(lo / r_t).to(torch.int64)
    bidx, bxyz, overflow = _build_grid(x, alive_x, origin, r_t, grid, m)

    q = torch.nonzero(alive_y).squeeze(1)
    yq = y[q]
    qcell = torch.clamp(torch.floor(yq / r_t).to(torch.int64) - origin, 0, grid - 1)
    off = torch.as_tensor(_OFFSETS, device=dev)
    nc = qcell[:, None, :] + off[None]                                   # (Q,27,3)
    # a non-zero offset whose cell lies outside the box could only alias a
    # clamped boundary cell, whose points are already covered: drop it
    off_ok = torch.all((off[None] == 0) | ((nc >= 0) & (nc < grid)), dim=-1)
    nid = nc[..., 0] + grid * (nc[..., 1] + grid * nc[..., 2])
    nid = torch.where(off_ok, nid, torch.full_like(nid, ncells))
    cand = bidx[nid].reshape(q.shape[0], 27 * m)
    cxyz = bxyz[nid].reshape(q.shape[0], 27 * m, 3)
    d2 = torch.sum((yq[:, None, :] - cxyz) ** 2, -1)
    good = (cand >= 0) & (d2 <= r_t * r_t)
    if not loop:
        good = good & (cand != q[:, None])
    inf = torch.full_like(d2, float("inf"))
    # the K nearest by a stable sort, as jnp.argsort sorts: equal distances
    # keep their candidate order
    sel = torch.argsort(torch.where(good, d2, inf), dim=1, stable=True)[:, :k]
    qidx = torch.gather(torch.clamp(cand, min=0), 1, sel)
    qmsk = torch.gather(good, 1, sel)

    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    idx[q] = torch.where(qmsk, qidx, torch.zeros_like(qidx))
    mask[q] = qmsk
    return NeighborList(idx=idx, mask=mask, overflow=overflow)


def radius_graph(x, r, k, loop=False, alive=None, cell_capacity=32, grid_cells=32):
    """All-pairs fixed-radius neighbors of ``x`` with itself, as a padded
    (N, K) list: ``torch_cluster.radius_graph(x, r, loop=loop,
    max_num_neighbors=k)`` (gm_dynamics.py:1081) keeping the K nearest.
    ``alive`` masks padding rows of static-capacity buffers."""
    if alive is None:
        alive = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    return _radius_impl(x, x, alive, alive, r, k, loop, cell_capacity, grid_cells)


def radius_query(x, y, r, k, alive_x=None, alive_y=None, cell_capacity=32, grid_cells=32):
    """Neighbours of each query ``y`` among the data points ``x`` within
    ``r``, as a padded (Nq, K) list of the K nearest:
    ``torch_cluster.radius(x, y, r, max_num_neighbors=k)``
    (gm_dynamics.py:1369, 1465). ``alive_*`` mask padding rows; dead queries
    come back fully masked."""
    if alive_x is None:
        alive_x = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    if alive_y is None:
        alive_y = torch.ones((y.shape[0],), dtype=torch.bool, device=y.device)
    return _radius_impl(x, y, alive_x, alive_y, r, k, True, cell_capacity, grid_cells)


# ------------------------------- dense grid ---------------------------------


class DenseGrid(NamedTuple):
    """Compacted cell-bucket tables for dense pair sums (the JAX package's
    ``DenseGrid``, field for field). Occupied cells of edge ``r`` are
    compacted, in ascending packed cell id, to the first of ``C = max_cells``
    rows; row C is an empty sentinel row. A cell's points sit in its first
    slots, lowest point index first. Coordinates are relative to the point's
    own cell corner; a neighbour cell at offset ``o`` is shifted by ``o * r``
    in the consumer."""

    bidx: torch.Tensor      # (C+1, M) int32 slot -> point id (-1 pad)
    bxyz: torch.Tensor      # (C+1, M, 3) cell-relative slot coords (0 pad)
    bmask: torch.Tensor     # (C+1, M) bool slot validity
    nbr: torch.Tensor       # (C, 27) int32 compacted neighbour-cell row (C = none)
    prow: torch.Tensor      # (N,) int32 point -> compacted row (C = dropped)
    pcol: torch.Tensor      # (N,) int32 point -> slot column (0 where dropped)
    overflow: torch.Tensor  # () points dropped (full cells + cells past C)
    origin: torch.Tensor    # (3,) int32 lattice anchor (cells of edge r)
    ucid: torch.Tensor      # (C,) int32 packed cell id per row (_GRID_SENT unused)

    @property
    def max_cells(self):
        return self.nbr.shape[0]

    @property
    def capacity(self):
        return self.bidx.shape[1]


_GRID_SENT = 1 << 30   # > any packed 10-bit-per-axis cell id


def _cell_join(ucid_a, ucid_b, cb):
    """(Ca, 27) row in table ``b`` of each 27-neighbourhood cell of table
    ``a``'s rows (``cb`` = none). ``ucid_b`` ascends with ``_GRID_SENT`` on
    its unused tail, so a binary search finds each cell's row; cell ids are
    unique, so the table equals the JAX package's dense equality join."""
    a_valid = ucid_a < _GRID_SENT
    off = torch.as_tensor(_OFFSETS, dtype=torch.int32, device=ucid_a.device)
    nx = (ucid_a & 1023)[:, None] + off[None, :, 0]
    ny = ((ucid_a >> 10) & 1023)[:, None] + off[None, :, 1]
    nz = (ucid_a >> 20)[:, None] + off[None, :, 2]
    axis_ok = a_valid[:, None] & ((nx >= 0) & (nx < 1024) & (ny >= 0) & (ny < 1024)
                                  & (nz >= 0) & (nz < 1024))
    ncid = (nx + (ny << 10) + (nz << 20)).contiguous()
    pos = torch.searchsorted(ucid_b, ncid, out_int32=True)
    hit = ucid_b[pos.clamp(max=cb - 1).long()] == ncid
    return torch.where(axis_ok & hit & (pos < cb), pos, torch.full_like(pos, cb))


def build_dense_grid(x, r, alive, max_cells, capacity) -> DenseGrid:
    """Bin points into compacted dense-grid buckets (see :class:`DenseGrid`),
    in a 1024^3 box of cells of edge ``r`` anchored at the live-point
    minimum; points beyond the box clip into its boundary cells. Points past
    ``capacity`` in a cell, or in cells past ``max_cells``, are dropped and
    counted in ``overflow``."""
    big = torch.finfo(x.dtype).max
    lo = torch.where(alive[:, None], x, torch.full_like(x, big)).amin(0)
    r_t = torch.as_tensor(r, dtype=x.dtype, device=x.device)
    origin = torch.floor(lo / r_t).to(torch.int32)
    return _compact_bins(x, r_t, alive, origin, max_cells, capacity, self_join=True)


def bin_queries(grid: DenseGrid, r, y, alive_y, max_cells, capacity):
    """Bin a second point set ``y`` onto ``grid``'s lattice (``grid.origin``)
    for the two-set pair kernels. Returns ``(qgrid, rnbr)``:

    - ``qgrid``: a :class:`DenseGrid` over the queries whose ``nbr`` holds,
      for each query row, the 27 neighbour rows in the SOURCE table
      (``grid.max_cells`` = none): the forward join;
    - ``rnbr`` (C_src, 27): each source row's 27 neighbour rows in the QUERY
      table (``max_cells`` = none): the adjoint join.

    Queries outside the source 1024^3 box clip into its boundary cells, with
    large cell-relative coordinates, so their pairs stay distance-masked.
    Dead and capacity-dropped queries have ``prow == max_cells``. Both joins
    search an ascending ``ucid`` table, which ``_compact_bins`` gives both
    grids."""
    r_t = torch.as_tensor(r, dtype=y.dtype, device=y.device)
    qgrid = _compact_bins(y, r_t, alive_y, grid.origin, max_cells, capacity, self_join=False)
    nbr_q = _cell_join(qgrid.ucid, grid.ucid, grid.max_cells)
    rnbr = _cell_join(grid.ucid, qgrid.ucid, max_cells)
    return qgrid._replace(nbr=nbr_q), rnbr


class _CellSort(NamedTuple):
    """The points sorted by packed cell id, the first ``C`` occupied cells
    compacted to rows (see ``_sort_cells``)."""

    order: torch.Tensor     # (N,) sorted position -> point
    xs: torch.Tensor        # (N, 3) the points in sorted order
    rank: torch.Tensor      # (N,) a sorted point's place in its cell
    keep_row: torch.Tensor  # (N,) the sorted point is live and its cell has a row
    crank: torch.Tensor     # (N,) its cell's row (C for none)
    npts: torch.Tensor      # (C,) live points per row
    starts0: torch.Tensor   # (C,) a row's first sorted position
    ucid: torch.Tensor      # (C,) int32 packed cell id per row (_GRID_SENT unused)
    corner: torch.Tensor    # (C, 3) a row's cell corner
    past_c: torch.Tensor    # () live points in cells past C


def _sort_cells(x, r, alive, origin, max_cells) -> _CellSort:
    """The JAX package's ``_compact_bins`` up to its tables: the stable sort
    by packed cell id (dead points last), each point's rank in its cell, the
    compacted rows of the first ``max_cells`` occupied cells in ascending
    cell id and their f32 corners. Points per cell come from a bincount,
    where the JAX package compares densely for the TPU."""
    n = x.shape[0]
    C = max_cells
    dev = x.device
    cc = torch.clamp(torch.floor(x / r).to(torch.int32) - origin, 0, 1023)
    cid = cc[:, 0] + (cc[:, 1] << 10) + (cc[:, 2] << 20)
    cid = torch.where(alive, cid, torch.full_like(cid, _GRID_SENT))

    order = torch.argsort(cid, stable=True)
    cids = cid[order]
    iota_n = torch.arange(n, device=dev)
    head = torch.ones((n,), dtype=torch.bool, device=dev)
    head[1:] = cids[1:] != cids[:-1]
    rank = iota_n - torch.cummax(torch.where(head, iota_n, 0), 0).values
    live = cids < _GRID_SENT
    crank_raw = torch.cumsum((rank == 0) & live, 0) - 1
    keep_row = live & (crank_raw < C)
    crank = torch.where(keep_row, crank_raw, C)

    npts = torch.bincount(crank, minlength=C + 1)[:C]
    starts0 = torch.cumsum(npts, 0) - npts
    ucid = torch.where(npts > 0, cids[starts0.clamp(max=n - 1)], _GRID_SENT).to(torch.int32)
    ucorner = torch.stack([ucid & 1023, (ucid >> 10) & 1023, ucid >> 20], -1)
    corner = (ucorner + origin[None, :]).to(x.dtype) * r
    return _CellSort(order=order, xs=x[order], rank=rank, keep_row=keep_row, crank=crank,
                     npts=npts, starts0=starts0, ucid=ucid, corner=corner,
                     past_c=(live & ~keep_row).sum())


def _compact_bins(x, r, alive, origin, max_cells, capacity, self_join) -> DenseGrid:
    """The JAX package's ``_compact_bins``. The stable sort, the f32 corner
    arithmetic and ``bxyz = xs - corner`` keep its order, so the tables and
    the cell-relative coordinates are the same bit for bit. The join comes
    from a binary search, where the JAX package compares densely for the
    TPU. Without ``self_join`` every ``nbr`` entry is C (``bin_queries``
    joins against another table)."""
    n = x.shape[0]
    C, M = max_cells, capacity
    dev = x.device
    cs = _sort_cells(x, r, alive, origin, C)
    slot = torch.arange(M, device=dev)
    posg = (cs.starts0[:, None] + slot[None, :]).clamp(max=n - 1)
    slotv = slot[None, :] < cs.npts.clamp(max=M)[:, None]
    bidx = torch.where(slotv, cs.order[posg], -1).to(torch.int32)
    bxyz = (cs.xs[posg] - cs.corner[:, None, :]) * slotv[..., None]
    bidx = torch.cat([bidx, torch.full((1, M), -1, dtype=torch.int32, device=dev)], 0)
    bxyz = torch.cat([bxyz, torch.zeros((1, M, 3), dtype=x.dtype, device=dev)], 0)
    bmask = torch.cat([slotv, torch.zeros((1, M), dtype=torch.bool, device=dev)], 0)
    overflow = (cs.npts - M).clamp(min=0).sum() + cs.past_c

    keep = cs.keep_row & (cs.rank < M)
    prow = torch.empty((n,), dtype=torch.int32, device=dev)
    pcol = torch.empty((n,), dtype=torch.int32, device=dev)
    prow[cs.order] = torch.where(keep, cs.crank, C).to(torch.int32)
    pcol[cs.order] = torch.where(keep, cs.rank.clamp(max=M - 1), 0).to(torch.int32)
    nbr = (_cell_join(cs.ucid, cs.ucid, C) if self_join
           else torch.full((C, 27), C, dtype=torch.int32, device=dev))
    return DenseGrid(bidx=bidx, bxyz=bxyz, bmask=bmask, nbr=nbr,
                     prow=prow, pcol=pcol, overflow=overflow, origin=origin, ucid=cs.ucid)


class QueryList(NamedTuple):
    """A second point set (the queries) on a source grid's lattice as one
    list sorted by cell, for the two-set splat kernels: the live queries of
    the first ``max_cells`` occupied cells, compacted to rows in ascending
    cell id, sit in list entries ``start[row] .. start[row] + cnt[row] - 1``,
    lowest point index first; no cell has a capacity. Entries past
    ``start[Cq]`` hold the queries of no row (dead ones, and live ones in
    cells past ``max_cells``), which no kernel reads."""

    order: torch.Tensor     # (Nq,) int64 list entry -> point
    start: torch.Tensor     # (Cq+1,) int32 a row's first entry; start[Cq] = the listed queries
    cnt: torch.Tensor       # (Cq+1,) int32 a row's queries; cnt[Cq] = 0
    x: torch.Tensor         # (Nq,) f32 cell-relative coordinates in list order (0 past start[Cq])
    y: torch.Tensor
    z: torch.Tensor
    prow: torch.Tensor      # (Nq,) int32 point -> row (Cq = none)
    pos: torch.Tensor       # (Nq,) int64 point -> list entry (Nq = none)
    nbr: torch.Tensor       # (Cq, 27) int32 a query row's 27 source rows (C_src = none)
    rnbr: torch.Tensor      # (C_src, 27) int32 a source row's 27 query rows (Cq = none)
    overflow: torch.Tensor  # () live queries in cells past max_cells

    @property
    def max_cells(self):
        return self.nbr.shape[0]


def sort_queries(grid: DenseGrid, r, y, alive_y, max_cells) -> QueryList:
    """The queries ``y`` on ``grid``'s lattice (``grid.origin``) as a
    :class:`QueryList`: ``bin_queries`` without its slots-a-cell cap. The
    same stable sort by cell id and the same f32 corner arithmetic, so a
    cell's queries sit lowest point index first and each listed coordinate
    is, bit for bit, the one ``bin_queries`` gives its slot; the rows and
    both joins are ``bin_queries``' wherever no cell is past its capacity.
    Only live queries in cells past ``max_cells`` are dropped (counted in
    ``overflow``)."""
    nq = y.shape[0]
    C = max_cells
    r_t = torch.as_tensor(r, dtype=y.dtype, device=y.device)
    cs = _sort_cells(y, r_t, alive_y, grid.origin, C)
    row = cs.crank.clamp(max=C - 1)
    xyz = torch.where(cs.keep_row[:, None], cs.xs - cs.corner[row], 0.0)
    zero = torch.zeros((1,), dtype=torch.int32, device=y.device)
    n_listed = cs.npts.sum(0, keepdim=True)
    iota = torch.arange(nq, device=y.device)
    prow = torch.empty((nq,), dtype=torch.int32, device=y.device)
    pos = torch.empty((nq,), dtype=torch.int64, device=y.device)
    prow[cs.order] = cs.crank.to(torch.int32)
    pos[cs.order] = torch.where(cs.keep_row, iota, nq)
    return QueryList(order=cs.order, start=torch.cat([cs.starts0, n_listed]).to(torch.int32),
                     cnt=torch.cat([cs.npts.to(torch.int32), zero]),
                     x=xyz[:, 0].contiguous(), y=xyz[:, 1].contiguous(), z=xyz[:, 2].contiguous(),
                     prow=prow, pos=pos, nbr=_cell_join(cs.ucid, grid.ucid, grid.max_cells),
                     rnbr=_cell_join(grid.ucid, cs.ucid, C), overflow=cs.past_c)


def slot_gather(grid: DenseGrid, f, fill=0.0):
    """Per-point field -> (C+1, M, ...) slot layout (dead slots = fill)."""
    mask = grid.bmask.reshape(grid.bmask.shape + (1,) * (f.ndim - 1))
    return torch.where(mask, f[grid.bidx.clamp(min=0).long()], fill)


def point_gather(grid: DenseGrid, slot_field):
    """(C+1, M, ...) slot field -> per-point (N, ...); dropped points read
    row C."""
    return slot_field[grid.prow.long(), grid.pcol.long()]
