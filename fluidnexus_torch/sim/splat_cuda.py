"""The two-set velocity splat's kernels: wrappers, plain versions and launch
counts (counterpart of ``_splat_fwd_kernel``/``splat_slots`` and
``_splat_bwd_kernel``/``splat_bwd_slots`` of
``fluidnexus_tpu/sim/pbf_pallas.py``; kernels in ``csrc/splat.cu``).

Interface. The sources are a :class:`~fluidnexus_torch.ops.neighbors.DenseGrid`
(C rows, M slots): ``scnt`` (C+1,) int32 and one (C+1, M) f32 plane per
coordinate axis (``pbf_cuda.planes``); per-slot vectors are (C+1, M, 3) f32.
The queries are a :class:`~fluidnexus_torch.ops.neighbors.QueryList` on the
same lattice (``sort_queries``): Cq rows, row h's queries at list entries
``qstart[h] .. qstart[h] + qcnt[h] - 1`` (``qstart``, ``qcnt`` (Cq+1,)
int32, any count a row), one (Nq,) f32 plane per coordinate axis and
per-entry vectors (Nq, 3). ``qnbr`` (Cq, 27) maps query rows to source rows
(C = none), ``rnbr`` (C, 27) source rows to query rows (Cq = none).

- ``splat_fwd(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)`` ->
  (Nq+1, 4): per listed query (wv, ws), sum W vel and sum W over the sources
  in radius, W = (h^2 - d2)^3 without the poly6 factor; entry Nq is 0, for
  the queries of no row (``QueryList.pos`` = Nq), and the entries past the
  rows are left as the kernel found them.
- ``splat_bwd(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q,
  h)`` -> (g_est, g_vel), each (C+1, M, 3): per source slot, sum 2 f W'
  (x_s - x_i) and sum W p_i over the listed queries in radius,
  f = <p_i, vel_s> - q_i, W' = -3 (h^2 - d2)^2; 0 at dead slots.

On a CPU tensor they take the plain versions (``splat_fwd_plain``,
``splat_bwd_plain``: 27 batched blocks of centre x neighbour); on a CUDA
tensor they launch the kernel (``splat_fwd_slots``, ``splat_bwd_slots``) or
raise. Each launch adds one to its ``LAUNCHES`` entry.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fluidnexus_torch.ops import cuda_build
from fluidnexus_torch.ops.neighbors import _OFFSETS
from fluidnexus_torch.sim.pbf_cuda import _live, _walk

MAX_M = 128   # slots per source cell row the kernels take (csrc/splat.cu)
FWD_QUERIES = 32   # queries a warp of the forward takes (csrc/splat.cu SPF_QUERIES)

LAUNCHES = {"splat_fwd": 0, "splat_bwd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("splat")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fnx_splat_max_m.argtypes = []
    lib.fnx_splat_max_m.restype = i
    lib.fnx_splat_fwd.argtypes = [p] * 13 + [i] * 4 + [f] * 2 + [p]
    lib.fnx_splat_fwd.restype = i
    lib.fnx_splat_bwd.argtypes = [p] * 15 + [i] * 3 + [f] * 2 + [p]
    lib.fnx_splat_bwd.restype = i
    if lib.fnx_splat_max_m() != MAX_M:
        raise RuntimeError("csrc/splat.cu and splat_cuda.MAX_M disagree")
    return lib


# ------------------------------ plain versions ------------------------------


def _two_set(nbr, cnt_c, xyz_c, cnt_n, xyz_n, h, mu_c, mu_n):
    """``pbf_cuda._walk`` over every row of ``nbr`` from one grid's centre
    slots to the other grid's: for each of the 27 offsets, (nb, inside, d,
    d2) with ``inside`` the live pairs with d2 < h^2."""
    for nb, pair, d, d2, _ in _walk(nbr, cnt_c, xyz_c, cnt_n, xyz_n, h, nbr.shape[0], mu_c, mu_n):
        yield nb, pair & (d2 < h * h), d, d2


def _reaching_rows(nbr, cnt_c, cnt_n):
    """The centre rows that hold a live point and have a live point of the
    other set among their 27 neighbour rows: the only rows with a non-zero
    output. The plain versions walk these alone."""
    return torch.nonzero((cnt_c[:-1] > 0) & (cnt_n[nbr.long()].sum(1) > 0)).flatten()


def listed_entries(qstart, qcnt, rows):
    """The list entries of query rows ``rows`` and each entry's row, row by
    row and in list order within a row."""
    n = qcnt[rows].long()
    row_of = torch.repeat_interleave(rows, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    at = torch.arange(len(row_of), device=qcnt.device) - first
    return qstart[row_of].long() + at, row_of


def splat_fwd_plain(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """The forward in plain torch: (Nq+1, 4), (wv, ws) per listed query, 0
    elsewhere. Each query is a centre row of one slot in the walk."""
    out = torch.zeros((xq.shape[0] + 1, 4), dtype=xq.dtype, device=xq.device)
    ent, row_of = listed_entries(qstart, qcnt, _reaching_rows(qnbr, qcnt, scnt))
    if len(ent) == 0:
        return out
    one = torch.ones(len(ent) + 1, dtype=qcnt.dtype, device=qcnt.device)
    mu_s = int(scnt.max())
    aw = torch.zeros((len(ent), 1), dtype=xq.dtype, device=xq.device)
    acc = [torch.zeros_like(aw) for _ in range(3)]
    for nb, inside, _, d2 in _two_set(qnbr[row_of], one, (xq[ent, None], yq[ent, None],
                                                          zq[ent, None]), scnt, (xs, ys, zs), h,
                                      1, mu_s):
        t2 = h * h - d2
        w = torch.where(inside, t2 * t2 * t2, 0.0)
        aw = aw + w.sum(-1)
        acc = [a + (w * vel[nb, :mu_s, ax][:, None, :]).sum(-1) for ax, a in enumerate(acc)]
    out[ent] = torch.cat(acc + [aw], -1)
    return out


def splat_bwd_plain(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h: float):
    """The adjoint in plain torch: (g_est, g_vel), each (C+1, M, 3). For each
    offset j, the source rows whose neighbour j holds queries, against that
    neighbour's list (padded to the longest such list)."""
    gx = torch.zeros(xs.shape + (3,), dtype=xs.dtype, device=xs.device)
    gv = torch.zeros_like(gx)
    rows = _reaching_rows(rnbr, scnt, qcnt)
    if len(rows) == 0:
        return gx, gv
    cnt_r = scnt[rows]
    mu_s = int(cnt_r.max())
    live = _live(cnt_r, mu_s)
    xc = [pl[rows, :mu_s, None] for pl in (xs, ys, zs)]
    v = [vel[rows, :mu_s, ax, None] for ax in range(3)]
    e = [torch.zeros((len(rows), mu_s), dtype=xs.dtype, device=xs.device) for _ in range(3)]
    g = [torch.zeros_like(e[0]) for _ in range(3)]
    for j in range(27):
        nb = rnbr[rows, j].long()
        sel = torch.nonzero(qcnt[nb] > 0).flatten()
        if len(sel) == 0:
            continue
        n = qcnt[nb[sel]].long()
        slot = torch.arange(int(n.max()), device=xs.device)
        ok = slot[None, :] < n[:, None]
        at = torch.where(ok, qstart[nb[sel]].long()[:, None] + slot, 0)
        xn = [pl[at][:, None, :] + float(o) * h for pl, o in zip((xq, yq, zq), _OFFSETS[j])]
        d = [c[sel] - b for c, b in zip(xc, xn)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = live[sel][:, :, None] & ok[:, None, :] & (d2 < h * h)
        t2 = h * h - d2
        w = torch.where(inside, t2 * t2 * t2, 0.0)
        dw = torch.where(inside, -3.0 * t2 * t2, 0.0)
        pn = [p[at, ax][:, None, :] for ax in range(3)]
        fd = (v[0][sel] * pn[0] + v[1][sel] * pn[1] + v[2][sel] * pn[2]
              - q[at][:, None, :]) * dw
        for a, da in zip(e, d):
            a[sel] += (fd * da).sum(-1)
        for a, pa in zip(g, pn):
            a[sel] += (w * pa).sum(-1)
    gx[rows, :mu_s] = torch.where(live[..., None], 2.0 * torch.stack(e, -1), 0.0)
    gv[rows, :mu_s] = torch.where(live[..., None], torch.stack(g, -1), 0.0)
    return gx, gv


# --------------------------------- kernels ----------------------------------


def _check_sources(cnt, planes, vel, dev):
    """The source grid's inputs: cnt (C+1,), (C+1, M) planes, vel (C+1, M,
    3). Returns (C, M)."""
    c, m = cnt.shape[0] - 1, planes[0].shape[1]
    if m > MAX_M:
        raise ValueError(f"the splat kernels take at most {MAX_M} source slots per cell, got {m}")
    cuda_build.check(cnt, "scnt", torch.int32, (c + 1,), dev)
    for pl, name in zip(planes, ("xs", "ys", "zs")):
        cuda_build.check(pl, name, torch.float32, (c + 1, m), dev)
    cuda_build.check(vel, "vel", torch.float32, (c + 1, m, 3), dev)
    return c, m


def _check_queries(start, cnt, planes, dev, vecs=()):
    """The query list's inputs: start, cnt (Cq+1,), (Nq,) planes, (Nq, 3)
    vectors. Returns (Cq, Nq)."""
    c, n = cnt.shape[0] - 1, planes[0].shape[0]
    cuda_build.check(start, "qstart", torch.int32, (c + 1,), dev)
    cuda_build.check(cnt, "qcnt", torch.int32, (c + 1,), dev)
    for pl, name in zip(planes, ("xq", "yq", "zq", "q")):
        cuda_build.check(pl, name, torch.float32, (n,), dev)
    for vec, name in vecs:
        cuda_build.check(vec, name, torch.float32, (n, 3), dev)
    return c, n


def splat_fwd_slots(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """Kernel 1 (csrc/splat.cu): (Nq+1, 4), (wv, ws) per listed query. The C
    entry first counts each row's FWD_QUERIES-query work items into ``ends``
    (a one-block scan kernel, its scratch), then launches the forward."""
    cuda_build.require_cuda(qnbr, "splat_fwd_slots")
    dev = qnbr.device
    cq, nq = _check_queries(qstart, qcnt, (xq, yq, zq), dev)
    cs, ms = _check_sources(scnt, (xs, ys, zs), vel, dev)
    cuda_build.check(qnbr, "qnbr", torch.int32, (cq, 27), dev)
    ends = torch.empty((cq,), dtype=torch.int32, device=dev)
    out = torch.empty((nq + 1, 4), dtype=torch.float32, device=dev)
    err = _lib().fnx_splat_fwd(
        qstart.data_ptr(), qcnt.data_ptr(), qnbr.data_ptr(), xq.data_ptr(), yq.data_ptr(),
        zq.data_ptr(), scnt.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
        vel.data_ptr(), ends.data_ptr(), out.data_ptr(), cq, nq, cs, ms, float(h), float(h * h),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "splat forward launch")
    LAUNCHES["splat_fwd"] += 1
    return out


def splat_bwd_slots(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h: float):
    """Kernel 2 (csrc/splat.cu): (g_est, g_vel), each (C+1, M, 3)."""
    cuda_build.require_cuda(rnbr, "splat_bwd_slots")
    dev = rnbr.device
    cs, ms = _check_sources(scnt, (xs, ys, zs), vel, dev)
    cq, _ = _check_queries(qstart, qcnt, (xq, yq, zq, q), dev, ((p, "p"),))
    cuda_build.check(rnbr, "rnbr", torch.int32, (cs, 27), dev)
    gx = torch.empty((cs + 1, ms, 3), dtype=torch.float32, device=dev)
    gv = torch.empty_like(gx)
    err = _lib().fnx_splat_bwd(
        scnt.data_ptr(), rnbr.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
        vel.data_ptr(), qstart.data_ptr(), qcnt.data_ptr(), xq.data_ptr(), yq.data_ptr(),
        zq.data_ptr(), p.data_ptr(), q.data_ptr(), gx.data_ptr(), gv.data_ptr(), cs, ms, cq,
        float(h), float(h * h), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "splat backward launch")
    LAUNCHES["splat_bwd"] += 1
    return gx, gv


def splat_fwd(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """The forward: ``splat_fwd_plain`` on the CPU, the kernel on CUDA."""
    if xs.device.type == "cpu":
        return splat_fwd_plain(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)
    return splat_fwd_slots(qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)


def splat_bwd(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h: float):
    """The adjoint: ``splat_bwd_plain`` on the CPU, the kernel on CUDA."""
    if xs.device.type == "cpu":
        return splat_bwd_plain(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h)
    return splat_bwd_slots(rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h)
