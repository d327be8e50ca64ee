"""The two-set velocity splat's kernels: wrappers, plain versions and launch
counts (counterpart of ``_splat_fwd_kernel``/``splat_slots`` and
``_splat_bwd_kernel``/``splat_bwd_slots`` of
``fluidnexus_tpu/sim/pbf_pallas.py``; kernels in ``csrc/splat.cu``).

Interface. The source grid (C rows, M slots) and the query grid (Cq rows, Mq
slots) are :class:`~fluidnexus_torch.ops.neighbors.DenseGrid` tables on one
lattice (``bin_queries``). Each grid gives ``cnt`` (C+1,) int32 and one
(C+1, M) f32 plane per coordinate axis (``pbf_cuda.planes``); per-slot
vectors are (C+1, M, 3) f32. ``qnbr`` (Cq, 27) maps query rows to source rows
(C = none), ``rnbr`` (C, 27) source rows to query rows (Cq = none).

- ``splat_fwd(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)`` ->
  (wv (Cq+1, Mq, 3), ws (Cq+1, Mq)): per query slot, sum W vel and sum W
  over the sources in radius, W = (h^2 - d2)^3 without the poly6 factor.
- ``splat_bwd(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h)`` ->
  (g_est, g_vel), each (C+1, M, 3): per source slot, sum 2 f W' (x_s - x_i)
  and sum W p_i over the queries in radius, f = <p_i, vel_s> - q_i,
  W' = -3 (h^2 - d2)^2.

Every output is 0 at dead slots. On a CPU tensor they take the plain versions
(``splat_fwd_plain``, ``splat_bwd_plain``: 27 batched blocks of centre slot x
neighbour slot); on a CUDA tensor they launch the kernel (``splat_fwd_slots``,
``splat_bwd_slots``) or raise. Each launch adds one to its ``LAUNCHES`` entry.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fluidnexus_torch.ops import cuda_build
from fluidnexus_torch.sim.pbf_cuda import _live, _walk

MAX_M = 128   # slots per cell row the kernels take (csrc/splat.cu)

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
    lib.fnx_splat_fwd.argtypes = [p] * 12 + [i] * 4 + [f] * 2 + [p]
    lib.fnx_splat_fwd.restype = i
    lib.fnx_splat_bwd.argtypes = [p] * 14 + [i] * 4 + [f] * 2 + [p]
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


def splat_fwd_plain(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """The forward in plain torch: (wv (Cq+1, Mq, 3), ws (Cq+1, Mq))."""
    wv = torch.zeros(xq.shape + (3,), dtype=xq.dtype, device=xq.device)
    ws = torch.zeros_like(xq)
    mu_q, mu_s = int(qcnt.max()), int(scnt.max())
    if mu_q == 0 or mu_s == 0:
        return wv, ws
    aw = torch.zeros_like(xq[:-1, :mu_q])
    acc = [torch.zeros_like(aw) for _ in range(3)]
    for nb, inside, _, d2 in _two_set(qnbr, qcnt, (xq, yq, zq), scnt, (xs, ys, zs), h, mu_q, mu_s):
        t2 = h * h - d2
        w = torch.where(inside, t2 * t2 * t2, 0.0)
        aw = aw + w.sum(-1)
        acc = [a + (w * vel[nb, :mu_s, ax][:, None, :]).sum(-1) for ax, a in enumerate(acc)]
    live = _live(qcnt[:-1], mu_q)
    ws[:-1, :mu_q] = torch.where(live, aw, 0.0)
    wv[:-1, :mu_q] = torch.where(live[..., None], torch.stack(acc, -1), 0.0)
    return wv, ws


def splat_bwd_plain(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h: float):
    """The adjoint in plain torch: (g_est, g_vel), each (C+1, M, 3)."""
    gx = torch.zeros(xs.shape + (3,), dtype=xs.dtype, device=xs.device)
    gv = torch.zeros_like(gx)
    mu_s, mu_q = int(scnt.max()), int(qcnt.max())
    if mu_q == 0 or mu_s == 0:
        return gx, gv
    v = [vel[:-1, :mu_s, ax][..., None] for ax in range(3)]
    e = [torch.zeros_like(xs[:-1, :mu_s]) for _ in range(3)]
    g = [torch.zeros_like(e[0]) for _ in range(3)]
    for nb, inside, d, d2 in _two_set(rnbr, scnt, (xs, ys, zs), qcnt, (xq, yq, zq), h, mu_s, mu_q):
        t2 = h * h - d2
        w = torch.where(inside, t2 * t2 * t2, 0.0)
        dw = torch.where(inside, -3.0 * t2 * t2, 0.0)
        pn = [p[nb, :mu_q, ax][:, None, :] for ax in range(3)]
        fd = (v[0] * pn[0] + v[1] * pn[1] + v[2] * pn[2] - q[nb, :mu_q][:, None, :]) * dw
        e = [a + (fd * da).sum(-1) for a, da in zip(e, d)]
        g = [a + (w * pa).sum(-1) for a, pa in zip(g, pn)]
    live = _live(scnt[:-1], mu_s)[..., None]
    gx[:-1, :mu_s] = torch.where(live, 2.0 * torch.stack(e, -1), 0.0)
    gv[:-1, :mu_s] = torch.where(live, torch.stack(g, -1), 0.0)
    return gx, gv


# --------------------------------- kernels ----------------------------------


def _check_side(cnt, planes, names, dev, vecs=()):
    """One grid's inputs: cnt (C+1,), (C+1, M) planes, (C+1, M, 3) vectors.
    Returns (C, M)."""
    c, m = cnt.shape[0] - 1, planes[0].shape[1]
    if m > MAX_M:
        raise ValueError(f"the splat kernels take at most {MAX_M} slots per cell, got {m}")
    cuda_build.check(cnt, "cnt", torch.int32, (c + 1,), dev)
    for pl, name in zip(planes, names):
        cuda_build.check(pl, name, torch.float32, (c + 1, m), dev)
    for vec, name in vecs:
        cuda_build.check(vec, name, torch.float32, (c + 1, m, 3), dev)
    return c, m


def splat_fwd_slots(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """Kernel 1 (csrc/splat.cu): (wv (Cq+1, Mq, 3), ws (Cq+1, Mq))."""
    cuda_build.require_cuda(qnbr, "splat_fwd_slots")
    dev = qnbr.device
    cq, mq = _check_side(qcnt, (xq, yq, zq), ("xq", "yq", "zq"), dev)
    cs, ms = _check_side(scnt, (xs, ys, zs), ("xs", "ys", "zs"), dev, ((vel, "vel"),))
    cuda_build.check(qnbr, "qnbr", torch.int32, (cq, 27), dev)
    wv = torch.empty((cq + 1, mq, 3), dtype=torch.float32, device=dev)
    ws = torch.empty((cq + 1, mq), dtype=torch.float32, device=dev)
    err = _lib().fnx_splat_fwd(
        qcnt.data_ptr(), qnbr.data_ptr(), xq.data_ptr(), yq.data_ptr(), zq.data_ptr(),
        scnt.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), vel.data_ptr(),
        wv.data_ptr(), ws.data_ptr(), cq, mq, cs, ms, float(h), float(h * h),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "splat forward launch")
    LAUNCHES["splat_fwd"] += 1
    return wv, ws


def splat_bwd_slots(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h: float):
    """Kernel 2 (csrc/splat.cu): (g_est, g_vel), each (C+1, M, 3)."""
    cuda_build.require_cuda(rnbr, "splat_bwd_slots")
    dev = rnbr.device
    cs, ms = _check_side(scnt, (xs, ys, zs), ("xs", "ys", "zs"), dev, ((vel, "vel"),))
    cq, mq = _check_side(qcnt, (xq, yq, zq, q), ("xq", "yq", "zq", "q"), dev, ((p, "p"),))
    cuda_build.check(rnbr, "rnbr", torch.int32, (cs, 27), dev)
    gx = torch.empty((cs + 1, ms, 3), dtype=torch.float32, device=dev)
    gv = torch.empty_like(gx)
    err = _lib().fnx_splat_bwd(
        scnt.data_ptr(), rnbr.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
        vel.data_ptr(), qcnt.data_ptr(), xq.data_ptr(), yq.data_ptr(), zq.data_ptr(),
        p.data_ptr(), q.data_ptr(), gx.data_ptr(), gv.data_ptr(), cs, ms, cq, mq, float(h),
        float(h * h), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "splat backward launch")
    LAUNCHES["splat_bwd"] += 1
    return gx, gv


def splat_fwd(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h: float):
    """The forward: ``splat_fwd_plain`` on the CPU, the kernel on CUDA."""
    if xq.device.type == "cpu":
        return splat_fwd_plain(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)
    return splat_fwd_slots(qnbr, qcnt, xq, yq, zq, scnt, xs, ys, zs, vel, h)


def splat_bwd(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h: float):
    """The adjoint: ``splat_bwd_plain`` on the CPU, the kernel on CUDA."""
    if xs.device.type == "cpu":
        return splat_bwd_plain(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h)
    return splat_bwd_slots(rnbr, scnt, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, h)
