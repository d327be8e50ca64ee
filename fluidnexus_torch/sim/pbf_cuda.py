"""The PBF pair kernels: wrappers, plain versions and launch counts
(counterpart of the v3 tick kernels and the v2 gas-density pair of
``fluidnexus_tpu/sim/pbf_pallas.py``; kernels in ``csrc/pbf.cu``).

Interface. A :class:`~fluidnexus_torch.ops.neighbors.DenseGrid` of C rows and
M slots gives ``nbr`` (C, 27) int32 (C = no cell) and, through ``planes``,
``cnt`` (C+1,) int32 and one cell-major (C+1, M) f32 plane per coordinate
axis. Row C is the empty sentinel row (``cnt[C] = 0``). Every per-slot input
and output is a (C+1, M) f32 plane; slot s of a row is live iff
s < cnt[row].

- ``phase1(nbr, cnt, x, y, z, imass, k)`` -> (lam, pi_raw, nl, s_p6,
  s_edges): lambda (with the 1/imass density division), the raw poly6 sum
  and the in-radius count, self included, 0 at dead slots; the global sums
  of pi_raw and nl over live slots.
- ``phase2(nbr, cnt, x, y, z, lam, nc, k)`` -> (x, y, z, s_corr, s_ns): the
  UPDATED coordinates after one Jacobi step (dead slots keep theirs), with
  nc = nl + counts; the global sums of s_corr and of the non-self in-radius
  count over live slots.
- ``density(nbr, cnt, x, y, z, k)`` -> pi: the gas loss's per-slot poly6
  sum, self included, 0 at dead slots.
- ``density_bwd(nbr, cnt, x, y, z, g, k)`` -> (C+1, M, 3): its adjoint for
  the per-slot cotangent ``g`` of pi, 0 at dead slots.

On a CPU tensor they take the plain versions (``*_plain``: the same math as
27 batched (C, M, M) blocks). On a CUDA tensor they launch the kernel
(``phase1_slots``, ``phase2_slots``, ``density_slots``,
``density_bwd_slots``) or raise; no CUDA tensor reaches a plain version
through them. Each kernel launch adds one to its entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fluidnexus_torch.ops import cuda_build
from fluidnexus_torch.ops.neighbors import _OFFSETS, DenseGrid

MAX_M = 128   # slots per cell row the kernels take (csrc/pbf.cu)

LAUNCHES = {"pbf_phase1": 0, "pbf_phase2": 0, "density_fwd": 0, "density_bwd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PairConsts(NamedTuple):
    """The solver constants the pair passes read, as the Pallas kernels take
    them (Python floats, rounded to f32 where they meet the data)."""

    h: float
    h2: float
    eps: float
    c6: float           # poly6 coefficient
    s45: float          # spiky-gradient coefficient
    inv_p0: float
    relax: float
    k_p: float
    e_p: float
    inv_denom: float    # 1 / poly6(dq_p h)

    @property
    def int_pow(self) -> int:
        """e_p as a repeat count where it is a small positive integer (the
        products are multiplied out, as the Pallas kernel does), else 0."""
        e = float(self.e_p)
        return int(e) if e.is_integer() and 0 < e <= 8 else 0


def pair_consts(params) -> PairConsts:
    return PairConsts(h=float(params.h), h2=float(params.h2), eps=float(params.epsilon),
                      c6=float(params.poly6_term1), s45=float(params.spiky_grad_term1),
                      inv_p0=1.0 / float(params.p0), relax=float(params.relaxation),
                      k_p=float(params.k_p), e_p=float(params.e_p),
                      inv_denom=float(1.0 / params.lamb_corr_denom))


def planes(grid: DenseGrid):
    """(cnt (C+1,) int32, x, y, z (C+1, M) f32) of ``grid``. Dead slots hold
    0; the kernels mask them by ``cnt`` and need no sentinel coordinates."""
    cnt = grid.bmask.sum(-1).to(torch.int32)
    return (cnt,) + tuple(grid.bxyz[..., a].contiguous() for a in range(3))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("pbf")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fnx_pbf_max_m.argtypes = []
    lib.fnx_pbf_max_m.restype = i
    lib.fnx_pbf_phase1.argtypes = [p] * 9 + [i] * 2 + [f] * 7 + [p]
    lib.fnx_pbf_phase1.restype = i
    lib.fnx_pbf_phase2.argtypes = [p] * 11 + [i] * 2 + [f] * 7 + [i] + [f] * 2 + [p]
    lib.fnx_pbf_phase2.restype = i
    lib.fnx_pbf_density.argtypes = [p] * 6 + [i] * 2 + [f] * 3 + [p]
    lib.fnx_pbf_density.restype = i
    lib.fnx_pbf_density_bwd.argtypes = [p] * 7 + [i] * 2 + [f] * 3 + [p]
    lib.fnx_pbf_density_bwd.restype = i
    if lib.fnx_pbf_max_m() != MAX_M:
        raise RuntimeError("csrc/pbf.cu and pbf_cuda.MAX_M disagree")
    return lib


# ------------------------------ plain versions ------------------------------


def _live(cnt, m):
    return torch.arange(m, device=cnt.device)[None, :] < cnt[:, None]


def _extent(nbr, cnt):
    """(R, Mu): rows up to the last one with a live slot, and the fullest
    row's count. The plain versions work on that corner of the planes."""
    occupied = torch.nonzero(cnt[:nbr.shape[0]] > 0)
    return (int(occupied.max()) + 1 if len(occupied) else 0), int(cnt.max())


def _walk(nbr, cnt_c, xyz_c, cnt_n, xyz_n, h, rows, mu_c, mu_n):
    """The pair walk of every kernel here and in ``splat_cuda``: for each of
    the 27 offsets, (nb, pair, d, d2, xs) as (R, Mu_c, Mu_n) blocks of centre
    slot x neighbour slot over the first R rows of ``nbr``, which maps the
    centre grid's rows to the neighbour grid's. ``nb`` are the neighbour rows,
    ``pair`` the live pairs, ``xs`` the shifted neighbour coordinates
    (R, 1, Mu_n) per axis, ``d`` the differences centre - xs per axis and
    ``d2 = |d|^2``, formed as the kernels form it. A self-join passes one
    grid as both sets."""
    live_c = _live(cnt_c[:rows], mu_c)[:, :, None]
    live_n = _live(cnt_n, mu_n)
    xc = [p[:rows, :mu_c, None] for p in xyz_c]
    for j in range(27):
        nb = nbr[:rows, j].long()
        xs = [p[nb, :mu_n][:, None, :] + float(o) * h for p, o in zip(xyz_n, _OFFSETS[j])]
        d = [a - b for a, b in zip(xc, xs)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        yield nb, live_c & live_n[nb][:, None, :], d, d2, xs


def _pairs(nbr, cnt, xyz, k: PairConsts, rows, mu):
    """The self-join of one grid for the PBF passes: for each of the 27
    offsets, (self, pair, d2, w, cg, xs) as (R, Mu, Mu) blocks (see
    ``_extent`` and ``_walk``). The arithmetic is the kernels', step for
    step."""
    cells = torch.arange(rows, device=nbr.device)
    eye = torch.eye(mu, dtype=torch.bool, device=nbr.device)
    for nb, pair, _, d2, xs in _walk(nbr, cnt, xyz, cnt, xyz, k.h, rows, mu, mu):
        self_ = (nb == cells)[:, None, None] & eye
        d2 = torch.where(self_, 0.0, d2)
        t2 = k.h2 - d2
        w = torch.where(pair & (d2 < k.h2), k.c6 * t2 * t2 * t2, 0.0)
        de = d2 + k.eps
        inv = torch.rsqrt(de)
        rlen = de * inv
        hr = k.h - rlen
        cg = torch.where(pair & (rlen < k.h) & ~self_, -k.s45 * hr * hr * inv, 0.0)
        yield self_, pair, d2, w, cg, xs


def _pad(a, like):
    """(R, Mu) rows -> a (C+1, M) plane, zero elsewhere."""
    out = torch.zeros_like(like)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def phase1_plain(nbr, cnt, x, y, z, imass, k: PairConsts):
    """Phase 1 in plain torch: (lam, pi_raw, nl, s_p6, s_edges)."""
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        zero = torch.zeros_like(x)
        return zero, zero, zero, zero.sum(), zero.sum()
    xc = [p[:rows, :mu] for p in (x, y, z)]
    wa, cga, c2a, nla = (torch.zeros_like(xc[0]) for _ in range(4))
    b = [torch.zeros_like(xc[0]) for _ in range(3)]
    for _, pair, d2, w, cg, xs in _pairs(nbr, cnt, (x, y, z), k, rows, mu):
        wa = wa + w.sum(-1)
        cga = cga + cg.sum(-1)
        c2a = c2a + (cg * cg * d2).sum(-1)
        nla = nla + (pair & (d2 <= k.h2)).sum(-1)
        b = [ba + (cg * xsa).sum(-1) for ba, xsa in zip(b, xs)]
    sg = [cga * a - ba for a, ba in zip(xc, b)]
    ip2 = k.inv_p0 * k.inv_p0
    gr_dot = (sg[0] * sg[0] + sg[1] * sg[1] + sg[2] * sg[2]) * ip2
    p_ratio = wa / imass[:rows, :mu] * k.inv_p0
    lam = -(p_ratio - 1.0) / (c2a * ip2 + gr_dot + k.relax)
    live = _live(cnt, mu)[:rows]
    lam, pi_raw, nl = (_pad(torch.where(live, a, 0.0), x) for a in (lam, wa, nla))
    return lam, pi_raw, nl, pi_raw.sum(), nl.sum()


def _ipow(x, k: PairConsts):
    if k.int_pow:
        acc = x
        for _ in range(k.int_pow - 1):
            acc = acc * x
        return acc
    return torch.pow(x, k.e_p)


def phase2_plain(nbr, cnt, x, y, z, lam, nc, k: PairConsts):
    """Phase 2 in plain torch: (x, y, z updated, s_corr, s_ns)."""
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        return x.clone(), y.clone(), z.clone(), x.new_zeros(()), x.new_zeros(())
    xc = [p[:rows, :mu] for p in (x, y, z)]
    lc = lam[:rows, :mu, None]
    nbs = nbr[:rows].long()
    ba, cra, nsa = (torch.zeros_like(xc[0]) for _ in range(3))
    b = [torch.zeros_like(xc[0]) for _ in range(3)]
    for j, (self_, pair, d2, w, cg, xs) in enumerate(_pairs(nbr, cnt, (x, y, z), k, rows, mu)):
        corr = -k.k_p * _ipow(torch.where(self_, 0.0, w) * k.inv_denom, k)
        bb = (lc + lam[nbs[:, j], :mu][:, None, :] + corr) * cg
        ns = pair & (d2 <= k.h2) & ~self_
        ba = ba + bb.sum(-1)
        cra = cra + torch.where(ns, corr, 0.0).sum(-1)
        nsa = nsa + ns.sum(-1)
        b = [acc + (bb * xsa).sum(-1) for acc, xsa in zip(b, xs)]
    live = _live(cnt, mu)[:rows]
    scale = k.inv_p0 / torch.clamp(nc[:rows, :mu], min=1e-20)
    out = []
    for p, a, ba_a in zip((x, y, z), xc, b):
        o = p.clone()
        o[:rows, :mu] = torch.where(live, a + (ba * a - ba_a) * scale, a)
        out.append(o)
    s_corr = torch.where(live, cra, 0.0).sum()
    s_ns = torch.where(live, nsa, 0.0).sum()
    return out[0], out[1], out[2], s_corr, s_ns


def density_plain(nbr, cnt, x, y, z, k: PairConsts):
    """The gas-loss density in plain torch: pi (C+1, M), 0 at dead slots."""
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        return torch.zeros_like(x)
    wa = torch.zeros_like(x[:rows, :mu])
    for _, _, _, w, _, _ in _pairs(nbr, cnt, (x, y, z), k, rows, mu):
        wa = wa + w.sum(-1)
    return _pad(torch.where(_live(cnt, mu)[:rows], wa, 0.0), x)


def density_bwd_plain(nbr, cnt, x, y, z, g, k: PairConsts):
    """The density's adjoint in plain torch: (C+1, M, 3), 0 at dead slots.
    Each pair adds (g_i + g_s) W'(d2) 2 (x_i - x_s), as the kernel does."""
    out = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        return out
    xc = [p[:rows, :mu, None] for p in (x, y, z)]
    gc = g[:rows, :mu, None]
    nbs = nbr[:rows].long()
    acc = [torch.zeros_like(xc[0][..., 0]) for _ in range(3)]
    for j, (_, pair, d2, _, _, xs) in enumerate(_pairs(nbr, cnt, (x, y, z), k, rows, mu)):
        t2 = k.h2 - d2
        dw = torch.where(pair & (d2 < k.h2), (-3.0 * k.c6) * t2 * t2, 0.0)
        b = (gc + g[nbs[:, j], :mu][:, None, :]) * dw * 2.0
        acc = [a + (b * (c - s)).sum(-1) for a, c, s in zip(acc, xc, xs)]
    live = _live(cnt, mu)[:rows, :, None]
    out[:rows, :mu] = torch.where(live, torch.stack(acc, -1), 0.0)
    return out


# --------------------------------- kernels ----------------------------------


def _check_planes(nbr, cnt, planes_, names):
    c = nbr.shape[0]
    m = planes_[0].shape[1]
    dev = nbr.device
    if m > MAX_M:
        raise ValueError(f"the PBF kernels take at most {MAX_M} slots per cell, got {m}")
    cuda_build.check(nbr, "nbr", torch.int32, (c, 27), dev)
    cuda_build.check(cnt, "cnt", torch.int32, (c + 1,), dev)
    for p, name in zip(planes_, names):
        cuda_build.check(p, name, torch.float32, (c + 1, m), dev)
    return c, m


def phase1_slots(nbr, cnt, x, y, z, imass, k: PairConsts):
    """Kernel 1 (csrc/pbf.cu): (lam, pi_raw, nl, s_p6, s_edges)."""
    cuda_build.require_cuda(nbr, "phase1_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, imass), ("x", "y", "z", "imass"))
    lam, pi_raw, nl = (torch.empty_like(x) for _ in range(3))
    err = _lib().fnx_pbf_phase1(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        imass.data_ptr(), lam.data_ptr(), pi_raw.data_ptr(), nl.data_ptr(), c, m, k.h, k.h2,
        k.eps, k.c6, k.s45, k.inv_p0, k.relax, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.raise_on(err, "pbf phase1 launch")
    LAUNCHES["pbf_phase1"] += 1
    return lam, pi_raw, nl, pi_raw.sum(), nl.sum()


def phase2_slots(nbr, cnt, x, y, z, lam, nc, k: PairConsts):
    """Kernel 2 (csrc/pbf.cu): (x, y, z updated, s_corr, s_ns)."""
    cuda_build.require_cuda(nbr, "phase2_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, lam, nc), ("x", "y", "z", "lam", "nc"))
    xo, yo, zo = (torch.empty_like(x) for _ in range(3))
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase2(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), lam.data_ptr(),
        nc.data_ptr(), xo.data_ptr(), yo.data_ptr(), zo.data_ptr(), part.data_ptr(), c, m, k.h,
        k.h2, k.eps, k.c6, k.s45, k.k_p, k.e_p, k.int_pow, k.inv_denom, k.inv_p0,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.raise_on(err, "pbf phase2 launch")
    LAUNCHES["pbf_phase2"] += 1
    s = part.sum(0)
    return xo, yo, zo, s[0], s[1]


def density_slots(nbr, cnt, x, y, z, k: PairConsts):
    """Kernel 3 (csrc/pbf.cu): the gas-loss density pi (C+1, M)."""
    cuda_build.require_cuda(nbr, "density_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z), ("x", "y", "z"))
    pi = torch.empty_like(x)
    err = _lib().fnx_pbf_density(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), pi.data_ptr(),
        c, m, k.h, k.h2, k.c6, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.raise_on(err, "pbf density launch")
    LAUNCHES["density_fwd"] += 1
    return pi


def density_bwd_slots(nbr, cnt, x, y, z, g, k: PairConsts):
    """Kernel 4 (csrc/pbf.cu): the density's adjoint (C+1, M, 3)."""
    cuda_build.require_cuda(nbr, "density_bwd_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, g), ("x", "y", "z", "g"))
    dx = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_density_bwd(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), g.data_ptr(),
        dx.data_ptr(), c, m, k.h, k.h2, k.c6, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.raise_on(err, "pbf density backward launch")
    LAUNCHES["density_bwd"] += 1
    return dx


def phase1(nbr, cnt, x, y, z, imass, k: PairConsts):
    """Phase 1: ``phase1_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase1_plain(nbr, cnt, x, y, z, imass, k)
    return phase1_slots(nbr, cnt, x, y, z, imass, k)


def phase2(nbr, cnt, x, y, z, lam, nc, k: PairConsts):
    """Phase 2: ``phase2_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase2_plain(nbr, cnt, x, y, z, lam, nc, k)
    return phase2_slots(nbr, cnt, x, y, z, lam, nc, k)


def density(nbr, cnt, x, y, z, k: PairConsts):
    """The gas-loss density: ``density_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return density_plain(nbr, cnt, x, y, z, k)
    return density_slots(nbr, cnt, x, y, z, k)


def density_bwd(nbr, cnt, x, y, z, g, k: PairConsts):
    """The density's adjoint: ``density_bwd_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return density_bwd_plain(nbr, cnt, x, y, z, g, k)
    return density_bwd_slots(nbr, cnt, x, y, z, g, k)
