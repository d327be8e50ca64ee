"""The PBF pair kernels: wrappers, plain versions and launch counts
(counterpart of the v3 tick kernels, the v2 and v1 projection kernels and the
v2 gas-density pair of ``fluidnexus_tpu/sim/pbf_pallas.py``; kernels in
``csrc/pbf.cu``).

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
- ``phase1_v2(nbr, cnt, x, y, z, k)`` -> (pi_raw, sg, c2d2, nlen, s_p6,
  s_edges): the raw sums of the per-iteration projection, lambda left to the
  caller: sg = (sum cg) x_i - sum cg x_s is (C+1, M, 3), c2d2 = sum cg^2 d2;
  0 at dead slots, so the global sums are plain sums.
- ``phase2_v2(nbr, cnt, x, y, z, lam, k)`` -> (dsum, s_corr, s_ns): dsum =
  (sum b) x_i - sum b x_s (C+1, M, 3), 0 at dead slots, the 1/p0/nc scaling
  left to the caller.
- ``gather_v1(nbr, cnt, x, y, z)`` -> (ncnt (C, 27) i32, xng (C, 27, 3, M))
  and ``gather_lam_v1(nbr, lam)`` -> lng (C, 27, M): the v1 pre-gather of
  the neighbour rows, plain torch as in the JAX package (``_gathers``).
- ``phase1_v1(ncnt, xng, x, y, z, k)`` and ``phase2_v1(ncnt, xng, lng, x,
  y, z, lam, k)``: ``phase1_v2``/``phase2_v2`` reading the neighbour rows
  from the gathered tensors instead of through ``nbr``; a row's live count is
  its own copy's, ``ncnt[row, 13]`` (row C has none).
- ``density(nbr, cnt, x, y, z, k)`` -> pi: the gas loss's per-slot poly6
  sum, self included, 0 at dead slots.
- ``density_bwd(nbr, cnt, x, y, z, g, k)`` -> (C+1, M, 3): its adjoint for
  the per-slot cotangent ``g`` of pi, 0 at dead slots.

On a CPU tensor they take the plain versions (``*_plain``: the same math as
27 batched (C, M, M) blocks). On a CUDA tensor they launch the kernel
(``phase1_slots``, ``phase2_slots``, ``phase1_v2_slots``,
``phase2_v2_slots``, ``phase1_v1_slots``, ``phase2_v1_slots``,
``density_slots``, ``density_bwd_slots``) or raise; no CUDA tensor reaches a plain version
through them. Each kernel launch adds one to its entry in ``LAUNCHES``;
``phase1_v1_slots(..., walk=True)``, a checking mode that no path takes,
counts under ``pbf_phase1_v1_walk``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fluidnexus_torch.ops import cuda_build
from fluidnexus_torch.ops.neighbors import _OFFSETS, DenseGrid

MAX_M = 128   # slots per cell row the kernels take (csrc/pbf.cu)

LAUNCHES = {"pbf_phase1": 0, "pbf_phase2": 0, "pbf_phase1_v2": 0, "pbf_phase2_v2": 0,
            "pbf_phase1_v1": 0, "pbf_phase2_v1": 0, "density_fwd": 0, "density_bwd": 0,
            "pbf_phase1_v1_walk": 0}


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
    lib.fnx_pbf_phase1_v2.argtypes = [p] * 9 + [i] * 2 + [f] * 5 + [p]
    lib.fnx_pbf_phase1_v2.restype = i
    lib.fnx_pbf_phase2_v2.argtypes = [p] * 8 + [i] * 2 + [f] * 7 + [i] + [f] + [p]
    lib.fnx_pbf_phase2_v2.restype = i
    lib.fnx_pbf_phase1_v1.argtypes = [p] * 9 + [i] * 2 + [f] * 5 + [i] + [p]
    lib.fnx_pbf_phase1_v1.restype = i
    lib.fnx_pbf_phase2_v1.argtypes = [p] * 9 + [i] * 2 + [f] * 7 + [i] + [f] + [p]
    lib.fnx_pbf_phase2_v1.restype = i
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


def _walk_gathered(ncnt, xng, cnt, xyz, h, rows, mu):
    """The v1 kernels' walk: ``_walk``'s self-join with the neighbour rows
    read from the pre-gathered coordinates ``xng`` (C, 27, 3, M) and counts
    ``ncnt`` (C, 27) instead of through ``nbr``; ``nb`` is None."""
    live_c = _live(cnt[:rows], mu)[:, :, None]
    xc = [p[:rows, :mu, None] for p in xyz]
    slot = torch.arange(mu, device=cnt.device)
    for j in range(27):
        live_n = slot[None, :] < ncnt[:rows, j, None]
        xs = [xng[:rows, j, a, :mu][:, None, :] + float(o) * h for a, o in enumerate(_OFFSETS[j])]
        d = [a - b for a, b in zip(xc, xs)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        yield None, live_c & live_n[:, None, :], d, d2, xs


def _pairs(nbr, cnt, xyz, k: PairConsts, rows, mu, gathered=None):
    """The self-join of one grid for the PBF passes: for each of the 27
    offsets, (self, pair, d2, w, cg, xs) as (R, Mu, Mu) blocks (see
    ``_extent`` and ``_walk``); with ``gathered`` = (ncnt, xng, ...) the
    neighbour rows come from the v1 pre-gather, where offset 13 of an
    occupied row is the row itself. The arithmetic is the kernels', step for
    step."""
    cells = torch.arange(rows, device=cnt.device)
    eye = torch.eye(mu, dtype=torch.bool, device=cnt.device)
    walk = (_walk(nbr, cnt, xyz, cnt, xyz, k.h, rows, mu, mu) if gathered is None
            else _walk_gathered(gathered[0], gathered[1], cnt, xyz, k.h, rows, mu))
    for j, (nb, pair, _, d2, xs) in enumerate(walk):
        self_row = nb == cells if nb is not None else torch.full_like(cells, j == 13, dtype=bool)
        self_ = self_row[:, None, None] & eye
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


def _pad3(parts, like, live):
    """Three (R, Mu) rows -> a (C+1, M, 3) vector field, zero at dead slots."""
    out = torch.zeros(like.shape + (3,), dtype=like.dtype, device=like.device)
    r, mu = parts[0].shape
    out[:r, :mu] = torch.where(live[..., None], torch.stack(parts, -1), 0.0)
    return out


def _phase1_sums(nbr, cnt, xyz, k: PairConsts, rows, mu, gathered=None):
    """Phase 1's per-slot sums over the first R rows: (sum w, sum cg^2 d2,
    the in-radius count, sg = (sum cg) x_i - sum cg x_s per axis)."""
    xc = [p[:rows, :mu] for p in xyz]
    wa, cga, c2a, nla = (torch.zeros_like(xc[0]) for _ in range(4))
    b = [torch.zeros_like(xc[0]) for _ in range(3)]
    for _, pair, d2, w, cg, xs in _pairs(nbr, cnt, xyz, k, rows, mu, gathered):
        wa = wa + w.sum(-1)
        cga = cga + cg.sum(-1)
        c2a = c2a + (cg * cg * d2).sum(-1)
        nla = nla + (pair & (d2 <= k.h2)).sum(-1)
        b = [ba + (cg * xsa).sum(-1) for ba, xsa in zip(b, xs)]
    return wa, c2a, nla, [cga * a - ba for a, ba in zip(xc, b)]


def phase1_plain(nbr, cnt, x, y, z, imass, k: PairConsts):
    """Phase 1 in plain torch: (lam, pi_raw, nl, s_p6, s_edges)."""
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        zero = torch.zeros_like(x)
        return zero, zero, zero, zero.sum(), zero.sum()
    wa, c2a, nla, sg = _phase1_sums(nbr, cnt, (x, y, z), k, rows, mu)
    ip2 = k.inv_p0 * k.inv_p0
    gr_dot = (sg[0] * sg[0] + sg[1] * sg[1] + sg[2] * sg[2]) * ip2
    p_ratio = wa / imass[:rows, :mu] * k.inv_p0
    lam = -(p_ratio - 1.0) / (c2a * ip2 + gr_dot + k.relax)
    live = _live(cnt, mu)[:rows]
    lam, pi_raw, nl = (_pad(torch.where(live, a, 0.0), x) for a in (lam, wa, nla))
    return lam, pi_raw, nl, pi_raw.sum(), nl.sum()


def _phase1_raw(nbr, cnt, xyz, k: PairConsts, gathered=None):
    rows, mu = _extent(nbr, cnt)
    x = xyz[0]
    if rows == 0:
        zero = torch.zeros_like(x)
        return zero, torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device), zero, zero, \
            zero.sum(), zero.sum()
    wa, c2a, nla, sg = _phase1_sums(nbr, cnt, xyz, k, rows, mu, gathered)
    live = _live(cnt, mu)[:rows]
    pi_raw, c2d2, nlen = (_pad(torch.where(live, a, 0.0), x) for a in (wa, c2a, nla))
    return pi_raw, _pad3(sg, x, live), c2d2, nlen, pi_raw.sum(), nlen.sum()


def phase1_v2_plain(nbr, cnt, x, y, z, k: PairConsts):
    """Phase 1 v2 in plain torch: (pi_raw, sg, c2d2, nlen, s_p6, s_edges)."""
    return _phase1_raw(nbr, cnt, (x, y, z), k)


def _own_counts(ncnt):
    """(C+1,) live counts of the gathered rows: each row's own copy's,
    ``ncnt[row, 13]``, and 0 for row C."""
    return torch.cat([ncnt[:, 13], ncnt.new_zeros(1)])


def phase1_v1_plain(ncnt, xng, x, y, z, k: PairConsts):
    """Phase 1 v1 in plain torch, from the gathered rows: as ``phase1_v2_plain``."""
    return _phase1_raw(ncnt, _own_counts(ncnt), (x, y, z), k, gathered=(ncnt, xng))


def _ipow(x, k: PairConsts):
    if k.int_pow:
        acc = x
        for _ in range(k.int_pow - 1):
            acc = acc * x
        return acc
    return torch.pow(x, k.e_p)


def _phase2_sums(nbr, cnt, xyz, lam, k: PairConsts, rows, mu, gathered=None):
    """Phase 2's per-slot sums over the first R rows: (sum b, sum b x_s per
    axis, sum corr and the count over the non-self pairs in radius). The
    neighbour lambdas come through ``nbr``, or from the gathered ``lng``."""
    lc = lam[:rows, :mu, None]
    if gathered is None:
        nbs = nbr[:rows].long()
        lam_n = lambda j: lam[nbs[:, j], :mu]            # noqa: E731
    else:
        lam_n = lambda j: gathered[2][:rows, j, :mu]     # noqa: E731
    ba, cra, nsa = (torch.zeros_like(lam[:rows, :mu]) for _ in range(3))
    b = [torch.zeros_like(ba) for _ in range(3)]
    for j, (self_, pair, d2, w, cg, xs) in enumerate(_pairs(nbr, cnt, xyz, k, rows, mu, gathered)):
        corr = -k.k_p * _ipow(torch.where(self_, 0.0, w) * k.inv_denom, k)
        bb = (lc + lam_n(j)[:, None, :] + corr) * cg
        ns = pair & (d2 <= k.h2) & ~self_
        ba = ba + bb.sum(-1)
        cra = cra + torch.where(ns, corr, 0.0).sum(-1)
        nsa = nsa + ns.sum(-1)
        b = [acc + (bb * xsa).sum(-1) for acc, xsa in zip(b, xs)]
    return ba, b, cra, nsa


def phase2_plain(nbr, cnt, x, y, z, lam, nc, k: PairConsts):
    """Phase 2 in plain torch: (x, y, z updated, s_corr, s_ns)."""
    rows, mu = _extent(nbr, cnt)
    if rows == 0:
        return x.clone(), y.clone(), z.clone(), x.new_zeros(()), x.new_zeros(())
    xc = [p[:rows, :mu] for p in (x, y, z)]
    ba, b, cra, nsa = _phase2_sums(nbr, cnt, (x, y, z), lam, k, rows, mu)
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


def _phase2_raw(nbr, cnt, xyz, lam, k: PairConsts, gathered=None):
    rows, mu = _extent(nbr, cnt)
    x = xyz[0]
    if rows == 0:
        return torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device), x.new_zeros(()), \
            x.new_zeros(())
    ba, b, cra, nsa = _phase2_sums(nbr, cnt, xyz, lam, k, rows, mu, gathered)
    live = _live(cnt, mu)[:rows]
    dsum = _pad3([ba * p[:rows, :mu] - ba_a for p, ba_a in zip(xyz, b)], x, live)
    return dsum, torch.where(live, cra, 0.0).sum(), torch.where(live, nsa, 0.0).sum()


def phase2_v2_plain(nbr, cnt, x, y, z, lam, k: PairConsts):
    """Phase 2 v2 in plain torch: (dsum, s_corr, s_ns)."""
    return _phase2_raw(nbr, cnt, (x, y, z), lam, k)


def phase2_v1_plain(ncnt, xng, lng, x, y, z, lam, k: PairConsts):
    """Phase 2 v1 in plain torch, from the gathered rows: as ``phase2_v2_plain``."""
    return _phase2_raw(ncnt, _own_counts(ncnt), (x, y, z), lam, k, gathered=(ncnt, xng, lng))


def gather_v1(nbr, cnt, x, y, z):
    """The v1 pre-gather of the neighbour rows (``_gathers`` of the JAX
    package, plain torch on either device): ncnt (C, 27) i32, the neighbours'
    live counts, and xng (C, 27, 3, M), their coordinate rows. An absent
    neighbour (C) reads the empty row C: count 0."""
    nb = nbr.long()
    return cnt[nb], torch.stack([x, y, z], 1)[nb]


def gather_lam_v1(nbr, lam):
    """The v1 pre-gather of the neighbour lambdas: lng (C, 27, M)."""
    return lam[nbr.long()]


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


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_planes(nbr, cnt, planes_, names):
    """Checks the (C, 27) i32 ``nbr``, ``cnt`` and the (C+1, M) f32 planes;
    returns (C, M)."""
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
    """Row 12 of PERF.md's kernel table (csrc/pbf.cu ``phase1_kernel``): (lam,
    pi_raw, nl, s_p6, s_edges)."""
    cuda_build.require_cuda(nbr, "phase1_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, imass), ("x", "y", "z", "imass"))
    lam, pi_raw, nl = (torch.empty_like(x) for _ in range(3))
    err = _lib().fnx_pbf_phase1(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        imass.data_ptr(), lam.data_ptr(), pi_raw.data_ptr(), nl.data_ptr(), c, m, k.h, k.h2,
        k.eps, k.c6, k.s45, k.inv_p0, k.relax, _stream(x))
    cuda_build.raise_on(err, "pbf phase1 launch")
    LAUNCHES["pbf_phase1"] += 1
    return lam, pi_raw, nl, pi_raw.sum(), nl.sum()


def phase2_slots(nbr, cnt, x, y, z, lam, nc, k: PairConsts):
    """Row 13 (csrc/pbf.cu ``phase2_kernel``): (x, y, z updated, s_corr, s_ns)."""
    cuda_build.require_cuda(nbr, "phase2_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, lam, nc), ("x", "y", "z", "lam", "nc"))
    xo, yo, zo = (torch.empty_like(x) for _ in range(3))
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase2(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), lam.data_ptr(),
        nc.data_ptr(), xo.data_ptr(), yo.data_ptr(), zo.data_ptr(), part.data_ptr(), c, m, k.h,
        k.h2, k.eps, k.c6, k.s45, k.k_p, k.e_p, k.int_pow, k.inv_denom, k.inv_p0,
        _stream(x))
    cuda_build.raise_on(err, "pbf phase2 launch")
    LAUNCHES["pbf_phase2"] += 1
    s = part.sum(0)
    return xo, yo, zo, s[0], s[1]


def density_slots(nbr, cnt, x, y, z, k: PairConsts):
    """Row 8 (csrc/pbf.cu ``density_kernel``): the gas-loss density pi (C+1, M)."""
    cuda_build.require_cuda(nbr, "density_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z), ("x", "y", "z"))
    pi = torch.empty_like(x)
    err = _lib().fnx_pbf_density(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), pi.data_ptr(),
        c, m, k.h, k.h2, k.c6, _stream(x))
    cuda_build.raise_on(err, "pbf density launch")
    LAUNCHES["density_fwd"] += 1
    return pi


def density_bwd_slots(nbr, cnt, x, y, z, g, k: PairConsts):
    """Row 9 (csrc/pbf.cu ``density_bwd_kernel``): the density's adjoint (C+1, M, 3)."""
    cuda_build.require_cuda(nbr, "density_bwd_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, g), ("x", "y", "z", "g"))
    dx = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_density_bwd(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), g.data_ptr(),
        dx.data_ptr(), c, m, k.h, k.h2, k.c6, _stream(x))
    cuda_build.raise_on(err, "pbf density backward launch")
    LAUNCHES["density_bwd"] += 1
    return dx


def phase1_v2_slots(nbr, cnt, x, y, z, k: PairConsts):
    """Row 6 (csrc/pbf.cu ``phase1_v2_kernel``): (pi_raw, sg, c2d2, nlen, s_p6,
    s_edges)."""
    cuda_build.require_cuda(nbr, "phase1_v2_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z), ("x", "y", "z"))
    pi_raw, c2d2, nlen = (torch.empty_like(x) for _ in range(3))
    sg = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase1_v2(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        pi_raw.data_ptr(), sg.data_ptr(), c2d2.data_ptr(), nlen.data_ptr(), c, m, k.h, k.h2,
        k.eps, k.c6, k.s45, _stream(x))
    cuda_build.raise_on(err, "pbf phase1 v2 launch")
    LAUNCHES["pbf_phase1_v2"] += 1
    return pi_raw, sg, c2d2, nlen, pi_raw.sum(), nlen.sum()


def phase2_v2_slots(nbr, cnt, x, y, z, lam, k: PairConsts):
    """Row 7 (csrc/pbf.cu ``phase2_v2_kernel``): (dsum, s_corr, s_ns)."""
    cuda_build.require_cuda(nbr, "phase2_v2_slots")
    c, m = _check_planes(nbr, cnt, (x, y, z, lam), ("x", "y", "z", "lam"))
    dsum = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase2_v2(
        cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), lam.data_ptr(),
        dsum.data_ptr(), part.data_ptr(), c, m, k.h, k.h2, k.eps, k.c6, k.s45, k.k_p, k.e_p,
        k.int_pow, k.inv_denom, _stream(x))
    cuda_build.raise_on(err, "pbf phase2 v2 launch")
    LAUNCHES["pbf_phase2_v2"] += 1
    s = part.sum(0)
    return dsum, s[0], s[1]


def _check_gathered(ncnt, xng, planes_, names, lng=None):
    """Checks v1's gathered counts ``ncnt`` (C, 27) i32 and rows ``xng`` (C,
    27, 3, M) (and ``lng`` (C, 27, M)) and the (C+1, M) f32 planes; returns
    (C, M)."""
    c, m = ncnt.shape[0], planes_[0].shape[1]
    dev = ncnt.device
    if m > MAX_M:
        raise ValueError(f"the PBF kernels take at most {MAX_M} slots per cell, got {m}")
    cuda_build.check(ncnt, "ncnt", torch.int32, (c, 27), dev)
    for p, name in zip(planes_, names):
        cuda_build.check(p, name, torch.float32, (c + 1, m), dev)
    cuda_build.check(xng, "xng", torch.float32, (c, 27, 3, m), dev)
    if lng is not None:
        cuda_build.check(lng, "lng", torch.float32, (c, 27, m), dev)
    return c, m


def phase1_v1_slots(ncnt, xng, x, y, z, k: PairConsts, walk=False):
    """Row 4 (csrc/pbf.cu ``phase1_v1_kernel``): as ``phase1_v2_slots`` from
    the gathered rows (each row's own count from its copy, ``ncnt[row,
    13]``). ``walk=True`` launches the checking mode instead, the
    one-block-a-row walk (``phase1_walk_kernel``) whose sums every row
    group's phase 1 keeps bit for bit; no path takes it, and it counts under
    ``pbf_phase1_v1_walk``."""
    cuda_build.require_cuda(xng, "phase1_v1_slots")
    c, m = _check_gathered(ncnt, xng, (x, y, z), ("x", "y", "z"))
    pi_raw, c2d2, nlen = (torch.empty_like(x) for _ in range(3))
    sg = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase1_v1(
        ncnt.data_ptr(), xng.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        pi_raw.data_ptr(), sg.data_ptr(), c2d2.data_ptr(), nlen.data_ptr(), c, m, k.h, k.h2,
        k.eps, k.c6, k.s45, int(walk), _stream(x))
    cuda_build.raise_on(err, "pbf phase1 v1 launch")
    LAUNCHES["pbf_phase1_v1_walk" if walk else "pbf_phase1_v1"] += 1
    return pi_raw, sg, c2d2, nlen, pi_raw.sum(), nlen.sum()


def phase2_v1_slots(ncnt, xng, lng, x, y, z, lam, k: PairConsts):
    """Row 5 (csrc/pbf.cu ``phase2_v1_kernel``): as ``phase2_v2_slots`` from
    the gathered rows (each row's own count from its copy, ``ncnt[row, 13]``)."""
    cuda_build.require_cuda(xng, "phase2_v1_slots")
    c, m = _check_gathered(ncnt, xng, (x, y, z, lam), ("x", "y", "z", "lam"), lng)
    dsum = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    err = _lib().fnx_pbf_phase2_v1(
        ncnt.data_ptr(), xng.data_ptr(), lng.data_ptr(), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), lam.data_ptr(), dsum.data_ptr(), part.data_ptr(), c, m, k.h, k.h2, k.eps,
        k.c6, k.s45, k.k_p, k.e_p, k.int_pow, k.inv_denom, _stream(x))
    cuda_build.raise_on(err, "pbf phase2 v1 launch")
    LAUNCHES["pbf_phase2_v1"] += 1
    s = part.sum(0)
    return dsum, s[0], s[1]


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


def phase1_v2(nbr, cnt, x, y, z, k: PairConsts):
    """Phase 1 v2: ``phase1_v2_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase1_v2_plain(nbr, cnt, x, y, z, k)
    return phase1_v2_slots(nbr, cnt, x, y, z, k)


def phase2_v2(nbr, cnt, x, y, z, lam, k: PairConsts):
    """Phase 2 v2: ``phase2_v2_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase2_v2_plain(nbr, cnt, x, y, z, lam, k)
    return phase2_v2_slots(nbr, cnt, x, y, z, lam, k)


def phase1_v1(ncnt, xng, x, y, z, k: PairConsts):
    """Phase 1 v1: ``phase1_v1_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase1_v1_plain(ncnt, xng, x, y, z, k)
    return phase1_v1_slots(ncnt, xng, x, y, z, k)


def phase2_v1(ncnt, xng, lng, x, y, z, lam, k: PairConsts):
    """Phase 2 v1: ``phase2_v1_plain`` on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return phase2_v1_plain(ncnt, xng, lng, x, y, z, lam, k)
    return phase2_v1_slots(ncnt, xng, lng, x, y, z, lam, k)
