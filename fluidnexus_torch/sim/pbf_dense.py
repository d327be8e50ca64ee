"""The PBF density projection over the dense cell grid (counterpart of
``fluidnexus_tpu/sim/pbf_dense.py``): exact sums over every in-radius pair,
with no ``knn_k`` truncation.

- ``project_iterations_dense`` keeps the contract and the diagnostics of the
  JAX package's grid-reuse tick: the grid built once per tick from the
  post-Euler estimates. ``backend`` "v3" (the default; the JAX package's
  ``_project_iterations_v3``) runs the v3 pair passes
  (``sim/pbf_cuda.phase1``/``phase2``), "v2" and "v1" the generic body over
  ``_project_core``.
- ``project_gas_constraints_dense`` is one projection through the v2
  kernels with the grid rebuilt from the current estimates, as the reference
  re-runs radius_graph every Jacobi iteration; rigid bodies run through it.
- ``_project_core`` is one Jacobi projection in slot space through the v2
  kernels (``phase1_v2``/``phase2_v2``) or the v1 kernels over the v1
  pre-gather, with lambda and the delta scaling computed here, as the JAX
  package does around its v2 and v1 kernels.

Every pair pass takes its kernel for a CUDA tensor and its plain version for
a CPU tensor.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch.profiler import record_function

from fluidnexus_torch.ops.neighbors import DenseGrid, build_dense_grid, point_gather, slot_gather
from fluidnexus_torch.sim import pbf_cuda
from fluidnexus_torch.sim.pbf import PBFParams
from fluidnexus_torch.sim.state import ParticleState


class TickSlots(NamedTuple):
    """A tick's dense grid and the pair passes' slot inputs on it."""

    grid: DenseGrid
    cnt: torch.Tensor                 # (C+1,) i32 live slots per row
    xyz: List[torch.Tensor]           # 3 x (C+1, M) cell-relative coordinates
    imass: torch.Tensor               # (C+1, M), 1 at dead slots
    counts: torch.Tensor              # (C+1, M)
    velocity: torch.Tensor            # (C+1, M, 3), 0 at dead slots


def tick_slots(state: ParticleState, params: PBFParams) -> TickSlots:
    """The grid built from the post-Euler estimates, the coordinate planes,
    and imass, counts and velocity gathered to slots."""
    grid = build_dense_grid(state.estimate_xyz, params.h, state.alive,
                            params.dense_max_cells, params.dense_cell_capacity)
    live = grid.bmask
    ivc = slot_gather(grid, torch.cat(
        [state.imass[:, None], state.counts[:, None], state.velocity], -1))
    cnt, *xyz = pbf_cuda.planes(grid)
    return TickSlots(grid, cnt, xyz, torch.where(live, ivc[..., 0], 1.0).contiguous(),
                     ivc[..., 1].contiguous(), torch.where(live[..., None], ivc[..., 2:5], 0.0))


BACKENDS = ("v3", "v2", "v1")


class CoreOut(NamedTuple):
    """One Jacobi projection in slot space; every per-slot field is (C+1, M)
    (delta (C+1, M, 3)) and 0 at dead slots."""

    delta: torch.Tensor
    pi: torch.Tensor          # pi_raw / imass
    p_ratio: torch.Tensor
    lam: torch.Tensor
    nlen: torch.Tensor
    s_p6: torch.Tensor
    s_edges: torch.Tensor
    s_corr: torch.Tensor
    s_ns: torch.Tensor


def _project_core(nbr, cnt, xyz, live, params: PBFParams, backend: str, imass_s, counts_s):
    """One Jacobi projection in slot space (``_project_core`` of the JAX
    package, sim/pbf_dense.py:85-212) through the v2 or the v1 kernels, on
    the cell rows ``nbr``/``cnt`` with the current coordinate planes
    ``xyz``. Lambda and the delta scaling 1/p0/max(nlen + counts, 1e-20) are
    computed here, between the two passes. ``imass_s`` is 1 at dead slots."""
    k = pbf_cuda.pair_consts(params)
    if backend == "v2":
        pi_raw, sg, c2d2, nlen, s_p6, s_edges = pbf_cuda.phase1_v2(nbr, cnt, *xyz, k)
    elif backend == "v1":
        ncnt, xng = pbf_cuda.gather_v1(nbr, cnt, *xyz)
        pi_raw, sg, c2d2, nlen, s_p6, s_edges = pbf_cuda.phase1_v1(ncnt, xng, cnt, *xyz, k)
    else:
        raise ValueError(f"_project_core runs the v2 or v1 kernels, not {backend!r}")
    p0 = params.p0
    pi = pi_raw / imass_s
    gr = sg / p0
    p_ratio = pi / p0
    lam = -(p_ratio - 1.0) / (c2d2 / (p0 * p0) + (gr * gr).sum(-1) + params.relaxation)
    lam = torch.where(live, lam, 0.0)
    if backend == "v2":
        dsum, s_corr, s_ns = pbf_cuda.phase2_v2(nbr, cnt, *xyz, lam, k)
    else:
        lng = pbf_cuda.gather_lam_v1(nbr, lam)
        dsum, s_corr, s_ns = pbf_cuda.phase2_v1(ncnt, xng, lng, cnt, *xyz, lam, k)
    delta = dsum / p0 / torch.clamp(nlen + counts_s, min=1e-20)[..., None]
    return CoreOut(delta, pi, p_ratio, lam, nlen, s_p6, s_edges, s_corr, s_ns)


def project_gas_constraints_dense(state: ParticleState, params: PBFParams):
    """One dense PBF density projection and the drag force, with the grid
    rebuilt from the current estimates, through the v2 kernels
    (``project_gas_constraints_dense``, sim/pbf_dense.py:215-297, with the
    JAX package's accelerator default; reference gm_dynamics.py:1076-1184).
    Returns ``(state, diagnostics)``, the JAX package's 12 keys as 0-d tensors
    left on the device.

    Points dropped by the grid read the zero row C, so p_ratio 0: they get
    no position update and a drag of -k v, as in the JAX package."""
    with record_function("fnx.dense_grid"):
        grid = build_dense_grid(state.estimate_xyz, params.h, state.alive,
                                params.dense_max_cells, params.dense_cell_capacity)
        live = grid.bmask
        ic = slot_gather(grid, torch.stack([state.imass, state.counts], -1))
        imass_s = torch.where(live, ic[..., 0], 1.0)
        cnt, *xyz = pbf_cuda.planes(grid)
    out = _project_core(grid.nbr, cnt, xyz, live, params, "v2", imass_s, ic[..., 1])

    # back to point space in one packed gather; row C is 0
    packed = torch.cat([out.delta, torch.stack([out.pi, out.p_ratio, out.lam, out.nlen], -1)], -1)
    pt = point_gather(grid, packed)                                     # (N, 7)
    delta, pi, p_ratio, lam, nlen = pt[:, 0:3], pt[:, 3], pt[:, 4], pt[:, 5], pt[:, 6]

    a = state.alive
    force_delta = state.velocity * (1.0 - p_ratio)[:, None] * -params.k
    force = state.force + torch.where(a[:, None], force_delta, 0.0)
    est = torch.where(a[:, None], state.estimate_xyz + delta, state.estimate_xyz)
    n_alive = torch.clamp(a.sum(), min=1).to(torch.float32)

    def amean(f):
        return torch.where(a, f, 0.0).sum() / n_alive

    diagnostics = {
        "velocity": amean(state.velocity.mean(-1)),
        "xyz": amean(state.xyz.mean(-1)),
        "estimate_xyz": amean(est.mean(-1)),
        "poly6_values": out.s_p6 / torch.clamp(out.s_edges, min=1),
        "pi": amean(pi),
        "p_ratio": amean(p_ratio),
        "force_delta": amean(force_delta.mean(-1)),
        "lambdas": amean(lam),
        "lamb_corr": out.s_corr / torch.clamp(out.s_ns, min=1),
        "estimate_xyz_delta": amean(delta.mean(-1)),
        "neighbors": amean(nlen),
        "overflow": grid.overflow,
    }
    return state._replace(estimate_xyz=est, force=force), diagnostics


def stack_diags(diags):
    """A list of per-iteration diagnostic dicts -> one dict of (iterations,)
    tensors, as the JAX package's scans stack them."""
    return {key: torch.stack([d[key] for d in diags]) for key in diags[0]} if diags else {}


def project_iterations_dense(state: ParticleState, params: PBFParams, iterations: int,
                             counts_step: float = 0.0, backend: str = "v3"):
    """``iterations`` Jacobi projections with the grid built ONCE per tick.

    Per iteration only the slot coordinates move, so pair distances are
    exact while the cell assignment may be up to one tick stale. imass,
    counts and velocity go to slots once; the drag force accumulates in slot
    space; positions and force return to point space once, at the end (dead
    and dropped points keep their estimate and get no force).
    ``counts_step``: 0.0 keeps ``state.counts`` fixed (the reference presets
    counts = solver_iterations), 1.0 adds one per projection. ``backend``
    "v3" runs the v3 passes, which fold lambda and the scaled update into the
    kernels; "v2" and "v1" the generic body of the JAX package
    (sim/pbf_dense.py:474-558) over ``_project_core``.

    Returns ``(state, diags)``: ``diags`` holds the JAX package's 12
    diagnostic keys, each stacked over the iterations and left on the
    device; nothing in the loop waits for the device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    k = pbf_cuda.pair_consts(params)
    with record_function("fnx.dense_grid"):
        grid, cnt, xyz0, imass_s, counts_s0, vel_s = tick_slots(state, params)
    live = grid.bmask                                           # (C+1, M)

    a = state.alive
    n_alive = torch.clamp(a.sum(), min=1).to(torch.float32)

    def amean(f):
        return torch.where(a, f, 0.0).sum() / n_alive

    def samean(f):
        """Slot-space counterpart of the per-point alive mean."""
        return torch.where(live, f, 0.0).sum() / n_alive

    const = {"velocity": amean(state.velocity.mean(-1)), "xyz": amean(state.xyz.mean(-1))}
    est0 = amean(state.estimate_xyz.mean(-1))
    xyz = xyz0
    force = torch.zeros_like(vel_s)
    cum_dmean = torch.zeros((), device=a.device)
    diags = []
    with record_function("fnx.jacobi"):
        for it in range(iterations):
            counts_it = counts_s0 + float(counts_step) * it
            if backend == "v3":
                lam, pi_raw, nl, s_p6, s_edges = pbf_cuda.phase1(grid.nbr, cnt, *xyz, imass_s, k)
                *new, s_corr, s_ns = pbf_cuda.phase2(grid.nbr, cnt, *xyz, lam, nl + counts_it, k)
                delta = torch.stack([n - o for n, o in zip(new, xyz)], -1)   # 0 at dead slots
                pi, p_ratio = pi_raw / imass_s, pi_raw / imass_s * k.inv_p0
            else:
                out = _project_core(grid.nbr, cnt, xyz, live, params, backend, imass_s, counts_it)
                delta, pi, p_ratio, lam, nl = out.delta, out.pi, out.p_ratio, out.lam, out.nlen
                s_p6, s_edges, s_corr, s_ns = out.s_p6, out.s_edges, out.s_corr, out.s_ns
                new = [p + delta[..., i] for i, p in enumerate(xyz)]
            xyz = new
            fd = torch.where(live[..., None], vel_s * (1.0 - p_ratio)[..., None] * -params.k, 0.0)
            force = force + fd
            dmean = delta.mean(-1).sum() / n_alive
            cum_dmean = cum_dmean + dmean
            diags.append({
                **const,
                "estimate_xyz": est0 + cum_dmean,
                "poly6_values": s_p6 / torch.clamp(s_edges, min=1),
                "pi": samean(pi),
                "p_ratio": samean(p_ratio),
                "force_delta": fd.mean(-1).sum() / n_alive,
                "lambdas": samean(lam),
                "lamb_corr": s_corr / torch.clamp(s_ns, min=1),
                "estimate_xyz_delta": dmean,
                "neighbors": samean(nl),
                "overflow": grid.overflow,
            })

    # back to point space once: the tick's position change and its force;
    # row C of both is 0, so dropped points get neither
    moved = torch.stack([n - o for n, o in zip(xyz, xyz0)], -1)
    pt = point_gather(grid, torch.cat([moved, force], -1))         # (N, 6)
    am = a[:, None]
    est = torch.where(am, state.estimate_xyz + pt[:, 0:3], state.estimate_xyz)
    force = state.force + torch.where(am, pt[:, 3:6], 0.0)
    counts = state.counts + float(counts_step) * iterations
    return state._replace(estimate_xyz=est, force=force, counts=counts), stack_diags(diags)
