"""The PBF tick's Jacobi loop over the dense cell grid (counterpart of
``fluidnexus_tpu/sim/pbf_dense.py``).

``project_iterations_dense`` keeps the contract and the diagnostics of the
JAX package's grid-reuse tick (``_project_iterations_v3`` on the TPU, the
generic scan body elsewhere): exact sums over every in-radius pair, with no
``knn_k`` truncation, and the grid built once per tick from the post-Euler
estimates. The pair passes are ``sim/pbf_cuda.phase1``/``phase2``: the
kernels for a CUDA tensor, their plain versions for a CPU tensor.
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


def project_iterations_dense(state: ParticleState, params: PBFParams, iterations: int,
                             counts_step: float = 0.0):
    """``iterations`` Jacobi projections with the grid built ONCE per tick.

    Per iteration only the slot coordinates move, so pair distances are
    exact while the cell assignment may be up to one tick stale. imass,
    counts and velocity go to slots once; the drag force accumulates in slot
    space; positions and force return to point space once, at the end (dead
    and dropped points keep their estimate and get no force).
    ``counts_step``: 0.0 keeps ``state.counts`` fixed (the reference presets
    counts = solver_iterations), 1.0 adds one per projection.

    Returns ``(state, diags)``: ``diags`` holds the JAX package's 12
    diagnostic keys, each stacked over the iterations and left on the
    device; nothing in the loop waits for the device."""
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
            lam, pi_raw, nl, s_p6, s_edges = pbf_cuda.phase1(grid.nbr, cnt, *xyz, imass_s, k)
            nc = nl + counts_s0 + float(counts_step) * it
            *new, s_corr, s_ns = pbf_cuda.phase2(grid.nbr, cnt, *xyz, lam, nc, k)
            delta = torch.stack([n - o for n, o in zip(new, xyz)], -1)   # 0 at dead slots
            xyz = new
            p_ratio = pi_raw / imass_s * k.inv_p0
            fd = torch.where(live[..., None], vel_s * (1.0 - p_ratio)[..., None] * -params.k, 0.0)
            force = force + fd
            dmean = delta.mean(-1).sum() / n_alive
            cum_dmean = cum_dmean + dmean
            diags.append({
                **const,
                "estimate_xyz": est0 + cum_dmean,
                "poly6_values": s_p6 / torch.clamp(s_edges, min=1),
                "pi": samean(pi_raw / imass_s),
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
    stacked = {key: torch.stack([d[key] for d in diags]) for key in diags[0]} if diags else {}
    return state._replace(estimate_xyz=est, force=force, counts=counts), stacked
