"""Position-Based Fluids solver (counterpart of ``fluidnexus_tpu/sim/pbf.py``).

The point-wise steps of a solver tick: the prediction ``guess_hidden``, the
commit ``confirm_guess``, ``remove_invalid`` over the padded radius graph,
and the capacity warning. The density projection itself is
``sim/pbf_dense.project_iterations_dense``. Positions live in scaled space
(world * scale_factor, scale_factor = 100).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fluidnexus_torch.ops.neighbors import radius_graph
from fluidnexus_torch.sim.state import ParticleState

GRAVITY = np.array([0.0, -9.8, 0.0], np.float32)


@dataclasses.dataclass(frozen=True)
class PBFParams:
    """Solver constants (ref setup_constants, gm_dynamics.py:83-186)."""

    secs: float = 0.033
    alpha: float = -0.2                  # gravity scaling for gases (buoyancy)
    beta: float = 0.0
    buoyancy_decay_rate: float = 0.0
    buoyancy_max_y: float = 0.0          # world units; >0 enables height-scaled buoyancy
    h: float = 0.625                     # SPH kernel radius (scaled space)
    p0: float = 1.5                      # rest density
    k: float = 3.0                       # drag coefficient
    min_neighbors: int = -1
    knn_k: int = 100                     # max neighbors (ref KNN_K)
    init_hidden_velocity: float = 0.0
    wind_force: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    wind_power: float = 1.0
    scale_factor: float = 100.0
    epsilon: float = 1e-8
    relaxation: float = 0.01             # ref RELAXATION
    k_p: float = 0.2                     # ref K_P (s_corr strength)
    e_p: float = 4.0                     # ref E_P (s_corr exponent)
    dq_p: float = 0.25                   # ref DQ_P (s_corr ref distance)
    cell_capacity: int = 32
    table_size: Optional[int] = None
    # static caps of the dense cell-pair grid: occupied cells and points per cell
    dense_max_cells: int = 4096
    dense_cell_capacity: int = 32

    @property
    def h2(self):
        return self.h * self.h

    @property
    def poly6_term1(self):
        return 315.0 / (64.0 * np.pi * self.h**9)

    @property
    def spiky_grad_term1(self):
        return 45.0 / (np.pi * self.h**6)

    @property
    def lamb_corr_denom(self):
        # poly6 at r2 = (DQ_P * H)^2 (ref gm_dynamics.py:134)
        r2 = (self.dq_p * self.dq_p * self.h * self.h)
        return self.poly6_term1 * (self.h2 - r2) ** 3


def guess_hidden(state: ParticleState, params: PBFParams, stable: bool = False,
                 use_wind: bool = False) -> ParticleState:
    """Semi-implicit Euler prediction (guess_hidden_particles, :978-1032).
    ``stable=True`` takes the stabilisation constants (secs 0.01, alpha -1).
    Buoyancy is recomputed each call, optionally scaled down with height;
    the stored buoyancy is the decayed one. Zeroes force and counts."""
    cur_secs = 0.01 if stable else params.secs
    cur_alpha = -1.0 if stable else params.alpha
    g = torch.as_tensor(GRAVITY, device=state.xyz.device)
    buoy = (g * cur_alpha).expand_as(state.xyz)

    if params.buoyancy_max_y > 0.0:
        coeff = 1.0 - state.xyz[:, 1:2] / (params.buoyancy_max_y * params.scale_factor)
        cur_buoy = buoy * coeff
    else:
        cur_buoy = buoy

    vel = state.velocity + cur_buoy * cur_secs + cur_secs * state.force
    if use_wind:
        y_world = state.xyz[:, 1:2] / params.scale_factor
        wf = torch.as_tensor(params.wind_force, dtype=torch.float32, device=state.xyz.device)
        wind = torch.clamp((y_world ** params.wind_power) * wf, 0.0, max(params.wind_force))
        vel = vel + wind * cur_secs

    stored = buoy * params.buoyancy_decay_rate if params.buoyancy_decay_rate > 0.0 else buoy
    m = state.alive[:, None]
    return state._replace(
        velocity=torch.where(m, vel, 0.0),
        buoyancy=stored.contiguous(),
        force=torch.zeros_like(state.force),
        estimate_xyz=torch.where(m, state.xyz + cur_secs * vel, state.estimate_xyz),
        counts=torch.zeros_like(state.counts),
    )


def confirm_guess(state: ParticleState, params: PBFParams) -> ParticleState:
    """Commit the estimates: v = dx / secs (``params.secs``, also during
    stabilisation), zero v and keep the old xyz for moves under epsilon
    (confirm_guess_hidden_particles, gm_dynamics.py:1323-1338)."""
    dx = state.estimate_xyz - state.xyz
    vel = dx / params.secs
    tiny = torch.linalg.vector_norm(dx, dim=1) < params.epsilon
    vel = torch.where(tiny[:, None], 0.0, vel)
    xyz = torch.where((tiny | ~state.alive)[:, None], state.xyz, state.estimate_xyz)
    return state._replace(velocity=torch.where(state.alive[:, None], vel, 0.0), xyz=xyz)


def neighbor_counts(state: ParticleState, params: PBFParams):
    """Non-self neighbour counts within H over the padded radius graph
    (remove_invalid_particles, :1033)."""
    nl = radius_graph(state.xyz, params.h, k=params.knn_k, loop=False, alive=state.alive,
                      cell_capacity=params.cell_capacity)
    return nl.mask.sum(-1)


def remove_invalid(state: ParticleState, params: PBFParams) -> ParticleState:
    """Kill particles with fewer than ``min_neighbors`` neighbours."""
    if params.min_neighbors < 0:
        return state
    keep = (neighbor_counts(state, params) >= params.min_neighbors) & state.alive
    return state._replace(alive=keep)


def warn_capacity_overflow(diags, context: str, strict: bool = False, log=print) -> int:
    """Report the points the static-capacity grids dropped in a tick (one
    host read of the stacked ``overflow``); raises instead under ``strict``
    (--strict_capacity). Returns the dropped count."""
    ov = diags.get("overflow")
    total = int(ov.sum()) if ov is not None else 0
    if total > 0:
        msg = (f"[capacity] {context}: neighbor grid dropped {total} "
               "point-slots this tick — pair sums are missing particles. "
               "Raise dense_max_cells / dense_cell_capacity (dense path) or "
               "cell_capacity / KNN_K (padded path) to cover the scene.")
        if strict:
            raise RuntimeError(msg + " (--strict_capacity raised)")
        log(msg)
    return total
