"""Position-Based Fluids constants (counterpart of ``fluidnexus_tpu/sim/pbf.py``).

Only ``PBFParams`` so far: phase A reads ``scale_factor``. The solver comes
with the phase-B slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


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
