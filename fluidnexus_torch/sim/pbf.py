"""Position-Based Fluids solver (counterpart of ``fluidnexus_tpu/sim/pbf.py``).

The point-wise steps of a solver tick: the prediction ``guess_hidden``, the
commit ``confirm_guess``, ``remove_invalid`` over the padded radius graph,
and the capacity warning. The density projection itself is
``sim/pbf_dense``: ``project_iterations_dense`` (one grid per tick) and
``project_gas_constraints_dense`` (one grid per Jacobi iteration), which
``solver_loop`` runs with a rigid body. Rigid bodies (``RigidSpec``,
``create_rigid_body``, the push-out ``project_rigid_constraints``) and the
forward velocity splat of the visual particles (``splat_velocity_to_points``,
``update_visual``). Phase C's differentiable pair sums: ``density_ratio_at``
(the gas loss) and ``visual_xyz_from_nn`` (the advection of the visual
particles), each a ``torch.autograd.Function`` with the JAX package's
analytic backward over the dense grid (its ``dense=True`` branch, the one
its accelerator runs), and ``guess_from_nn``. Positions live in scaled space
(world * scale_factor, scale_factor = 100).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from fluidnexus_torch.ops.neighbors import (
    DenseGrid, bin_queries, build_dense_grid, point_gather, radius_graph, radius_query,
    slot_gather,
)
from fluidnexus_torch.sim import pbf_cuda, splat_cuda
from fluidnexus_torch.sim.state import ParticleState, VisualState

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


def solver_loop(state: ParticleState, params: PBFParams, iterations: int,
                rigid: Optional["RigidBody"] = None):
    """``iterations`` Jacobi projections with the reference's counts schedule
    (counts + 1 after each projection, train_physical_particle.py:292-298).
    Without a rigid body the grid is built once (``project_iterations_dense``,
    counts_step 1). With one, each iteration runs, in this order,
    ``project_gas_constraints_dense`` (a grid rebuilt from the current
    estimates, the v2 kernels), the push-out of the body and counts + 1.
    Returns (state, diags stacked over the iterations)."""
    from fluidnexus_torch.sim.pbf_dense import (
        project_gas_constraints_dense, project_iterations_dense, stack_diags,
    )

    if rigid is None:
        return project_iterations_dense(state, params, iterations, counts_step=1.0)
    diags = []
    with record_function("fnx.jacobi"):
        for _ in range(iterations):
            state, diag = project_gas_constraints_dense(state, params)
            state = project_rigid_constraints(state, rigid, params)
            state = state._replace(counts=state.counts + 1.0)
            diags.append(diag)
    return state, stack_diags(diags)


def splat_velocity_to_points(points, point_alive, state: ParticleState, params: PBFParams):
    """The poly6-weighted velocity splat from the hidden estimates to
    ``points``, as a position delta (update_visual_particles,
    gm_dynamics.py:1360-1402): delta = secs sum_j w_j v_j / max(sum_j w_j,
    eps), through the two-lattice splat forward kernel over every in-radius
    source (the JAX package's accelerator branch, ``dense=True``). No
    gradient."""
    with torch.no_grad():
        grid = build_dense_grid(state.estimate_xyz, params.h, state.alive,
                                params.dense_max_cells, params.dense_cell_capacity)
        return _splat_delta(grid, state.velocity, points, point_alive, params)[0]


def update_visual(visual: VisualState, state: ParticleState, params: PBFParams) -> VisualState:
    """The visual particles advected by the dense splat of the hidden velocities."""
    delta = splat_velocity_to_points(visual.xyz, visual.alive, state, params)
    return visual._replace(xyz=torch.where(visual.alive[:, None], visual.xyz + delta, visual.xyz))


# --------------------------- differentiable NN paths ------------------------


def _grid_for(positions, alive, params: PBFParams, grid, what: str) -> DenseGrid:
    """The source grid of a pair sum: built here from the detached positions,
    or the caller's pre-built one, which must be a ``DenseGrid`` with the
    params' caps and one ``prow`` entry per position (else ``ValueError``)."""
    C, M = params.dense_max_cells, params.dense_cell_capacity
    if grid is None:
        return build_dense_grid(positions.detach(), params.h, alive, C, M)
    if not isinstance(grid, DenseGrid):
        raise ValueError(f"{what}: grid must be a DenseGrid, got {type(grid).__name__}")
    if (grid.max_cells, grid.capacity) != (C, M):
        raise ValueError(f"{what}: the grid has {grid.max_cells} cells x {grid.capacity} slots, "
                         f"the params {C} x {M}")
    if tuple(grid.prow.shape) != (positions.shape[0],):
        raise ValueError(f"{what}: the grid bins {grid.prow.shape[0]} points, "
                         f"the positions are {positions.shape[0]}")
    return grid


class _DensityRatio(torch.autograd.Function):
    """rho / rho0 over the dense grid (the JAX ``_density_ratio_dense``
    custom VJP, sim/pbf.py:486-532). Differentiable in the positions and
    imass; dropped points read the self-only density c6 h^6 and get no
    position gradient."""

    @staticmethod
    def forward(ctx, positions, imass, params: PBFParams, grid: DenseGrid):
        k = pbf_cuda.pair_consts(params)
        planes = pbf_cuda.planes(grid)
        pi_s = pbf_cuda.density(grid.nbr, *planes, k)
        pi_s[-1] = float(params.poly6_term1 * params.h ** 6)   # row C: the self pair alone
        pi_n = point_gather(grid, pi_s)
        ctx.save_for_backward(imass, pi_n)
        ctx.grid, ctx.planes, ctx.params, ctx.k = grid, planes, params, k
        return pi_n / imass / params.p0

    @staticmethod
    def backward(ctx, g):
        imass, pi_n = ctx.saved_tensors
        grid, params = ctx.grid, ctx.params
        g_s = slot_gather(grid, g / (imass * params.p0)).contiguous()   # dL/dpi, 0 at dead slots
        ds = pbf_cuda.density_bwd(grid.nbr, *ctx.planes, g_s, ctx.k)
        dimass = -pi_n / (imass * imass * params.p0) * g
        return point_gather(grid, ds), dimass, None, None


def density_ratio_at(positions, alive, imass, params: PBFParams, grid: Optional[DenseGrid] = None):
    """rho / rho0 at scaled-space positions, the gas-constraint loss
    (get_gas_constraints_from_exyz_nn, gm_dynamics.py:1269-1296), over every
    in-radius pair of the dense grid. ``grid`` is an optional pre-built
    ``build_dense_grid(positions.detach(), h, alive, C, M)``, checked against
    the params' caps and the positions' count. Dead and dropped particles
    read a self-only density and get no position gradient."""
    grid = _grid_for(positions, alive, params, grid, "density_ratio_at")
    return _DensityRatio.apply(positions, imass, params, grid)


def _splat_delta(grid: DenseGrid, vel, points, point_alive, params: PBFParams):
    """The splat forward over the source ``grid``: (delta (Nq, 3), ws (Nq,),
    the tables the adjoint reads). The queries are binned on the grid's
    lattice; the forward kernel gives the per-slot sums, c6 applied outside
    the kernel, so the eps clamp is max(c6 ws, eps). Dead and dropped queries
    read the zero row Cq: delta 0."""
    C, M = params.dense_max_cells, params.dense_cell_capacity
    qgrid, rnbr = bin_queries(grid, params.h, points, point_alive, C, M)
    planes, qplanes = pbf_cuda.planes(grid), pbf_cuda.planes(qgrid)
    vel_s = slot_gather(grid, vel).contiguous()
    wv_s, ws_s = splat_cuda.splat_fwd(qgrid.nbr, *qplanes, *planes, vel_s, params.h)
    c6 = float(np.float32(params.poly6_term1))
    wvs = point_gather(qgrid, torch.cat([wv_s * c6, ws_s[..., None] * c6], -1))  # row Cq: 0
    ws = wvs[:, 3]
    delta = params.secs * wvs[:, :3] / torch.clamp(ws, min=params.epsilon)[:, None]
    return delta, ws, (grid, qgrid, rnbr, planes, qplanes, vel_s)


class _SplatDelta(torch.autograd.Function):
    """delta (Nq, 3) = secs (sum_j W_ij vel_j) / max(sum_j W_ij, eps) of the
    queries ``points`` over the sources in ``grid`` (the JAX
    ``_splat_delta_dense`` custom VJP, sim/pbf.py:373-455). Differentiable in
    ``src`` (through W) and ``vel``; ``points`` is treated as detached. Dead
    and dropped queries get delta 0; dropped sources contribute nothing."""

    @staticmethod
    def forward(ctx, src, vel, points, point_alive, params: PBFParams, grid: DenseGrid):
        delta, ws, tables = _splat_delta(grid, vel, points, point_alive, params)
        ctx.save_for_backward(ws, delta)
        ctx.tables = tables
        ctx.params = params
        return delta

    @staticmethod
    def backward(ctx, g):
        ws, delta = ctx.saved_tensors
        grid, qgrid, rnbr, planes, qplanes, vel_s = ctx.tables
        params = ctx.params
        c6 = np.float32(params.poly6_term1)
        s = torch.clamp(ws, min=params.epsilon)
        p = float(c6 * np.float32(params.secs)) * g / s[:, None]
        q = torch.where(ws < params.epsilon, 0.0, float(c6) * (g * delta).sum(-1) / s)
        pq_s = slot_gather(qgrid, torch.cat([p, q[:, None]], -1))        # 0 at dead slots
        gx_s, gv_s = splat_cuda.splat_bwd(rnbr, *planes, vel_s, *qplanes,
                                          pq_s[..., :3].contiguous(), pq_s[..., 3].contiguous(),
                                          params.h)
        gsv = point_gather(grid, torch.cat([gx_s, gv_s], -1))           # row C: 0
        return gsv[:, :3], gsv[:, 3:], None, None, None, None


def visual_xyz_from_nn(visual_xyz, visual_alive, estimate_xyz_nn, state: ParticleState,
                       params: PBFParams, grid: Optional[DenseGrid] = None):
    """Differentiable advection of the (detached) visual particles by the
    learnable hidden positions (get_visual_xyz_from_nn,
    gm_dynamics.py:1453-1500) through the two-set splat over the dense grid.
    ``estimate_xyz_nn`` is in world units (the optimizer's down-scaled
    space); the result is in scaled space. ``grid`` is an optional pre-built
    source grid at ``estimate_xyz_nn * scale_factor``, checked as in
    ``density_ratio_at``."""
    est = estimate_xyz_nn * params.scale_factor
    vel = (est - state.xyz) / params.secs
    vx = visual_xyz.detach()
    grid = _grid_for(est, state.alive, params, grid, "visual_xyz_from_nn")
    return vx + _SplatDelta.apply(est, vel, vx, visual_alive, params, grid)


def guess_from_nn(estimate_xyz_nn, state: ParticleState, params: PBFParams):
    """One more simulated tick from the NN positions, for the next-step gas
    loss (get_guess_hidden_particles_from_nn, gm_dynamics.py:1302-1320).
    Returns scaled-space positions."""
    if params.buoyancy_max_y > 0.0:
        coeff = 1.0 - estimate_xyz_nn[:, 1:2] / params.buoyancy_max_y
        cur_buoy = state.buoyancy * coeff
    else:
        cur_buoy = state.buoyancy
    est = estimate_xyz_nn * params.scale_factor
    tmp_velocity = (est - state.xyz) / params.secs
    est_vel = tmp_velocity + cur_buoy * params.secs + params.secs * state.force
    return est + params.secs * est_vel


# --------------------------------- rigid body --------------------------------


@dataclasses.dataclass(frozen=True)
class RigidSpec:
    """Rigid-body config (ref setup_constants:151-167)."""

    kind: str = "sphere"                       # cuboid | sphere | cylinder
    particle_radius: float = 0.25
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # world units (scaled inside)
    cuboid_num: Tuple[int, int, int] = (10, 10, 10)
    sphere_radius: float = 1.0
    sphere_num: int = 1000
    cylinder_radius: float = 1.0
    cylinder_num: Tuple[int, int] = (64, 16)
    scale_factor: float = 100.0


class RigidBody(NamedTuple):
    xyz: torch.Tensor          # (M, 3) surface particles, scaled space
    spec_kind: int             # 0 cuboid, 1 sphere, 2 cylinder
    center: torch.Tensor       # (3,) scaled space
    half_extent: torch.Tensor  # (3,) size per kind: cuboid half sizes, sphere (r, 0, 0),
                               # cylinder (r, half length, 0)


def create_rigid_body(spec: RigidSpec, rng: np.random.Generator, device="cuda") -> RigidBody:
    """The body's surface particle cloud (create_rigid_body,
    gm_dynamics.py:612-672), made on the host as the JAX package makes it:
    the sphere draws its points from ``rng``, the cuboid and the cylinder draw
    nothing. The cylinder's axis is z."""
    diam = 2 * spec.particle_radius
    if spec.kind == "cuboid":
        xn, yn, zn = spec.cuboid_num
        pts = []
        for i in range(xn):
            for j in range(yn):
                for kk in range(zn):
                    if 0 < i < xn - 1 and 0 < j < yn - 1 and 0 < kk < zn - 1:
                        continue
                    pts.append([i * diam - xn // 2 * diam, j * diam - yn // 2 * diam,
                                kk * diam - zn // 2 * diam])
        xyz = np.array(pts, np.float32)
        half = np.array([xn * diam, yn * diam, zn * diam], np.float32) / 2
        kind = 0
    elif spec.kind == "sphere":
        phi = rng.uniform(0, 2 * np.pi, spec.sphere_num)
        theta = np.arccos(rng.uniform(-1, 1, spec.sphere_num))
        xyz = np.stack([spec.sphere_radius * np.sin(theta) * np.cos(phi),
                        spec.sphere_radius * np.sin(theta) * np.sin(phi),
                        spec.sphere_radius * np.cos(theta)], 1).astype(np.float32)
        half = np.array([spec.sphere_radius, 0, 0], np.float32)
        kind = 1
    elif spec.kind == "cylinder":
        ncyc, nh = spec.cylinder_num
        pts = []
        for i in range(ncyc):
            for j in range(nh):
                th = i * 2 * np.pi / ncyc
                pts.append([spec.cylinder_radius * np.cos(th), spec.cylinder_radius * np.sin(th),
                            (j - nh / 2) * diam])
        xyz = np.array(pts, np.float32)
        half = np.array([spec.cylinder_radius, nh * diam / 2, 0], np.float32)
        kind = 2
    else:
        raise ValueError(spec.kind)
    center = np.asarray(spec.center, np.float32) * spec.scale_factor
    f32 = dict(dtype=torch.float32, device=device)
    return RigidBody(xyz=torch.as_tensor(xyz + center, **f32), spec_kind=kind,
                     center=torch.as_tensor(center, **f32), half_extent=torch.as_tensor(half, **f32))


def inside_rigid_body(rb: RigidBody, xyz):
    """Point-in-body test (check_inside_rigid_body, gm_dynamics.py:1186-1218)."""
    if rb.spec_kind == 0:
        lower, upper = rb.center - rb.half_extent, rb.center + rb.half_extent
        return torch.all((xyz >= lower) & (xyz <= upper), -1)
    if rb.spec_kind == 1:
        return torch.linalg.vector_norm(xyz - rb.center, dim=-1) <= rb.half_extent[0]
    dxy = (xyz[:, 0] - rb.center[0]) ** 2 + (xyz[:, 1] - rb.center[1]) ** 2
    return (dxy <= rb.half_extent[0] ** 2) & (torch.abs(xyz[:, 2] - rb.center[2]) <= rb.half_extent[1])


def _push_out_of_rigid(rb: RigidBody, xyz, alive, params: PBFParams):
    """Points inside the body move to the nearest surface particle within h
    (project_rigid_body_constraints, gm_dynamics.py:1220-1266: dp1 = -(p -
    nearest)); the 8 nearest come from ``radius_query``, and of equal
    distances the first wins, as ``jnp.argmin`` picks."""
    inside = inside_rigid_body(rb, xyz) & alive
    nl = radius_query(rb.xyz, xyz, params.h, k=8, alive_y=inside)
    d2 = torch.sum((xyz[:, None] - rb.xyz[nl.idx]) ** 2, -1)
    d2 = torch.where(nl.mask, d2, float("inf"))
    nearest = torch.gather(nl.idx, 1, torch.argmin(d2, -1, keepdim=True))[:, 0]
    move = inside & nl.mask.any(-1)
    return torch.where(move[:, None], rb.xyz[nearest], xyz)


def project_rigid_constraints(state: ParticleState, rb: RigidBody,
                              params: PBFParams) -> ParticleState:
    """The hidden estimates pushed out of the body."""
    with record_function("fnx.rigid"):
        return state._replace(estimate_xyz=_push_out_of_rigid(rb, state.estimate_xyz,
                                                              state.alive, params))


def project_rigid_constraints_visual(visual: VisualState, rb: RigidBody,
                                     params: PBFParams) -> VisualState:
    """The visual particles pushed out of the body."""
    with record_function("fnx.rigid"):
        return visual._replace(xyz=_push_out_of_rigid(rb, visual.xyz, visual.alive, params))
