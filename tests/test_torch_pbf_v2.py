"""The per-iteration-rebuild PBF projection and the rigid bodies in the port
against the JAX package, on the CPU: ``radius_query``,
``project_gas_constraints_dense`` through the v2 plain versions and
``project_iterations_dense`` through the v2 and v1 plain versions (against
the JAX ``backend="xla"`` scan), ``project_iterations_dense`` v2 and v1
against the per-iteration rebuild, ``solver_loop`` with each rigid kind and
without one, and the velocity splat of the visual particles. Inputs are
seeded numpy arrays handed to both packages.

Tolerances: the JAX scan forms the spiky length from sqrt and a divide, the
port's passes (as the Pallas kernels) from rsqrt; the two differ at ~1e-7
relative, so positions are held at 1e-5 and forces at 1e-4."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim import pbf_dense as jdense
from fluidnexus_tpu.sim.state import make_particle_state as j_make_particle_state
from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state
from fluidnexus_torch import convert
from fluidnexus_torch.ops import neighbors as tnb
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_dense as tdense

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


def _params(cls, **kw):
    kw = {"h": 1.0, "p0": 1.5, "k": 3.0, "secs": 0.033, "knn_k": 256, "cell_capacity": 64,
          "dense_max_cells": 256, "dense_cell_capacity": 32, **kw}
    return cls(**kw)


def _mk_state(n_live, capacity, seed=0, center=(32.0, 10.0, -30.0), spread=2.0, imass=True):
    """tests/test_pbf_dense.py's state, with a random inverse mass unless
    ``imass`` is False."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-spread, spread, (n_live, 3)).astype(np.float32)
           + np.asarray(center, np.float32))
    st = j_make_particle_state(capacity, jnp.asarray(pts), init_velocity_y=10.0)
    st = st._replace(
        estimate_xyz=st.xyz + 0.01 * rng.standard_normal((capacity, 3)).astype(np.float32),
        velocity=jnp.asarray(rng.standard_normal((capacity, 3)).astype(np.float32)),
        counts=jnp.full((capacity,), 3.0),
        imass=jnp.asarray((0.8 + 0.4 * rng.random(capacity)).astype(np.float32)
                          if imass else np.ones(capacity, np.float32)),
    )
    return st, convert.particle_state_from_numpy(st, device=CPU)


def _close_states(got, ref, pos_tol=1e-5, force_tol=1e-4):
    np.testing.assert_allclose(got.estimate_xyz.numpy(), _np(ref.estimate_xyz), rtol=0,
                               atol=pos_tol)
    np.testing.assert_allclose(got.force.numpy(), _np(ref.force), rtol=force_tol, atol=force_tol)
    np.testing.assert_array_equal(got.counts.numpy(), _np(ref.counts))


def _close_diags(got, ref, tol=1e-4):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(_np(got[key]), _np(ref[key]), rtol=tol, atol=tol, err_msg=key)


# ------------------------------- radius_query --------------------------------


@pytest.mark.parametrize("case", ["roomy", "full_cell", "far_queries"])
def test_radius_query_matches_jax(case):
    """Indices, mask and overflow exactly: dead data and dead queries, a cell
    over ``cell_capacity``, queries far below the data (the box is anchored
    at the minimum over data and queries) and ties in distance (a lattice)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0.0, 6.0, (300, 3)).astype(np.float32)
    x[:64] = np.round(x[:64] * 2) / 2                     # a lattice: equal distances
    y = rng.uniform(-0.5, 6.5, (200, 3)).astype(np.float32)
    alive_x, alive_y = rng.random(300) > 0.1, rng.random(200) > 0.2
    if case == "full_cell":
        x[100:160] = 2.2 + 0.05 * rng.random((60, 3)).astype(np.float32)
    if case == "far_queries":
        y[:20] -= 10.0
    r, k = 0.9, 12
    ref = jnb.radius_query(jnp.asarray(x), jnp.asarray(y), r, k, alive_x=jnp.asarray(alive_x),
                           alive_y=jnp.asarray(alive_y), cell_capacity=32)
    got = tnb.radius_query(torch.as_tensor(x), torch.as_tensor(y), r, k,
                           alive_x=torch.as_tensor(alive_x), alive_y=torch.as_tensor(alive_y),
                           cell_capacity=32)
    assert int(got.mask.sum()) > 200
    if case == "full_cell":
        assert int(got.overflow) > 0
    np.testing.assert_array_equal(got.idx.numpy(), _np(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), _np(ref.mask))
    assert int(got.overflow) == int(ref.overflow)


# ------------------------ the per-iteration projection ------------------------


def _overflow_pair(case):
    """JAX and port params and states: a roomy grid, or one whose cells
    (capacity 4) drop points."""
    caps = (256, 32) if case == "roomy" else (64, 4)
    pj = _params(jpbf.PBFParams, h=1.0 if case == "roomy" else 2.0, dense_max_cells=caps[0],
                 dense_cell_capacity=caps[1])
    pt = _params(tpbf.PBFParams, h=pj.h, dense_max_cells=caps[0], dense_cell_capacity=caps[1])
    return (pj, pt, *_mk_state(300, 384, seed=2 if case == "roomy" else 7,
                               spread=2.0 if case == "roomy" else 1.5))


def _dropped(st, params):
    grid = tnb.build_dense_grid(st.estimate_xyz, params.h, st.alive, params.dense_max_cells,
                                params.dense_cell_capacity)
    dropped = (grid.prow == params.dense_max_cells) & st.alive
    assert int(dropped.sum()) > 0
    return dropped


@pytest.mark.parametrize("case", ["roomy", "overflow"])
def test_project_gas_constraints_dense_matches_jax(case):
    """One projection with the grid rebuilt (the v2 passes): positions 1e-5,
    force 1e-4, every diagnostic 1e-4. With an overflowing grid the dropped
    points read the zero row, p_ratio 0, so they keep their estimate and get
    the spurious -k v drag of the JAX package (sim/pbf_dense.py:455-458)."""
    pj, pt, st_j, st_t = _overflow_pair(case)
    ref, ref_d = jdense.project_gas_constraints_dense(st_j, pj, backend="xla")
    got, got_d = tdense.project_gas_constraints_dense(st_t, pt)
    _close_states(got, ref)
    _close_diags(got_d, ref_d)
    if case == "overflow":
        assert int(got_d["overflow"]) > 0
        dropped = _dropped(st_t, pt)
        np.testing.assert_array_equal(got.estimate_xyz[dropped].numpy(),
                                      st_t.estimate_xyz[dropped].numpy())
        torch.testing.assert_close(got.force[dropped], -pt.k * st_t.velocity[dropped])


@pytest.mark.parametrize("backend", ["v2", "v1"])
@pytest.mark.parametrize("case", ["roomy", "overflow"])
def test_project_iterations_dense_v2_v1_match_jax(backend, case):
    """Three projections over one grid through the v2 or the v1 plain
    versions against the JAX package's ``backend="xla"`` scan, as
    tests/test_torch_pbf.py holds the v3 passes: positions 1e-4, force 1e-3,
    every diagnostic 1e-4. Points the overflowing grid drops keep their
    estimate and get no force."""
    pj, pt, st_j, st_t = _overflow_pair(case)
    ref, ref_d = jdense.project_iterations_dense(st_j, pj, 3, backend="xla", counts_step=1.0)
    got, got_d = tdense.project_iterations_dense(st_t, pt, 3, counts_step=1.0, backend=backend)
    _close_states(got, ref, pos_tol=1e-4, force_tol=1e-3)
    _close_diags(got_d, ref_d)
    assert got_d["p_ratio"].shape == (3,)
    if case == "overflow":
        assert int(got_d["overflow"][0]) > 0
        dropped = _dropped(st_t, pt)
        np.testing.assert_array_equal(got.estimate_xyz[dropped].numpy(),
                                      st_t.estimate_xyz[dropped].numpy())
        np.testing.assert_array_equal(got.force[dropped].numpy(), st_t.force[dropped].numpy())


@pytest.mark.parametrize("backend", ["v2", "v1"])
@pytest.mark.parametrize("counts_step", [0.0, 1.0])
def test_iterations_match_per_iteration_rebuild(backend, counts_step):
    """``project_iterations_dense`` v2 and v1 (one grid a tick) against four
    rebuild-every-iteration projections (the v2 passes), as tests/test_pbf_dense.py:198-239
    holds the JAX package's: positions 3e-4, force 1.5e-2 relative (a stale
    cell assignment sees a few boundary pairs differently), diagnostics 1e-3;
    and the v2 body against the v3 passes at 1e-5."""
    params = _params(tpbf.PBFParams)
    _, st = _mk_state(400, 512, seed=1, spread=2.0, imass=False)
    ref, ref_diags = st, []
    for _ in range(4):
        ref, d = tdense.project_gas_constraints_dense(ref, params)
        ref_diags.append(d)
        ref = ref._replace(counts=ref.counts + counts_step)
    got, got_d = tdense.project_iterations_dense(st, params, 4, counts_step=counts_step,
                                                 backend=backend)
    assert int(got_d["overflow"][0]) == 0
    torch.testing.assert_close(got.estimate_xyz, ref.estimate_xyz, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(got.force, ref.force, rtol=1.5e-2, atol=1e-3)
    torch.testing.assert_close(got.counts, ref.counts)
    for i, d in enumerate(ref_diags):
        for key in d:
            torch.testing.assert_close(got_d[key][i], d[key].to(got_d[key].dtype), rtol=1e-3,
                                       atol=1e-3, msg=f"iter {i} {key}")
    v3, v3_d = tdense.project_iterations_dense(st, params, 4, counts_step=counts_step)
    torch.testing.assert_close(got.estimate_xyz, v3.estimate_xyz, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.force, v3.force, rtol=1e-4, atol=1e-4)
    for key in v3_d:
        torch.testing.assert_close(got_d[key], v3_d[key], rtol=1e-4, atol=1e-4, msg=key)


def test_project_iterations_dense_rejects_an_unknown_backend():
    _, st = _mk_state(20, 32)
    with pytest.raises(ValueError, match="backend"):
        tdense.project_iterations_dense(st, _params(tpbf.PBFParams), 1, backend="xla")


@pytest.mark.parametrize("name", ["phase1_v2_slots", "phase2_v2_slots", "phase1_v1_slots",
                                  "phase2_v1_slots"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """The kernel wrappers never fall back to a plain version: a CPU tensor
    is refused before any build or launch."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    params = _params(tpbf.PBFParams)
    _, st = _mk_state(50, 64)
    grid = tnb.build_dense_grid(st.estimate_xyz, params.h, st.alive, 256, 32)
    cnt, *xyz = pc.planes(grid)
    lam = torch.zeros_like(xyz[0])
    ncnt, xng = pc.gather_v1(grid.nbr, cnt, *xyz)
    args = {"phase1_v2_slots": (grid.nbr, cnt, *xyz),
            "phase2_v2_slots": (grid.nbr, cnt, *xyz, lam),
            "phase1_v1_slots": (ncnt, xng, cnt, *xyz),
            "phase2_v1_slots": (ncnt, xng, pc.gather_lam_v1(grid.nbr, lam), cnt, *xyz, lam)}
    before = dict(pc.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        getattr(pc, name)(*args[name], pc.pair_consts(params))
    assert pc.LAUNCHES == before


# -------------------------------- rigid bodies --------------------------------


# kind: spec keywords, a body in the middle of _mk_state's cloud, small
# enough that the push-out puts no two points on one surface particle: such a
# pair has d2 = 0 and a spiky coefficient of ~s45 h^2 / sqrt(eps), whose
# (sum b) x_i - sum b x_s terms cancel to ~1e-4 scaled units of rounding
# noise, with the JAX scan's sqrt form and the rsqrt form apart by 1e-4
# relative there; chip_smoke.py runs the full-size cylinder.
_RIGID = {
    "cuboid": dict(cuboid_num=(5, 5, 5), particle_radius=0.15),
    "sphere": dict(sphere_radius=0.8, sphere_num=300),
    "cylinder": dict(cylinder_radius=0.7, cylinder_num=(24, 6), particle_radius=0.15),
}


def _rigid_pair(kind, seed=0):
    kw = dict(kind=kind, center=(0.32, 0.1, -0.3), **_RIGID[kind])
    rb_j = jpbf.create_rigid_body(jpbf.RigidSpec(**kw), np.random.default_rng(seed))
    rng_t = np.random.default_rng(seed)
    rb_t = tpbf.create_rigid_body(tpbf.RigidSpec(**kw), rng_t, device=CPU)
    return rb_j, rb_t, rng_t


@pytest.mark.parametrize("kind", ["cuboid", "sphere", "cylinder"])
def test_solver_loop_with_a_rigid_body_matches_jax(kind):
    """The body's particles and its generator draws exactly; the push-out of
    a cloud exactly; ``solver_loop(rigid=...)`` (per-iteration rebuild, the
    v2 passes, the push-out and counts + 1 each iteration) over 3 iterations:
    positions 1e-5, force 1e-4, diagnostics 1e-4."""
    rb_j, rb_t, rng_t = _rigid_pair(kind)
    rng_j = np.random.default_rng(0)
    jpbf.create_rigid_body(jpbf.RigidSpec(kind=kind, **_RIGID[kind]), rng_j)
    assert rng_t.random() == rng_j.random()
    np.testing.assert_array_equal(rb_t.xyz.numpy(), _np(rb_j.xyz))
    assert rb_t.spec_kind == rb_j.spec_kind
    np.testing.assert_array_equal(rb_t.half_extent.numpy(), _np(rb_j.half_extent))

    pj, pt = _params(jpbf.PBFParams), _params(tpbf.PBFParams)
    st_j, st_t = _mk_state(300, 384, seed=5, spread=2.0)
    inside = tpbf.inside_rigid_body(rb_t, st_t.estimate_xyz) & st_t.alive
    np.testing.assert_array_equal(inside.numpy(),
                                  _np(jpbf.inside_rigid_body(rb_j, st_j.estimate_xyz) & st_j.alive))
    assert int(inside.sum()) >= 5
    pushed_j = jpbf.project_rigid_constraints(st_j, rb_j, pj)
    pushed_t = tpbf.project_rigid_constraints(st_t, rb_t, pt)
    np.testing.assert_array_equal(pushed_t.estimate_xyz.numpy(), _np(pushed_j.estimate_xyz))
    assert int((pushed_t.estimate_xyz != st_t.estimate_xyz).any(-1).sum()) > 0

    st_j = st_j._replace(counts=jnp.zeros_like(st_j.counts))
    st_t = st_t._replace(counts=torch.zeros_like(st_t.counts))
    ref, ref_d = jpbf.solver_loop(st_j, pj, 3, rigid=rb_j)
    got, got_d = tpbf.solver_loop(st_t, pt, 3, rigid=rb_t)
    _close_states(got, ref)
    _close_diags(got_d, ref_d)
    assert got_d["p_ratio"].shape == (3,)


def test_solver_loop_without_a_body_matches_jax():
    """``solver_loop`` without a body: one grid a tick, counts + 1 after each
    projection."""
    pj, pt = _params(jpbf.PBFParams), _params(tpbf.PBFParams)
    st_j, st_t = _mk_state(300, 384, seed=6, spread=1.5)
    ref, ref_d = jpbf.solver_loop(st_j, pj, 2)
    got, got_d = tpbf.solver_loop(st_t, pt, 2)
    _close_states(got, ref, pos_tol=1e-4, force_tol=1e-3)
    _close_diags(got_d, ref_d)


# ----------------------------- the visual splat ------------------------------


def test_update_visual_matches_jax():
    """``splat_velocity_to_points`` (the dense splat) and ``update_visual``
    against the JAX padded path, where ``knn_k`` covers every neighbourhood:
    1e-5; dead queries keep their positions."""
    pj, pt = _params(jpbf.PBFParams, knn_k=128), _params(tpbf.PBFParams, knn_k=128)
    st_j, st_t = _mk_state(250, 256, seed=9, spread=2.0)
    rng = np.random.default_rng(9)
    q = (rng.uniform(-2.5, 2.5, (200, 3)) + np.array([32.0, 10.0, -30.0])).astype(np.float32)
    vis_j = j_make_visual_state(256, jnp.asarray(q))
    vis_j = vis_j._replace(alive=vis_j.alive.at[:10].set(False))
    vis_t = convert.visual_state_from_numpy(vis_j, device=CPU)
    ref = jpbf.splat_velocity_to_points(vis_j.xyz, vis_j.alive, st_j, pj, dense=False)
    got = tpbf.splat_velocity_to_points(vis_t.xyz, vis_t.alive, st_t, pt)
    live = vis_t.alive.numpy()
    np.testing.assert_allclose(got.numpy()[live], _np(ref)[live], rtol=1e-5, atol=1e-5)
    ref_v = jpbf.update_visual(vis_j, st_j, pj)
    got_v = tpbf.update_visual(vis_t, st_t, pt)
    np.testing.assert_allclose(got_v.xyz.numpy(), _np(ref_v.xyz), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_v.xyz.numpy()[:10], q[:10])
    assert float(np.abs(got_v.xyz.numpy()[:200] - q)[10:].max()) > 1e-3


def test_rigid_visual_push_out_matches_jax():
    rb_j, rb_t, _ = _rigid_pair("cylinder")
    rng = np.random.default_rng(10)
    q = (rng.uniform(-1.5, 1.5, (200, 3)) + np.array([32.0, 10.0, -30.0])).astype(np.float32)
    vis_j = j_make_visual_state(256, jnp.asarray(q))
    ref = jpbf.project_rigid_constraints_visual(vis_j, rb_j, _params(jpbf.PBFParams))
    got = tpbf.project_rigid_constraints_visual(convert.visual_state_from_numpy(vis_j, CPU), rb_t,
                                                _params(tpbf.PBFParams))
    assert int((got.xyz.numpy()[:200] != q).any(-1).sum()) > 0
    np.testing.assert_array_equal(got.xyz.numpy(), _np(ref.xyz))
