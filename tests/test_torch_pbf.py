"""The PBF tick's modules in the port against the JAX package, on the CPU:
the dense grid, the two pair passes (plain versions) against the generic XLA
body and the v3 Pallas kernels, ``project_iterations_dense``, and the
point-wise solver steps. Inputs are seeded numpy arrays handed to both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim import pbf_dense as jdense
from fluidnexus_tpu.sim import pbf_pallas as jpallas
from fluidnexus_tpu.sim.state import make_particle_state as j_make_particle_state
from fluidnexus_torch import convert
from fluidnexus_torch.ops import neighbors as tnb
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda
from fluidnexus_torch.sim.pbf_dense import project_iterations_dense

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _params(cls, **kw):
    return cls(h=1.0, p0=1.5, k=3.0, secs=0.033, knn_k=100, **kw)


def _mk_state(n_live, capacity, seed=0, center=(32.0, 10.0, -30.0), spread=2.0):
    """tests/test_pbf_dense.py's state, with a random inverse mass."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-spread, spread, (n_live, 3)).astype(np.float32)
           + np.asarray(center, np.float32))
    st = j_make_particle_state(capacity, jnp.asarray(pts), init_velocity_y=10.0)
    st = st._replace(
        estimate_xyz=st.xyz + 0.01 * rng.standard_normal((capacity, 3)).astype(np.float32),
        velocity=jnp.asarray(rng.standard_normal((capacity, 3)).astype(np.float32)),
        counts=jnp.full((capacity,), 3.0),
        imass=jnp.asarray((0.8 + 0.4 * rng.random(capacity)).astype(np.float32)),
    )
    return st, convert.particle_state_from_numpy(st, device=CPU)


# ------------------------------- dense grid ---------------------------------


@pytest.mark.parametrize("case", ["roomy", "full_cell", "cells_past_cap"])
def test_build_dense_grid_matches_jax(case):
    rng = np.random.default_rng(3)
    n, r = 600, 0.7
    x = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    max_cells, cap = 512, 32
    if case == "full_cell":       # 50 points in one cell of capacity 32
        x[:50] = 0.3 + 0.01 * rng.random((50, 3)).astype(np.float32)
    if case == "cells_past_cap":  # more occupied cells than rows
        max_cells = 64
    alive = rng.random(n) > 0.2   # dead points anywhere
    jg = jnb.build_dense_grid(jnp.asarray(x), r, jnp.asarray(alive), max_cells, cap)
    tg = tnb.build_dense_grid(torch.as_tensor(x), r, torch.as_tensor(alive), max_cells, cap)
    if case != "roomy":
        assert int(jg.overflow) > 0
    for name in ("bidx", "bmask", "nbr", "prow", "pcol", "ucid", "origin", "overflow"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), _np(getattr(jg, name)),
                                      err_msg=name)
    # the cell-relative coordinates bit for bit
    np.testing.assert_array_equal(tg.bxyz.numpy().view(np.uint32), _np(jg.bxyz).view(np.uint32))


def test_slot_point_gather_round_trip():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(0, 5, (300, 3)).astype(np.float32))
    alive = torch.arange(300) < 250
    grid = tnb.build_dense_grid(x, 0.7, alive, 256, 64)
    assert int(grid.overflow) == 0
    assert sorted(grid.bidx[grid.bmask].tolist()) == list(range(250))
    f = torch.stack([torch.arange(300.0), -torch.arange(300.0)], -1)
    slots = tnb.slot_gather(grid, f, fill=7.0)
    assert slots.shape == (257, 64, 2) and bool((slots[~grid.bmask] == 7.0).all())
    back = tnb.point_gather(grid, slots)
    torch.testing.assert_close(back[:250], f[:250], rtol=0, atol=0)
    assert bool((grid.prow[250:] == 256).all())   # dead points read row C


# ------------------------------ pair passes ---------------------------------


def _pair_inputs(seed=0, n_live=400, capacity=512, spread=2.0, caps=(512, 32)):
    params_j = _params(jpbf.PBFParams, dense_max_cells=caps[0], dense_cell_capacity=caps[1])
    params_t = _params(tpbf.PBFParams, dense_max_cells=caps[0], dense_cell_capacity=caps[1])
    st_j, st_t = _mk_state(n_live, capacity, seed=seed, spread=spread)
    jg = jnb.build_dense_grid(st_j.estimate_xyz, params_j.h, st_j.alive, *caps)
    tg = convert.dense_grid_from_numpy(jg, device=CPU)
    return params_j, params_t, st_j, st_t, jg, tg


def _live(tg):
    return tg.bmask[:-1].numpy()


def test_pair_passes_match_the_jax_xla_body():
    """phase1_plain/phase2_plain on the JAX grid against the per-slot
    quantities of the JAX generic body (_project_core, backend 'xla') on live
    slots, rtol/atol 1e-5, and the four global sums."""
    params_j, params_t, st_j, st_t, jg, tg = _pair_inputs()
    mc = jg.bmask[:-1]
    ic = jnb.slot_gather(jg, jnp.stack([st_j.imass, st_j.counts], -1))[:-1]
    imass_j = jnp.where(mc, ic[..., 0], 1.0)
    (delta, pi, _, lam, nlen, s_p6, s_edges, s_corr, s_ns) = jdense._project_core(
        jg, params_j, "xla", jpallas._planes(jg), imass_j, ic[..., 1])

    k = pbf_cuda.pair_consts(params_t)
    cnt, x, y, z = pbf_cuda.planes(tg)
    imass_t = torch.ones_like(x)
    imass_t[:-1] = _t(imass_j)
    live = _live(tg)
    assert live.sum() == 400 and int(tg.overflow) == 0
    t_lam, t_pi, t_nl, t_p6, t_edges = pbf_cuda.phase1_plain(tg.nbr, cnt, x, y, z, imass_t, k)
    np.testing.assert_allclose(t_lam[:-1].numpy()[live], _np(lam)[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((t_pi / imass_t)[:-1].numpy()[live], _np(pi)[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_nl[:-1].numpy()[live], _np(nlen)[live])
    np.testing.assert_allclose(float(t_p6), float(s_p6), rtol=1e-5)
    assert float(t_edges) == float(s_edges)
    assert not t_lam[:-1].numpy()[~live].any() and not t_lam[-1].any()

    # phase 2 on JAX's lambda, so its inputs are the same as the body's
    lam_in = torch.zeros_like(x)
    lam_in[:-1] = torch.where(tg.bmask[:-1], _t(lam), 0.0)
    nc = torch.zeros_like(x)
    nc[:-1] = _t(nlen + ic[..., 1])
    *new, t_corr, t_ns = pbf_cuda.phase2_plain(tg.nbr, cnt, x, y, z, lam_in, nc, k)
    for a, (n, o) in enumerate(zip(new, (x, y, z))):
        np.testing.assert_allclose((n - o)[:-1].numpy()[live], _np(delta)[..., a][live],
                                   rtol=1e-5, atol=1e-5)
        # phase 2 returns coordinates: dead slots and row C keep theirs
        np.testing.assert_array_equal(n[:-1].numpy()[~live], o[:-1].numpy()[~live])
        np.testing.assert_array_equal(n[-1].numpy(), o[-1].numpy())
    np.testing.assert_allclose(float(t_corr), float(s_corr), rtol=1e-5)
    assert float(t_ns) == float(s_ns)


def test_pair_passes_match_the_v3_pallas_kernels():
    """phase1_plain/phase2_plain against phase1_slots_v3/phase2_slots_v3 in
    interpret mode on an 8-cell x 8-slot grid: live slots and the global sums
    (raw dead-slot outputs depend on the Pallas STRIP)."""
    caps = (8, 8)
    params_j, params_t, st_j, st_t, jg, tg = _pair_inputs(
        seed=11, n_live=40, capacity=64, spread=0.6, caps=caps)
    c, m = caps
    mc = jg.bmask[:-1]
    cnt_j, _, sent = jpallas._planes(jg)
    grouped = jpallas.cells_to_grouped
    xg = [grouped(jnp.where(mc, jg.bxyz[:-1, :, a], sent[:-1])) for a in range(3)]
    ic = jnb.slot_gather(jg, jnp.stack([st_j.imass, st_j.counts], -1))[:-1]
    img = jnp.where(grouped(mc), grouped(ic[..., 0]), 1.0)
    planes_j = tuple(jnp.where(jg.bmask, jg.bxyz[..., a], sent) for a in range(3))
    k = pbf_cuda.pair_consts(params_t)
    lam_g, pi_g, nl_g, s_p6, s_edges = jpallas.phase1_slots_v3(
        jg, k.h, k.eps, k.c6, k.s45, k.inv_p0, k.relax, *xg, img, (cnt_j,) + planes_j)
    lam_pad = jnp.concatenate([jpallas.grouped_to_cells(lam_g, c), jnp.zeros((1, m))], 0)
    nc_g = nl_g + grouped(ic[..., 1])
    *new_g, s_corr, s_ns = jpallas.phase2_slots_v3(
        jg, k.h, k.eps, k.c6, k.s45, k.k_p, k.e_p, k.inv_denom, k.inv_p0, *xg, lam_g, nc_g,
        (cnt_j,) + planes_j + (lam_pad,))

    def cells(a):
        return _np(jpallas.grouped_to_cells(a, c))

    cnt, x, y, z = pbf_cuda.planes(tg)
    imass_t = torch.ones_like(x)
    imass_t[:-1] = _t(jpallas.grouped_to_cells(img, c))
    live = _live(tg)
    assert live.sum() > 30 and int((tg.nbr < c).sum()) >= 8 * 8   # 2 x 2 x 2 cells, all live
    t_lam, t_pi, t_nl, t_p6, t_edges = pbf_cuda.phase1_plain(tg.nbr, cnt, x, y, z, imass_t, k)
    for got, ref in ((t_lam, lam_g), (t_pi, pi_g), (t_nl, nl_g)):
        np.testing.assert_allclose(got[:-1].numpy()[live], cells(ref)[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(t_p6), float(t_edges)], [float(s_p6), float(s_edges)],
                               rtol=1e-5)
    nc = torch.zeros_like(x)
    nc[:-1] = _t(cells(nc_g))
    *new, t_corr, t_ns = pbf_cuda.phase2_plain(tg.nbr, cnt, x, y, z, _t(lam_pad) * tg.bmask,
                                               nc, k)
    for n, ref in zip(new, new_g):
        np.testing.assert_allclose(n[:-1].numpy()[live], cells(ref)[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(t_corr), float(t_ns)], [float(s_corr), float(s_ns)],
                               rtol=1e-5)


# -------------------------------- the tick ----------------------------------


@pytest.mark.parametrize("counts_step", [0.0, 1.0])
def test_project_iterations_dense_matches_jax(counts_step):
    params_j = _params(jpbf.PBFParams, dense_max_cells=512, dense_cell_capacity=64)
    params_t = _params(tpbf.PBFParams, dense_max_cells=512, dense_cell_capacity=64)
    st_j, st_t = _mk_state(400, 512, seed=1, spread=2.0)
    ref, ref_d = jdense.project_iterations_dense(st_j, params_j, 4, backend="xla",
                                                 counts_step=counts_step)
    got, got_d = project_iterations_dense(st_t, params_t, 4, counts_step=counts_step)
    np.testing.assert_allclose(got.estimate_xyz.numpy(), _np(ref.estimate_xyz), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.force.numpy(), _np(ref.force), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.counts.numpy(), _np(ref.counts))
    assert set(got_d) == set(ref_d)
    for key in ref_d:
        assert got_d[key].shape == (4,), key
        np.testing.assert_allclose(got_d[key].numpy(), _np(ref_d[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    dead = ~st_t.alive.numpy()
    np.testing.assert_array_equal(got.estimate_xyz.numpy()[dead], st_t.estimate_xyz.numpy()[dead])
    np.testing.assert_array_equal(got.force.numpy()[dead], 0.0)


# ------------------------------ point-wise steps ----------------------------


@pytest.mark.parametrize("stable,use_wind,max_y", [(True, False, 0.0), (False, False, 0.0),
                                                    (False, True, 0.5), (True, True, 0.0)])
def test_guess_hidden_matches_jax(stable, use_wind, max_y):
    kw = dict(alpha=-0.2, buoyancy_max_y=max_y, buoyancy_decay_rate=0.5 if use_wind else 0.0,
              wind_force=(3.0, 0.5, 1.0), wind_power=1.5)
    st_j, st_t = _mk_state(300, 384, seed=2)
    rng = np.random.default_rng(5)
    force = rng.standard_normal((384, 3)).astype(np.float32)
    st_j = st_j._replace(force=jnp.asarray(force))
    st_t = st_t._replace(force=torch.as_tensor(force))
    ref = jpbf.guess_hidden(st_j, _params(jpbf.PBFParams, **kw), stable=stable, use_wind=use_wind)
    got = tpbf.guess_hidden(st_t, _params(tpbf.PBFParams, **kw), stable=stable, use_wind=use_wind)
    for name in ("velocity", "buoyancy", "force", "estimate_xyz", "counts"):
        np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_confirm_guess_and_remove_invalid_match_jax():
    params_j = dataclasses.replace(_params(jpbf.PBFParams), min_neighbors=3, h=0.9)
    params_t = dataclasses.replace(_params(tpbf.PBFParams), min_neighbors=3, h=0.9)
    st_j, st_t = _mk_state(300, 384, seed=4, spread=3.0)
    # a few estimates that do not move (the epsilon branch)
    est = _np(st_j.estimate_xyz).copy()
    est[:10] = _np(st_j.xyz)[:10]
    st_j = st_j._replace(estimate_xyz=jnp.asarray(est))
    st_t = st_t._replace(estimate_xyz=torch.as_tensor(est))
    ref = jpbf.confirm_guess(st_j, params_j)
    got = tpbf.confirm_guess(st_t, params_t)
    for name in ("xyz", "velocity"):
        np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
    assert not got.velocity[:10].any()
    ref_r = jpbf.remove_invalid(ref, params_j)
    got_r = tpbf.remove_invalid(got, params_t)
    assert 0 < int(got_r.alive.sum()) < int(got.alive.sum())
    np.testing.assert_array_equal(got_r.alive.numpy(), _np(ref_r.alive))
