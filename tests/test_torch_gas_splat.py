"""Phase C's pair sums in the port against the JAX package, on the CPU:
``bin_queries`` and the two differentiable sums ``density_ratio_at`` and
``visual_xyz_from_nn`` (value and gradients) against the JAX package's dense
branch, their gradcheck, and the checks of a passed grid. The kernels' plain
versions against the Pallas kernels are in test_torch_gas_splat_pallas.py.
Inputs are seeded numpy arrays handed to both."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim.state import make_particle_state as j_make_particle_state
from fluidnexus_torch import convert
from fluidnexus_torch.ops import neighbors as tnb
from fluidnexus_torch.sim import pbf as tpbf
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


# ------------------------------- bin_queries --------------------------------


@pytest.mark.parametrize("case", ["inside", "outside_box", "overflow"])
def test_bin_queries_matches_jax(case):
    """The query grid, its query->source ``nbr`` and the source->query
    ``rnbr`` are identical to the JAX package's, with dead queries, queries
    far outside the source box on both sides, and query cells that overflow."""
    rng = np.random.default_rng(4)
    r = 0.7
    x = rng.uniform(0.0, 6.0, (300, 3)).astype(np.float32)
    alive_x = rng.random(300) > 0.1
    y = rng.uniform(-1.0, 7.0, (400, 3)).astype(np.float32)
    alive_y = rng.random(400) > 0.15
    qcells, qcap = 512, 32
    if case == "outside_box":          # past the 1024-cell box and below its origin
        y[:20] += 2000.0
        y[20:40] -= 50.0
        alive_y[:40] = True
    if case == "overflow":             # a full query cell and query cells past the cap
        y[:40] = 3.1 + 0.05 * rng.random((40, 3)).astype(np.float32)
        qcells, qcap = 64, 16
    jg = jnb.build_dense_grid(jnp.asarray(x), r, jnp.asarray(alive_x), 512, 32)
    tg = tnb.build_dense_grid(torch.as_tensor(x), r, torch.as_tensor(alive_x), 512, 32)
    jq, jr = jnb.bin_queries(jg, r, jnp.asarray(y), jnp.asarray(alive_y), qcells, qcap)
    tq, tr = tnb.bin_queries(tg, r, torch.as_tensor(y), torch.as_tensor(alive_y), qcells, qcap)
    if case == "overflow":
        assert int(jq.overflow) > 0
    if case == "outside_box":
        assert int(tq.bxyz.abs().max()) > 100, "no query clipped into a boundary cell"
    ucid = tq.ucid.numpy()
    used = ucid[ucid < tnb._GRID_SENT]
    assert np.all(np.diff(used) > 0) and np.all(np.diff(ucid) >= 0), \
        "the query table's cell ids do not ascend"
    for name in ("bidx", "bmask", "nbr", "prow", "pcol", "ucid", "origin", "overflow"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), _np(getattr(jq, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tq.bxyz.numpy().view(np.uint32), _np(jq.bxyz).view(np.uint32))
    np.testing.assert_array_equal(tr.numpy(), _np(jr))
    assert (tq.nbr.numpy() < 512).any() and (tr.numpy() < qcells).any()


# ------------------ the differentiable sums against the JAX dense branch ------------------


def _params(cls, **kw):
    return cls(h=1.0, knn_k=128, cell_capacity=64, dense_max_cells=512, dense_cell_capacity=32,
               **kw)


def test_density_ratio_at_matches_jax_dense():
    """Value, position gradient and imass gradient against the JAX package's
    ``density_ratio_at(dense=True)``: values to 1e-5, the position gradient to
    atol 2e-5 x its scale and rtol 2e-4 (tests/test_pbf_dense.py:288-296),
    the imass gradient to atol 1e-5 x its scale and rtol 1e-4. Dead particles
    read the self-only density and get no position gradient."""
    rng = np.random.default_rng(7)
    n = 256
    pos = rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[200:] = False
    imass = (0.8 + 0.4 * rng.random(n)).astype(np.float32)
    w = (rng.normal(size=n) * alive).astype(np.float32)
    params_j, params_t = _params(jpbf.PBFParams), _params(tpbf.PBFParams)

    def jloss(p, im):
        r = jpbf.density_ratio_at(p, jnp.asarray(alive), im, params_j, dense=True)
        return jnp.sum(jnp.asarray(w) * (r - 1.0) ** 2), r

    (l_j, r_j), (gp_j, gi_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pos), jnp.asarray(imass))
    p_t = torch.tensor(pos, requires_grad=True)
    i_t = torch.tensor(imass, requires_grad=True)
    r_t = tpbf.density_ratio_at(p_t, torch.as_tensor(alive), i_t, params_t)
    l_t = (torch.as_tensor(w) * (r_t - 1.0) ** 2).sum()
    gp_t, gi_t = torch.autograd.grad(l_t, (p_t, i_t))

    np.testing.assert_allclose(r_t.detach().numpy(), _np(r_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    scale = float(np.abs(_np(gp_j)).max())
    np.testing.assert_allclose(gp_t.numpy()[alive], _np(gp_j)[alive], atol=2e-5 * scale,
                               rtol=2e-4)
    assert not gp_t.numpy()[~alive].any()
    np.testing.assert_allclose(r_t.detach().numpy()[~alive],
                               params_t.poly6_term1 * params_t.h ** 6 / imass[~alive] / 1.5,
                               rtol=1e-6)
    iscale = float(np.abs(_np(gi_j)).max())
    np.testing.assert_allclose(gi_t.numpy(), _np(gi_j), atol=1e-5 * iscale, rtol=1e-4)


def test_visual_xyz_from_nn_matches_jax_dense():
    """Value and nn-gradient of the advection against the JAX package's
    ``visual_xyz_from_nn(dense=True)`` (tests/test_pbf_dense.py:363-373):
    values to 1e-5, the gradient to atol 3e-5 x its scale and rtol 3e-4.
    Dead queries keep their position, dead sources get no gradient."""
    rng = np.random.default_rng(11)
    n, nq = 256, 320
    pos = rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    qpos = rng.uniform(-0.5, 6.5, (nq, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[200:] = False
    q_alive = np.ones(nq, bool)
    q_alive[300:] = False
    params_j, params_t = _params(jpbf.PBFParams), _params(tpbf.PBFParams)
    st_j = j_make_particle_state(n, jnp.asarray(pos), init_velocity_y=10.0)
    st_j = st_j._replace(alive=jnp.asarray(alive))
    st_t = convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), device=CPU)
    nn0 = (pos / params_t.scale_factor + 0.002 * rng.normal(size=(n, 3))).astype(np.float32)
    w = (rng.normal(size=(nq, 3)) * q_alive[:, None]).astype(np.float32)

    def jloss(nn):
        out = jpbf.visual_xyz_from_nn(jnp.asarray(qpos), jnp.asarray(q_alive), nn, st_j, params_j,
                                      dense=True)
        return jnp.sum(jnp.asarray(w) * out), out

    (l_j, o_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(nn0))
    nn_t = torch.tensor(nn0, requires_grad=True)
    o_t = tpbf.visual_xyz_from_nn(torch.as_tensor(qpos), torch.as_tensor(q_alive), nn_t, st_t,
                                  params_t)
    l_t = (torch.as_tensor(w) * o_t).sum()
    (g_t,) = torch.autograd.grad(l_t, nn_t)

    np.testing.assert_allclose(o_t.detach().numpy(), _np(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(o_t.detach().numpy()[~q_alive], qpos[~q_alive])
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-4)
    scale = float(np.abs(_np(g_j)).max())
    np.testing.assert_allclose(g_t.numpy(), _np(g_j), atol=3e-5 * scale, rtol=3e-4)
    assert not g_t.numpy()[~alive].any()


def test_queries_past_a_cells_capacity_stay_still_as_in_the_dense_branch():
    """Forty visual particles on one spot (as emissions at a ratio over 1
    pile up at an emitter) fill one query cell past ``dense_cell_capacity``
    (32). The port bins queries at the splat kernels' 128 slots a cell, so
    all forty move as the JAX package's padded top-K branch (its CPU runs)
    moves them (1e-5), where its dense branch leaves the 8 past 32 still;
    the other 80 queries move as the dense branch moves them, and report no
    drop."""
    rng = np.random.default_rng(12)
    n, nq = 256, 120
    pos = rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    qpos = rng.uniform(0.5, 5.5, (nq, 3)).astype(np.float32)
    qpos[:40] = 3.4
    q_alive = np.ones(nq, bool)
    params_j, params_t = _params(jpbf.PBFParams), _params(tpbf.PBFParams)
    st_j = j_make_particle_state(n, jnp.asarray(pos), init_velocity_y=10.0)
    st_t = convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), device=CPU)
    nn = (pos / params_t.scale_factor + 0.002 * rng.normal(size=(n, 3))).astype(np.float32)
    args = (jnp.asarray(qpos), jnp.asarray(q_alive), jnp.asarray(nn), st_j, params_j)
    dense = _np(jpbf.visual_xyz_from_nn(*args, dense=True))
    top_k = _np(jpbf.visual_xyz_from_nn(*args, dense=False))
    got, dropped = tpbf.visual_xyz_from_nn(torch.as_tensor(qpos), torch.as_tensor(q_alive),
                                           torch.as_tensor(nn), st_t, params_t,
                                           return_dropped=True)
    got = got.numpy()
    still, still_k = np.all(got == qpos, axis=1), np.all(top_k == qpos, axis=1)
    assert int(np.all(dense[:40] == qpos[:40], axis=1).sum()) == 8, "JAX's dense branch changed"
    assert int(dropped) == 0 and not still[:40].any()
    np.testing.assert_allclose(got[:40], top_k[:40], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:40], np.broadcast_to(got[0], (40, 3)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(still[40:], still_k[40:])     # no source in reach
    np.testing.assert_allclose(got[40:], dense[40:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[~still], top_k[~still], rtol=1e-5, atol=1e-5)


def _piled_visual(rng, n_pile):
    """A hidden cloud of 256 with random velocities and estimates 0.1 past
    their positions, ``n_pile`` visual particles jittered within 0.02 of one
    spot inside it (one cell of h = 1), and 40 spread around, in a visual
    state of ``n_pile + 64`` slots; the fitted positions ``nn`` near the
    cloud. Returns (JAX state, port state, JAX visual state, port visual
    state, nn)."""
    from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state

    pos = rng.uniform(0.0, 6.0, (256, 3)).astype(np.float32)
    st_j = j_make_particle_state(256, jnp.asarray(pos))
    st_j = st_j._replace(estimate_xyz=st_j.xyz + 0.1,
                         velocity=jnp.asarray(rng.normal(0.0, 10.0, (256, 3)).astype(np.float32)))
    st = convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), device=CPU)
    vis = np.concatenate([3.4 + rng.uniform(-0.02, 0.02, (n_pile, 3)),
                          rng.uniform(0.5, 5.5, (40, 3))]).astype(np.float32)
    vis_j = j_make_visual_state(n_pile + 64, jnp.asarray(vis))
    vis_t = convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), device=CPU)
    nn = (pos / 100.0 + 0.002 * rng.normal(size=(256, 3))).astype(np.float32)
    return st_j, st, vis_j, vis_t, nn


def _in_radius_max(src, qry, h):
    """The most sources within h of any query, and the most sources in one
    cell of edge h: what JAX's padded top-K branch keeps (knn_k, and its
    grid's cell_capacity)."""
    d2 = ((qry[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    cells = np.unique(np.floor(src / h).astype(np.int64), axis=0, return_counts=True)[1]
    return int((d2 <= h * h).sum(1).max()), int(cells.max())


def test_a_pile_past_the_kernels_slots_leaves_its_tail_still_and_reports_it():
    """300 visual particles piled in one cell, more than the 128 a cell that
    the kernels once held (the test's name is from then): every one of them
    moves, and none is reported dropped, through ``visual_xyz_from_nn``,
    ``update_visual`` and the phase-C commit, as the JAX package's CPU
    (top-K) branch moves them (1e-5), and ``warn_capacity_overflow`` reports
    nothing even under --strict_capacity. The sources in reach of any query
    number under ``knn_k`` and JAX's ``cell_capacity``, so that branch is
    exact."""
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain

    params_j, params = _params(jpbf.PBFParams), _params(tpbf.PBFParams)
    st_j, st, vis_j, vis, nn = _piled_visual(np.random.default_rng(13), 300)
    live = np.asarray(vis_j.alive)
    vx = np.asarray(vis_j.xyz)
    for src in (nn * params.scale_factor, np.asarray(st_j.estimate_xyz)):
        reach, per_cell = _in_radius_max(src, vx[live], params.h)
        assert reach < min(params.knn_k, 100) and per_cell < params.cell_capacity
    want = _np(jpbf.visual_xyz_from_nn(vis_j.xyz, vis_j.alive, jnp.asarray(nn), st_j, params_j,
                                       dense=False))
    delta = _np(jpbf.splat_velocity_to_points(vis_j.xyz, vis_j.alive, st_j, params_j,
                                              dense=False))
    want_u = np.where(live[:, None], vx + delta, vx)

    moved, dropped = tpbf.visual_xyz_from_nn(vis.xyz, vis.alive, torch.as_tensor(nn), st, params,
                                             return_dropped=True)
    vis2, dropped2 = tpbf.update_visual(vis, st, params, return_dropped=True)
    _, vis3, dropped3 = ttrain.commit_frame(params, st, vis, torch.as_tensor(nn))
    for got, ref, n_dropped in ((moved, want, dropped), (vis2.xyz, want_u, dropped2),
                                (vis3.xyz, want, dropped3)):
        got = got.numpy()
        assert int(n_dropped) == 0
        assert not np.all(got[:300] == vx[:300], axis=1).any(), "a piled particle stayed still"
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5, atol=1e-5)
    logs = []
    assert tpbf.warn_capacity_overflow({"overflow": dropped3}, "frame 1 advection", strict=True,
                                       log=logs.append, what=tpbf.QUERY_DROPS) == 0
    assert logs == []


def test_a_future_frame_reports_the_piles_drops_and_strict_raises(tmp_path, monkeypatch):
    """``predict`` from a checkpoint whose 140 visual particles sit on one
    spot inside the hidden cloud, and 100 more on a line in z past it, one
    to a cell of h, with ``dense_max_cells`` cut to 64: the pile's cell comes
    first of the query list's rows, so all 140 move and none is dropped, and
    the frame's dict and its log report only the 37 of the line in cells
    past the 64th (63 after the pile's), as a capacity overflow;
    --strict_capacity raises on them."""
    import dataclasses

    from fluidnexus_torch.core.config import Config
    from fluidnexus_torch.data.cameras import Camera
    from fluidnexus_torch.data.readers import SceneInfo
    from fluidnexus_torch.pipelines import future_simulation as tfuture
    from fluidnexus_torch.pipelines.train_physical_particle import pbf_params_from_config
    from fluidnexus_torch.sim.state import make_particle_state, make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, save_hidden, save_visual

    cfg = Config()
    o, m = cfg.optim, cfg.model
    m.load_path = str(tmp_path / "recon")
    m.hidden_capacity = m.visual_capacity = 2048   # over the future emitters' padded plans
    o.future_pred_frames, o.solver_iterations_future = 1, 2
    o.H, o.emit_ratio_hidden, o.emit_ratio_visual = 2.0, 0.0, 0.0
    monkeypatch.setattr(tfuture, "pbf_params_from_config", lambda c: dataclasses.replace(
        pbf_params_from_config(c), dense_max_cells=64))
    params = tfuture.pbf_params_from_config(cfg)
    rng = np.random.default_rng(14)
    base = np.array([0.326, 0.05, -0.3], np.float32) * 100
    st = make_particle_state(2048, (rng.uniform(-3, 3, (300, 3)) + base).astype(np.float32),
                             init_velocity_y=50.0, device="cpu")
    save_hidden(st._replace(estimate_xyz=st.xyz), params, os.path.join(m.load_path, "checkpoint"), 1)
    line = base + 0.3 + np.array([0.0, 0.0, 4.0], np.float32) * np.arange(1, 101)[:, None]
    vis = make_visual_state(2048, np.concatenate([np.broadcast_to(base + 0.3, (140, 3)), line]
                                                 ).astype(np.float32), device="cpu")
    save_visual(vis, constant_visual_attrs(2048, 1, device="cpu"),
                os.path.join(m.load_path, "checkpoint"), 1)
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cams = [Camera(uid=t, R=R, T=-R.T @ np.array([0.326, 0.05, 1.7]), fovx=0.7, fovy=0.55,
                   width=32, height=24, image_name="train00", time_idx=t) for t in range(2)]
    scene = SceneInfo(point_cloud=None, train_cameras=cams, test_cameras=[],
                      nerf_normalization={"radius": 2.0, "translate": np.zeros(3)})
    advected = []
    update_visual = tfuture.update_visual

    def recording(visual, *a, **kw):
        out = update_visual(visual, *a, **kw)
        advected.append((visual.xyz.clone(), out[0].xyz.clone()))
        return out

    monkeypatch.setattr(tfuture, "update_visual", recording)
    logs = []
    frames = tfuture.predict(cfg, scene_info=scene, log=logs.append, save_renders=False,
                             device="cpu")
    assert frames[0]["query_drops"] == 37 and frames[0]["visual"] == 240
    before, after = advected[0]
    assert not torch.all(before[:140] == after[:140], dim=1).any(), "a piled particle stayed still"
    assert [line for line in logs if "capacity overflow" in line] == [
        "[capacity overflow] future 0 advection: " + tpbf.QUERY_DROPS.format(n=37)]
    cfg.strict_capacity = True
    with pytest.raises(RuntimeError, match="strict_capacity"):
        tfuture.predict(cfg, scene_info=scene, log=logs.append, save_renders=False, device="cpu")


def test_shared_grid_matches_the_internal_build():
    """A pre-built grid at the same positions gives the same values and
    gradients, bit for bit, as the build inside each sum (the phase-C step
    shares one)."""
    rng = np.random.default_rng(5)
    n = 200
    params = tpbf.PBFParams(h=1.0, dense_max_cells=512, dense_cell_capacity=32, scale_factor=1.0)
    state = convert.particle_state_from_numpy(jax.tree.map(np.asarray, j_make_particle_state(
        n, jnp.asarray(rng.uniform(0, 5, (n, 3)).astype(np.float32)))), device=CPU)
    vx = torch.as_tensor(rng.uniform(0, 5, (150, 3)).astype(np.float32))
    va = torch.ones(150, dtype=torch.bool)

    def run(shared):
        nn = (state.xyz + 0.01).clone().requires_grad_(True)
        grid = (tnb.build_dense_grid(nn.detach(), params.h, state.alive, 512, 32)
                if shared else None)
        adv = tpbf.visual_xyz_from_nn(vx, va, nn, state, params, grid=grid)
        r = tpbf.density_ratio_at(nn, state.alive, state.imass, params, grid=grid)
        loss = adv.square().sum() + ((r - 1.0) ** 2).sum()
        return loss, torch.autograd.grad(loss, nn)[0]

    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1) and torch.equal(g0, g1)


def test_a_passed_grid_is_checked():
    """A pre-built grid must be a DenseGrid with the params' caps and one
    ``prow`` entry per position; anything else raises ValueError."""
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(rng.uniform(0, 4, (100, 3)).astype(np.float32))
    alive = torch.ones(100, dtype=torch.bool)
    params = tpbf.PBFParams(h=1.0, dense_max_cells=256, dense_cell_capacity=32, scale_factor=1.0)
    state = convert.particle_state_from_numpy(jax.tree.map(
        np.asarray, j_make_particle_state(100, jnp.asarray(pos.numpy()))), device=CPU)
    good = tnb.build_dense_grid(pos, 1.0, alive, 256, 32)
    bad = {"cells": tnb.build_dense_grid(pos, 1.0, alive, 512, 32),
           "capacity": tnb.build_dense_grid(pos, 1.0, alive, 256, 16),
           "points": tnb.build_dense_grid(pos[:90], 1.0, alive[:90], 256, 32),
           "type": tuple(good)}
    tpbf.density_ratio_at(pos, alive, state.imass, params, grid=good)
    for name, grid in bad.items():
        with pytest.raises(ValueError):
            tpbf.density_ratio_at(pos, alive, state.imass, params, grid=grid)
        with pytest.raises(ValueError):
            tpbf.visual_xyz_from_nn(pos, alive, pos, state, params, grid=grid)


def test_gradcheck_of_both_functions_in_float64():
    """torch.autograd.gradcheck of the density ratio (positions and imass)
    and of the advection (nn) in float64, on a few dozen points."""
    rng = np.random.default_rng(9)
    n = 24
    params = tpbf.PBFParams(h=1.0, dense_max_cells=64, dense_cell_capacity=32, scale_factor=1.0)
    pos = torch.tensor(rng.uniform(0, 1.6, (n, 3)), dtype=torch.float64, requires_grad=True)
    imass = torch.tensor(0.8 + 0.4 * rng.random(n), dtype=torch.float64, requires_grad=True)
    alive = torch.as_tensor(rng.random(n) > 0.1)
    assert torch.autograd.gradcheck(
        lambda p, im: tpbf.density_ratio_at(p, alive, im, params), (pos, imass), eps=1e-6,
        atol=1e-7, rtol=1e-5)

    xyz = torch.tensor(rng.uniform(0, 1.6, (n, 3)), dtype=torch.float64)
    state = tpbf.ParticleState(
        xyz=xyz, estimate_xyz=xyz, velocity=torch.zeros_like(xyz), force=torch.zeros_like(xyz),
        buoyancy=torch.zeros_like(xyz), imass=torch.ones(n, dtype=torch.float64),
        counts=torch.zeros(n, dtype=torch.float64), particle_id=torch.arange(n, dtype=torch.int32),
        alive=alive, next_id=torch.tensor(n, dtype=torch.int32))
    vx = torch.tensor(rng.uniform(0, 1.6, (30, 3)), dtype=torch.float64)
    va = torch.as_tensor(rng.random(30) > 0.1)
    nn = (xyz + 0.05 * torch.tensor(rng.normal(size=(n, 3)))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: tpbf.visual_xyz_from_nn(vx, va, x, state, params), (nn,), eps=1e-6, atol=1e-7,
        rtol=1e-5)


def test_gradcheck_of_the_advection_at_a_pile_in_float64():
    """torch.autograd.gradcheck of ``_SplatDelta`` (through
    ``visual_xyz_from_nn``) in float64 with 150 queries piled in one cell of
    h, past the 128 a cell that the kernels once held: the adjoint walks the
    pile's whole list."""
    rng = np.random.default_rng(10)
    n = 24
    params = tpbf.PBFParams(h=1.0, dense_max_cells=64, dense_cell_capacity=32, scale_factor=1.0)
    xyz = torch.tensor(rng.uniform(0, 1.6, (n, 3)), dtype=torch.float64)
    alive = torch.ones(n, dtype=torch.bool)
    state = tpbf.ParticleState(
        xyz=xyz, estimate_xyz=xyz, velocity=torch.zeros_like(xyz), force=torch.zeros_like(xyz),
        buoyancy=torch.zeros_like(xyz), imass=torch.ones(n, dtype=torch.float64),
        counts=torch.zeros(n, dtype=torch.float64), particle_id=torch.arange(n, dtype=torch.int32),
        alive=alive, next_id=torch.tensor(n, dtype=torch.int32))
    vx = torch.tensor(np.concatenate([0.5 + rng.uniform(0.0, 0.4, (150, 3)),
                                      rng.uniform(0, 1.6, (20, 3))]), dtype=torch.float64)
    va = torch.ones(170, dtype=torch.bool)
    nn = (xyz + 0.05 * torch.tensor(rng.normal(size=(n, 3)))).requires_grad_(True)
    ql = tnb.sort_queries(tnb.build_dense_grid(nn.detach(), 1.0, alive, 64, 32), 1.0, vx, va, 64)
    assert int(ql.cnt.max()) >= 150 and int(ql.overflow) == 0
    assert torch.autograd.gradcheck(
        lambda x: tpbf.visual_xyz_from_nn(vx, va, x, state, params), (nn,), eps=1e-6, atol=1e-7,
        rtol=1e-5)


@pytest.mark.parametrize("case", ["inside", "outside_box", "past_max_cells", "pile"])
def test_sort_queries_matches_bin_queries_live_slots(case):
    """``sort_queries`` against ``bin_queries`` on the same source grid, row
    by row and bit for bit wherever no cell exceeds ``bin_queries``' slots:
    each row's count and points (lowest index first), their cell-relative
    coordinates, both joins, the point -> row map and the point -> entry map
    (start + slot), with dead queries, queries clipped into the box's
    boundary cells and query cells past ``max_cells`` (their queries counted
    in ``overflow`` by both). With a pile of 70 in one cell at 32 slots, the
    list holds all 70 in that row, in point order, and counts none of them."""
    rng = np.random.default_rng(21)
    r = 0.7
    x = torch.as_tensor(rng.uniform(0.0, 6.0, (300, 3)).astype(np.float32))
    alive_x = torch.as_tensor(rng.random(300) > 0.1)
    y = rng.uniform(-1.0, 7.0, (400, 3)).astype(np.float32)
    alive_y = rng.random(400) > 0.15
    qcells, qcap = 512, 128
    if case == "outside_box":
        y[:20] += 2000.0
        y[20:40] -= 50.0
        alive_y[:40] = True
    if case == "past_max_cells":
        qcells = 64
    if case == "pile":
        y[:70] = 3.1 + 0.05 * rng.random((70, 3)).astype(np.float32)
        alive_y[:70] = True
        qcap = 32
    y, alive_y = torch.as_tensor(y), torch.as_tensor(alive_y)
    grid = tnb.build_dense_grid(x, r, alive_x, 512, 32)
    qg, rnbr = tnb.bin_queries(grid, r, y, alive_y, qcells, qcap)
    ql = tnb.sort_queries(grid, r, y, alive_y, qcells)
    assert torch.equal(ql.nbr, qg.nbr) and torch.equal(ql.rnbr, rnbr)
    cnt = qg.bmask.sum(1).to(torch.int32)
    full = cnt == qcap
    assert int(ql.cnt[-1]) == 0 and torch.equal(ql.cnt[~full], cnt[~full])
    assert torch.equal(ql.start, torch.cumsum(ql.cnt, 0, dtype=torch.int32) - ql.cnt)
    for h in range(qcells):
        c, s = int(ql.cnt[h]), int(ql.start[h])
        k = min(c, qcap)
        assert torch.equal(ql.order[s:s + k].to(torch.int32), qg.bidx[h, :k])
        assert bool((ql.order[s:s + c].diff() > 0).all())
        for a, plane in enumerate((ql.x, ql.y, ql.z)):
            assert torch.equal(plane[s:s + k].view(torch.int32),
                               qg.bxyz[h, :k, a].contiguous().view(torch.int32))
    kept = qg.prow < qcells
    assert torch.equal(ql.prow[kept], qg.prow[kept])
    assert torch.equal(ql.pos[kept], ql.start[qg.prow[kept].long()].long() + qg.pcol[kept].long())
    assert torch.equal(ql.order[ql.pos[kept]], torch.nonzero(kept).flatten())
    past = int((alive_y & (ql.prow == qcells)).sum())
    assert int(ql.overflow) == past and torch.equal(ql.pos[ql.prow == qcells],
                                                    torch.full((int((ql.prow == qcells).sum()),), 400))
    if case == "past_max_cells":
        assert past > 0 and int(qg.overflow) == past
    elif case == "pile":
        row = int(ql.prow[0])
        assert int(ql.cnt[row]) == 70 and int(qg.overflow) == 70 - qcap and past == 0
        assert ql.order[int(ql.start[row]):int(ql.start[row]) + 70].tolist() == list(range(70))
    else:
        assert past == 0 and int(qg.overflow) == 0
