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


def _piled_visual(rng, n_pile, params):
    """A hidden cloud with a velocity and ``n_pile`` visual particles on one
    spot inside it, plus 40 spread around: (ParticleState, VisualState, nn)."""
    from fluidnexus_torch.sim.state import make_particle_state, make_visual_state

    pos = rng.uniform(0.0, 6.0, (256, 3)).astype(np.float32)
    st = make_particle_state(256, pos, init_velocity_y=10.0, device="cpu")
    st = st._replace(estimate_xyz=st.xyz + 0.1)
    vis = np.concatenate([np.full((n_pile, 3), 3.4, np.float32),
                          rng.uniform(0.5, 5.5, (40, 3)).astype(np.float32)])
    nn = (pos / params.scale_factor + 0.002 * rng.normal(size=(256, 3))).astype(np.float32)
    return st, make_visual_state(n_pile + 64, vis, device="cpu"), torch.as_tensor(nn)


def test_a_pile_past_the_kernels_slots_leaves_its_tail_still_and_reports_it():
    """140 visual particles on one spot: the query cell holds the kernels'
    128, so the last 12 stay where they are, and the fit's advection,
    ``update_visual`` and the phase-C commit each report 12 through
    ``warn_capacity_overflow``, which raises under --strict_capacity."""
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain

    params = _params(tpbf.PBFParams)
    st, vis, nn = _piled_visual(np.random.default_rng(13), 140, params)
    moved, dropped = tpbf.visual_xyz_from_nn(vis.xyz, vis.alive, nn, st, params,
                                             return_dropped=True)
    still = np.all(moved.numpy() == vis.xyz.numpy(), axis=1)[:140]
    assert int(dropped) == 12 and still[128:].all() and not still[:128].any()
    vis2, dropped2 = tpbf.update_visual(vis, st, params, return_dropped=True)
    still2 = np.all(vis2.xyz.numpy() == vis.xyz.numpy(), axis=1)[:140]
    assert int(dropped2) == 12 and still2[128:].all() and not still2[:128].any()
    *_, dropped3 = ttrain.commit_frame(params, st, vis, nn)
    logs = []
    assert tpbf.warn_capacity_overflow({"overflow": dropped3}, "frame 1 advection",
                                       log=logs.append, what=tpbf.QUERY_DROPS) == 12
    assert len(logs) == 1 and "capacity overflow" in logs[0] and "dropped 12" in logs[0]
    with pytest.raises(RuntimeError, match="strict_capacity"):
        tpbf.warn_capacity_overflow({"overflow": dropped3}, "frame 1 advection", strict=True,
                                    what=tpbf.QUERY_DROPS)


def test_a_future_frame_reports_the_piles_drops_and_strict_raises(tmp_path):
    """``predict`` from a checkpoint whose 140 visual particles sit on one
    spot inside the hidden cloud: the frame's dict and its log report the 12
    the query cell drops, as a capacity overflow, and --strict_capacity
    raises on them."""
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
    params = pbf_params_from_config(cfg)
    rng = np.random.default_rng(14)
    base = np.array([0.326, 0.05, -0.3], np.float32) * 100
    st = make_particle_state(2048, (rng.uniform(-3, 3, (300, 3)) + base).astype(np.float32),
                             init_velocity_y=50.0, device="cpu")
    save_hidden(st._replace(estimate_xyz=st.xyz), params, os.path.join(m.load_path, "checkpoint"), 1)
    vis = make_visual_state(2048, np.broadcast_to(base + 0.3, (140, 3)).copy(), device="cpu")
    save_visual(vis, constant_visual_attrs(2048, 1, device="cpu"),
                os.path.join(m.load_path, "checkpoint"), 1)
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cams = [Camera(uid=t, R=R, T=-R.T @ np.array([0.326, 0.05, 1.7]), fovx=0.7, fovy=0.55,
                   width=32, height=24, image_name="train00", time_idx=t) for t in range(2)]
    scene = SceneInfo(point_cloud=None, train_cameras=cams, test_cameras=[],
                      nerf_normalization={"radius": 2.0, "translate": np.zeros(3)})
    logs = []
    frames = tfuture.predict(cfg, scene_info=scene, log=logs.append, save_renders=False,
                             device="cpu")
    assert frames[0]["query_drops"] == 12 and frames[0]["visual"] == 140
    assert [line for line in logs if "capacity overflow" in line] == [
        "[capacity overflow] future 0 advection: " + tpbf.QUERY_DROPS.format(n=12)]
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
