"""Phase C's pair sums in the port against the JAX package, on the CPU:
``bin_queries`` and the two differentiable sums ``density_ratio_at`` and
``visual_xyz_from_nn`` (value and gradients) against the JAX package's dense
branch, their gradcheck, and the checks of a passed grid. The kernels' plain
versions against the Pallas kernels are in test_torch_gas_splat_pallas.py.
Inputs are seeded numpy arrays handed to both."""
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
