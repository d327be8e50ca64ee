"""The plain versions of the gas-density and velocity-splat kernels in the
port (``sim/pbf_cuda.density_plain``/``density_bwd_plain``,
``sim/splat_cuda.splat_fwd_plain``/``splat_bwd_plain``) against the Pallas
kernels of the JAX package in interpret mode, on the CPU, on 8-cell x
8-slot grids (interpret mode is slow). The splat's plain versions take the
queries as the port's ``QueryList`` (``sort_queries``) and the JAX kernels
as its slot grid (``bin_queries``), under its capacity; they are held per
live query and per live source. Inputs are seeded numpy arrays handed to
both."""
import jax.numpy as jnp
import numpy as np
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf_pallas as jpallas
from fluidnexus_torch import convert
from fluidnexus_torch.ops import neighbors as tnb
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda, splat_cuda
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _cloud(seed, n, spread, center=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) + np.asarray(center, np.float32)
    return rng, pts


def _small_grids(seed=0):
    """A source grid and a query grid of 8 cells x 8 slots at h = 1 around
    (1, 1, 1): 2 x 2 x 2 occupied cells each, some points dead. Returns
    (rng, source grid, query grid, rnbr, the queries, their liveness)."""
    rng, src = _cloud(seed, 40, 0.6)
    alive = rng.random(40) > 0.1
    _, qry = _cloud(seed + 1, 36, 0.7)
    q_alive = rng.random(36) > 0.1
    jg = jnb.build_dense_grid(jnp.asarray(src), 1.0, jnp.asarray(alive), 8, 8)
    jq, jr = jnb.bin_queries(jg, 1.0, jnp.asarray(qry), jnp.asarray(q_alive), 8, 8)
    return rng, jg, jq, jr, qry, q_alive


def _query_list(jg, jq, qry, q_alive):
    """The port's source grid (``jg`` converted) and its ``sort_queries``
    list of the same queries, which must hold the live queries of ``jq``
    (no query cell past its capacity), and the live queries' rows."""
    assert int(jq.overflow) == 0, "a query cell is past the Pallas capacity"
    tg = convert.dense_grid_from_numpy(jg, device=CPU)
    ql = tnb.sort_queries(tg, 1.0, torch.as_tensor(qry), torch.as_tensor(q_alive), 8)
    kept = _np(jq.prow) < 8
    np.testing.assert_array_equal(ql.prow.numpy(), _np(jq.prow))
    return tg, ql, kept


def _list_args(ql):
    return ql.start, ql.cnt, ql.x, ql.y, ql.z


def _at_slots(jq, per_point):
    """A per-query array laid out in ``jq``'s slots, 0 at dead slots."""
    bidx, bmask = _np(jq.bidx), _np(jq.bmask)
    out = per_point[np.clip(bidx, 0, None)]
    return (out * bmask.reshape(bmask.shape + (1,) * (per_point.ndim - 1))).astype(np.float32)


def test_density_plain_versions_match_pallas_interpret():
    """density_plain / density_bwd_plain against density_slots_v2 /
    density_bwd_slots_v2 in interpret mode, live slots only (the Pallas raw
    outputs at dead slots depend on its STRIP)."""
    rng, jg, *_ = _small_grids()
    k = pbf_cuda.pair_consts(tpbf.PBFParams(h=1.0))
    pi_j = jpallas.density_slots_v2(jg, k.h, k.eps, k.c6, k.s45)
    g = (rng.standard_normal(jg.bmask.shape) * _np(jg.bmask)).astype(np.float32)
    dx_j = jpallas.density_bwd_slots_v2(jg, jnp.asarray(g), k.h, k.c6)

    tg = convert.dense_grid_from_numpy(jg, device=CPU)
    cnt, x, y, z = pbf_cuda.planes(tg)
    live = tg.bmask[:-1].numpy()
    assert live.sum() > 30
    pi_t = pbf_cuda.density_plain(tg.nbr, cnt, x, y, z, k)
    np.testing.assert_allclose(pi_t[:-1].numpy()[live], _np(pi_j)[live], rtol=1e-5, atol=1e-7)
    assert not pi_t[:-1].numpy()[~live].any() and not pi_t[-1].any()
    dx_t = pbf_cuda.density_bwd_plain(tg.nbr, cnt, x, y, z, torch.as_tensor(g), k)
    scale = float(np.abs(_np(dx_j)[live]).max())
    np.testing.assert_allclose(dx_t[:-1].numpy()[live], _np(dx_j)[live], rtol=1e-4,
                               atol=1e-5 * scale)
    assert not dx_t[:-1].numpy()[~live].any() and not dx_t[-1].any()


def test_splat_plain_versions_match_pallas_interpret():
    """splat_fwd_plain / splat_bwd_plain on the query list against
    splat_slots / splat_bwd_slots in interpret mode on the slot grid, per
    live query and per live source, with random source velocities and
    per-query planes p, q; the forward is 0 at entry Nq and the adjoint at
    dead source slots."""
    rng, jg, jq, jr, qry, q_alive = _small_grids(seed=3)
    h = 1.0
    vel_s = (rng.standard_normal(jg.bxyz.shape) * _np(jg.bmask)[..., None]).astype(np.float32)
    p = rng.standard_normal((len(qry), 3)).astype(np.float32)
    q = rng.standard_normal(len(qry)).astype(np.float32)
    wv_j, ws_j = jpallas.splat_slots(jg, jq, jnp.asarray(vel_s), h)
    gx_j, gv_j = jpallas.splat_bwd_slots(jg, jq, jr, jnp.asarray(vel_s),
                                         jnp.asarray(_at_slots(jq, p)), jnp.asarray(_at_slots(jq, q)),
                                         h)

    tg, ql, kept = _query_list(jg, jq, qry, q_alive)
    np.testing.assert_array_equal(ql.rnbr.numpy(), _np(jr))
    planes = pbf_cuda.planes(tg)
    slive = tg.bmask[:-1].numpy()
    assert kept.sum() > 25 and slive.sum() > 30
    out = splat_cuda.splat_fwd_plain(ql.nbr, *_list_args(ql), *planes, torch.as_tensor(vel_s), h)
    assert float(out[:, 3].max()) > 0 and not out[-1].any()
    row, col = _np(jq.prow)[kept], _np(jq.pcol)[kept]
    got = out.numpy()[ql.pos.numpy()[kept]]
    for g, ref in ((got[:, :3], _np(wv_j)[row, col]), (got[:, 3], _np(ws_j)[row, col])):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6 * scale)
    order = ql.order
    gx_t, gv_t = splat_cuda.splat_bwd_plain(ql.rnbr, *planes, torch.as_tensor(vel_s),
                                            *_list_args(ql), torch.as_tensor(p)[order],
                                            torch.as_tensor(q)[order], h)
    for g, ref in ((gx_t, gx_j), (gv_t, gv_j)):
        scale = float(np.abs(_np(ref)[slive]).max())
        assert scale > 0
        np.testing.assert_allclose(g[:-1].numpy()[slive], _np(ref)[slive], rtol=1e-4,
                                   atol=1e-5 * scale)
        assert not g[:-1].numpy()[~slive].any() and not g[-1].any()


def test_density_plain_matches_pallas_interpret_with_an_isolated_point():
    """density_plain against density_slots_v2 in interpret mode on a grid
    where one point sits alone (its 26 neighbour cells are empty): its pi is
    the self term c6 h^6 alone in both, and the other live slots agree."""
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9], (24, 3)),
                          [[5.5, 5.5, 5.5]]]).astype(np.float32)
    alive = rng.random(25) > 0.1
    alive[-1] = True
    jg = jnb.build_dense_grid(jnp.asarray(pts), 1.0, jnp.asarray(alive), 8, 8)
    k = pbf_cuda.pair_consts(tpbf.PBFParams(h=1.0))
    pi_j = _np(jpallas.density_slots_v2(jg, k.h, k.eps, k.c6, k.s45))

    tg = convert.dense_grid_from_numpy(jg, device=CPU)
    cnt, x, y, z = pbf_cuda.planes(tg)
    live = tg.bmask[:-1].numpy()
    row, col = int(tg.prow[-1]), int(tg.pcol[-1])
    assert int(cnt[tg.nbr[row].long()].sum()) == 1, "the last point is not alone"
    assert live.sum() > 15
    pi_t = pbf_cuda.density_plain(tg.nbr, cnt, x, y, z, k)
    np.testing.assert_allclose(pi_t[:-1].numpy()[live], pi_j[live], rtol=1e-5, atol=1e-7)
    self_term = np.float32(k.c6) * np.float32(k.h2) ** 3
    np.testing.assert_allclose([float(pi_t[row, col]), pi_j[row, col]], self_term, rtol=1e-6)
    assert not pi_t[:-1].numpy()[~live].any() and not pi_t[-1].any()


def test_splat_bwd_plain_matches_pallas_interpret_with_sources_out_of_reach():
    """splat_bwd_plain on the query list against splat_bwd_slots in
    interpret mode on grids where one source cell has no query cell among
    its 27 neighbours: its live sources read exactly 0 in both, and the
    other live sources agree."""
    rng = np.random.default_rng(6)
    src = np.concatenate([rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9], (24, 3)),
                          rng.uniform([5.2, 0.2, 0.2], [5.8, 0.8, 0.8], (6, 3))]).astype(np.float32)
    alive = rng.random(30) > 0.1
    qry = rng.uniform(0.1, 1.9, (30, 3)).astype(np.float32)
    q_alive = rng.random(30) > 0.1
    jg = jnb.build_dense_grid(jnp.asarray(src), 1.0, jnp.asarray(alive), 8, 8)
    jq, jr = jnb.bin_queries(jg, 1.0, jnp.asarray(qry), jnp.asarray(q_alive), 8, 8)
    vel_s = (rng.standard_normal(jg.bxyz.shape) * _np(jg.bmask)[..., None]).astype(np.float32)
    p = rng.standard_normal((30, 3)).astype(np.float32)
    q = rng.standard_normal(30).astype(np.float32)
    gx_j, gv_j = jpallas.splat_bwd_slots(jg, jq, jr, jnp.asarray(vel_s),
                                         jnp.asarray(_at_slots(jq, p)), jnp.asarray(_at_slots(jq, q)),
                                         1.0)

    tg, ql, _ = _query_list(jg, jq, qry, q_alive)
    planes = pbf_cuda.planes(tg)
    slive = tg.bmask[:-1].numpy()
    out_of_reach = (ql.cnt[ql.rnbr.long()].sum(1) == 0).numpy()[:, None] & slive
    assert out_of_reach.sum() >= 3 and (slive & ~out_of_reach).sum() > 15
    gx_t, gv_t = splat_cuda.splat_bwd_plain(ql.rnbr, *planes, torch.as_tensor(vel_s),
                                            *_list_args(ql), torch.as_tensor(p)[ql.order],
                                            torch.as_tensor(q)[ql.order], 1.0)
    for got, ref in ((gx_t, gx_j), (gv_t, gv_j)):
        ref = _np(ref)
        scale = float(np.abs(ref[slive]).max())
        assert scale > 0
        np.testing.assert_allclose(got[:-1].numpy()[slive], ref[slive], rtol=1e-4,
                                   atol=1e-5 * scale)
        assert not got[:-1].numpy()[out_of_reach].any() and not ref[out_of_reach].any()
        assert not got[:-1].numpy()[~slive].any() and not got[-1].any()


def test_splat_fwd_plain_matches_pallas_interpret_with_queries_out_of_reach():
    """splat_fwd_plain on the query list against splat_slots in interpret
    mode on grids where one query cell has no source cell among its 27
    neighbours: its live queries read exactly 0 in both, and the other live
    queries agree."""
    rng = np.random.default_rng(7)
    src = rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9], (30, 3)).astype(np.float32)
    alive = rng.random(30) > 0.1
    qry = np.concatenate([rng.uniform([0.1, 0.1, 0.1], [1.9, 1.9, 0.9], (24, 3)),
                          rng.uniform([5.2, 0.2, 0.2], [5.8, 0.8, 0.8], (6, 3))]).astype(np.float32)
    q_alive = rng.random(30) > 0.1
    jg = jnb.build_dense_grid(jnp.asarray(src), 1.0, jnp.asarray(alive), 8, 8)
    jq, _ = jnb.bin_queries(jg, 1.0, jnp.asarray(qry), jnp.asarray(q_alive), 8, 8)
    vel_s = (rng.standard_normal(jg.bxyz.shape) * _np(jg.bmask)[..., None]).astype(np.float32)
    wv_j, ws_j = jpallas.splat_slots(jg, jq, jnp.asarray(vel_s), 1.0)

    tg, ql, kept = _query_list(jg, jq, qry, q_alive)
    planes = pbf_cuda.planes(tg)
    reach = (planes[0][ql.nbr.long()].sum(1) > 0).numpy()
    out_of_reach = kept & ~reach[np.minimum(ql.prow.numpy(), 7)]
    assert out_of_reach.sum() >= 3 and (kept & ~out_of_reach).sum() > 15
    out = splat_cuda.splat_fwd_plain(ql.nbr, *_list_args(ql), *planes, torch.as_tensor(vel_s), 1.0)
    got = out.numpy()[ql.pos.numpy()]
    row, col = np.minimum(_np(jq.prow), 7), _np(jq.pcol)
    for g, ref in ((got[:, :3], _np(wv_j)[row, col]), (got[:, 3], _np(ws_j)[row, col])):
        scale = float(np.abs(ref[kept]).max())
        assert scale > 0
        np.testing.assert_allclose(g[kept], ref[kept], rtol=1e-5, atol=1e-6 * scale)
        assert not g[out_of_reach].any() and not ref[out_of_reach].any()
        assert not g[~kept].any()
