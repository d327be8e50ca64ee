"""The plain versions of the gas-density and velocity-splat kernels in the
port (``sim/pbf_cuda.density_plain``/``density_bwd_plain``,
``sim/splat_cuda.splat_fwd_plain``/``splat_bwd_plain``) against the Pallas
kernels of the JAX package in interpret mode, on the CPU, on 8-cell x
8-slot grids (interpret mode is slow). Inputs are seeded numpy arrays handed
to both."""
import jax.numpy as jnp
import numpy as np
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf_pallas as jpallas
from fluidnexus_torch import convert
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda, splat_cuda

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
    (1, 1, 1): 2 x 2 x 2 occupied cells each, some points dead."""
    rng, src = _cloud(seed, 40, 0.6)
    alive = rng.random(40) > 0.1
    _, qry = _cloud(seed + 1, 36, 0.7)
    q_alive = rng.random(36) > 0.1
    jg = jnb.build_dense_grid(jnp.asarray(src), 1.0, jnp.asarray(alive), 8, 8)
    jq, jr = jnb.bin_queries(jg, 1.0, jnp.asarray(qry), jnp.asarray(q_alive), 8, 8)
    return rng, jg, jq, jr


def test_density_plain_versions_match_pallas_interpret():
    """density_plain / density_bwd_plain against density_slots_v2 /
    density_bwd_slots_v2 in interpret mode, live slots only (the Pallas raw
    outputs at dead slots depend on its STRIP)."""
    rng, jg, _, _ = _small_grids()
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
    """splat_fwd_plain / splat_bwd_plain against splat_slots /
    splat_bwd_slots in interpret mode on live slots, with random source
    velocities and query-side planes p, q (0 at dead query slots)."""
    rng, jg, jq, jr = _small_grids(seed=3)
    h = 1.0
    vel_s = (rng.standard_normal(jg.bxyz.shape) * _np(jg.bmask)[..., None]).astype(np.float32)
    p_s = (rng.standard_normal(jq.bxyz.shape) * _np(jq.bmask)[..., None]).astype(np.float32)
    q_s = (rng.standard_normal(jq.bmask.shape) * _np(jq.bmask)).astype(np.float32)
    wv_j, ws_j = jpallas.splat_slots(jg, jq, jnp.asarray(vel_s), h)
    gx_j, gv_j = jpallas.splat_bwd_slots(jg, jq, jr, jnp.asarray(vel_s), jnp.asarray(p_s),
                                         jnp.asarray(q_s), h)

    tg, tq = (convert.dense_grid_from_numpy(g, device=CPU) for g in (jg, jq))
    tr = _t(jr)
    planes, qplanes = pbf_cuda.planes(tg), pbf_cuda.planes(tq)
    qlive, slive = tq.bmask[:-1].numpy(), tg.bmask[:-1].numpy()
    assert qlive.sum() > 25 and slive.sum() > 30
    wv_t, ws_t = splat_cuda.splat_fwd_plain(tq.nbr, *qplanes, *planes, torch.as_tensor(vel_s), h)
    assert float(ws_t.max()) > 0
    for got, ref in ((wv_t, wv_j), (ws_t, ws_j)):
        scale = float(np.abs(_np(ref)[qlive]).max())
        np.testing.assert_allclose(got[:-1].numpy()[qlive], _np(ref)[qlive], rtol=1e-5,
                                   atol=1e-6 * scale)
        assert not got[:-1].numpy()[~qlive].any() and not got[-1].any()
    gx_t, gv_t = splat_cuda.splat_bwd_plain(tr, *planes, torch.as_tensor(vel_s), *qplanes,
                                            torch.as_tensor(p_s), torch.as_tensor(q_s), h)
    for got, ref in ((gx_t, gx_j), (gv_t, gv_j)):
        scale = float(np.abs(_np(ref)[slive]).max())
        assert scale > 0
        np.testing.assert_allclose(got[:-1].numpy()[slive], _np(ref)[slive], rtol=1e-4,
                                   atol=1e-5 * scale)
        assert not got[:-1].numpy()[~slive].any() and not got[-1].any()


