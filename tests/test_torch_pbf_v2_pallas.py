"""The v2 PBF pair passes of the port (plain versions) against the JAX
package's v2 Pallas kernels (``phase1_slots_v2``/``phase2_slots_v2``) in
interpret mode, on the CPU. One small case: interpret mode spends its time
tracing, not on the size. Live slots and the corrected global sums are held
(the Pallas raw outputs at dead slots depend on its STRIP): each field to
1e-5 of its scale, since sg and dsum are differences of two sums taken in
another order, and the sums to 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import torch

from fluidnexus_tpu.ops import neighbors as jnb
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim import pbf_pallas as jpallas
from fluidnexus_torch import convert
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda
from tests.test_torch_pbf import _mk_state

CPU = torch.device("cpu")


def pallas_case(seed=11):
    """An 8-cell x 8-slot grid of 40 live points in 2 x 2 x 2 cells at h = 1,
    as the JAX package and as the port hold it, the pair constants, and a
    lambda per live slot from the Pallas phase 1 (the formula of
    sim/pbf_dense.py:155-160)."""
    caps = (8, 8)
    kw = dict(h=1.0, p0=1.5, dense_max_cells=caps[0], dense_cell_capacity=caps[1])
    st_j, _ = _mk_state(40, 64, seed=seed, spread=0.6)
    jg = jnb.build_dense_grid(st_j.estimate_xyz, 1.0, st_j.alive, *caps)
    tg = convert.dense_grid_from_numpy(jg, device=CPU)
    live = tg.bmask.numpy()
    assert live.sum() > 30 and int((tg.nbr < caps[0]).sum()) >= 8 * 8
    return jpbf.PBFParams(**kw), pbf_cuda.pair_consts(tpbf.PBFParams(**kw)), jg, tg, live


def lambda_from(pi, sg, c2d2, live, p0=1.5, relax=0.01):
    lam = -(pi / p0 - 1.0) / (c2d2 / (p0 * p0) + ((sg / p0) ** 2).sum(-1) + relax)
    return np.where(live, lam, 0.0).astype(np.float32)


def _held(got, ref, live, name):
    """A (C+1, M[, 3]) port field against the kernel's (C, M[, 3]) on live
    slots, to 1e-5 of the field's scale; 0 at the port's dead slots."""
    want = np.asarray(ref)[live[:-1]]
    np.testing.assert_allclose(got[:-1].numpy()[live[:-1]], want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    assert not got.numpy()[~live].any(), name


def check_phase1(got, ref, live):
    """The port's (pi_raw, sg, c2d2, nlen, s_p6, s_edges) planes of C+1 rows
    against the Pallas kernel's C rows."""
    for name, a, b in zip(("pi", "sg", "c2d2", "nlen"), got[:4], ref[:4]):
        _held(a, b, live, name)
    np.testing.assert_allclose([float(got[4]), float(got[5])], [float(ref[4]), float(ref[5])],
                               rtol=1e-5)


def check_phase2(got, ref, live):
    _held(got[0], ref[0], live, "dsum")
    np.testing.assert_allclose([float(got[1]), float(got[2])], [float(ref[1]), float(ref[2])],
                               rtol=1e-5)


def test_v2_passes_match_the_v2_pallas_kernels():
    params_j, k, jg, tg, live = pallas_case()
    ref1 = jpallas.phase1_slots_v2(jg, k.h, k.eps, k.c6, k.s45)
    cnt, x, y, z = pbf_cuda.planes(tg)
    got1 = pbf_cuda.phase1_v2_plain(tg.nbr, cnt, x, y, z, k)
    check_phase1(got1, ref1, live)

    lam = lambda_from(*(np.asarray(a) for a in (ref1[0], ref1[1], ref1[2])), live[:-1])
    ref2 = jpallas.phase2_slots_v2(jg, jnp.asarray(lam), k.h, k.eps, k.c6, k.s45, k.k_p, k.e_p,
                                   k.inv_denom)
    lam_t = torch.zeros_like(x)
    lam_t[:-1] = torch.as_tensor(lam)
    got2 = pbf_cuda.phase2_v2_plain(tg.nbr, cnt, x, y, z, lam_t, k)
    check_phase2(got2, ref2, live)
