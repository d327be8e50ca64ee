"""The v1 PBF pair passes of the port (the pre-gather and the plain
versions) against the JAX package's v1 Pallas kernels
(``phase1_slots``/``phase2_slots``) in interpret mode, on the CPU. One small
case, apart from the v2 one so that the two interpret-mode traces run side
by side; live slots and the corrected global sums at 1e-5."""
import jax.numpy as jnp
import numpy as np
import torch

from fluidnexus_tpu.sim import pbf_pallas as jpallas
from fluidnexus_torch.sim import pbf_cuda
from tests.test_torch_pbf_v2_pallas import check_phase1, check_phase2, lambda_from, pallas_case


def test_v1_passes_match_the_v1_pallas_kernels():
    params_j, k, jg, tg, live = pallas_case()
    gathered = jpallas._gathers(jg)
    ref1 = jpallas.phase1_slots(jg, k.h, k.eps, k.c6, k.s45, gathered=gathered)
    cnt, x, y, z = pbf_cuda.planes(tg)
    ncnt, xng = pbf_cuda.gather_v1(tg.nbr, cnt, x, y, z)
    c, m = tg.max_cells, tg.capacity
    assert ncnt.shape == (c, 27) and xng.shape == (c, 27, 3, m)
    got1 = pbf_cuda.phase1_v1_plain(ncnt, xng, cnt, x, y, z, k)
    check_phase1(got1, ref1, live)
    # the gathered rows are the v2 walk's rows: v1 and v2 agree exactly
    for a, b in zip(got1, pbf_cuda.phase1_v2_plain(tg.nbr, cnt, x, y, z, k)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    lam = lambda_from(*(np.asarray(a) for a in (ref1[0], ref1[1], ref1[2])), live[:-1])
    ref2 = jpallas.phase2_slots(jg, jnp.asarray(lam), k.h, k.eps, k.c6, k.s45, k.k_p, k.e_p,
                                k.inv_denom, gathered=gathered)
    lam_t = torch.zeros_like(x)
    lam_t[:-1] = torch.as_tensor(lam)
    lng = pbf_cuda.gather_lam_v1(tg.nbr, lam_t)
    got2 = pbf_cuda.phase2_v1_plain(ncnt, xng, lng, cnt, x, y, z, lam_t, k)
    check_phase2(got2, ref2, live)
    for a, b in zip(got2, pbf_cuda.phase2_v2_plain(tg.nbr, cnt, x, y, z, lam_t, k)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
