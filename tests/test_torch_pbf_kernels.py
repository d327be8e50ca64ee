"""The PBF pair kernels (fluidnexus_torch/csrc/pbf.cu) against their plain
PyTorch versions, on the card. Every test here is marked `cuda` and skips
where there is no card. The file imports no JAX, so on a machine with the
card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pbf_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.ops.neighbors import build_dense_grid, slot_gather
from fluidnexus_torch.sim import pbf_cuda as pc
from fluidnexus_torch.sim.pbf import PBFParams
from fluidnexus_torch.sim.pbf_dense import project_iterations_dense
from fluidnexus_torch.sim.state import make_particle_state
from tests.torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _grid_inputs(device, m, n, box, seed):
    """A random cloud binned at h = 1 with M = m slots per cell; some points
    dead, a random inverse mass, counts 3."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, box, (n, 3)).astype(np.float32), device=device)
    alive = torch.as_tensor(rng.random(n) > 0.1, device=device)
    imass = torch.as_tensor((0.8 + 0.4 * rng.random(n)).astype(np.float32), device=device)
    grid = build_dense_grid(x, 1.0, alive, 512, m)
    cnt, *xyz = pc.planes(grid)
    im = torch.where(grid.bmask, slot_gather(grid, imass), 1.0).contiguous()
    return grid, cnt, xyz, im


@pytest.mark.parametrize("m,n,box,e_p", [(4, 300, 4.0, 4.0), (32, 900, 3.0, 2.5),
                                         (128, 1500, 2.0, 4.0)])
def test_pbf_kernels_match_plain_on_the_card(cuda_device, m, n, box, e_p):
    grid, cnt, xyz, im = _grid_inputs(cuda_device, m, n, box, seed=m)
    c = grid.max_cells
    assert bool((cnt == m).any()), "no full cell"
    assert bool((grid.nbr[cnt[:c] > 0] == c).any()), "no absent neighbour row"
    k = pc.pair_consts(PBFParams(h=1.0, e_p=e_p))
    live = grid.bmask

    lam, pi_raw, nl, s_p6, s_edges = pc.phase1_slots(grid.nbr, cnt, *xyz, im, k)
    ref = pc.phase1_plain(grid.nbr, cnt, *xyz, im, k)
    for got, want in zip((lam, pi_raw), ref):
        torch.testing.assert_close(got[live], want[live], rtol=0,
                                   atol=1e-4 * float(want[live].abs().max()))
        assert not got[~live].any()
    torch.testing.assert_close(nl, ref[2], rtol=0, atol=0)
    torch.testing.assert_close(torch.stack([s_p6, s_edges]), torch.stack(ref[3:]), rtol=1e-5,
                               atol=0)

    nc = (nl + 3.0).contiguous()
    *new, s_corr, s_ns = pc.phase2_slots(grid.nbr, cnt, *xyz, lam, nc, k)
    *new_p, corr_p, ns_p = pc.phase2_plain(grid.nbr, cnt, *xyz, lam, nc, k)
    for a, b, x0 in zip(new, new_p, xyz):
        torch.testing.assert_close(a[~live], x0[~live], rtol=0, atol=0)   # coordinates kept
        d, d_p = (a - x0)[live], (b - x0)[live]                            # the Jacobi update
        torch.testing.assert_close(d, d_p, rtol=0, atol=1e-4 * float(d_p.abs().max()))
    torch.testing.assert_close(torch.stack([s_corr, s_ns]), torch.stack([corr_p, ns_p]),
                               rtol=1e-5, atol=0)


def test_tick_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """``project_iterations_dense`` through the kernels against the plain CPU
    path; the loop launches each kernel once per iteration, and no CUDA
    tensor reaches a plain version."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 5, (700, 3)).astype(np.float32)
    params = PBFParams(h=1.0, dense_max_cells=512, dense_cell_capacity=32)

    def run(device):
        st = make_particle_state(800, pts, init_velocity_y=10.0, device=device)
        st = st._replace(estimate_xyz=st.xyz + 0.05, counts=torch.full_like(st.counts, 4.0))
        return project_iterations_dense(st, params, 4)

    ref, ref_d = run("cpu")
    for name in ("phase1_plain", "phase2_plain"):
        fn = getattr(pc, name)

        def cpu_only(*a, _fn=fn, _name=name, **kw):
            assert a[2].device.type == "cpu", f"{_name} was given a CUDA tensor"
            return _fn(*a, **kw)

        monkeypatch.setattr(pc, name, cpu_only)
    pc.reset_launches()
    got, got_d = run(cuda_device)
    assert pc.LAUNCHES == {**{name: 0 for name in pc.LAUNCHES}, "pbf_phase1": 4, "pbf_phase2": 4}
    torch.testing.assert_close(got.estimate_xyz.cpu(), ref.estimate_xyz, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.force.cpu(), ref.force, rtol=1e-4, atol=1e-3)
    for key in ref_d:
        torch.testing.assert_close(got_d[key].cpu(), ref_d[key], rtol=1e-4, atol=1e-4, msg=key)
