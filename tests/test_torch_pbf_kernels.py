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
from tests.torch_helpers import (  # noqa: F401 (one_intra_op_thread: autouse)
    one_intra_op_thread,  # noqa: F401
    coincident_pairs_grid, cuda_device, guarded_gather, isolated_point_grid, leave_nan_blocks,
    phase1_against_the_walk,
)

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


@pytest.mark.parametrize("m", [32, 128])
def test_phase1_at_its_edges(cuda_device, m):
    """Phase 1 (v3) into NaN-filled blocks against its plain version at M = 32
    and M = 128 (a row of 128 takes eight passes; lists span more than one
    staged chunk of 256 entries), over full rows with two live particles at
    one position in one row (a non-self pair at d2 = 0, which the kernel must
    tell from the self pair by index) and one point alone, whose sums are its
    self pair's: pi_raw and nl bit for bit. lambda and pi_raw at 1e-4 of
    their scale, nl exact, dead slots, empty rows and row C exactly 0.
    Epsilon 1e-2 as in ``test_phase2_at_its_edges``: the pair at d2 = 0 has
    cg ~ eps^-1/2, whose terms sg cancels."""
    grid, rng = isolated_point_grid(m, cuda_device, seed=m + 5, coincident=True)
    cnt, *xyz = pc.planes(grid)
    live = grid.bmask
    im = torch.as_tensor((0.8 + 0.4 * rng.random(tuple(live.shape))).astype(np.float32),
                         device=cuda_device)
    im = torch.where(live, im, 1.0).contiguous()
    k = pc.pair_consts(PBFParams(h=1.0, epsilon=1e-2))
    args = (grid.nbr, cnt, *xyz, im, k)
    assert int(grid.prow[1]) == int(grid.prow[2]) < grid.max_cells
    assert all(bool(p[grid.prow[1], grid.pcol[1]] == p[grid.prow[2], grid.pcol[2]]) for p in xyz)
    assert int(cnt[grid.nbr.long()].sum(1).max()) > 256
    lam_p, pi_p, nl_p, s_p6_p, s_edges_p = pc.phase1_plain(*args)
    leave_nan_blocks(cuda_device, *(tuple(xyz[0].shape),) * 3)
    lam, pi_raw, nl, s_p6, s_edges = pc.phase1_slots(*args)
    for got, want in zip((lam, pi_raw), (lam_p, pi_p)):
        torch.testing.assert_close(got[live], want[live], rtol=0,
                                   atol=1e-4 * float(want[live].abs().max()))
    for got in (lam, pi_raw, nl):
        assert torch.equal(got[~live], torch.zeros_like(got[~live]))   # NaN where unwritten
    torch.testing.assert_close(nl, nl_p, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack([s_p6, s_edges]), torch.stack([s_p6_p, s_edges_p]),
                               rtol=1e-5, atol=0)
    row, col = int(grid.prow[0]), int(grid.pcol[0])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "point 0 is not alone"
    for got, want in ((pi_raw, pi_p), (nl, nl_p)):
        assert torch.equal(got[row, col:col + 1].view(torch.int32),
                           want[row, col:col + 1].view(torch.int32))
    assert float(nl[row, col]) == 1.0


@pytest.mark.parametrize("m", [32, 128])
def test_phase1_keeps_the_walks_sums(cuda_device, m):
    """Phase 1 (v3, row 12), phase 1 v2 (row 6) and phase 1 v1 (row 4), which
    share one row-group body, against phase 1 v1's checking mode, the walk
    over the rows, which takes the self pair by index and adds each slot's
    pairs in the order the row groups keep, over 20 pairs of live particles
    at one position at the default epsilon: their cg ~ 1e5 cancels in sg, so
    sums that took such a pair for the self pair (cg 0) would round
    otherwise, far beyond the epilogue's few ulp. Row 12: pi_raw bit for bit,
    nl exact, lambda within 1e-6 relative (the epilogue's f32 rounding); rows
    6 and 4: every output bit for bit."""
    grid, rng = coincident_pairs_grid(m, cuda_device, seed=m + 7)
    live = grid.bmask
    im = torch.as_tensor((0.8 + 0.4 * rng.random(tuple(live.shape))).astype(np.float32),
                         device=cuda_device)
    same_pi, same_nl, rel, raw_same = phase1_against_the_walk(
        grid, torch.where(live, im, 1.0).contiguous(), pc.pair_consts(PBFParams(h=1.0)))
    assert same_pi and same_nl
    assert all(raw_same), raw_same
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("m", [32, pc.MAX_M])
def test_phase1_v1_keeps_the_walks_bits(cuda_device, m):
    """Phase 1 v1 (row 4: the row groups over the gathered rows) into
    NaN-filled blocks against its checking mode, the walk, at atol=0, over
    ``test_phase1_at_its_edges``' grid at the default epsilon: M = 32 and M =
    MAX_M with full rows, empty rows, two live particles at one position in
    one row and one point alone, the gathered rows followed by guard rows
    that hold live neighbours (``guarded_gather``), which row C must not
    read. pi_raw, sg, c2d2 and nlen bit for bit, each 0 at dead slots, empty
    rows and row C."""
    grid, _ = isolated_point_grid(m, cuda_device, seed=m + 5, coincident=True)
    cnt, *xyz = pc.planes(grid)
    live = grid.bmask
    assert bool((cnt == m).any()) and bool((cnt[:-1] == 0).any())
    assert int(grid.prow[1]) == int(grid.prow[2]) < grid.max_cells
    ncnt, xng, _ = guarded_gather(grid.nbr, cnt, *xyz, torch.zeros_like(xyz[0]))
    k = pc.pair_consts(PBFParams(h=1.0))
    walk = pc.phase1_v1_slots(ncnt, xng, *xyz, k, walk=True)
    leave_nan_blocks(cuda_device, *(tuple(w.shape) for w in walk[:4]))
    got = pc.phase1_v1_slots(ncnt, xng, *xyz, k)
    for name, g, w in zip(("pi_raw", "sg", "c2d2", "nlen"), got, walk):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"row 4 {name}"
        assert not g[~live].any(), f"row 4 {name} off the live slots"
    assert torch.equal(torch.stack(got[4:]), torch.stack(walk[4:]))


@pytest.mark.parametrize("m,e_p", [(32, 4.0), (32, 2.5), (128, 4.0), (128, 2.5)])
def test_phase2_at_its_edges(cuda_device, m, e_p):
    """Phase 2 (v3) into NaN-filled blocks against its plain version at M = 32
    and M = 128 (a row of 128 takes four passes; lists span more than one
    staged chunk of 256 entries), at e_p 4 (the power multiplied out)
    and 2.5 (powf), over full rows with two live particles at one position in
    one row (a non-self pair at d2 = 0, which the kernel must tell from the
    self pair by index) and one point alone, whose update is exactly 0: its
    coordinates are kept bit for bit. Epsilon 1e-2: the pair at d2 = 0 has
    cg ~ eps^-1/2, whose terms the update's sums cancel; at the default 1e-8
    the comparison would read two summation orders' rounding of ~1e4-times
    larger terms."""
    grid, _ = isolated_point_grid(m, cuda_device, seed=m + 4, coincident=True)
    cnt, *xyz = pc.planes(grid)
    k = pc.pair_consts(PBFParams(h=1.0, e_p=e_p, epsilon=1e-2))
    lam, _, nl, _, _ = pc.phase1_plain(grid.nbr, cnt, *xyz, torch.ones_like(xyz[0]), k)
    args = (grid.nbr, cnt, *xyz, lam.contiguous(), (nl + 3.0).contiguous(), k)
    assert int(grid.prow[1]) == int(grid.prow[2]) < grid.max_cells
    assert all(bool(p[grid.prow[1], grid.pcol[1]] == p[grid.prow[2], grid.pcol[2]]) for p in xyz)
    assert int(cnt[grid.nbr.long()].sum(1).max()) > 256
    *new_p, corr_p, ns_p = pc.phase2_plain(*args)
    leave_nan_blocks(cuda_device, *(tuple(x.shape) for x in xyz), (cnt.numel(), 2))
    *new, corr, ns = pc.phase2_slots(*args)
    live = grid.bmask
    for a, b, x0 in zip(new, new_p, xyz):
        torch.testing.assert_close(a[~live], x0[~live], rtol=0, atol=0)   # coordinates kept
        d, d_p = (a - x0)[live], (b - x0)[live]                            # the Jacobi update
        torch.testing.assert_close(d, d_p, rtol=0, atol=1e-4 * float(d_p.abs().max()))
    torch.testing.assert_close(torch.stack([corr, ns]), torch.stack([corr_p, ns_p]), rtol=1e-5,
                               atol=0)
    row, col = int(grid.prow[0]), int(grid.pcol[0])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "point 0 is not alone"
    for a, x0 in zip(new, xyz):
        assert torch.equal(a[row, col:col + 1].view(torch.int32), x0[row, col:col + 1].view(torch.int32))


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
