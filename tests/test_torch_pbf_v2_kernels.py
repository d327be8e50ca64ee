"""The v2 and v1 PBF pair kernels (fluidnexus_torch/csrc/pbf.cu) against
their plain PyTorch versions, and the rigid-body solver loop on the card
against the plain CPU path. Every test here is marked `cuda` and skips where
there is no card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pbf_v2_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.sim import pbf_cuda as pc
from fluidnexus_torch.sim.pbf import PBFParams, RigidSpec, create_rigid_body, solver_loop
from fluidnexus_torch.sim.state import make_particle_state
from tests.test_torch_pbf_kernels import _grid_inputs
from tests.torch_helpers import (  # noqa: F401 (one_intra_op_thread: autouse)
    one_intra_op_thread,  # noqa: F401
    GRADED_BANDS, cuda_device, graded_rows_grid, guarded_gather, isolated_point_grid,
    leave_nan_blocks, phase2_part, plain_row_partials,
)

pytestmark = pytest.mark.cuda


def _held(got, want, live, what):
    """Live slots to 1e-4 of the field's scale, dead slots 0."""
    w = want[live]
    torch.testing.assert_close(got[live], w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=what)
    assert not got[~live].any(), what


@pytest.mark.parametrize("m,n,box,e_p", [(4, 300, 4.0, 4.0), (32, 900, 3.0, 2.5),
                                         (128, 1500, 2.0, 4.0)])
def test_v2_and_v1_kernels_match_plain_on_the_card(cuda_device, m, n, box, e_p):
    grid, cnt, xyz, _ = _grid_inputs(cuda_device, m, n, box, seed=m + 1)
    assert bool((cnt == m).any()), "no full cell"
    k = pc.pair_consts(PBFParams(h=1.0, e_p=e_p))
    live = grid.bmask
    ncnt, xng = pc.gather_v1(grid.nbr, cnt, *xyz)

    out2 = pc.phase1_v2_slots(grid.nbr, cnt, *xyz, k)
    out1 = pc.phase1_v1_slots(ncnt, xng, *xyz, k)
    walk = pc.phase1_v1_slots(ncnt, xng, *xyz, k, walk=True)
    ref = pc.phase1_v2_plain(grid.nbr, cnt, *xyz, k)
    for name, a, b, w, r in zip(("pi_raw", "sg", "c2d2", "nlen"), out2, out1, walk, ref):
        if name != "nlen":
            _held(a, r, live, f"v2 {name}")
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=f"v1 {name}")
        torch.testing.assert_close(b, w, rtol=0, atol=0, msg=f"v1 {name} against the walk")
    torch.testing.assert_close(out2[3], ref[3], rtol=0, atol=0)       # nlen exactly
    torch.testing.assert_close(torch.stack(out2[4:]), torch.stack(ref[4:]), rtol=1e-5, atol=0)

    pi, sg, c2d2 = out2[:3]
    lam = -(pi / 1.5 - 1.0) / (c2d2 / 2.25 + ((sg / 1.5) ** 2).sum(-1) + 0.01)
    lam = torch.where(live, lam, 0.0).contiguous()
    d2, s_corr, s_ns = pc.phase2_v2_slots(grid.nbr, cnt, *xyz, lam, k)
    d1 = pc.phase2_v1_slots(ncnt, xng, pc.gather_lam_v1(grid.nbr, lam), *xyz, lam, k)
    ref2 = pc.phase2_v2_plain(grid.nbr, cnt, *xyz, lam, k)
    _held(d2, ref2[0], live, "v2 dsum")
    torch.testing.assert_close(d1[0], d2, rtol=0, atol=0, msg="v1 dsum")
    torch.testing.assert_close(torch.stack([s_corr, s_ns]), torch.stack(ref2[1:]), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("m,e_p", [(32, 4.0), (32, 2.5), (128, 4.0), (128, 2.5)])
def test_phase2_v2_at_its_edges(cuda_device, m, e_p):
    """Phase 2 v2 into NaN-filled blocks against its plain version at M = 32
    and M = 128 (lists span more than one staged chunk of 256 entries), at
    e_p 4 and 2.5, over full rows with two live particles at one position in
    one row (a non-self pair at d2 = 0) and one point alone, whose dsum is
    exactly 0: dsum at 1e-4 of its scale, 0 at dead slots, empty rows and row
    C; each row's partial sums, s_corr at 1e-5 of the rows' scale and s_ns
    exactly, 0 at empty rows; the wrapper's global sums at 1e-5. Epsilon 1e-2
    as in ``test_phase2_at_its_edges``."""
    grid, _ = isolated_point_grid(m, cuda_device, seed=m + 6, coincident=True)
    cnt, *xyz = pc.planes(grid)
    live = grid.bmask
    k = pc.pair_consts(PBFParams(h=1.0, e_p=e_p, epsilon=1e-2))
    lam = pc.phase1_plain(grid.nbr, cnt, *xyz, torch.ones_like(xyz[0]), k)[0].contiguous()
    args = (grid.nbr, cnt, *xyz, lam, k)
    assert int(grid.prow[1]) == int(grid.prow[2]) < grid.max_cells
    assert int(cnt[grid.nbr.long()].sum(1).max()) > 256
    dsum_p, corr_p, ns_p = pc.phase2_v2_plain(*args)
    part_p = plain_row_partials(*args)
    leave_nan_blocks(cuda_device, tuple(dsum_p.shape), (cnt.numel(), 2))
    dsum, part = phase2_part(pc, "pbf_phase2_v2", args)
    _held(dsum, dsum_p, live, "v2 dsum")
    empty = cnt == 0
    assert torch.equal(part[empty], torch.zeros_like(part[empty]))       # NaN where unwritten
    torch.testing.assert_close(part[:, 0], part_p[:, 0], rtol=0,
                               atol=1e-5 * float(part_p[:, 0].abs().max()))
    torch.testing.assert_close(part[:, 1], part_p[:, 1], rtol=0, atol=0)
    _, corr, ns = pc.phase2_v2_slots(*args)
    torch.testing.assert_close(torch.stack([corr, ns]), torch.stack([corr_p, ns_p]), rtol=1e-5,
                               atol=0)
    row, col = int(grid.prow[0]), int(grid.pcol[0])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "point 0 is not alone"
    assert not dsum[row, col].any()


def _bands_present(cnt, m):
    """Every band of ``GRADED_BANDS`` up to m holds a live row."""
    live = cnt[cnt > 0]
    return all(bool(((live >= lo) & (live <= hi)).any()) for lo, hi in GRADED_BANDS if hi <= m)


@pytest.mark.parametrize("m,eps", [(32, 1e-2), (32, 1e-8), (128, 1e-2), (128, 1e-8)])
def test_phase1_v2_at_its_edges(cuda_device, m, eps):
    """Phase 1 v2 (row 6) into NaN-filled blocks against its plain version at
    M = 32 and M = 128 over ``graded_rows_grid``: rows of 1-8, 9-16, 17-24
    and more live slots, so that every count of centre slots a lane and of
    passes runs, lists longer than a staged chunk, live particles paired at
    d2 = 0 in one row, and one point alone. pi_raw and c2d2 at 1e-4 of their
    scale, nlen exact, all 0 at dead slots, empty rows and row C; the global
    sums at 1e-5; the lone point's pi_raw and nlen bit for bit (its self pair
    alone); and every output bit for bit against phase 1 v1's walk (row 4).
    sg is held to the plain version at epsilon 1e-2 only: at the default 1e-8
    the d2 = 0 pairs' cg ~ 1e5 cancels in sg, so two summation orders part by
    their rounding of those terms, and only the walk's order holds it."""
    grid, _ = graded_rows_grid(m, cuda_device, seed=m + 11)
    cnt, *xyz = pc.planes(grid)
    assert _bands_present(cnt, m)
    assert int(cnt[grid.nbr.long()].sum(1).max()) > 256
    live = grid.bmask
    k = pc.pair_consts(PBFParams(h=1.0, epsilon=eps))
    args = (grid.nbr, cnt, *xyz, k)
    want = pc.phase1_v2_plain(*args)
    leave_nan_blocks(cuda_device, *(tuple(w.shape) for w in want[:4]))
    got = pc.phase1_v2_slots(*args)
    for name, g, w in zip(("pi_raw", "sg", "c2d2"), got, want):
        if name != "sg" or eps == 1e-2:
            _held(g, w, live, f"row 6 {name}")
    assert not got[1][~live].any()
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)       # nlen exactly
    torch.testing.assert_close(torch.stack(got[4:]), torch.stack(want[4:]), rtol=1e-5, atol=0)
    row, col = int(grid.prow[-1]), int(grid.pcol[-1])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "the last point is not alone"
    for g, w in ((got[0], want[0]), (got[3], want[3])):
        assert torch.equal(g[row, col:col + 1].view(torch.int32), w[row, col:col + 1].view(torch.int32))
    ncnt, xng = pc.gather_v1(grid.nbr, cnt, *xyz)
    walk = pc.phase1_v1_slots(ncnt, xng, *xyz, k, walk=True)
    for name, g, w in zip(("pi_raw", "sg", "c2d2", "nlen"), got, walk):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"row 6 {name} against the walk"


@pytest.mark.parametrize("m,e_p", [(32, 4.0), (32, 2.5), (128, 4.0), (128, 2.5)])
def test_phase2_v1_at_its_edges(cuda_device, m, e_p):
    """Phase 2 v1 (row 5) through its C entry into NaN-filled blocks against
    its plain version at M = 32 and M = 128, at e_p 4 and 2.5, over
    ``graded_rows_grid`` (rows of every band, so one and two passes of one and
    two centre slots a lane, d2 = 0 pairs in one row, one point alone), its
    gathered rows followed by guard rows that hold live neighbours
    (``guarded_gather``), which row C must not read: dsum at 1e-4 of its
    scale, 0 at dead slots, empty rows and row C; each row's partial sums
    against ``plain_row_partials`` (s_corr at 1e-5 of the rows' scale, s_ns
    exactly, 0 at empty rows and row C); the wrapper's global sums at 1e-5;
    the lone point's dsum exactly 0; dsum and the partial sums bit for bit
    those of phase 2 v2 (row 7) on the same rows. Epsilon 1e-2 as in
    ``test_phase2_v2_at_its_edges``."""
    grid, _ = graded_rows_grid(m, cuda_device, seed=m + 12)
    cnt, *xyz = pc.planes(grid)
    assert _bands_present(cnt, m)
    live = grid.bmask
    k = pc.pair_consts(PBFParams(h=1.0, e_p=e_p, epsilon=1e-2))
    lam = pc.phase1_plain(grid.nbr, cnt, *xyz, torch.ones_like(xyz[0]), k)[0].contiguous()
    ncnt, xng, lng = guarded_gather(grid.nbr, cnt, *xyz, lam)
    args = (ncnt, xng, lng, *xyz, lam, k)
    args2 = (grid.nbr, cnt, *xyz, lam, k)
    dsum_p, corr_p, ns_p = pc.phase2_v1_plain(*args)
    part_p = plain_row_partials(*args2)
    leave_nan_blocks(cuda_device, tuple(dsum_p.shape), (cnt.numel(), 2))
    dsum, part = phase2_part(pc, "pbf_phase2_v1", args)
    _held(dsum, dsum_p, live, "row 5 dsum")
    empty = cnt == 0
    assert torch.equal(part[empty], torch.zeros_like(part[empty]))       # NaN where unwritten
    torch.testing.assert_close(part[:, 0], part_p[:, 0], rtol=0,
                               atol=1e-5 * float(part_p[:, 0].abs().max()))
    torch.testing.assert_close(part[:, 1], part_p[:, 1], rtol=0, atol=0)
    _, corr, ns = pc.phase2_v1_slots(*args)
    torch.testing.assert_close(torch.stack([corr, ns]), torch.stack([corr_p, ns_p]), rtol=1e-5,
                               atol=0)
    row, col = int(grid.prow[-1]), int(grid.pcol[-1])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "the last point is not alone"
    assert not dsum[row, col].any()
    dsum2, part2 = phase2_part(pc, "pbf_phase2_v2", args2)
    torch.testing.assert_close(dsum, dsum2, rtol=0, atol=0)
    torch.testing.assert_close(part, part2, rtol=0, atol=0)


def test_rigid_solver_loop_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """``solver_loop`` with a cylinder through the v2 kernels against the
    plain CPU path: one launch of each v2 kernel per iteration, no CUDA
    tensor reaches a plain version; positions 1e-4, force 1e-3."""
    rng = np.random.default_rng(0)
    pts = (rng.uniform(-2.0, 2.0, (700, 3)) + np.array([32.0, 10.0, -30.0])).astype(np.float32)
    params = PBFParams(h=1.0, dense_max_cells=512, dense_cell_capacity=32)
    spec = RigidSpec(kind="cylinder", center=(0.32, 0.1, -0.3), cylinder_radius=0.7,
                     cylinder_num=(24, 6), particle_radius=0.15)

    def run(device):
        st = make_particle_state(800, pts, init_velocity_y=10.0, device=device)
        st = st._replace(estimate_xyz=st.xyz + 0.05)
        rb = create_rigid_body(spec, np.random.default_rng(0), device=device)
        return solver_loop(st, params, 3, rigid=rb)

    ref, ref_d = run("cpu")
    for name in ("phase1_v2_plain", "phase2_v2_plain"):
        fn = getattr(pc, name)

        def cpu_only(*a, _fn=fn, _name=name, **kw):
            assert a[2].device.type == "cpu", f"{_name} was given a CUDA tensor"
            return _fn(*a, **kw)

        monkeypatch.setattr(pc, name, cpu_only)
    pc.reset_launches()
    got, got_d = run(cuda_device)
    assert (pc.LAUNCHES["pbf_phase1_v2"], pc.LAUNCHES["pbf_phase2_v2"]) == (3, 3)
    assert pc.LAUNCHES["pbf_phase1"] == pc.LAUNCHES["pbf_phase1_v1"] == 0
    assert pc.LAUNCHES["pbf_phase1_v1_walk"] == 0
    torch.testing.assert_close(got.estimate_xyz.cpu(), ref.estimate_xyz, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.force.cpu(), ref.force, rtol=1e-3, atol=1e-3)
    for key in ref_d:
        torch.testing.assert_close(got_d[key].cpu(), ref_d[key], rtol=1e-4, atol=1e-4, msg=key)
