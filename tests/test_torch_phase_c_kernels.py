"""The gas-density kernels (fluidnexus_torch/csrc/pbf.cu) and the velocity
splat kernels (csrc/splat.cu) against their plain PyTorch versions, and the
two differentiable sums through them against the CPU, on the card. Every
test here is marked `cuda` and skips where there is no card. The file imports
no JAX, so on a machine with the card it runs without the JAX package's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phase_c_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.ops.neighbors import build_dense_grid, slot_gather, sort_queries
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda as pc
from fluidnexus_torch.sim import splat_cuda as sc
from fluidnexus_torch.sim.state import make_particle_state
from tests.torch_helpers import (  # noqa: F401 (one_intra_op_thread: autouse)
    ISOLATED_GRIDS, cuda_device, isolated_point_grid, leave_nan_blocks, listed_mask,
    one_intra_op_thread, splat_edge_args, splat_fwd_edge_args,
)

pytestmark = pytest.mark.cuda


def _held(got, want, live, tol=1e-4, zero=None):
    """``got`` against ``want`` on live slots at ``tol`` of the field's
    scale; 0 at dead slots (at ``zero`` where given: the splat forward's
    entries past its rows are not written)."""
    scale = float(want[live].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=tol * scale)
    assert not got[~live if zero is None else zero].any()


def _held_fwd(got, want, qstart, qcnt):
    """The splat forward's (Nq+1, 4) output against its plain version's on
    the listed entries, field by field (wv, ws), and 0 at entry Nq."""
    listed = listed_mask(qstart, qcnt, got.shape[0] - 1)
    last = torch.zeros_like(listed)
    last[-1] = True
    _held(got[:, 3], want[:, 3], listed, zero=last)
    _held(got[:, :3], want[:, :3], listed[:, None].expand(-1, 3), zero=last)


@pytest.mark.parametrize("m,n,box", [(4, 300, 4.0), (32, 900, 3.0), (128, 1500, 2.0)])
def test_density_kernels_match_plain_on_the_card(cuda_device, m, n, box):
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.uniform(0, box, (n, 3)).astype(np.float32), device=cuda_device)
    alive = torch.as_tensor(rng.random(n) > 0.1, device=cuda_device)
    grid = build_dense_grid(x, 1.0, alive, 512, m)
    cnt, *xyz = pc.planes(grid)
    assert bool((cnt == m).any()), "no full cell"
    k = pc.pair_consts(tpbf.PBFParams(h=1.0))
    live = grid.bmask
    _held(pc.density_slots(grid.nbr, cnt, *xyz, k), pc.density_plain(grid.nbr, cnt, *xyz, k), live)
    g = torch.as_tensor(rng.standard_normal(live.shape).astype(np.float32), device=cuda_device)
    g = torch.where(live, g, 0.0).contiguous()
    _held(pc.density_bwd_slots(grid.nbr, cnt, *xyz, g, k),
          pc.density_bwd_plain(grid.nbr, cnt, *xyz, g, k), live[..., None].expand(-1, -1, 3))


@pytest.mark.parametrize("m,n,box", [(32, 900, 3.0), (128, 1500, 2.0)])
def test_density_bwd_at_its_edges(cuda_device, m, n, box):
    """The density's adjoint into a NaN-filled block against its plain
    version at M = 32 and M = 128 (a row of 128 live slots takes four passes
    and its neighbourhood several staged chunks), with full rows and one
    point alone, whose 26 neighbour cells are empty: its gradient is the self
    pair's exact 0."""
    assert ISOLATED_GRIDS[m] == (n, box)
    grid, rng = isolated_point_grid(m, cuda_device, seed=m + 1)
    cnt, *xyz = pc.planes(grid)
    assert bool((cnt == m).any()), "no full cell"
    k = pc.pair_consts(tpbf.PBFParams(h=1.0))
    live = grid.bmask
    g = torch.where(live, torch.as_tensor(rng.standard_normal(live.shape).astype(np.float32),
                                          device=cuda_device), 0.0).contiguous()
    leave_nan_blocks(cuda_device, live.shape + (3,))
    got = pc.density_bwd_slots(grid.nbr, cnt, *xyz, g, k)
    _held(got, pc.density_bwd_plain(grid.nbr, cnt, *xyz, g, k), live[..., None].expand(-1, -1, 3))
    row, col = int(grid.prow[0]), int(grid.pcol[0])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "point 0 is not alone"
    assert not got[row, col].any()


@pytest.mark.parametrize("m", [32, 128])
def test_density_at_its_edges(cuda_device, m):
    """The gas-loss density into a NaN-filled block against its plain
    version at M = 32 and M = 128 with full rows (a row's neighbourhood list
    spans more than one staged chunk of 384 entries), and one point alone,
    whose 26 neighbour cells are empty: its pi is the self term alone, the
    plain version's bit for bit."""
    grid, _ = isolated_point_grid(m, cuda_device, seed=m + 2)
    cnt, *xyz = pc.planes(grid)
    assert bool((cnt == m).any()), "no full cell"
    assert int(cnt[grid.nbr.long()].sum(1).max()) > 384, "no list spans two chunks"
    k = pc.pair_consts(tpbf.PBFParams(h=1.0))
    want = pc.density_plain(grid.nbr, cnt, *xyz, k)
    leave_nan_blocks(cuda_device, tuple(want.shape))
    got = pc.density_slots(grid.nbr, cnt, *xyz, k)
    _held(got, want, grid.bmask)
    row, col = int(grid.prow[0]), int(grid.pcol[0])
    assert int(cnt[grid.nbr[row].long()].sum()) == 1, "point 0 is not alone"
    assert torch.equal(got[row, col:col + 1].view(torch.int32), want[row, col:col + 1].view(torch.int32))


@pytest.mark.parametrize("ms,pile", [(32, 0), (128, 0), (32, 300), (128, 300)])
def test_splat_bwd_at_its_edges(cuda_device, ms, pile):
    """The splat adjoint into NaN-filled blocks against its plain version at
    source capacities 32 and 128, without and with a pile of 300 queries in
    one cell: full source rows, query lists that span more than one staged
    chunk of 256 entries (with the pile, a list of over 300 from one row),
    source rows with no query in reach, which read exactly 0, and row Cs."""
    args = splat_edge_args(ms, pile, cuda_device, seed=ms + pile + 1)
    rnbr, scnt, qcnt = args[0], args[1], args[7]
    lists = qcnt[rnbr.long()].sum(1)
    assert bool((scnt == ms).any()) and int(lists.max()) > 256
    assert int(qcnt.max()) > (256 if pile else 0)
    none = (lists == 0) & (scnt[:-1] > 0)
    assert bool(none.any()), "every source row has a query in reach"
    gx_p, gv_p = sc.splat_bwd_plain(*args)
    leave_nan_blocks(cuda_device, tuple(gx_p.shape), tuple(gv_p.shape))
    gx, gv = sc.splat_bwd_slots(*args)
    slive = pc._live(scnt, args[2].shape[1])[..., None].expand(-1, -1, 3)
    _held(gx, gx_p, slive)
    _held(gv, gv_p, slive)
    assert not gx[:-1][none].any() and not gv[:-1][none].any()
    assert not gx[-1].any() and not gv[-1].any()


@pytest.mark.parametrize("ms,pile", [(32, 0), (128, 0), (32, 300), (128, 300)])
def test_splat_fwd_at_its_edges(cuda_device, ms, pile):
    """The splat forward into a NaN-filled block against its plain version
    at source capacities 32 and 128, without and with a pile of 300 queries
    in one cell (a row of ten 32-query work items, the last ragged): full
    source rows whose query rows' source lists span more than one staged
    chunk of 256 entries, over 1 024 query rows (two tiles of the work items'
    scan) with no source in reach, which read exactly 0, and entry Nq, which
    reads 0."""
    args = splat_fwd_edge_args(ms, pile, cuda_device, seed=ms + pile + 3)
    qnbr, qstart, qcnt, scnt = args[0], args[1], args[2], args[6]
    lists = scnt[qnbr.long()].sum(1)
    assert bool((scnt == ms).any()) and int(lists.max()) > 256
    assert int(qcnt.max()) > (256 if pile else 0) and int((qcnt > 0).sum()) > 1024
    nq = args[3].shape[0]
    want = sc.splat_fwd_plain(*args)
    leave_nan_blocks(cuda_device, tuple(want.shape))
    got = sc.splat_fwd_slots(*args)
    _held_fwd(got, want, qstart, qcnt)
    none_rows = torch.nonzero((lists == 0) & (qcnt[:-1] > 0)).flatten()
    assert len(none_rows), "every query row has a source in reach"
    none = listed_mask(qstart, torch.where(
        torch.isin(torch.arange(qcnt.numel(), device=qcnt.device), none_rows), qcnt, 0), nq)
    assert not got[none].any() and not got[-1].any()


@pytest.mark.parametrize("ms,pile", [(8, 0), (32, 40), (128, 200)])
def test_splat_kernels_match_plain_on_the_card(cuda_device, ms, pile):
    """Both splat kernels at source capacities 8, 32 and 128 with queries
    outside the source box and piles of 0, 40 and 200 queries on one spot."""
    rng = np.random.default_rng(ms + pile)
    dev = cuda_device
    src = torch.as_tensor(rng.uniform(0, 3, (1200, 3)).astype(np.float32), device=dev)
    qry = rng.uniform(-0.5, 3.5, (900 + pile, 3)).astype(np.float32)
    qry[:30] -= 40.0
    qry[900:] = 1.7
    qry = torch.as_tensor(qry, device=dev)
    alive = torch.as_tensor(rng.random(1200) > 0.1, device=dev)
    q_alive = torch.as_tensor(rng.random(900 + pile) > 0.1, device=dev)
    grid = build_dense_grid(src, 1.0, alive, 512, ms)
    ql = sort_queries(grid, 1.0, qry, q_alive, 512)
    planes = pc.planes(grid)
    lst = (ql.start, ql.cnt, ql.x, ql.y, ql.z)
    vel = slot_gather(grid, torch.as_tensor(rng.normal(size=(1200, 3)).astype(np.float32),
                                            device=dev)).contiguous()
    slive = grid.bmask
    _held_fwd(sc.splat_fwd_slots(ql.nbr, *lst, *planes, vel, 1.0),
              sc.splat_fwd_plain(ql.nbr, *lst, *planes, vel, 1.0), ql.start, ql.cnt)
    p = torch.as_tensor(rng.normal(size=(900 + pile, 3)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(size=900 + pile).astype(np.float32), device=dev)
    gx, gv = sc.splat_bwd_slots(ql.rnbr, *planes, vel, *lst, p, q, 1.0)
    gx_p, gv_p = sc.splat_bwd_plain(ql.rnbr, *planes, vel, *lst, p, q, 1.0)
    _held(gx, gx_p, slive[..., None].expand(-1, -1, 3))
    _held(gv, gv_p, slive[..., None].expand(-1, -1, 3))


def test_sums_on_the_card_match_the_cpu(cuda_device, monkeypatch):
    """density_ratio_at and visual_xyz_from_nn, values and gradients,
    through the kernels against the plain CPU path; each kernel launches once
    per call, and no CUDA tensor reaches a plain version."""
    rng = np.random.default_rng(0)
    n, nq = 700, 500
    pts = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    vis = rng.uniform(0, 5, (nq, 3)).astype(np.float32)
    nn0 = (pts + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    params = tpbf.PBFParams(h=1.0, dense_max_cells=512, dense_cell_capacity=32, scale_factor=1.0)

    def run(device):
        st = make_particle_state(800, pts, init_velocity_y=10.0, device=device)
        nn = torch.zeros((800, 3), device=device)
        nn[:n] = torch.as_tensor(nn0, device=device)
        nn.requires_grad_(True)
        va = torch.ones(nq, dtype=torch.bool, device=device)
        adv = tpbf.visual_xyz_from_nn(torch.as_tensor(vis, device=device), va, nn, st, params)
        r = tpbf.density_ratio_at(nn, st.alive, st.imass, params)
        loss = adv.square().sum() + torch.where(st.alive, (r - 1.0) ** 2, 0.0).sum()
        return adv.detach(), r.detach(), torch.autograd.grad(loss, nn)[0]

    ref = run("cpu")
    for mod, names in ((pc, ("density_plain", "density_bwd_plain")),
                       (sc, ("splat_fwd_plain", "splat_bwd_plain"))):
        for name in names:
            fn = getattr(mod, name)

            def cpu_only(*a, _fn=fn, _name=name, **kw):
                assert all(t.device.type == "cpu" for t in a if torch.is_tensor(t)), \
                    f"{_name} was given a CUDA tensor"
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, cpu_only)
    pc.reset_launches()
    sc.reset_launches()
    got = run(cuda_device)
    assert (pc.LAUNCHES["density_fwd"], pc.LAUNCHES["density_bwd"]) == (1, 1)
    assert sc.LAUNCHES == {"splat_fwd": 1, "splat_bwd": 1}
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4 * float(b.abs().max()))
