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

from fluidnexus_torch.ops.neighbors import bin_queries, build_dense_grid, slot_gather
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim import pbf_cuda as pc
from fluidnexus_torch.sim import splat_cuda as sc
from fluidnexus_torch.sim.state import make_particle_state
from tests.torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _held(got, want, live, tol=1e-4):
    """``got`` against ``want`` on live slots at ``tol`` of the field's
    scale; 0 at dead slots."""
    scale = float(want[live].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=tol * scale)
    assert not got[~live].any()


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


@pytest.mark.parametrize("ms,mq", [(8, 32), (32, 8), (128, 64)])
def test_splat_kernels_match_plain_on_the_card(cuda_device, ms, mq):
    """Both splat kernels at unequal source and query capacities, with
    queries outside the source box."""
    rng = np.random.default_rng(ms + mq)
    dev = cuda_device
    src = torch.as_tensor(rng.uniform(0, 3, (1200, 3)).astype(np.float32), device=dev)
    qry = rng.uniform(-0.5, 3.5, (900, 3)).astype(np.float32)
    qry[:30] -= 40.0
    qry = torch.as_tensor(qry, device=dev)
    alive = torch.as_tensor(rng.random(1200) > 0.1, device=dev)
    q_alive = torch.as_tensor(rng.random(900) > 0.1, device=dev)
    grid = build_dense_grid(src, 1.0, alive, 512, ms)
    qgrid, rnbr = bin_queries(grid, 1.0, qry, q_alive, 512, mq)
    planes, qplanes = pc.planes(grid), pc.planes(qgrid)
    vel = slot_gather(grid, torch.as_tensor(rng.normal(size=(1200, 3)).astype(np.float32),
                                            device=dev)).contiguous()
    qlive, slive = qgrid.bmask, grid.bmask
    wv, ws = sc.splat_fwd_slots(qgrid.nbr, *qplanes, *planes, vel, 1.0)
    wv_p, ws_p = sc.splat_fwd_plain(qgrid.nbr, *qplanes, *planes, vel, 1.0)
    _held(ws, ws_p, qlive)
    _held(wv, wv_p, qlive[..., None].expand(-1, -1, 3))
    p = torch.where(qlive[..., None], torch.as_tensor(
        rng.normal(size=qlive.shape + (3,)).astype(np.float32), device=dev), 0.0).contiguous()
    q = torch.where(qlive, torch.as_tensor(rng.normal(size=qlive.shape).astype(np.float32),
                                           device=dev), 0.0).contiguous()
    gx, gv = sc.splat_bwd_slots(rnbr, *planes, vel, *qplanes, p, q, 1.0)
    gx_p, gv_p = sc.splat_bwd_plain(rnbr, *planes, vel, *qplanes, p, q, 1.0)
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
