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
from tests.torch_helpers import cuda_device  # noqa: F401

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
    out1 = pc.phase1_v1_slots(ncnt, xng, cnt, *xyz, k)
    ref = pc.phase1_v2_plain(grid.nbr, cnt, *xyz, k)
    for name, a, b, r in zip(("pi_raw", "sg", "c2d2"), out2, out1, ref):
        _held(a, r, live, f"v2 {name}")
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=f"v1 {name}")
    torch.testing.assert_close(out2[3], ref[3], rtol=0, atol=0)       # nlen exactly
    torch.testing.assert_close(torch.stack(out2[4:]), torch.stack(ref[4:]), rtol=1e-5, atol=0)

    pi, sg, c2d2 = out2[:3]
    lam = -(pi / 1.5 - 1.0) / (c2d2 / 2.25 + ((sg / 1.5) ** 2).sum(-1) + 0.01)
    lam = torch.where(live, lam, 0.0).contiguous()
    d2, s_corr, s_ns = pc.phase2_v2_slots(grid.nbr, cnt, *xyz, lam, k)
    d1 = pc.phase2_v1_slots(ncnt, xng, pc.gather_lam_v1(grid.nbr, lam), cnt, *xyz, lam, k)
    ref2 = pc.phase2_v2_plain(grid.nbr, cnt, *xyz, lam, k)
    _held(d2, ref2[0], live, "v2 dsum")
    torch.testing.assert_close(d1[0], d2, rtol=0, atol=0, msg="v1 dsum")
    torch.testing.assert_close(torch.stack([s_corr, s_ns]), torch.stack(ref2[1:]), rtol=1e-5,
                               atol=0)


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
    torch.testing.assert_close(got.estimate_xyz.cpu(), ref.estimate_xyz, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.force.cpu(), ref.force, rtol=1e-3, atol=1e-3)
    for key in ref_d:
        torch.testing.assert_close(got_d[key].cpu(), ref_d[key], rtol=1e-4, atol=1e-4, msg=key)
