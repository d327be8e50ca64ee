"""The rasterizer's CUDA kernels (fluidnexus_torch/csrc/rasterizer.cu) against
their plain PyTorch versions, on the card. Every test here is marked `cuda`
and skips where there is no card. The file imports no JAX, so on a machine
with the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.ops import rasterizer as tr
from fluidnexus_torch.ops import rasterizer_cuda as tc
from tests.torch_helpers import cuda_device, packed_tiles  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("c", [1, 3])
def test_kernels_match_plain_on_the_card(cuda_device, c):
    packed, counts, _ = packed_tiles(t=6, k=96, c=c, seed=4)
    pk = torch.as_tensor(packed, device=cuda_device)
    cn = torch.as_tensor(counts, device=cuda_device)
    plain = tc.composite_plain(pk, cn, 3, 16, 16)
    accum, ft, med, ckpt = tc.composite_fwd(pk, cn, 3, 16, 16)
    for a, b in zip((accum, ft, med), plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    pk_g = pk.clone().requires_grad_(True)
    a_p, f_p, _ = tc.composite_plain(pk_g, cn, 3, 16, 16)
    ((a_p * gacc).sum() + (f_p * gft).sum()).backward()
    dpk = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, 3, 16, 16)
    live = (torch.arange(96, device=cuda_device)[None, :] < cn[:, None])[..., None]
    ref = pk_g.grad * live
    for f in range(ref.shape[-1]):  # one scale per field, as chip_smoke.py holds it
        torch.testing.assert_close(dpk[..., f], ref[..., f], rtol=0,
                                   atol=1e-4 * float(ref[..., f].abs().max()), msg=f"field {f}")
    gid = torch.randint(0, 40, (6, 96), generator=gen, device=cuda_device)
    torch.testing.assert_close(tc.combine_rows(dpk, gid, cn, 40),
                               tc.combine_plain(dpk, gid, cn, 40), atol=1e-5, rtol=1e-5)


def _scene(n, c, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.8, 0.8, (n, 3))
    scales = np.exp(rng.uniform(-3.5, -2.0, (n, 3)))
    rots = rng.normal(size=(n, 4))
    ops = rng.uniform(0.2, 0.9, (n,))
    cols = rng.uniform(0, 1, (n, c))
    return [torch.as_tensor(a, dtype=torch.float32) for a in (means, cols, ops, scales, rots)]


@pytest.mark.parametrize("c", [1, 3])
def test_rasterize_on_the_card_matches_the_cpu(cuda_device, c, monkeypatch):
    """``rasterize`` through the kernels on the card against the plain CPU
    path, forward and gradients; no CUDA tensor reaches a plain version."""
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cam = Camera(uid=0, R=R, T=-R.T @ np.array([0.0, 0.0, 3.0]), fovx=0.8, fovy=0.6,
                 width=80, height=48)
    cfg = tr.RasterizerConfig(tile_capacity=64, chunk=16, dup_x=4, dup_y=2)

    def run(device):
        args = [a.to(device).requires_grad_(True) for a in _scene(120, c, seed=c)]
        out = tr.rasterize(*args, view_matrix=torch.as_tensor(cam.world_view, device=device),
                           proj_matrix=torch.as_tensor(cam.full_proj, device=device),
                           tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                           height=cam.height, bg_color=torch.zeros(c, device=device), config=cfg)
        ((out.color ** 2).sum() + 0.3 * out.final_t.sum()).backward()
        return out, [a.grad for a in args]

    out_c, g_c = run("cpu")
    for name in ("composite_plain", "combine_plain"):
        fn = getattr(tc, name)

        def cpu_only(*a, _fn=fn, _name=name, **k):
            assert a[0].device.type == "cpu", f"{_name} was given a CUDA tensor"
            return _fn(*a, **k)

        monkeypatch.setattr(tc, name, cpu_only)
    tc.reset_launches()
    out_d, g_d = run(cuda_device)
    assert all(v == 1 for v in tc.LAUNCHES.values()), tc.LAUNCHES
    for name in ("color", "final_t", "depth"):
        torch.testing.assert_close(getattr(out_d, name).cpu(), getattr(out_c, name), atol=1e-4,
                                   rtol=0)
    for name, a, b in zip(("means", "cols", "ops", "scales", "rots"), g_d, g_c):
        scale = max(float(b.abs().max()), 1e-6)
        torch.testing.assert_close(a.cpu(), b, atol=2e-3 * scale, rtol=0, msg=name)
