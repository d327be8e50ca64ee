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
from tests.torch_helpers import (  # noqa: F401 (one_intra_op_thread: autouse)
    one_intra_op_thread,  # noqa: F401
    EDGE_CASES, cuda_device, edge_tiles, leave_nan_blocks, packed_tiles, threshold_tiles,
)

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


def _plain_grad(pk, cn, tiles_x, tx, ty, gacc, gft):
    pk_g = pk.clone().requires_grad_(True)
    a_p, f_p, _ = tc.composite_plain(pk_g, cn, tiles_x, tx, ty)
    ((a_p * gacc).sum() + (f_p * gft).sum()).backward()
    live = (torch.arange(pk.shape[1], device=pk.device)[None, :] < cn[:, None])[..., None]
    return pk_g.grad * live, live


def _assert_fields_close(dpk, ref):
    for f in range(ref.shape[-1]):  # one scale per field, as chip_smoke.py holds it
        torch.testing.assert_close(dpk[..., f], ref[..., f], rtol=0,
                                   atol=1e-4 * float(ref[..., f].abs().max()), msg=f"field {f}")


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_kernels_at_edge_cases_match_plain(cuda_device, c, case):
    """A full tile (K 512) and an empty one, counts off every multiple of 32
    and 64, alphas at the .99 clamp, T crossing 1e-4 inside a window, one
    Gaussian in 64 tiles and ids repeated inside a tile: each kernel against
    its plain version; dead slots and the depth column of the gradient are 0
    (written by the kernel into a NaN-filled block), and the combine never
    reads the dead slots (NaN there)."""
    packed, counts, gid, n, tiles_x = edge_tiles(case, c, seed=c)
    pk, cn, gd = (torch.as_tensor(a, device=cuda_device) for a in (packed, counts, gid))
    accum, ft, med, ckpt = tc.composite_fwd(pk, cn, tiles_x, 16, 16)
    for a, b in zip((accum, ft, med), tc.composite_plain(pk, cn, tiles_x, 16, 16)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    ref, live = _plain_grad(pk, cn, tiles_x, 16, 16, gacc, gft)
    leave_nan_blocks(cuda_device, pk.shape)
    dpk = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, tiles_x, 16, 16)
    assert not dpk[~live.expand_as(dpk)].any() and not dpk[..., -1].any()
    _assert_fields_close(dpk, ref)
    g = torch.where(live, dpk, torch.full_like(dpk, float("nan")))
    out = tc.combine_rows(g, gd, cn, n)
    out_p = tc.combine_plain(g, gd, cn, n)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5 * float(out_p.abs().max()))


def test_combine_takes_unaligned_rows(cuda_device):
    """Rows that start off a 16- or 8-byte boundary are added a float at a
    time, F = 8 and F = 10 alike."""
    for c in (1, 3):
        packed, counts, gid, n, _ = edge_tiles("shared", c)
        gd, cn = torch.as_tensor(gid, device=cuda_device), torch.as_tensor(counts, device=cuda_device)
        g = torch.randn(packed.shape, device=cuda_device)
        flat = torch.empty(g.numel() + 1, device=cuda_device)
        g_off = flat[1:].view(g.shape).copy_(g)
        out_p = tc.combine_plain(g, gd, cn, n)
        torch.testing.assert_close(tc.combine_rows(g_off, gd, cn, n), out_p, rtol=0,
                                   atol=1e-5 * float(out_p.abs().max()))


# tiles beside the main path's 16 x 16: no multiple of 32 or 64 pixels, odd
# pixel counts, and over 1 024 pixels (run as chunks of tc.BLOCK_P)
OTHER_TILES = [(5, 5), (12, 12), (10, 10), (48, 32), (64, 32), (64, 64)]


@pytest.mark.parametrize("tile", [(16, 16), (8, 8), (16, 8), (32, 16), (24, 8), (8, 4), (12, 8),
                                  (32, 32), (64, 16), (16, 6)] + OTHER_TILES)
def test_backward_at_each_tile_size(cuda_device, tile):
    """The forward and the backward take every tile and match their plain
    versions there; the splats spread over the whole tile, so each chunk of
    a tile over 1 024 pixels draws."""
    tx, ty = tile
    packed, counts, _ = packed_tiles(t=6, k=96, c=3, seed=5, tiles_x=3, tile=max(tx, ty))
    pk = torch.as_tensor(packed, device=cuda_device)
    cn = torch.as_tensor(counts, device=cuda_device)
    accum, ft, med, ckpt = tc.composite_fwd(pk, cn, 3, tx, ty)
    for a, b in zip((accum, ft, med), tc.composite_plain(pk, cn, 3, tx, ty)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    ref, live = _plain_grad(pk, cn, 3, tx, ty, gacc, gft)
    leave_nan_blocks(cuda_device, pk.shape)
    dpk = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, 3, tx, ty)
    assert not dpk[~live.expand_as(dpk)].any() and not dpk[..., -1].any()
    _assert_fields_close(dpk, ref)


def _nan_outputs(t, k, c, p, device):
    """NaN-filled blocks of the forward's four output shapes."""
    leave_nan_blocks(device, (t, c, p), (t, 1, p), (t, 1, p), (t, -(-k // tc.CKPT), p))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _live_windows(counts, k):
    nwin = (counts.long() + tc.CKPT - 1) // tc.CKPT
    w = torch.arange(-(-k // tc.CKPT), device=counts.device)[None, :]
    return w < nwin[:, None], w == nwin[:, None] - 1


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_forward_at_edge_cases(cuda_device, c, case):
    """The forward into NaN-filled blocks against its plain version at each
    edge case, and its box skip changing no bit of what it writes (against
    the same kernel walking every live slot at every pixel)."""
    packed, counts, _, _, tiles_x = edge_tiles(case, c, seed=c)
    pk, cn = torch.as_tensor(packed, device=cuda_device), torch.as_tensor(counts, device=cuda_device)
    t, k, _ = pk.shape
    _nan_outputs(t, k, c, 256, cuda_device)
    out = tc.composite_fwd(pk, cn, tiles_x, 16, 16)
    for a, b in zip(out[:3], tc.composite_plain(pk, cn, tiles_x, 16, 16)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    full = tc.composite_fwd(pk, cn, tiles_x, 16, 16, box_skip=False)
    for a, b in zip(out[:3], full[:3]):
        assert torch.equal(_bits(a), _bits(b))
    live, _ = _live_windows(cn, k)
    assert torch.equal(_bits(out[3][live]), _bits(full[3][live]))


@pytest.mark.parametrize("tile", [(8, 4), (16, 6), (32, 5), (32, 1)] + OTHER_TILES)
def test_forward_masks_spare_lanes(cuda_device, tile):
    """Tiles whose last warp holds spare lanes without pixels (a multiple of
    32 pixels that is not one of 64, or of no 32), an odd pixel count (a
    thread's second pixel past the tile, the rows on odd floats), tiles run
    as chunks: every pixel is still written, and matches the plain
    version."""
    tx, ty = tile
    packed, counts, _ = packed_tiles(t=6, k=96, c=3, seed=7, tiles_x=3, tile=max(tx, ty))
    pk, cn = torch.as_tensor(packed, device=cuda_device), torch.as_tensor(counts, device=cuda_device)
    _nan_outputs(6, 96, 3, tx * ty, cuda_device)
    out = tc.composite_fwd(pk, cn, 3, tx, ty)
    for a, b in zip(out[:3], tc.composite_plain(pk, cn, 3, tx, ty)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_a_launch_of_70_000_tiles(cuda_device):
    """70 000 tiles of 4 x 4 pixels in one launch (more than the 65 536 the
    tile order once held): forward and backward against their plain
    versions, the combine against ``index_add_``."""
    t, tiles_x = 70_000, 350
    packed, counts, _ = packed_tiles(t=t, k=8, c=3, seed=9, tiles_x=tiles_x, tile=4)
    pk = torch.as_tensor(packed, device=cuda_device)
    cn = torch.as_tensor(counts, device=cuda_device)
    _nan_outputs(t, 8, 3, 16, cuda_device)
    accum, ft, med, ckpt = tc.composite_fwd(pk, cn, tiles_x, 4, 4)
    for a, b in zip((accum, ft, med), tc.composite_plain(pk, cn, tiles_x, 4, 4)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    ref, live = _plain_grad(pk, cn, tiles_x, 4, 4, gacc, gft)
    dpk = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, tiles_x, 4, 4)
    assert not dpk[~live.expand_as(dpk)].any()
    _assert_fields_close(dpk, ref)
    gid = torch.randint(0, 5000, (t, 8), generator=gen, device=cuda_device)
    out_p = tc.combine_plain(dpk, gid, cn, 5000)
    torch.testing.assert_close(tc.combine_rows(dpk, gid, cn, 5000), out_p, rtol=0,
                               atol=1e-5 * float(out_p.abs().max()))


def test_a_chunked_backward_repeats_bit_for_bit(cuda_device):
    """Tiles of 64 x 32 = 2 048 pixels run as two chunks, whose sums are
    added in chunk order with no atomics: two backwards give the same bits,
    and match the plain version."""
    packed, counts, _ = packed_tiles(t=6, k=96, c=3, seed=11, tiles_x=3, tile=64)
    pk = torch.as_tensor(packed, device=cuda_device)
    cn = torch.as_tensor(counts, device=cuda_device)
    accum, ft, _, ckpt = tc.composite_fwd(pk, cn, 3, 64, 32)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    first = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, 3, 64, 32)
    second = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, 3, 64, 32)
    assert torch.equal(_bits(first), _bits(second))
    _assert_fields_close(first, _plain_grad(pk, cn, 3, 64, 32, gacc, gft)[0])


@pytest.mark.parametrize("case", EDGE_CASES + ("threshold",))
def test_backward_takes_the_forwards_checkpoints(cuda_device, case):
    """The backward fed the forward's checkpoints and final T: its re-sweep
    reaches, bit for bit, the forward's next checkpoint at each live
    window's end and its final T after the last; its gradient is the same
    bits whether the forward skipped slots or walked every one, and (but at
    the threshold tiles, where torch's exp rounds some alphas to the other
    side of 1/255) matches the plain version."""
    if case == "threshold":
        packed, counts, tiles_x = threshold_tiles(3, seed=3)
    else:
        packed, counts, _, _, tiles_x = edge_tiles(case, 3, seed=3)
    pk, cn = torch.as_tensor(packed, device=cuda_device), torch.as_tensor(counts, device=cuda_device)
    k = pk.shape[1]
    accum, ft, _, ckpt = tc.composite_fwd(pk, cn, tiles_x, 16, 16)
    _, ft_full, _, ckpt_full = tc.composite_fwd(pk, cn, tiles_x, 16, 16, box_skip=False)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    gacc = torch.randn(accum.shape, generator=gen, device=cuda_device)
    gft = torch.randn(ft.shape, generator=gen, device=cuda_device)
    dpk, t_end = tc.composite_bwd(pk, cn, gacc, gft, ft, ckpt, tiles_x, 16, 16, resweep=True)
    live, last = _live_windows(cn, k)
    want = torch.where(last[..., None], ft, torch.cat([ckpt[:, 1:], ckpt[:, :1]], 1))
    assert torch.equal(_bits(t_end[live]), _bits(want[live]))
    dpk_full = tc.composite_bwd(pk, cn, gacc, gft, ft_full, ckpt_full, tiles_x, 16, 16)
    assert torch.equal(_bits(dpk), _bits(dpk_full))
    if case != "threshold":
        _assert_fields_close(dpk, _plain_grad(pk, cn, tiles_x, 16, 16, gacc, gft)[0])


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
