"""Parity of the port's rasterizer (fluidnexus_torch.ops.rasterizer and the
plain versions in rasterizer_cuda) with the JAX package, on the CPU. The
Pallas kernels run in interpret mode, as the JAX package's own tests run them.
The kernels themselves are held against the same plain versions on the card
by chip_smoke.py and by tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.ops import rasterizer as jr
from fluidnexus_tpu.ops.rasterizer_pallas import combine_rows_rmw, composite_tiles_packed
from fluidnexus_torch.ops import rasterizer as tr
from fluidnexus_torch.ops import rasterizer_cuda as tc
from tests.test_rasterizer import make_camera, random_scene
from tests.torch_helpers import EDGE_CASES, edge_tiles
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_helpers import packed_tiles as _packed_tiles


def _t(x):
    return torch.as_tensor(np.array(x))


def _cam_args(cam):
    return (cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy, cam.width, cam.height)


def _project_both(n=60, seed=0, width=64, height=48):
    cam = make_camera(width=width, height=height)
    means, cols, ops, scales, rots = random_scene(n=n, c=3, seed=seed)
    alive = np.ones(n, bool)
    alive[::7] = False
    vm, pm, tfx, tfy, w, h = _cam_args(cam)
    pj = jr.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(rots),
                              jnp.asarray(vm), jnp.asarray(pm), tfx, tfy, w, h,
                              alive=jnp.asarray(alive))
    pt = tr.project_gaussians(_t(means), _t(scales), _t(rots), _t(vm), _t(pm), tfx, tfy, w, h,
                              alive=_t(alive))
    return pj, pt, ops, cam


def test_project_gaussians_matches_jax():
    pj, pt, _, _ = _project_both()
    for name in ("xy", "conic", "depth", "radius"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))


@pytest.mark.parametrize("seed", [3, 7])
def test_build_tile_lists_matches_jax(seed):
    """The port always culls tightly: the JAX package's default."""
    pj, _, ops, cam = _project_both(n=80, seed=seed)
    cfg_j = jr.RasterizerConfig(tile_capacity=32, dup_x=3, dup_y=2, tight_cull=True)
    cfg_t = tr.RasterizerConfig(tile_capacity=32, dup_x=3, dup_y=2)
    tiles_x, tiles_y = -(-cam.width // 16), -(-cam.height // 16)
    # the same projection into both, so only the list building is compared
    pt = tr.Projected(*(_t(x) for x in pj))
    gj, live_j = jr._build_tile_lists(pj, cfg_j, tiles_x, tiles_y, opacities=jnp.asarray(ops))
    gt, counts = tr._build_tile_lists(pt, cfg_t, tiles_x, tiles_y, opacities=_t(ops))
    live_t = np.arange(32)[None, :] < counts.numpy()[:, None]
    np.testing.assert_array_equal(live_t, np.asarray(live_j))
    assert live_t.sum() > 0
    np.testing.assert_array_equal(gt.numpy()[live_t], np.asarray(gj)[live_t])


def _composite_inputs(case, c):
    """(packed, counts, tiles_x): the random tiles of ``packed_tiles`` or one
    of the kernels' edge cases (``tests/torch_helpers.edge_tiles``)."""
    if case == "random":
        packed, counts, _ = _packed_tiles(c=c, seed=c)
        return packed, counts, 2
    # the shared Gaussian in 4 x 4 tiles here, not 8 x 8: the Pallas kernel
    # takes power from expanded monomials (px^2, px py, ...), which lose
    # digits as px grows (see packed_tiles). At 8 x 8 tiles (px to 128) its
    # accum is 1.07e-4 from a float64 plain version, the f32 plain one 8.9e-8
    # (c = 3, seed 3). The card tests hold the kernels at 8 x 8
    packed, counts, _, _, tiles_x = edge_tiles(case, c, seed=c, shared_tiles_x=4)
    return packed, counts, tiles_x


@pytest.mark.parametrize("case", ("random",) + EDGE_CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_composite_plain_matches_pallas(c, case):
    packed, counts, tiles_x = _composite_inputs(case, c)
    t, k, _ = packed.shape
    live = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    gacc = np.random.default_rng(9).normal(size=(t, c, 256)).astype(np.float32)
    gft = np.random.default_rng(10).normal(size=(t, 1, 256)).astype(np.float32)

    def jf(pk):
        acc, ft, med = composite_tiles_packed(pk, jnp.asarray(live), tiles_x, 16, 16)
        return acc, ft, med

    (acc_j, ft_j, med_j), vjp = jax.vjp(jf, jnp.asarray(packed))
    (dpk_j,) = vjp((jnp.asarray(gacc), jnp.asarray(gft), jnp.zeros_like(med_j)))

    pk_t = _t(packed).requires_grad_(True)
    acc_t, ft_t, med_t = tc.composite_plain(pk_t, _t(counts), tiles_x, 16, 16, chunk=16)
    for a, b in ((acc_t, acc_j), (ft_t, ft_j), (med_t, med_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-4)
    (acc_t * _t(gacc)).sum().add((ft_t * _t(gft)).sum()).backward()
    dpk_t = pk_t.grad.numpy()
    dpk_j = np.array(dpk_j)
    dead = np.arange(k)[None, :] >= counts[:, None]
    dpk_t[dead] = 0.0  # dead slots are never combined; JAX zeroes only whole blocks
    dpk_j[dead] = 0.0
    # one scale per field: the conic columns grow with dx^2 and would hide an
    # error in the colour or opacity columns under a single scale
    for f in range(dpk_j.shape[-1]):
        scale = float(np.abs(dpk_j[..., f]).max())
        np.testing.assert_allclose(dpk_t[..., f], dpk_j[..., f], rtol=0, atol=2e-3 * scale,
                                   err_msg=f"packed field {f}")


def _combine_inputs(case):
    """(g, gid, counts, n): random rows, or the ids and counts of an edge
    case with random rows of F = 10."""
    rng = np.random.default_rng(3)
    if case == "random":
        t, k, n, f = 12, 32, 64, 10
        cnt = rng.integers(0, k + 1, (t,)).astype(np.int32)
        gid = np.stack([rng.permutation(n)[:k] for _ in range(t)]).astype(np.int32)
    else:
        packed, cnt, gid, n, _ = edge_tiles(case, 3)
        t, k, f = packed.shape
    return rng.normal(size=(t, k, f)).astype(np.float32), gid, cnt, n


@pytest.mark.parametrize("case", ("random",) + EDGE_CASES)
def test_combine_plain_matches_pallas(case):
    g, gid, cnt, n = _combine_inputs(case)
    live = np.arange(g.shape[1])[None, :] < cnt[:, None]
    ref = combine_rows_rmw(jnp.asarray(g * live[..., None]), jnp.asarray(gid, jnp.int32),
                           jnp.asarray(cnt), n)
    # dead rows carry garbage here: the port's combine must not read them
    out = tc.combine_plain(_t(g), _t(gid).long(), _t(cnt), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _raster_kw(cam, c):
    return dict(tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                height=cam.height)


def _rasterize_against_jax(c, tile_x=16, tile_y=16):
    """The port's ``rasterize`` against JAX's (``backend="xla"``) at tiles of
    tile_x x tile_y: colour, final T and depth at 1e-4, radii exact, the five
    gradients at 2e-3 of their scale."""
    cam = make_camera(width=64, height=32)
    means, cols, ops, scales, rots = random_scene(n=50, c=c, seed=c)
    tiles = dict(tile_x=tile_x, tile_y=tile_y)
    cfg_j = jr.RasterizerConfig(tile_capacity=64, chunk=16, dup_x=4, dup_y=2, backend="xla",
                                **tiles)
    cfg_t = tr.RasterizerConfig(tile_capacity=64, chunk=16, dup_x=4, dup_y=2, **tiles)
    kw = _raster_kw(cam, c)
    bg = np.zeros(c, np.float32)
    args = (means, cols, ops, scales, rots)

    def jf(m, co, o, s, r):
        return jr.rasterize(m, co, o, s, r, view_matrix=jnp.asarray(cam.world_view),
                            proj_matrix=jnp.asarray(cam.full_proj), bg_color=jnp.asarray(bg),
                            config=cfg_j, **kw)

    def tf(m, co, o, s, r):
        return tr.rasterize(m, co, o, s, r, view_matrix=_t(cam.world_view),
                            proj_matrix=_t(cam.full_proj), bg_color=_t(bg), config=cfg_t, **kw)

    def jloss(*a):
        out = jf(*a)
        return (out.color ** 2).sum() + 0.3 * out.final_t.sum(), out

    # the forward once, its outputs beside the gradients
    (_, out_j), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_(True) for a in args]
    out_t = tf(*targs)
    np.testing.assert_allclose(out_t.color.detach().numpy(), np.asarray(out_j.color), atol=1e-4)
    np.testing.assert_allclose(out_t.final_t.detach().numpy(), np.asarray(out_j.final_t), atol=1e-4)
    np.testing.assert_allclose(out_t.depth.numpy(), np.asarray(out_j.depth), atol=1e-4)
    np.testing.assert_array_equal(out_t.radii.numpy(), np.asarray(out_j.radii))

    ((out_t.color ** 2).sum() + 0.3 * out_t.final_t.sum()).backward()
    for name, a, b in zip(("means", "cols", "ops", "scales", "rots"), gj, targs):
        scale = max(float(jnp.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=2e-3 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("c", [1, 3])
def test_rasterize_matches_jax(c):
    _rasterize_against_jax(c)


@pytest.mark.parametrize("tile", [(5, 5), (12, 12), (64, 32)])
def test_rasterize_matches_jax_at_other_tiles(tile):
    """Tiles the card takes beside the main path's 16 x 16: odd pixel counts
    (5 x 5), no multiple of 32 or 64 (12 x 12), over 1 024 pixels (64 x 32,
    which the card runs as two chunks); the 64 x 32 frame's edges cut the 5
    x 5 and 12 x 12 tiles."""
    _rasterize_against_jax(3, *tile)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the dispatchers use the plain versions and launch no
    kernel; the kernel wrappers refuse CPU tensors outright."""
    packed, counts, _ = _packed_tiles(c=3)
    tc.reset_launches()
    out = tc.composite(_t(packed), _t(counts), 2, 16, 16)
    ref = tc.composite_plain(_t(packed), _t(counts), 2, 16, 16)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b)
    assert all(v == 0 for v in tc.LAUNCHES.values())
    with pytest.raises(ValueError):
        tc.composite_fwd(_t(packed), _t(counts), 2, 16, 16)
    with pytest.raises(ValueError):
        tc.combine_rows(_t(packed), torch.zeros(packed.shape[:2], dtype=torch.long), _t(counts), 8)
