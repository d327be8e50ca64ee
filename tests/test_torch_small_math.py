"""Parity of the port's small modules with the JAX package, on the CPU: Adam,
the lr schedule, camera matrices, image losses, the background render and
the radius graph behind the distance penalty."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core import optim as jopt
from fluidnexus_tpu.data.cameras import Camera as JCamera
from fluidnexus_tpu.ops.neighbors import radius_graph as j_radius_graph
from fluidnexus_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_tpu.sim import state as jsstate
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_tpu.splat.render import render_particles_with_background as j_render
from fluidnexus_tpu.utils import losses as jloss
from fluidnexus_tpu.utils import maths as jmaths
from fluidnexus_tpu.utils.maths import expon_lr as j_expon_lr
from fluidnexus_torch import convert
from fluidnexus_torch.core import optim as topt
from fluidnexus_torch.data.cameras import Camera as TCamera
from fluidnexus_torch.ops.neighbors import radius_graph as t_radius_graph
from fluidnexus_torch.ops.rasterizer import RasterizerConfig as TRasterizerConfig
from fluidnexus_torch.pipelines import train_physical_particle as ttrain
from fluidnexus_torch.splat import dynamics as tdyn
from fluidnexus_torch.splat.render import render_particles_with_background as t_render
from fluidnexus_torch.utils import losses as tloss
from fluidnexus_torch.utils import maths as tmaths
from fluidnexus_torch.utils.maths import expon_lr as t_expon_lr


def _t(x):
    return torch.as_tensor(np.array(x))


def test_adam_matches_jax():
    rng = np.random.default_rng(0)
    p = {"xyz": rng.normal(size=(50, 3)).astype(np.float32),
         "c": rng.normal(size=(7,)).astype(np.float32)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    sj, st = jopt.adam_init(pj), topt.adam_init(pt)
    for i in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * (i + 1) for k, v in p.items()}
        g["xyz"][:5] = 0.0  # eps 1e-15: zero gradients move by exactly 0
        lrs = {"xyz": np.float32(1e-3), "c": np.float32(0.05)}
        pj, sj = jopt.adam_step(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, lrs)
        pt, st = topt.adam_step(pt, {k: _t(v) for k, v in g.items()}, st,
                                {k: float(v) for k, v in lrs.items()})
    back = convert.adam_state_to_numpy(st)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(back.mu[k], np.asarray(sj.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(back.nu[k], np.asarray(sj.nu[k]), rtol=1e-6)
    assert int(back.count) == int(sj.count) == 3
    np.testing.assert_array_equal(pt["xyz"][:5].numpy(), p["xyz"][:5])
    st2 = convert.adam_state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    assert st2.count.dtype == torch.int32 and int(st2.count) == 3


@pytest.mark.parametrize("delay", [0, 500])
def test_expon_lr_matches_jax(delay):
    for step in (0, 1, 7, 999, 30000, 40000):
        args = (step, 3.2e-4, 3.2e-6, delay, 0.01, 30000)
        assert t_expon_lr(*args) == j_expon_lr(*args)
    assert t_expon_lr(5, 0.0, 0.0) == 0.0


@pytest.mark.parametrize("cyr", [0.0, 0.1])
def test_camera_matrices_match_jax(cyr):
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    kw = dict(uid=0, R=q, T=rng.normal(size=3), fovx=0.9, fovy=0.55, width=96, height=54,
              cxr=0.05, cyr=cyr)
    cj, ct = JCamera(**kw), TCamera(**kw)
    for name in ("world_view", "projection", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(cj, name), err_msg=name)
    assert (ct.tan_fovx, ct.tan_fovy) == (cj.tan_fovx, cj.tan_fovy)
    np.testing.assert_array_equal(tmaths.get_projection_matrix(0.01, 100.0, 0.9, 0.55),
                                  jmaths.get_projection_matrix(0.01, 100.0, 0.9, 0.55))
    assert tmaths.fov2focal(0.9, 96) == jmaths.fov2focal(0.9, 96)
    assert tmaths.focal2fov(tmaths.fov2focal(0.9, 96), 96) == pytest.approx(0.9, rel=1e-12)


def test_convert_round_trips_jax_states():
    rng = np.random.default_rng(12)
    vis = jax.tree.map(np.asarray, jsstate.make_visual_state(
        16, jnp.asarray(rng.normal(size=(9, 3)).astype(np.float32))))
    attrs = jax.tree.map(np.asarray, jdyn.constant_visual_attrs(16, channels=1))
    vt = convert.visual_state_from_numpy(vis, device="cpu")
    assert vt.xyz.dtype == torch.float32 and vt.alive.dtype == torch.bool
    for a, b in zip(convert.visual_state_to_numpy(vt), vis):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(convert.visual_attrs_to_numpy(convert.visual_attrs_from_numpy(attrs, "cpu")),
                    attrs):
        np.testing.assert_array_equal(a, b)


def test_image_losses_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (1, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    aj, bj, at, bt = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    np.testing.assert_allclose(float(tloss.l1_loss(at, bt)), float(jloss.l1_loss(aj, bj)), rtol=1e-6)
    np.testing.assert_allclose(float(tloss.ssim(at, bt)), float(jloss.ssim(aj, bj)), rtol=1e-5)
    np.testing.assert_allclose(float(tloss.psnr(at, bt)), float(jloss.psnr(aj, bj)), rtol=1e-5)
    # the blur-matrix SSIM gradient, as the fit takes it
    gj = jax.grad(lambda x: jloss.ssim(x, bj))(aj)
    at.requires_grad_(True)
    tloss.ssim(at, bt).backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(gj), atol=1e-6)


def _background(n=40, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        scaling=rng.uniform(-4.0, -2.5, (n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
    )


def test_render_with_background_matches_jax():
    from tests.test_rasterizer import make_camera

    cam = make_camera(width=48, height=32)
    rng = np.random.default_rng(4)
    cap = 64
    pos = rng.uniform(-0.4, 0.4, (cap, 3)).astype(np.float32)
    alive = np.arange(cap) < 50
    attrs_j = jdyn.constant_visual_attrs(cap, channels=1)
    attrs_j = attrs_j._replace(scales=attrs_j.scales + 3.0)  # visible at this size
    attrs_t = convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), device="cpu")
    bgd = _background()
    bg_j = jdyn.BackgroundSplats(**{k: jnp.asarray(v) for k, v in bgd.items()})
    bg_t = convert.background_from_numpy(bg_j, device="cpu")
    kw = dict(tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=48, height=32)
    cfg_j = JRasterizerConfig(tile_capacity=64, chunk=16, dup_x=3, dup_y=2, backend="xla")
    cfg_t = TRasterizerConfig(tile_capacity=64, chunk=16, dup_x=3, dup_y=2)

    def jl(p):
        out = j_render(p, jnp.asarray(alive), attrs_j, bg_j, view_matrix=jnp.asarray(cam.world_view),
                       proj_matrix=jnp.asarray(cam.full_proj), bg_color=jnp.zeros(3),
                       config=cfg_j, **kw)
        return (out.color ** 2).sum(), out.color

    (lj, col_j), gj = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(pos))
    pt = _t(pos).requires_grad_(True)
    out = t_render(pt, _t(alive), attrs_t, bg_t, view_matrix=_t(cam.world_view),
                   proj_matrix=_t(cam.full_proj), bg_color=torch.zeros(3), config=cfg_t, **kw)
    (out.color ** 2).sum().backward()
    assert out.color.shape == (3, 32, 48)
    np.testing.assert_allclose(out.color.detach().numpy(), np.asarray(col_j), atol=1e-4)
    scale = float(jnp.abs(gj).max())
    assert scale > 0
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), atol=2e-3 * scale)
    back = convert.background_to_numpy(bg_t)
    for k, v in bgd.items():
        np.testing.assert_array_equal(back[k], v)


def _column(n, seed):
    """Points of a smoke-like column (world units): x, z within 0.01 of the
    axis, y over 0.5 — far outside the 32 x 0.002 box of the distance grid, so
    the boundary cells overflow their capacity of 32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.316, 0.336, (n, 1))
    z = rng.uniform(-0.31, -0.29, (n, 1))
    y = rng.uniform(-0.02, 0.48, (n, 1))
    return np.concatenate([x, y, z], 1).astype(np.float32)


@pytest.mark.parametrize("r,k", [(0.002, 32), (0.004, 4)])
def test_radius_graph_matches_jax(r, k):
    pts = _column(3000, seed=int(r * 1e4) + k)
    alive = np.ones(len(pts), bool)
    alive[::5] = False
    nj = j_radius_graph(jnp.asarray(pts), r, k=k, loop=False, alive=jnp.asarray(alive))
    nt = t_radius_graph(_t(pts), r, k=k, loop=False, alive=_t(alive))
    assert int(nt.overflow) == int(nj.overflow) > 0
    np.testing.assert_array_equal(nt.mask.numpy(), np.asarray(nj.mask))
    np.testing.assert_array_equal(nt.idx.numpy(), np.asarray(nj.idx))
    assert nt.mask.sum() > 0


def test_distance_penalty_matches_jax():
    pts = _column(2500, seed=7)
    alive = np.ones(len(pts), bool)
    alive[-300:] = False
    vj, gj = jax.value_and_grad(jtrain.distance_penalty)(jnp.asarray(pts), jnp.asarray(alive), 0.002)
    pt = _t(pts).requires_grad_(True)
    vt = ttrain.distance_penalty(pt, _t(alive), 0.002)
    vt.backward()
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-9)
