"""Phase A of the reconstruction (first-frame visual fit) in the port against
the JAX package, on the CPU: the fit step, the whole ``fit_first_frame`` from
one seed, and the visual npy checkpoint across the two packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.core.optim import adam_init as j_adam_init
from fluidnexus_tpu.data.scene import cameras_by_time as j_cameras_by_time
from fluidnexus_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_tpu.utils.maths import expon_lr
from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.core.optim import adam_init as t_adam_init
from fluidnexus_torch.data.cameras import Camera as TCamera
from fluidnexus_torch.data.readers import SceneInfo as TSceneInfo
from fluidnexus_torch.pipelines import train_physical_particle as ttrain
from fluidnexus_torch.splat import dynamics as tdyn
from tests.test_torch_small_math import _background
from tests.test_train_physical import smoke_like_scene


def _small(cfg):
    """A few hundred particles and small tiles; the smoke widths otherwise."""
    o, m, p = cfg.optim, cfg.model, cfg.pipe
    m.visual_capacity = 512
    m.init_visual_num_pts = 150
    m.init_thick_visual_num_pts = 50
    o.iterations_per_time_first = 3
    o.batch = 2
    o.lambda_first_distance = 1.0
    o.distance_threshold_visual = 0.002
    p.tile_capacity = 64
    p.chunk = 16
    p.dup_x = 3
    p.dup_y = 3
    return cfg


def _port_scene(scene):
    cams = [TCamera(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)})
            for c in scene.train_cameras]
    return TSceneInfo(point_cloud=None, train_cameras=cams, test_cameras=[],
                      nerf_normalization=scene.nerf_normalization)


def _bgs(with_bg):
    if not with_bg:
        return None, None
    d = _background(n=48, seed=11)
    d["xyz"] = d["xyz"] * 0.3 + np.array([0.326, 0.1, -0.3], np.float32)
    bg_j = jdyn.BackgroundSplats(**{k: jnp.asarray(v) for k, v in d.items()})
    return bg_j, convert.background_from_numpy(bg_j, device="cpu")


def _lr(cfg, extent, it):
    o = cfg.optim
    return expon_lr(it, o.position_lr_init * extent * o.pos_lr_scale_factor,
                    o.position_lr_final * extent, lr_delay_mult=o.position_lr_delay_mult,
                    max_steps=o.position_lr_max_steps)


@pytest.mark.parametrize("with_bg", [False, True])
def test_first_frame_step_matches_jax(with_bg):
    cfg = _small(JConfig())
    o, m = cfg.optim, cfg.model
    scene = smoke_like_scene()
    cams0 = j_cameras_by_time(scene.train_cameras)[0]
    w, h = cams0[0].width, cams0[0].height
    bg_j, bg_t = _bgs(with_bg)
    pts = jdyn.create_visual_points(m, np.random.default_rng(5))
    vis_j = j_make_visual_state(m.visual_capacity, jnp.asarray(pts))
    attrs_j = jdyn.constant_visual_attrs(m.visual_capacity, channels=1)
    vis_t = convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), device="cpu")
    attrs_t = convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), device="cpu")
    rc = dict(tile_capacity=64, chunk=16, dup_x=3, dup_y=3)
    args = (w, h, o.lambda_dssim, o.lambda_first_distance, o.distance_threshold_visual, 3)
    step_j = jtrain.make_first_frame_step(bg_j, JRasterizerConfig(backend="xla", **rc), *args)
    step_t = ttrain.make_first_frame_step(bg_t, ttrain.raster_config_from(_small(TConfig())),
                                          *args)
    cj = jtrain._cam_tensors(cams0)
    gts_j = jtrain._gts(cams0, 3)
    ct = ttrain._cam_tensors(_port_scene(scene).train_cameras[:len(cams0)], "cpu")
    gts_t = ttrain._gts(_port_scene(scene).train_cameras[:len(cams0)], 3, "cpu")
    xj, optj = vis_j.xyz, j_adam_init({"xyz": vis_j.xyz})
    xt, optt = vis_t.xyz, t_adam_init({"xyz": vis_t.xyz})
    rng = np.random.default_rng(0)
    lr = np.float32(1e-3)
    steps = 3
    for _ in range(steps):
        sel, wt, inv_w = ttrain._select_batch(rng, len(cams0), 2, 1)
        xj, optj, lj, l1j = step_j(xj, vis_j.alive, attrs_j, optj, tuple(c[sel] for c in cj),
                                   gts_j[sel], lr, wt, inv_w)
        st = torch.as_tensor(sel)
        xt, optt, lt, l1t = step_t(xt, vis_t.alive, attrs_t, optt, tuple(c[st] for c in ct),
                                   gts_t[st], float(lr), torch.as_tensor(wt),
                                   torch.as_tensor(inv_w))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
        np.testing.assert_allclose(float(l1t), float(l1j), rtol=1e-4)
    # eps 1e-15: a particle whose gradient is ~0 moves by +-lr on its sign alone
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2 * steps * float(lr))
    moved = np.abs(xt.numpy() - pts_padded(pts, m.visual_capacity)).max()
    assert moved > 0.5 * float(lr)


def pts_padded(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts
    return out


def _jax_phase_a(cfg, scene):
    """The phase-A lines of the JAX ``train`` (up to the x100 scaling), driven
    through the JAX package's functions from ``cfg.seed``."""
    o, m = cfg.optim, cfg.model
    params = jtrain.pbf_params_from_config(cfg)
    rcfg = JRasterizerConfig(tile_capacity=cfg.pipe.tile_capacity, tile_x=cfg.pipe.tile_x,
                             tile_y=cfg.pipe.tile_y, dup_x=cfg.pipe.dup_x, dup_y=cfg.pipe.dup_y,
                             chunk=cfg.pipe.chunk, backend=cfg.pipe.backend)
    rng = np.random.default_rng(cfg.seed)
    cams0 = j_cameras_by_time(scene.train_cameras)[0]
    visual = j_make_visual_state(m.visual_capacity, jnp.asarray(jdyn.create_visual_points(m, rng)))
    attrs = jdyn.constant_visual_attrs(m.visual_capacity, channels=1)
    step = jtrain.make_first_frame_step(None, rcfg, cams0[0].width, cams0[0].height,
                                        o.lambda_dssim, o.lambda_first_distance,
                                        o.distance_threshold_visual, 3)
    opt = j_adam_init({"xyz": visual.xyz})
    views, projs, fovs = jtrain._cam_tensors(cams0)
    gts = jtrain._gts(cams0, 3)
    extent = scene.nerf_normalization["radius"]
    vxyz, losses = visual.xyz, []
    for it in range(1, o.iterations_per_time_first + 1):
        sel, w, inv_w = jtrain._select_batch(rng, len(cams0), o.batch, cfg.pipe.dp)
        vxyz, opt, loss, _ = step(vxyz, visual.alive, attrs, opt, (views[sel], projs[sel], fovs[sel]),
                                  gts[sel], np.float32(_lr(cfg, extent, it)), w, inv_w)
        losses.append(float(loss))
    return np.asarray(vxyz * params.scale_factor), np.asarray(visual.alive), losses


def test_fit_first_frame_matches_jax():
    scene = smoke_like_scene()
    cfg_j = _small(JConfig())
    cfg_t = _small(TConfig())
    cfg_j.seed = cfg_t.seed = 3
    xyz_j, alive_j, losses_j = _jax_phase_a(cfg_j, scene)
    visual, attrs, losses_t = ttrain.fit_first_frame(cfg_t, _port_scene(scene), log=lambda *a: None,
                                                     device="cpu")
    np.testing.assert_array_equal(visual.alive.numpy(), alive_j)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-4)
    steps = cfg_t.optim.iterations_per_time_first
    lr_max = max(_lr(cfg_t, 2.0, it) for it in range(1, steps + 1))
    # positions are x100 here: the Adam bound scales with them
    np.testing.assert_allclose(visual.xyz.numpy(), xyz_j, atol=100 * 2 * steps * lr_max)
    assert attrs.color.shape == (cfg_t.model.visual_capacity, 1)


def test_fit_first_frame_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.fit_first_frame(_small(TConfig()), _port_scene(smoke_like_scene()))


def test_visual_checkpoint_round_trip_from_jax(tmp_path):
    cap = 128
    rng = np.random.default_rng(8)
    vis = j_make_visual_state(cap, jnp.asarray(rng.normal(size=(90, 3)).astype(np.float32) * 50))
    attrs = jdyn.constant_visual_attrs(cap, channels=1)
    attrs = attrs._replace(color=jnp.asarray(rng.uniform(0, 1, (cap, 1)).astype(np.float32)),
                           opacity=jnp.asarray(rng.normal(size=(cap, 1)).astype(np.float32)))
    jdyn.save_visual(vis, attrs, str(tmp_path), 4)
    vt, at = tdyn.load_visual(str(tmp_path), 4, cap, channels=3, device="cpu")
    np.testing.assert_allclose(vt.xyz.numpy(), np.asarray(vis.xyz), rtol=1e-6)
    np.testing.assert_array_equal(vt.alive.numpy(), np.asarray(vis.alive))
    np.testing.assert_array_equal(at.color.numpy()[:90], np.repeat(np.asarray(attrs.color)[:90], 3, 1))
    np.testing.assert_array_equal(at.opacity.numpy()[:90], np.asarray(attrs.opacity)[:90])
    # and back: the port writes what the JAX package reads
    tdyn.save_visual(vt, convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs), "cpu"),
                     str(tmp_path), 5)
    vj, aj = jdyn.load_visual(str(tmp_path), 5, cap, channels=1)
    np.testing.assert_allclose(np.asarray(vj.xyz), np.asarray(vis.xyz), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(aj.color), np.asarray(attrs.color) * np.asarray(vis.alive)[:, None]
                                  + np.asarray(jdyn.constant_visual_attrs(cap).color) * ~np.asarray(vis.alive)[:, None])
