"""Background 3DGS training, stage 1 of the reconstruction (counterpart of
``fluidnexus_tpu/pipelines/train_background.py``).

Parity target: FluidDynamics/entries_fluid_nexus/train_background.py:30-279:
random-camera L1 + D-SSIM loss with the optional scale-anisotropy
regulariser, Adam over the five trainables with the exponential position
lr, the densify / prune / opacity-reset schedule, the domain prunes, and the
PLY and camera-pose outputs.

``train`` is a plain loop of one ``step`` an iteration (render through the
tile rasterizer with the ``xy_offset`` hook, loss, gradients, Adam,
densification stats) with the host events (densify, opacity reset, prunes,
saves) at exactly the iterations where the JAX package fires them. The JAX
package batches runs of steps between those events into one ``lax.scan``
launch (``make_train_scan``), which only saves TPU dispatches: the port has
no counterpart. The camera order is ``default_rng(cfg.seed).permutation``,
as in JAX; the random background and the densify noise come from the
port's own ``torch.Generator`` seeded with ``cfg.seed`` (not the JAX draws).

The step's layers are ``torch.profiler.record_function`` spans:
``fnx.render``, ``fnx.photometric_loss``, ``fnx.backward``, ``fnx.adam``
(the rasterizer adds project, tile_lists, gather and composite), and the
host events ``fnx.densify``.

CLI: python -m fluidnexus_torch train_background --config <json> ...
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from fluidnexus_torch import resolve_device
from fluidnexus_torch.core.config import Config, dump_config, parse_cli
from fluidnexus_torch.core.optim import adam_init, adam_step
from fluidnexus_torch.core.ply import save_background_ply
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.data.scene import read_scene
from fluidnexus_torch.ops import rasterizer_cuda
from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize
from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
from fluidnexus_torch.splat.background import (
    MAX_NEW, TRAINABLE, BackgroundModel, BackgroundParams, add_densification_stats,
    create_from_points, densify_and_prune, densify_noise, prune_large_points,
    prune_near_cam_points, prune_near_points, reset_opacity,
)
from fluidnexus_torch.utils.losses import l1_loss, psnr, scale_ratio_penalty, ssim
from fluidnexus_torch.utils.maths import expon_lr, get_world_to_view, normalize
from fluidnexus_torch.utils.png import write_png

SMOKE_LOCATION = (0.328, -0.04, -0.34)   # prune_near_cam_points' reference point


def save_image(path, img_chw):
    """A (C, H, W) image in [0, 1] as an 8-bit PNG, gray for one channel and
    RGB for three: the pixels the JAX package's PIL writer stores
    (clip to [0, 1], times 255, truncated to uint8), written by
    ``utils/png.write_png``, so no imaging library is needed."""
    arr = (torch.clamp(torch.as_tensor(img_chw), 0, 1) * 255).detach().cpu().numpy()
    write_png(path, arr.astype(np.uint8).transpose(1, 2, 0))


def _trainable(model: BackgroundModel):
    return {k: getattr(model, k) for k in TRAINABLE}


def params_from_config(cfg: Config) -> BackgroundParams:
    o = cfg.optim
    return BackgroundParams(
        percent_dense=o.percent_dense,
        position_lr_init=o.position_lr_init, position_lr_final=o.position_lr_final,
        position_lr_delay_mult=o.position_lr_delay_mult,
        position_lr_max_steps=o.position_lr_max_steps,
        color_lr=o.color_lr, opacity_lr=o.opacity_lr, scaling_lr=o.scaling_lr,
        rotation_lr=o.rotation_lr, densify_grad_threshold=o.densify_grad_threshold,
    )


def make_train_step(width: int, height: int, raster_cfg: RasterizerConfig,
                    lambda_dssim: float, lambda_reg_scaling: float,
                    scaling_reg_ratio_threshold: float):
    """The (model, opt, view, proj, fovs, gt, bg, lrs) -> (model, opt, loss,
    l1) step: render, L1 + D-SSIM (+ the scaling-ratio regulariser), one
    Adam step over ``TRAINABLE``, the densification stats from the gradient
    of the zero ``xy_offset``."""

    def step(model: BackgroundModel, opt, cam_view, cam_proj, cam_fovs, gt, bg, lrs):
        p = {k: v.detach().requires_grad_(True) for k, v in _trainable(model).items()}
        xy_off = torch.zeros((model.capacity, 2), device=model.xyz.device, requires_grad=True)
        with record_function("fnx.render"):
            out = rasterize(p["xyz"], p["color"], torch.sigmoid(p["opacity"]),
                            torch.exp(p["scaling"]), normalize(p["rotation"]), alive=model.alive,
                            xy_offset=xy_off, view_matrix=cam_view, proj_matrix=cam_proj,
                            tan_fovx=cam_fovs[0], tan_fovy=cam_fovs[1], width=width,
                            height=height, bg_color=bg, config=raster_cfg)
        with record_function("fnx.photometric_loss"):
            l1v = l1_loss(out.color, gt)
            loss = (1.0 - lambda_dssim) * l1v + lambda_dssim * (1.0 - ssim(out.color, gt))
            if lambda_reg_scaling > 0:
                loss = loss + lambda_reg_scaling * scale_ratio_penalty(
                    p["scaling"], model.alive, scaling_reg_ratio_threshold)
        with record_function("fnx.backward"):
            grads = torch.autograd.grad(loss, [*p.values(), xy_off])
        with record_function("fnx.adam"):
            new, opt = adam_step(_trainable(model), dict(zip(TRAINABLE, grads)), opt, lrs)
            model = add_densification_stats(model._replace(**new), grads[-1], out.radii)
        return model, opt, loss.detach(), l1v.detach()

    return step


def render_view(model: BackgroundModel, cam: Camera, bg, raster_cfg: RasterizerConfig):
    dev = model.xyz.device
    return rasterize(
        model.xyz, model.color, model.get_opacity, model.get_scaling, model.get_rotation,
        alive=model.alive,
        view_matrix=torch.as_tensor(cam.world_view, device=dev),
        proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        width=cam.width, height=cam.height, bg_color=bg, config=raster_cfg,
    )


def _gt(c: Camera, device):
    img = c.image[..., None] if c.image.ndim == 2 else c.image
    return torch.tensor(img.transpose(2, 0, 1), dtype=torch.float32, device=device)


def camera_locations(cams: List[Camera], model_path: str):
    """The cameras' OpenGL positions, and with a ``model_path`` their c2w
    matrices dumped to ``gs_all_cam_poses.npy`` (train_background.py:75-89);
    without one the camera centres, as the JAX package takes them."""
    if not model_path:
        return np.stack([c.camera_center for c in cams])
    poses, gl_trans = [], []
    for c in cams:
        c2w = np.linalg.inv(get_world_to_view(c.R, c.T))
        poses.append(c2w)
        c2w_gl = c2w.copy()
        c2w_gl[:3, 1:3] *= -1
        gl_trans.append(c2w_gl[:3, 3])
    os.makedirs(model_path, exist_ok=True)
    np.save(os.path.join(model_path, "gs_all_cam_poses.npy"), np.stack(poses))
    return np.stack(gl_trans)


def train(cfg: Config, scene_info, writer=None, bg_params: Optional[BackgroundParams] = None,
          log_every: int = 100, log=print, device="cuda"):
    """Stage 1 on ``device``: ``cfg.optim.iterations`` steps from
    ``scene_info.point_cloud``, the PLY of the alive rows written to
    ``<model_path>/point_cloud/iteration_{it}`` at each of
    ``cfg.save_iterations``. Returns (model, stats), stats holding the
    iterations, the wall seconds, the iterations a second and one dict per
    densify (iteration, alive after it, cloned, split, pruned, dropped). A
    tile with a side of 0 or less raises ValueError before any work."""
    rasterizer_cuda.check_tile(cfg.pipe.tile_x, cfg.pipe.tile_y, device)
    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    bp = bg_params or params_from_config(cfg)
    raster_cfg = raster_config_from(cfg)
    cams = scene_info.train_cameras
    if not cams:
        raise ValueError("stage 1 needs training cameras")
    if scene_info.point_cloud is None:
        raise ValueError("stage 1 needs an initial point cloud (--init_pcd_bg)")
    extent = scene_info.nerf_normalization["radius"]
    width, height = cams[0].width, cams[0].height

    model = create_from_points(scene_info.point_cloud, bp, device=dev)
    opt = adam_init(_trainable(model))
    background = torch.full((3,), 1.0 if m.white_background else 0.0, device=dev)
    cam_locations = camera_locations(cams, m.model_path)

    step_fn = make_train_step(width, height, raster_cfg, o.lambda_dssim,
                              o.lambda_reg_scaling, o.scaling_reg_ratio_threshold)
    views = torch.as_tensor(np.stack([c.world_view for c in cams]), device=dev)
    projs = torch.as_tensor(np.stack([c.full_proj for c in cams]), device=dev)
    fovs = torch.as_tensor(np.asarray([[c.tan_fovx, c.tan_fovy] for c in cams], np.float32),
                           device=dev)
    gts = [_gt(c, dev) for c in cams]
    fixed_lrs = dict(color=bp.color_lr, scaling=bp.scaling_lr, rotation=bp.rotation_lr,
                     opacity=bp.opacity_lr)

    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    order: List[int] = []
    densifies = []
    t0 = time.time()

    def next_cam() -> int:
        nonlocal order
        if not order:
            order = list(rng.permutation(len(cams)))
        return order.pop()

    for it in range(1, o.iterations + 1):
        lr_xyz = expon_lr(it, bp.position_lr_init * extent, bp.position_lr_final * extent,
                          lr_delay_mult=bp.position_lr_delay_mult,
                          max_steps=bp.position_lr_max_steps)
        ci = next_cam()
        bg = torch.rand(3, generator=gen, device=dev) if m.random_background else background
        model, opt, loss, l1v = step_fn(model, opt, views[ci], projs[ci], fovs[ci], gts[ci], bg,
                                        dict(fixed_lrs, xyz=float(np.float32(lr_xyz))))
        if it % log_every == 0:
            lossf = float(loss)
            _guard_finite(lossf, it, model, m.model_path)
            if writer:
                writer.add_scalar("train_loss/l1_loss", float(l1v), it)
                writer.add_scalar("train_loss/total_loss", lossf, it)
                writer.add_scalar("points", int(model.num_alive), it)

        # densification schedule (train_background.py:236-253)
        if it < o.densify_until_iter:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                size_threshold = 20.0 if it > o.opacity_reset_interval else 0.0
                with record_function("fnx.densify"):
                    model, mu, nu, st = densify_and_prune(
                        model, opt.mu, opt.nu, densify_noise(gen, min(MAX_NEW, model.capacity),
                                                             dev),
                        o.densify_grad_threshold, o.opacity_threshold, extent, size_threshold,
                        o.percent_dense)
                opt = opt._replace(mu=mu, nu=nu)
                st = {k: int(v) for k, v in st.items()}
                densifies.append(dict(iteration=it, alive=int(model.num_alive), **st))
                log(f"densify at {it}: alive {densifies[-1]['alive']}, cloned {st['cloned']}, "
                    f"split {st['split']}, pruned {st['pruned']}, dropped {st['dropped']}")
            if it % o.opacity_reset_interval == 0 or (m.white_background
                                                      and it == o.densify_from_iter):
                model = reset_opacity(model)
        if o.prune_near_interval > 0 and it % o.prune_near_interval == 0:
            model = prune_near_points(model, o.valid_min_y, o.valid_max_z)
        if o.prune_near_cam_interval > 0 and it % o.prune_near_cam_interval == 0:
            model = prune_near_cam_points(model, cam_locations, SMOKE_LOCATION)
        if o.prune_large_interval > 0 and it % o.prune_large_interval == 0:
            model = prune_large_points(model)

        if m.model_path and it in cfg.save_iterations:
            save(model, m.model_path, it)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    return model, dict(iterations=o.iterations, wall_s=wall,
                       it_per_s=o.iterations / wall if wall > 0 else float("inf"),
                       densify=densifies)


def _guard_finite(lossf: float, it: int, model, model_path: str):
    """A non-finite loss aborts the run with an emergency checkpoint (the
    JAX package's guard; the reference has none)."""
    if np.isfinite(lossf):
        return
    if model_path:
        try:
            save(model, model_path, it)
        except Exception:
            pass
    raise FloatingPointError(
        f"non-finite loss {lossf} at iteration {it}"
        + (f"; emergency checkpoint saved under {model_path}" if model_path else ""))


def save(model: BackgroundModel, model_path: str, iteration: int):
    """PLY save of the alive Gaussians (scene.save -> gm_background.save_ply)
    at ``point_cloud/iteration_{iteration}``: unpadded, as the JAX package
    writes it, while stages 2 and 4 read ``iteration_{:05d}``."""
    alive = model.alive.cpu().numpy()
    out = os.path.join(model_path, f"point_cloud/iteration_{iteration}", "point_cloud.ply")
    host = {k: getattr(model, k).detach().cpu().numpy()[alive] for k in TRAINABLE}
    save_background_ply(out, host["xyz"], host["color"], host["opacity"], host["scaling"],
                        host["rotation"])
    return out


@torch.no_grad()
def evaluate(model: BackgroundModel, cameras: List[Camera], bg, raster_cfg) -> dict:
    """Held-out metrics (training_report parity, train_background.py:280-347)."""
    l1s, psnrs = [], []
    for c in cameras:
        out = render_view(model, c, bg, raster_cfg)
        img = torch.clamp(out.color, 0, 1)
        gt = _gt(c, img.device)
        l1s.append(float(l1_loss(img, gt)))
        psnrs.append(float(psnr(img, gt)))
    return {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}


def main(argv=None, device="cuda"):
    """``python -m fluidnexus_torch train_background``: the JAX CLI's flags
    (``core/config.parse_cli``); reads the capture's ``<view>_bg/`` frames
    and trains. Returns (model, stats)."""
    cfg = parse_cli(argv, description="train background Gaussians")
    if cfg.detect_anomaly:  # --detect_anomaly parity (helper_parser.py:24,46)
        torch.autograd.set_detect_anomaly(True)
    cfg.model.is_bg = True
    scene_info = read_scene(cfg)
    writer = None
    if cfg.model.model_path:
        dump_config(cfg, os.path.join(cfg.model.model_path, "cfg_args.json"))
        from fluidnexus_torch.utils.tb import TrainLogger

        writer = TrainLogger(cfg.model.model_path)
    model, stats = train(cfg, scene_info, writer, device=device)
    print(f"done: {dict((k, v) for k, v in stats.items() if k != 'densify')}")
    return model, stats


if __name__ == "__main__":
    main()
