"""The level-two appearance fit, stage 3 of the reconstruction (counterpart of
``fluidnexus_tpu/pipelines/train_visual_particle.py``).

Parity target: FluidDynamics/entries_fluid_nexus/train_visual_particle.py
(train:28-253): for each frame, load the level-one visual positions (world
units, ``scale=False``), optionally initialise the scales from the mean
3-NN distance and inherit the previous frame's attributes, then fit colour,
opacity, scales and rotation against the frame's images with L1 + D-SSIM,
the per-attribute consistency with the previous frame and the
scale-anisotropy regulariser, and save the frame's npys.

``train`` is a plain loop of one ``step`` an iteration (render through the
tile rasterizer, loss, gradients zeroed at dead rows, one Adam step), with
the loss read on the host once a frame, as the JAX package reads it. The
camera draws come from one ``np.random.default_rng(cfg.seed)`` shared by
every frame, as in JAX.

The step's layers are ``torch.profiler.record_function`` spans:
``fnx.render``, ``fnx.photometric_loss``, ``fnx.consistency``,
``fnx.backward`` and ``fnx.adam`` (the rasterizer adds project, tile_lists,
gather and composite), and once a frame ``fnx.knn``.

CLI: python -m fluidnexus_torch train_visual_particle --config <json> ...
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from fluidnexus_torch import resolve_device
from fluidnexus_torch.core.config import Config, dump_config, parse_cli
from fluidnexus_torch.core.optim import adam_init, adam_step
from fluidnexus_torch.data.scene import cameras_by_time, read_scene
from fluidnexus_torch.ops import rasterizer_cuda
from fluidnexus_torch.ops.knn import mean_dist_to_knn
from fluidnexus_torch.pipelines.train_physical_particle import (
    _cam_tensors, _gts, _load_background, map_cameras, raster_config_from,
)
from fluidnexus_torch.splat.dynamics import BackgroundSplats, VisualAttrs, load_visual, save_visual
from fluidnexus_torch.splat.render import render_particles_with_background
from fluidnexus_torch.utils.losses import l1_loss, scale_ratio_penalty, ssim

FIELDS = ("color", "opacity", "scales", "rotation")


def init_scales_from_knn(visual, attrs: VisualAttrs, enabled: bool) -> VisualAttrs:
    """(init_quantities_current_level_two, gm_dynamics.py:399-414): the live
    rows' scales = clamp(log sqrt(mean 3-NN d^2), -10, 1) on all three axes."""
    if not enabled:
        return attrs
    with record_function("fnx.knn"):
        d2 = torch.clamp(mean_dist_to_knn(visual.xyz, alive=visual.alive), min=1e-7)
        s = torch.clamp(torch.log(torch.sqrt(d2)), -10.0, 1.0)
        scales = torch.where(visual.alive[:, None], s[:, None].expand(-1, 3), attrs.scales)
    return attrs._replace(scales=scales)


def inherit_prev(attrs: VisualAttrs, prev: Optional[VisualAttrs], o) -> VisualAttrs:
    """The previous frame's attributes for the fields fitted and inherited
    (init_quantities_current_level_two, gm_dynamics.py:405-414). Static
    capacities keep the previous frame's rows at the same index."""
    if prev is None:
        return attrs
    return attrs._replace(**{f: getattr(prev, f) for f in FIELDS
                             if getattr(o, f"fit_{f}") and getattr(o, f"inherit_prev_{f}")})


def make_level_two_step(bg: Optional[BackgroundSplats], raster_cfg, width, height, o,
                        fit_fields):
    """The (trainable, fixed_attrs, prev_attrs, has_prev, visual_xyz, alive,
    opt, cams, gts, lrs) -> (trainable, opt, loss, l1) step."""
    lambda_cons = dict(color=o.lambda_consistency_color, opacity=o.lambda_consistency_opacity,
                       scales=o.lambda_consistency_scales,
                       rotation=o.lambda_consistency_rotation)

    def loss_fn(tr, fixed_attrs: VisualAttrs, prev_attrs: VisualAttrs, has_prev, visual_xyz,
                alive, cams, gts):
        attrs = fixed_attrs._replace(**tr)

        def one(cam_view, cam_proj, fovs, gt):
            with record_function("fnx.render"):
                out = render_particles_with_background(
                    visual_xyz, alive, attrs, bg,
                    view_matrix=cam_view, proj_matrix=cam_proj,
                    tan_fovx=fovs[0], tan_fovy=fovs[1], width=width, height=height,
                    bg_color=torch.zeros(3 if bg is not None else attrs.color.shape[-1],
                                         device=visual_xyz.device),
                    config=raster_cfg,
                )
            with record_function("fnx.photometric_loss"):
                img = out.color
                if img.shape[0] == 1 and gt.shape[0] == 3:
                    img = img.repeat(3, 1, 1)   # gray particles against an RGB image
                l1v = l1_loss(img, gt)
                return ((1.0 - o.lambda_dssim) * l1v * o.lambda_image
                        + o.lambda_dssim * (1.0 - ssim(img, gt)) * o.lambda_image), l1v

        losses, l1s = map_cameras(one, cams, gts)
        loss = losses.mean()
        with record_function("fnx.consistency"):
            n_alive = torch.clamp(alive.sum(), min=1)
            for f in fit_fields:
                if lambda_cons[f] > 0:
                    d = (tr[f] - getattr(prev_attrs, f)) ** 2
                    cons = torch.where(alive[:, None], d, 0.0).sum() / (n_alive * d.shape[-1])
                    loss = loss + lambda_cons[f] * cons * has_prev
            if "scales" in fit_fields and o.lambda_reg_scaling > 0:
                loss = loss + o.lambda_reg_scaling * scale_ratio_penalty(
                    tr["scales"], alive, o.scaling_reg_ratio_threshold)
        return loss, l1s.mean()

    def step(trainable, fixed_attrs, prev_attrs, has_prev, visual_xyz, alive, opt, cams, gts,
             lrs):
        tr = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
        loss, l1v = loss_fn(tr, fixed_attrs, prev_attrs, has_prev, visual_xyz, alive, cams, gts)
        with record_function("fnx.backward"):
            grads = torch.autograd.grad(loss, list(tr.values()))
        with record_function("fnx.adam"):
            grads = {k: torch.where(alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
                     for k, g in zip(tr, grads)}
            new, opt = adam_step(trainable, grads, opt, lrs)
        return new, opt, loss.detach(), l1v.detach()

    return step


def train(cfg: Config, scene_info=None, log=print, writer=None, device="cuda"):
    """Stage 3 on ``device``: for each frame of the scene, the level-one
    checkpoint under ``<load_path>/checkpoint`` fitted for
    ``int(min + (max - min) t / n_frames)`` iterations
    (``iterations_per_time_current_level_two`` and ``_max``), written to
    ``<model_path>/checkpoint_level_two``. The background is the PLY at
    ``cfg.model.bg_load_path`` when that is set. Returns one dict per frame
    (frame, loss, l1: the last iteration's). Without a ``scene_info`` the
    scene is read from ``cfg.model.data_path`` (``read_scene``). A tile with
    a side of 0 or less raises ValueError before any work
    (``rasterizer_cuda.check_tile``)."""
    rasterizer_cuda.check_tile(cfg.pipe.tile_x, cfg.pipe.tile_y, device)
    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    raster_cfg = raster_config_from(cfg)
    rng = np.random.default_rng(cfg.seed)
    if scene_info is None:
        scene_info = read_scene(cfg)
    train_by_t = cameras_by_time(scene_info.train_cameras)
    n_frames = len(train_by_t)
    cam0 = train_by_t[0][0]
    width, height = cam0.width, cam0.height
    channels = 3 if m.level_two_color_3ch else 1
    bg = _load_background(cfg, None, dev, log)

    load_dir = os.path.join(m.load_path, "checkpoint")
    out_dir = os.path.join(m.model_path, "checkpoint_level_two") if m.model_path else None
    fit_fields = tuple(f for f in FIELDS if getattr(o, f"fit_{f}"))
    lrs = {f: float(np.float32(getattr(o, f"visual_{f}_lr"))) for f in fit_fields}
    step = make_level_two_step(bg, raster_cfg, width, height, o, fit_fields)

    prev: Optional[VisualAttrs] = None
    results = []
    for t in range(n_frames):
        # level one saves world-unit positions; stage 3 renders them as saved
        visual, attrs = load_visual(load_dir, t, m.visual_capacity, channels=channels,
                                    scale=False, device=dev)
        attrs = init_scales_from_knn(visual, attrs, o.fit_scales and o.init_scales_w_xyz_dist)
        attrs = inherit_prev(attrs, prev, o)

        trainable = {f: getattr(attrs, f) for f in fit_fields}
        opt = adam_init(trainable)
        prev_in = prev if prev is not None else attrs
        has_prev = 1.0 if prev is not None else 0.0

        cams = train_by_t[t]
        cviews, cprojs, cfovs = _cam_tensors(cams, dev)
        gts = _gts(cams, 3 if bg is not None or channels == 3 else 1, dev)

        iters_min = o.iterations_per_time_current_level_two
        iters_max = o.iterations_per_time_current_level_two_max
        iters = int(iters_min + (iters_max - iters_min) * t / n_frames)
        for _ in range(iters):
            sel = torch.as_tensor(rng.choice(len(cams), size=min(o.batch, len(cams)),
                                             replace=False), device=dev)
            trainable, opt, loss, l1v = step(
                trainable, attrs, prev_in, has_prev, visual.xyz, visual.alive, opt,
                (cviews[sel], cprojs[sel], cfovs[sel]), gts[sel], lrs)

        attrs = attrs._replace(**trainable)
        prev = attrs
        lossf, l1f = (float(v) for v in torch.stack([loss, l1v]).tolist())
        results.append({"frame": t, "loss": lossf, "l1": l1f})
        if writer:
            writer.add_scalar("level_two/loss", lossf, t)
            writer.add_scalar("level_two/l1", l1f, t)
        log(f"level-two frame {t}/{n_frames - 1}: loss={lossf:.5f}")
        if out_dir:
            save_visual(visual, attrs, out_dir, t, scale=False)
    return results


def main(argv=None, device="cuda"):
    """``python -m fluidnexus_torch train_visual_particle``: the JAX CLI's
    flags (``core/config.parse_cli``); writes ``cfg_args.json`` and a
    TensorBoard log under ``model_path`` when that is set. Returns
    ``train``'s results."""
    cfg = parse_cli(argv, description="train visual particles (level two)")
    writer = None
    if cfg.model.model_path:
        dump_config(cfg, os.path.join(cfg.model.model_path, "cfg_args.json"))
        from fluidnexus_torch.utils.tb import TrainLogger

        writer = TrainLogger(cfg.model.model_path)
    results = train(cfg, writer=writer, device=device)
    print(f"done: {len(results)} frames")
    return results


if __name__ == "__main__":
    main()
