"""Future prediction (counterpart of
``fluidnexus_tpu/pipelines/future_simulation.py``): the no-grad PBF rollout
from the last reconstructed frame.

Parity target: FluidDynamics/entries_fluid_nexus/future_simulation.py
(predict:25-234): load the last frame's hidden and visual checkpoint, decay
the rest density from p0 toward p0_future over decay_frames_future_p0, and
per frame: remove_invalid, emission, the guess (with wind from wind_since),
the solver, the rigid bodies, the commit, the visual advection, the renders
of every camera of frame 0's rig and the npy checkpoint. As in the JAX
package, the Ball capture's object is a rigid sphere at the reference's
object centre (the reference calls an undefined function there).

The frame's layers are ``torch.profiler.record_function`` spans:
``fnx.future_tick`` (remove_invalid, emission, solver tick, push-outs of the
hidden particles, commit), ``fnx.rigid`` (each push-out), ``fnx.update_visual``,
``fnx.render`` and ``fnx.save`` (the PNGs and the npy checkpoint).
``predict`` reads the scene from ``cfg.model.data_path`` (``data/scene.read_scene``)
when it is not handed one; ``main`` is the stage CLI
(``python -m fluidnexus_torch future_simulation``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from fluidnexus_torch import resolve_device
from fluidnexus_torch.core.config import Config, dump_config, parse_cli
from fluidnexus_torch.data.scene import cameras_by_time, read_scene
from fluidnexus_torch.ops import rasterizer_cuda
from fluidnexus_torch.pipelines.train_background import save_image
from fluidnexus_torch.pipelines.train_physical_particle import (
    _load_background, pbf_params_from_config, raster_config_from, solver_tick,
)
from fluidnexus_torch.sim.pbf import (
    QUERY_DROPS, RigidBody, RigidSpec, confirm_guess, create_rigid_body,
    project_rigid_constraints, project_rigid_constraints_visual, remove_invalid, update_visual,
    warn_capacity_overflow,
)
from fluidnexus_torch.splat.dynamics import (
    BackgroundSplats, EmitterPoints, constant_visual_attrs, emit_hidden, emit_visual, load_hidden,
    load_visual, pad_emission, plan_emission, remove_bottom_visual, save_hidden, save_visual,
)
from fluidnexus_torch.splat.render import render_particles_with_background

# reference object-ball geometry (gm_background.create_from_pcd:139-143)
OBJECT_BALL_CENTER = (0.328, 0.378, -0.28)
OBJECT_BALL_RADIUS = 0.11


def _moved(before, after):
    """How many rows a push-out moved."""
    return (after != before).any(-1).sum()


def predict(cfg: Config, scene_info=None, log=print, save_renders: bool = True,
            bg: Optional[BackgroundSplats] = None, device="cuda"):
    """The future stage on ``device``: ``future_pred_frames`` frames from the
    checkpoint of the last frame of ``scene_info`` under
    ``<load_path>/checkpoint``, written to ``<model_path>/checkpoint`` and the
    renders to ``<model_path>/training_render``. One
    ``np.random.default_rng(cfg.seed)`` draws the rigid body, then the object
    ball, then each frame's emission plans, in the JAX package's order.
    ``bg`` defaults to the PLY at ``cfg.model.bg_load_path`` when that is
    set. Returns one dict per frame: the JAX package's frame, p0, hidden,
    visual and p_ratio, and the remove_invalid kills and the hidden and
    visual points the rigid body moved. Without a ``scene_info`` the scene
    is read from ``cfg.model.data_path`` (``read_scene``). A tile with a side
    of 0 or less raises ValueError before any work
    (``rasterizer_cuda.check_tile``); the card takes every other tile."""
    rasterizer_cuda.check_tile(cfg.pipe.tile_x, cfg.pipe.tile_y, device)
    dev = resolve_device(device)
    if scene_info is None:
        scene_info = read_scene(cfg)
    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    raster_cfg = raster_config_from(cfg)
    rng = np.random.default_rng(cfg.seed)
    train_by_t = cameras_by_time(scene_info.train_cameras)
    test_by_t = cameras_by_time(scene_info.test_cameras)
    n_frames = len(train_by_t)
    bg = _load_background(cfg, bg, dev, log)

    # the last reconstructed frame (ref :95-102)
    load_ckpt = os.path.join(m.load_path, "checkpoint")
    level_two = o.use_level_two_in_future and m.level_two_load_path
    visual_ckpt = os.path.join(m.level_two_load_path, "checkpoint_level_two") if level_two \
        else load_ckpt
    last = n_frames - 1
    state = load_hidden(load_ckpt, last, m.hidden_capacity, params, device=dev)
    use_smoothed = {k: getattr(o, f"use_smoothed_{k}") for k in
                    ("color", "scales", "opacity", "rotation")} \
        if o.use_level_two_smoothed_in_future else None
    visual, attrs = load_visual(
        visual_ckpt, last, m.visual_capacity,
        channels=3 if (o.use_level_two_in_future and m.level_two_color_3ch) else 1,
        smoothed_window=o.smoothed_window_size if use_smoothed else None,
        use_smoothed=use_smoothed, scale=not (o.use_level_two_in_future and m.level_two_load_path != ""),
        device=dev)
    if not o.use_level_two_in_future:
        attrs = constant_visual_attrs(m.visual_capacity, channels=1, device=dev)
    hidden_alive = int(state.num_alive)
    log(f"loaded frame {last}: hidden={hidden_alive} visual={int(visual.num_alive)}")

    emitters = EmitterPoints.from_config(m, is_future=True)
    hid_cap = max(int(np.ceil(o.emit_ratio_hidden)) * max(len(emitters.hidden), 1),
                  len(emitters.hidden_first), 1)
    vis_cap = max(int(np.ceil(o.emit_ratio_visual)) * max(len(emitters.visual), 1),
                  len(emitters.visual_first), 1)

    rigid: Optional[RigidBody] = None
    if o.rigid_since >= 0:
        spec = RigidSpec(kind=o.rigid_body, particle_radius=o.rigid_particle_radius,
                         center=tuple(o.rigid_body_center), cuboid_num=tuple(o.rigid_cuboid_num),
                         sphere_radius=o.rigid_sphere_radius, sphere_num=o.rigid_sphere_num,
                         cylinder_radius=o.rigid_cylinder_radius,
                         cylinder_num=tuple(o.rigid_cylinder_num))
        rigid = create_rigid_body(spec, rng, device=dev)
    object_ball = None
    if m.capture_part == "ball":
        object_ball = create_rigid_body(
            RigidSpec(kind="sphere", sphere_radius=OBJECT_BALL_RADIUS * params.scale_factor,
                      sphere_num=1000, center=OBJECT_BALL_CENTER), rng, device=dev)

    out_ckpt = os.path.join(m.model_path, "checkpoint") if m.model_path else None
    render_dir = os.path.join(m.model_path, "training_render") if m.model_path else None
    cams = train_by_t[0] + test_by_t.get(0, [])
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    p0_recon, p0_future = params.p0, o.p0_future
    frames = []
    for fut in range(o.future_pred_frames):
        frame_idx = n_frames + fut
        # rest-density decay back toward the reconstruction's p0 (ref :123)
        cur_p0 = p0_future + (p0_recon - p0_future) * (
            1 - min(1, fut / max(o.decay_frames_future_p0, 1)))
        cur_params = dataclasses.replace(params, p0=cur_p0)
        use_wind = o.wind_since >= 0 and frame_idx >= o.wind_since
        use_rigid = rigid if (o.rigid_since >= 0 and frame_idx >= o.rigid_since) else None
        moved_hidden = moved_visual = zero

        with record_function("fnx.future_tick"):
            state = remove_invalid(state, cur_params)
            killed = hidden_alive - state.num_alive
            if fut == 0:
                visual = remove_bottom_visual(visual)
            # the reference's future_time_index < 2 "first lattice" branch is
            # dead code (its caller passes -1), so every frame takes the ratio path
            nh, hm = pad_emission(plan_emission(emitters.hidden, o.emit_ratio_hidden, rng), hid_cap)
            nv, vm = pad_emission(plan_emission(emitters.visual, o.emit_ratio_visual, rng), vis_cap)
            state = emit_hidden(state, nh, o.init_hidden_velocity, o.alpha, mask=hm)
            visual = emit_visual(visual, nv, mask=vm)
            state, diags = solver_tick(state, cur_params, o.solver_iterations_future, use_wind)
            if object_ball is not None:
                state = project_rigid_constraints(state, object_ball, cur_params)
            if use_rigid is not None:
                before = state.estimate_xyz
                state = project_rigid_constraints(state, use_rigid, cur_params)
                moved_hidden = _moved(before, state.estimate_xyz)
            state = confirm_guess(state, cur_params)
        with record_function("fnx.update_visual"):
            visual, dropped = update_visual(visual, state, cur_params, return_dropped=True)
        if use_rigid is not None:
            before = visual.xyz
            visual = project_rigid_constraints_visual(visual, use_rigid, cur_params)
            moved_visual = _moved(before, visual.xyz)
        if object_ball is not None:
            visual = project_rigid_constraints_visual(visual, object_ball, cur_params)

        # every camera of frame 0's rig (ref :180-227)
        images = []
        if render_dir and save_renders:
            with record_function("fnx.render"), torch.no_grad():
                for cam in cams:
                    out = render_particles_with_background(
                        visual.xyz / cur_params.scale_factor, visual.alive, attrs, bg,
                        view_matrix=torch.as_tensor(cam.world_view, device=dev),
                        proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                        height=cam.height,
                        bg_color=torch.zeros(3 if bg is not None else attrs.color.shape[-1],
                                             device=dev),
                        config=raster_cfg)
                    images.append((cam.image_name, out.color))
        with record_function("fnx.save"):
            for name, img in images:
                save_image(os.path.join(
                    render_dir, f"render_frame{frame_idx:03d}_{name}_0000.png"), img)
            if out_ckpt:
                save_hidden(state, cur_params, out_ckpt, frame_idx)
                save_visual(visual, attrs, out_ckpt, frame_idx)

        # one host read for the frame's counts, its last p_ratio and the splat's drops
        hidden_alive, n_visual, n_killed, n_rh, n_rv, p_ratio, n_dropped = torch.stack(
            [t.to(torch.float64) for t in (state.num_alive, visual.num_alive, killed,
                                           moved_hidden, moved_visual, diags["p_ratio"][-1],
                                           dropped)]
        ).tolist()
        hidden_alive = int(hidden_alive)
        warn_capacity_overflow({"overflow": n_dropped}, f"future {fut} advection",
                               strict=cfg.strict_capacity,
                               log=log, what=QUERY_DROPS)
        frames.append({"frame": frame_idx, "p0": cur_p0, "hidden": hidden_alive,
                       "visual": int(n_visual), "p_ratio": p_ratio, "killed": int(n_killed),
                       "rigid_hidden": int(n_rh), "rigid_visual": int(n_rv),
                       "query_drops": int(n_dropped)})
        log(f"future {fut}: p0={cur_p0:.3f} hidden={hidden_alive} visual={int(n_visual)} "
            f"killed={int(n_killed)} rigid moved hidden={int(n_rh)} visual={int(n_rv)} "
            f"p_ratio={p_ratio:.6f}")
    return frames


def main(argv=None, device="cuda"):
    """``python -m fluidnexus_torch future_simulation``: the JAX CLI's flags
    (``core/config.parse_cli``); writes ``cfg_args.json`` under
    ``model_path`` when that is set. Returns ``predict``'s frames."""
    cfg = parse_cli(argv, description="future simulation rollout")
    if cfg.model.model_path:
        dump_config(cfg, os.path.join(cfg.model.model_path, "cfg_args.json"))
    frames = predict(cfg, device=device)
    print(f"done: {len(frames)} future frames")
    return frames


if __name__ == "__main__":
    main()
