"""Physical-particle reconstruction (counterpart of
``fluidnexus_tpu/pipelines/train_physical_particle.py``).

Parity target: FluidDynamics/entries_fluid_nexus/train_physical_particle.py.
So far phases A and B:

- ``fit_first_frame`` (phase A) fits the first frame's visual particle
  positions against the multi-view images (camera render, gray L1 + SSIM,
  the min-separation penalty, one Adam step per iteration);
- ``stabilize_hidden`` (phase B) builds the hidden PBF pillar and settles it
  with ``stable_iterations`` solver ticks.

Phase C, and ``train`` composing the three with the frame checkpoints, come
with the next slice.

The fit step's layers are ``torch.profiler.record_function`` spans named
``fnx.*`` (render, photometric_loss, distance_penalty, backward, adam; the
rasterizer adds project, tile_lists, gather and composite; the solver tick
remove_invalid, guess, dense_grid, jacobi and confirm), which
``chip_smoke.py`` reads.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from fluidnexus_torch import resolve_device
from fluidnexus_torch.core.config import Config
from fluidnexus_torch.core.optim import AdamState, adam_init, adam_step
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.data.scene import cameras_by_time
from fluidnexus_torch.ops.neighbors import radius_graph
from fluidnexus_torch.ops.rasterizer import RasterizerConfig
from fluidnexus_torch.sim.pbf import (
    PBFParams, confirm_guess, guess_hidden, remove_invalid, warn_capacity_overflow,
)
from fluidnexus_torch.sim.pbf_dense import project_iterations_dense
from fluidnexus_torch.sim.state import ParticleState, make_particle_state, make_visual_state
from fluidnexus_torch.splat.dynamics import (
    BackgroundSplats, VisualAttrs, constant_visual_attrs, create_hidden_points,
    create_visual_points,
)
from fluidnexus_torch.splat.render import render_particles_with_background, to_gray
from fluidnexus_torch.utils.losses import l1_loss, ssim
from fluidnexus_torch.utils.maths import expon_lr


def pbf_params_from_config(cfg: Config) -> PBFParams:
    o = cfg.optim
    return PBFParams(
        secs=o.secs, alpha=o.alpha, beta=o.beta, buoyancy_decay_rate=o.buoyancy_decay_rate,
        buoyancy_max_y=o.buoyancy_max_y, h=o.H, p0=o.p0, k=o.k,
        min_neighbors=o.min_neighbors, knn_k=min(o.KNN_K, 128),
        init_hidden_velocity=o.init_hidden_velocity,
        wind_force=tuple(float(x) for x in o.wind_force), wind_power=o.wind_power,
    )


def raster_config_from(cfg: Config) -> RasterizerConfig:
    p = cfg.pipe
    return RasterizerConfig(tile_capacity=p.tile_capacity, tile_x=p.tile_x, tile_y=p.tile_y,
                            dup_x=p.dup_x, dup_y=p.dup_y, chunk=p.chunk)


def map_cameras(one, cams, gts):
    """Per-camera loop: ``one(view, proj, fovs, gt)`` for each camera of the
    batch, its outputs stacked."""
    outs = [one(*(c[i] for c in cams), gts[i]) for i in range(gts.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(len(outs[0])))


def distance_penalty(positions, alive, threshold, k: int = 32):
    """Sum of (threshold - d)^2 over pairs closer than the threshold
    (utils/loss_utils.distance_loss:98), over radius-graph neighbor lists
    instead of a dense cdist. Only the valid pairs are gathered: the padded
    (N, K) gather's backward would funnel every masked slot (index 0) into one
    row, which PyTorch's CUDA index backward walks serially (517 ms per fit
    iteration against ~15 ms at the 65 536-row smoke capacity on an H100,
    chip_smoke.py)."""
    nl = radius_graph(positions.detach(), threshold, k=k, loop=False, alive=alive)
    i, j = torch.nonzero(nl.mask, as_tuple=True)
    d = torch.sqrt(torch.clamp(torch.sum(
        (positions[i] - positions[nl.idx[i, j]]) ** 2, -1), min=1e-20))
    return (torch.clamp(threshold - d, min=0.0) ** 2).sum()


def solver_tick(state: ParticleState, params: PBFParams, solver_iterations: int,
                use_wind: bool, stable: bool = False):
    """One simulation tick as the reference schedules it
    (train_physical_particle.py:286-298): guess, counts = solver_iterations
    for every slot up front, then ``solver_iterations`` Jacobi projections
    over one dense grid (``project_iterations_dense``). Returns (state,
    diags), the diagnostics stacked over the iterations on the device."""
    with record_function("fnx.guess"):
        state = tick_guess(state, params, solver_iterations, use_wind, stable)
    return project_iterations_dense(state, params, solver_iterations, counts_step=0.0)


def tick_guess(state: ParticleState, params: PBFParams, solver_iterations: int,
               use_wind: bool, stable: bool = False) -> ParticleState:
    """The tick's state before its projections: the guess, with counts =
    solver_iterations for every slot."""
    state = guess_hidden(state, params, stable=stable, use_wind=use_wind)
    return state._replace(counts=torch.full_like(state.counts, float(solver_iterations)))


# ------------------------------- phase A step --------------------------------


def make_first_frame_step(bg: Optional[BackgroundSplats], raster_cfg, width, height,
                          lambda_dssim, lambda_first_distance, distance_threshold_visual,
                          channels: int):
    """Phase-A fit step on one device. ``w`` carries per-camera weights and
    ``inv_w`` = 1 / (number of real cameras)."""

    def loss_fn(vxyz, alive, attrs, cams, gts, w, inv_w):
        def one(cam_view, cam_proj, fovs, gt):
            with record_function("fnx.render"):
                out = render_particles_with_background(
                    vxyz, alive, attrs, bg,
                    view_matrix=cam_view, proj_matrix=cam_proj,
                    tan_fovx=fovs[0], tan_fovy=fovs[1], width=width, height=height,
                    bg_color=torch.zeros(3 if bg is not None else channels, device=vxyz.device),
                    config=raster_cfg,
                )
            # losses in 1-channel gray space: equal to the reference's
            # gray-repeated-x3 comparison, 3x cheaper
            with record_function("fnx.photometric_loss"):
                img = to_gray(out.color)
                gtg = to_gray(gt)
                l1v = l1_loss(img, gtg)
                sv = 1.0 - ssim(img, gtg)
            return (1.0 - lambda_dssim) * l1v + lambda_dssim * sv, l1v

        losses, l1s = map_cameras(one, cams, gts)
        loss = (losses * w).sum() * inv_w
        if lambda_first_distance > 0:
            with record_function("fnx.distance_penalty"):
                loss = loss + lambda_first_distance * distance_penalty(
                    vxyz, alive, distance_threshold_visual)
        return loss, (l1s * w).sum() * inv_w

    def step(visual_xyz, alive, attrs: VisualAttrs, opt: AdamState, cams, gts, lr, w, inv_w):
        x = visual_xyz.detach().requires_grad_(True)
        loss, l1v = loss_fn(x, alive, attrs, cams, gts, w, inv_w)
        with record_function("fnx.backward"):
            (grad,) = torch.autograd.grad(loss, x)
        with record_function("fnx.adam"):
            new, opt = adam_step({"xyz": visual_xyz}, {"xyz": grad}, opt, {"xyz": lr})
        return new["xyz"], opt, loss.detach(), l1v.detach()

    return step


# ------------------------------- orchestration -------------------------------


def _cam_tensors(cams: List[Camera], device):
    views = torch.as_tensor(np.stack([c.world_view for c in cams]), device=device)
    projs = torch.as_tensor(np.stack([c.full_proj for c in cams]), device=device)
    fovs = torch.as_tensor(np.asarray([[c.tan_fovx, c.tan_fovy] for c in cams], np.float32),
                           device=device)
    return views, projs, fovs


def _select_batch(rng, n_cams: int, batch: int, dp: int):
    """Camera mini-batch of size min(batch, n_cams), padded up to a multiple
    of dp with zero-weight repeats. Returns (indices, weights, 1/realcount),
    drawing from ``rng`` exactly as the JAX package does."""
    b = min(batch, n_cams)
    sel = rng.choice(n_cams, size=b, replace=False)
    pad = (-b) % dp
    if pad:
        sel = np.concatenate([sel, np.repeat(sel[:1], pad)])
    w = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    return sel, w, np.float32(1.0 / b)


def _gts(cams: List[Camera], channels: int, device):
    out = []
    for c in cams:
        img = c.image
        if img.ndim == 2:
            img = img[..., None]
        if channels == 3 and img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        out.append(img.transpose(2, 0, 1))
    return torch.as_tensor(np.stack(out).astype(np.float32), device=device)


def fit_first_frame(cfg: Config, scene_info, bg: Optional[BackgroundSplats] = None, log=print,
                    device="cuda"):
    """Phase A of the reconstruction (JAX ``train`` lines up to the x100
    scaling): create the visual column from ``cfg.seed``, then
    ``iterations_per_time_first`` Adam steps against the frame-0 cameras.
    Returns ``(visual, attrs, losses)``: ``visual.xyz`` is already multiplied
    by ``scale_factor`` (detach_visual_and_scale, ref :188) and ``losses`` is
    the (iterations,) tensor of per-step losses. ``bg`` defaults to the PLY
    at ``cfg.model.bg_load_path`` when that is set."""
    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    raster_cfg = raster_config_from(cfg)
    rng = np.random.default_rng(cfg.seed)

    train_by_t = cameras_by_time(scene_info.train_cameras)
    cam0 = train_by_t[0][0]
    width, height = cam0.width, cam0.height
    channels = 3  # render channel (num_channel, ref :42)

    if bg is None and m.bg_load_path:
        ply = os.path.join(m.bg_load_path, "point_cloud",
                           f"iteration_{m.bg_load_iteration:05d}", "point_cloud.ply")
        bg = BackgroundSplats.from_ply(ply, device=dev)
        log(f"loaded background: {bg.n} splats from {ply}")

    vis_pts = create_visual_points(m, rng)
    visual = make_visual_state(m.visual_capacity, vis_pts, device=dev)
    attrs = constant_visual_attrs(m.visual_capacity, channels=1, device=dev)

    step = make_first_frame_step(bg, raster_cfg, width, height, o.lambda_dssim,
                                 o.lambda_first_distance, o.distance_threshold_visual, channels)
    opt = adam_init({"xyz": visual.xyz})
    cviews, cprojs, cfovs = _cam_tensors(train_by_t[0], dev)
    gts0 = _gts(train_by_t[0], channels, dev)
    extent = scene_info.nerf_normalization["radius"]

    vxyz = visual.xyz
    losses = []
    t0 = time.time()
    for it in range(1, o.iterations_per_time_first + 1):
        lr = expon_lr(it, o.position_lr_init * extent * o.pos_lr_scale_factor,
                      o.position_lr_final * extent,
                      lr_delay_mult=o.position_lr_delay_mult, max_steps=o.position_lr_max_steps)
        sel, w, inv_w = _select_batch(rng, len(train_by_t[0]), o.batch, cfg.pipe.dp)
        sel_t = torch.as_tensor(sel, device=dev)
        vxyz, opt, loss, _ = step(vxyz, visual.alive, attrs, opt,
                                  (cviews[sel_t], cprojs[sel_t], cfovs[sel_t]), gts0[sel_t],
                                  float(np.float32(lr)), torch.as_tensor(w, device=dev),
                                  torch.as_tensor(inv_w, device=dev))
        losses.append(loss)
    losses = torch.stack(losses) if losses else torch.zeros((0,), device=dev)
    log(f"phase A done in {time.time()-t0:.1f}s "
        f"loss={float(losses[-1]) if len(losses) else float('nan'):.5f}")

    # detach_visual_and_scale (ref :188): visual positions now live in x100 space
    visual = visual._replace(xyz=vxyz * params.scale_factor)
    return visual, attrs, losses


def stabilize_hidden(cfg: Config, params: PBFParams, log=print, device="cuda"):
    """Phase B of the reconstruction (JAX ``train`` :433-444, ref :190-228):
    the hidden lattice pillar, then ``stable_iterations`` ticks of
    remove_invalid -> solver_tick(stable=True) -> confirm_guess, each
    tick's grid overflow reported (raised under ``cfg.strict_capacity``).
    Returns ``(state, diags)``: the hidden ``ParticleState`` and each tick's
    diagnostics, stacked over the iterations and left on the device."""
    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    hidden_pts = create_hidden_points(m)
    state = make_particle_state(m.hidden_capacity, hidden_pts,
                                init_velocity_y=o.init_hidden_velocity,
                                gravity_alpha_buoyancy=np.array([0, -9.8, 0]) * o.alpha,
                                device=dev)
    log(f"hidden init: {hidden_pts.shape[0]} particles")

    diags = []
    for _ in range(o.stable_iterations):
        with record_function("fnx.remove_invalid"):
            state = remove_invalid(state, params)
        state, d = solver_tick(state, params, o.solver_iterations, use_wind=False, stable=True)
        warn_capacity_overflow(d, "phase B stabilization", strict=cfg.strict_capacity, log=log)
        with record_function("fnx.confirm"):
            state = confirm_guess(state, params)
        diags.append(d)
    return state, diags
