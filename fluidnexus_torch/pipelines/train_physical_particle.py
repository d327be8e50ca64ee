"""Physical-particle reconstruction (counterpart of
``fluidnexus_tpu/pipelines/train_physical_particle.py``).

Parity target: FluidDynamics/entries_fluid_nexus/train_physical_particle.py.
``train`` runs the stage's three phases on one device:

- ``fit_first_frame`` (phase A) fits the first frame's visual particle
  positions against the multi-view images (camera render, gray L1 + SSIM,
  the min-separation penalty, one Adam step per iteration);
- ``stabilize_hidden`` (phase B) builds the hidden PBF pillar and settles it
  with ``stable_iterations`` solver ticks;
- ``_phase_c`` (phase C), for every later frame: remove_invalid, emission,
  one solver tick, then the fit of the learnable hidden positions
  (``make_current_frame_step``: the visual particles advected by the
  differentiable splat and rendered, the distance, exyz and two gas-density
  losses, one Adam step per iteration), the commit and the per-frame npy
  checkpoints.

``train`` reads the scene from ``cfg.model.data_path`` (``data/scene.read_scene``)
when it is not handed one; ``main`` is the stage CLI
(``python -m fluidnexus_torch train_physical_particle``).

The fit steps' layers are ``torch.profiler.record_function`` spans named
``fnx.*`` (grid_nn, advect, render, photometric_loss, distance_penalty, exyz,
gas_loss, next_gas_loss, backward, adam; the rasterizer adds project,
tile_lists, gather and composite; the solver tick remove_invalid, guess,
dense_grid, jacobi and confirm; phase C's frame emit and commit), which
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
from fluidnexus_torch.core.config import Config, dump_config, parse_cli
from fluidnexus_torch.core.optim import AdamState, adam_init, adam_step
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.data.scene import cameras_by_time, read_scene
from fluidnexus_torch.ops.neighbors import build_dense_grid, radius_graph
from fluidnexus_torch.ops import rasterizer_cuda
from fluidnexus_torch.ops.rasterizer import RasterizerConfig
from fluidnexus_torch.sim.pbf import (
    PBFParams, confirm_guess, density_ratio_at, guess_from_nn, guess_hidden, remove_invalid,
    visual_xyz_from_nn, warn_capacity_overflow,
)
from fluidnexus_torch.sim.pbf_dense import project_iterations_dense
from fluidnexus_torch.sim.state import (
    ParticleState, VisualState, make_particle_state, make_visual_state,
)
from fluidnexus_torch.splat.dynamics import (
    BackgroundSplats, EmitterPoints, VisualAttrs, constant_visual_attrs, create_hidden_points,
    create_visual_points, emit_hidden, emit_visual, load_hidden, load_visual, pad_emission,
    plan_emission, plan_extra_visual, save_hidden, save_visual,
)
from fluidnexus_torch.splat.render import render_particles_with_background, to_gray, to_gray3
from fluidnexus_torch.utils.losses import l1_loss, psnr, ssim
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


# ------------------------------- phase C step --------------------------------


def _alive_mean(values, alive):
    """Sum of ``values`` over the alive rows over max(#alive, 1)."""
    return torch.where(alive, values, 0.0).sum() / torch.clamp(alive.sum(), min=1)


def make_current_frame_step(bg: Optional[BackgroundSplats], raster_cfg, width, height,
                            params: PBFParams, o, channels: int):
    """Phase-C fit step on one device: the learnable hidden positions ``nn``
    (world units) advect the visual particles, which are rendered and
    compared with the frame's images; the current distance penalty, the exyz
    term and the two gas-density terms join the loss; the gradient, masked
    by ``alive``, takes one Adam step. One dense grid at ``nn *
    scale_factor`` is built per iteration and shared by the advection and the
    gas loss, which evaluate at the same positions; the next-step gas term
    builds its own at ``guess_from_nn``."""
    lambda_dssim = o.lambda_dssim

    def loss_fn(nn, state: ParticleState, visual: VisualState, attrs, cams, gts, w, inv_w):
        with record_function("fnx.grid_nn"):
            grid_nn = build_dense_grid(nn.detach() * params.scale_factor, params.h, state.alive,
                                       params.dense_max_cells, params.dense_cell_capacity)
        with record_function("fnx.advect"):
            vxyz_world = visual_xyz_from_nn(visual.xyz, visual.alive, nn, state, params,
                                            grid=grid_nn) / params.scale_factor

        def one(cam_view, cam_proj, fovs, gt):
            with record_function("fnx.render"):
                out = render_particles_with_background(
                    vxyz_world, visual.alive, attrs, bg,
                    view_matrix=cam_view, proj_matrix=cam_proj,
                    tan_fovx=fovs[0], tan_fovy=fovs[1], width=width, height=height,
                    bg_color=torch.zeros(3 if bg is not None else channels, device=nn.device),
                    config=raster_cfg,
                )
            with record_function("fnx.photometric_loss"):
                img = to_gray(out.color)
                gtg = to_gray(gt)
                l1v = l1_loss(img, gtg)
                sv = 1.0 - ssim(img, gtg)
            return (1.0 - lambda_dssim) * l1v + lambda_dssim * sv, l1v

        img_losses, l1s = map_cameras(one, cams, gts)
        loss = o.lambda_image * (img_losses * w).sum() * inv_w
        aux = {"l1": (l1s * w).sum() * inv_w}
        if o.lambda_current_distance > 0:
            with record_function("fnx.distance_penalty"):
                loss = loss + o.lambda_current_distance * distance_penalty(
                    vxyz_world, visual.alive, o.distance_threshold_visual)
        if o.lambda_exyz > 0:
            with record_function("fnx.exyz"):
                # masked MSE over alive particles (ref :371-373)
                diff = (nn * params.scale_factor - state.estimate_xyz) ** 2
                exyz_v = torch.where(state.alive[:, None], diff, 0.0).sum() / (
                    torch.clamp(state.alive.sum(), min=1) * 3)
                loss = loss + o.lambda_exyz * exyz_v
                aux["exyz"] = exyz_v
        if o.lambda_gas_constraints > 0:
            with record_function("fnx.gas_loss"):
                ratio = density_ratio_at(nn * params.scale_factor, state.alive, state.imass,
                                         params, grid=grid_nn)
                gas_v = _alive_mean((ratio - 1.0) ** 2, state.alive)
                loss = loss + o.lambda_gas_constraints * gas_v
                aux["gas"] = gas_v
        if o.lambda_next_gas_constraints > 0:
            with record_function("fnx.next_gas_loss"):
                nxt = guess_from_nn(nn, state, params)
                ratio2 = density_ratio_at(nxt, state.alive, state.imass, params)
                gas2_v = _alive_mean((ratio2 - 1.0) ** 2, state.alive)
                loss = loss + o.lambda_next_gas_constraints * gas2_v
                aux["next_gas"] = gas2_v
        return loss, aux

    def step(exyz_nn, opt: AdamState, state: ParticleState, visual: VisualState,
             attrs: VisualAttrs, cams, gts, lr, w, inv_w):
        x = exyz_nn.detach().requires_grad_(True)
        loss, aux = loss_fn(x, state, visual, attrs, cams, gts, w, inv_w)
        with record_function("fnx.backward"):
            (grad,) = torch.autograd.grad(loss, x)
        with record_function("fnx.adam"):
            grad = torch.where(state.alive[:, None], grad, 0.0)
            new, opt = adam_step({"nn": exyz_nn}, {"nn": grad}, opt, {"nn": lr})
        return new["nn"], opt, loss.detach(), {k: v.detach() for k, v in aux.items()}

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


def _load_background(cfg: Config, bg, dev, log):
    """``bg`` as given, else the PLY at ``cfg.model.bg_load_path`` when that
    is set, else None."""
    m = cfg.model
    if bg is None and m.bg_load_path:
        ply = os.path.join(m.bg_load_path, "point_cloud",
                           f"iteration_{m.bg_load_iteration:05d}", "point_cloud.ply")
        bg = BackgroundSplats.from_ply(ply, device=dev)
        log(f"loaded background: {bg.n} splats from {ply}")
    return bg


def fit_first_frame(cfg: Config, scene_info, bg: Optional[BackgroundSplats] = None, log=print,
                    device="cuda", rng: Optional[np.random.Generator] = None):
    """Phase A of the reconstruction (JAX ``train`` lines up to the x100
    scaling): create the visual column, then ``iterations_per_time_first``
    Adam steps against the frame-0 cameras. Both draw from ``rng``, by
    default a new ``np.random.default_rng(cfg.seed)``; ``train`` passes the
    one generator that phase C goes on drawing from, as the JAX package's
    ``train`` does. Returns ``(visual, attrs, losses)``: ``visual.xyz`` is
    already multiplied by ``scale_factor`` (detach_visual_and_scale, ref
    :188) and ``losses`` is the (iterations,) tensor of per-step losses.
    ``bg`` defaults to the PLY at ``cfg.model.bg_load_path`` when that is
    set. A tile with a side of 0 or less raises ValueError before any work
    (``rasterizer_cuda.check_tile``); the card takes every other tile."""
    rasterizer_cuda.check_tile(cfg.pipe.tile_x, cfg.pipe.tile_y, device)
    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    raster_cfg = raster_config_from(cfg)
    if rng is None:
        rng = np.random.default_rng(cfg.seed)

    train_by_t = cameras_by_time(scene_info.train_cameras)
    cam0 = train_by_t[0][0]
    width, height = cam0.width, cam0.height
    channels = 3  # render channel (num_channel, ref :42)
    bg = _load_background(cfg, bg, dev, log)

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


# ---------------------------------- phase C ----------------------------------


def emission_caps(cfg: Config, emitters: EmitterPoints):
    """The static emission capacities of the JAX ``_phase_c`` (:484-487):
    ``pad_emission`` cuts each frame's plan at its cap, so they change
    results."""
    o, m = cfg.optim, cfg.model
    hid_cap = max(int(np.ceil(o.emit_ratio_hidden)) * max(len(emitters.hidden), 1), 1)
    vis_cap = max(int(np.ceil(o.emit_ratio_visual)) * max(len(emitters.visual), 1), 1) + \
        max(int(m.visual_capacity * max(o.extra_visual_ratio, 0.02)), o.extra_visual_num,
            o.extra_visual_min_num, 64)
    return hid_cap, vis_cap


def simulate_frame(cfg: Config, params: PBFParams, t: int, state: ParticleState,
                   visual: VisualState, emitters: EmitterPoints, caps, rng, log=print):
    """A frame's simulation before its fit (JAX ``_phase_c`` :490-508):
    remove_invalid, the hidden emission, the visual emitter and the resample
    of high visual particles (drawn from ``rng`` in that order), one solver
    tick, its overflow report. Returns (state, visual, diags, emitted), with
    ``emitted`` the (hidden, visual) candidates within the caps."""
    o, m = cfg.optim, cfg.model
    hid_cap, vis_cap = caps
    with record_function("fnx.remove_invalid"):
        state = remove_invalid(state, params)
    use_wind = o.wind_since >= 0 and t >= o.wind_since
    with record_function("fnx.emit"):
        new_hidden, hmask = pad_emission(
            plan_emission(emitters.hidden, o.emit_ratio_hidden, rng), hid_cap)
        state = emit_hidden(state, new_hidden, o.init_hidden_velocity, o.alpha, mask=hmask)
        new_visual = plan_emission(emitters.visual, o.emit_ratio_visual, rng)
        extra = plan_extra_visual(visual.xyz.cpu().numpy(), visual.alive.cpu().numpy(),
                                  o.extra_visual_ratio, o.extra_visual_num, o.extra_visual_y_min,
                                  o.extra_visual_min_num, m.emitter_visual_delta, rng)
        new_v, vmask = pad_emission(np.concatenate([new_visual, extra], 0), vis_cap)
        visual = emit_visual(visual, new_v, mask=vmask)
    state, diags = solver_tick(state, params, o.solver_iterations, use_wind)
    warn_capacity_overflow(diags, f"frame {t} simulate", strict=cfg.strict_capacity, log=log)
    return state, visual, diags, (int(hmask.sum()), int(vmask.sum()))


def frame_iterations(cfg: Config, t: int, n_frames: int, cams: List[Camera]):
    """(iterations, cameras) of frame ``t``: the count ramps from
    iterations_per_time_current to _max over the frames; from
    sparse_views_from_time_index on, only the sparse views, for
    iterations_per_time_current_sparse."""
    o = cfg.optim
    lo, hi = o.iterations_per_time_current, o.iterations_per_time_current_max
    iters = int(lo + (hi - lo) * t / n_frames)
    if 0 < o.sparse_views_from_time_index <= t:
        cams = [c for c in cams if c.image_name in o.sparse_views]
        iters = o.iterations_per_time_current_sparse
    return iters, cams


def fit_frame(cfg: Config, params: PBFParams, step, state: ParticleState, visual: VisualState,
              attrs: VisualAttrs, cams: List[Camera], iters: int, extent: float, rng, dev):
    """The frame's fit: Adam over ``nn`` = estimate_xyz / scale_factor, from
    fresh moments (training_setup_current, gm:372), ``iters`` steps of
    ``step`` on camera batches drawn from ``rng``. Returns (nn, losses)."""
    o = cfg.optim
    exyz_nn = state.estimate_xyz / params.scale_factor
    opt = adam_init({"nn": exyz_nn})
    cviews, cprojs, cfovs = _cam_tensors(cams, dev)
    gts = _gts(cams, 3, dev)
    losses = []
    for it in range(1, iters + 1):
        lr = expon_lr(it, o.position_lr_init * extent * o.pos_lr_scale_factor,
                      o.position_lr_final * extent, lr_delay_mult=o.position_lr_delay_mult,
                      max_steps=o.position_lr_max_steps)
        sel, w, inv_w = _select_batch(rng, len(cams), o.batch, cfg.pipe.dp)
        sel_t = torch.as_tensor(sel, device=dev)
        exyz_nn, opt, loss, _ = step(exyz_nn, opt, state, visual, attrs,
                                     (cviews[sel_t], cprojs[sel_t], cfovs[sel_t]), gts[sel_t],
                                     float(np.float32(lr)), torch.as_tensor(w, device=dev),
                                     torch.as_tensor(inv_w, device=dev))
        losses.append(loss)
    return exyz_nn, losses


def commit_frame(params: PBFParams, state: ParticleState, visual: VisualState, exyz_nn):
    """confirm_from_nn + advect visual + wo_velocity (ref :456-458): the
    visual particles move by the splat of the fitted positions (its own grid),
    the fitted positions become the alive estimates, then confirm_guess."""
    with record_function("fnx.commit"), torch.no_grad():
        new_visual_xyz = visual_xyz_from_nn(visual.xyz, visual.alive, exyz_nn, state, params)
        a = state.alive[:, None]
        state = state._replace(estimate_xyz=torch.where(a, exyz_nn * params.scale_factor,
                                                        state.estimate_xyz))
        visual = visual._replace(xyz=torch.where(visual.alive[:, None], new_visual_xyz, visual.xyz))
        state = confirm_guess(state, params)
    return state, visual


def _phase_c(cfg: Config, scene_info, state: ParticleState, visual: VisualState,
             attrs: VisualAttrs, bg, raster_cfg, params: PBFParams, rng, writer, log, ckpt_path,
             start_frame: int = 1):
    """Phase C: per-frame simulate + fit (ref :244-469) from ``start_frame``
    on, on the device the state lies on. Returns the JAX package's result
    dict (state, visual, attrs, background, metrics, params)."""
    o, m = cfg.optim, cfg.model
    dev = state.xyz.device
    train_by_t = cameras_by_time(scene_info.train_cameras)
    test_by_t = cameras_by_time(scene_info.test_cameras)
    n_frames = len(train_by_t)
    cam0 = train_by_t[0][0]
    extent = scene_info.nerf_normalization["radius"]
    emitters = EmitterPoints.from_config(m)
    caps = emission_caps(cfg, emitters)
    step = make_current_frame_step(bg, raster_cfg, cam0.width, cam0.height, params, o, 3)

    metrics_per_frame = []
    for t in range(start_frame, n_frames):
        state, visual, diags, emitted = simulate_frame(cfg, params, t, state, visual, emitters,
                                                       caps, rng, log=log)
        log(f"frame {t}: emitted {emitted[0]} hidden and {emitted[1]} visual candidates")
        if writer:
            for k, v in diags.items():
                writer.add_scalar(f"sim_frame_{t:03d}/{k}", float(v[-1]), t)
        iters, cams = frame_iterations(cfg, t, n_frames, train_by_t[t])
        exyz_nn, losses = fit_frame(cfg, params, step, state, visual, attrs, cams, iters, extent,
                                    rng, dev)
        loss = float(losses[-1]) if losses else float("nan")
        if writer:
            writer.add_scalar(f"train_loss_frame_{t:03d}/total", loss, t)
        state, visual = commit_frame(params, state, visual, exyz_nn)

        frame_metrics = {"frame": t, "loss": loss, "hidden": int(state.num_alive),
                         "visual": int(visual.num_alive)}
        # held-out evaluation (training_report parity, ref :588-741)
        if test_by_t.get(t):
            ev, img0 = evaluate_frame(visual, attrs, bg, test_by_t[t], raster_cfg,
                                      return_image=True)
            frame_metrics.update(ev)
            if writer:
                for k, v in ev.items():
                    writer.add_scalar(f"test_frame_{t:03d}/{k}", v, t)
                writer.add_image("render/test_view", img0, t)
        metrics_per_frame.append(frame_metrics)
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss at frame {t}; last good per-frame npy "
                f"checkpoints are under {ckpt_path or '(no model_path)'}")
        log(f"frame {t}/{n_frames-1}: loss={loss:.5f} "
            f"hidden={int(state.num_alive)} visual={int(visual.num_alive)}")
        if ckpt_path:
            save_hidden(state, params, ckpt_path, t)
            save_visual(visual, attrs, ckpt_path, t)

    return dict(state=state, visual=visual, attrs=attrs, background=bg,
                metrics=metrics_per_frame, params=params)


def evaluate_frame(visual: VisualState, attrs: VisualAttrs, bg, cams: List[Camera],
                   raster_cfg, scale_factor=100.0, scaled=True, return_image=False):
    """Held-out render metrics (training_report, ref :588-741): gray L1 and
    PSNR against the supervision image and against the real capture."""
    out = {}
    first_img = None
    dev = visual.xyz.device
    vxyz = visual.xyz / scale_factor if scaled else visual.xyz
    with torch.no_grad():
        for cam in cams:
            r = render_particles_with_background(
                vxyz, visual.alive, attrs, bg,
                view_matrix=torch.as_tensor(cam.world_view, device=dev),
                proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                height=cam.height,
                bg_color=torch.zeros(3 if bg is not None else attrs.color.shape[-1], device=dev),
                config=raster_cfg,
            )
            img = to_gray3(torch.clamp(r.color, 0, 1))
            if first_img is None:
                first_img = img.cpu().numpy()
            for name, target in (("", cam.image), ("_real", cam.image_real)):
                if target is None:
                    continue
                tgt = target[..., None] if target.ndim == 2 else target
                tgt = np.repeat(tgt, 3, -1) if tgt.shape[-1] == 1 else tgt
                gt = to_gray3(torch.as_tensor(tgt, device=dev).permute(2, 0, 1))
                out.setdefault(f"l1{name}", []).append(float(l1_loss(img, gt)))
                out.setdefault(f"psnr{name}", []).append(float(psnr(img, gt)))
    res = {k: float(np.mean(v)) for k, v in out.items()}
    return (res, first_img) if return_image else res


# ------------------------------------ train ----------------------------------


def train(cfg: Config, scene_info=None, writer=None, log=print, resume_from_frame: int = -1,
          bg: Optional[BackgroundSplats] = None, device="cuda"):
    """The reconstruction stage, phases A -> B -> C, on ``device``. One
    ``np.random.default_rng(cfg.seed)`` feeds phase A's column and camera
    picks and then phase C's picks and emissions, as in the JAX package.
    With ``cfg.model.model_path`` set, the post-B state is saved as frame 0
    and every phase-C frame after it (``<model_path>/checkpoint``).
    ``resume_from_frame >= 1`` restarts phase C at that frame from the saved
    checkpoint of the frame before (the reference cannot resume, SURVEY §5).
    Without a ``scene_info`` the scene is read from ``cfg.model.data_path``
    (``read_scene``). A tile with a side of 0 or less raises ValueError
    before any work (``rasterizer_cuda.check_tile``); the card takes every
    other tile."""
    rasterizer_cuda.check_tile(cfg.pipe.tile_x, cfg.pipe.tile_y, device)
    dev = resolve_device(device)
    if scene_info is None:
        scene_info = read_scene(cfg)
    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    raster_cfg = raster_config_from(cfg)
    rng = np.random.default_rng(cfg.seed)
    bg = _load_background(cfg, bg, dev, log)
    ckpt_path = os.path.join(m.model_path, "checkpoint") if m.model_path else None

    if resume_from_frame >= 1:
        state = load_hidden(ckpt_path, resume_from_frame - 1, m.hidden_capacity, params,
                            device=dev)
        visual, attrs = load_visual(ckpt_path, resume_from_frame - 1, m.visual_capacity,
                                    channels=1, device=dev)
        log(f"resumed from frame {resume_from_frame - 1}: "
            f"hidden={int(state.num_alive)} visual={int(visual.num_alive)}")
        return _phase_c(cfg, scene_info, state, visual, attrs, bg, raster_cfg, params,
                        rng, writer, log, ckpt_path, start_frame=resume_from_frame)

    visual, attrs, _ = fit_first_frame(cfg, scene_info, bg=bg, log=log, device=dev, rng=rng)
    state, _ = stabilize_hidden(cfg, params, log=log, device=dev)
    log(f"phase B done: hidden={int(state.num_alive)} visual={int(visual.num_alive)}")
    if ckpt_path:
        save_hidden(state, params, ckpt_path, 0)
        save_visual(visual, attrs, ckpt_path, 0)
    return _phase_c(cfg, scene_info, state, visual, attrs, bg, raster_cfg, params,
                    rng, writer, log, ckpt_path, start_frame=1)


def main(argv=None, device="cuda"):
    """``python -m fluidnexus_torch train_physical_particle``: the JAX CLI's
    flags (``core/config.parse_cli``) and ``--resume_from_frame N``, taken
    out of argv before the config is parsed. Writes ``cfg_args.json`` and a
    TensorBoard log under ``model_path`` when that is set. Returns
    ``train``'s result."""
    import sys

    resume = -1
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--resume_from_frame" in argv:
        i = argv.index("--resume_from_frame")
        resume = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    cfg = parse_cli(argv, description="train physical particles")
    if cfg.detect_anomaly:  # --detect_anomaly parity (helper_parser.py:24,46)
        torch.autograd.set_detect_anomaly(True)
    writer = None
    if cfg.model.model_path:
        dump_config(cfg, os.path.join(cfg.model.model_path, "cfg_args.json"))
        from fluidnexus_torch.utils.tb import TrainLogger

        writer = TrainLogger(cfg.model.model_path)
    result = train(cfg, writer=writer, resume_from_frame=resume, device=device)
    print(f"done: {len(result['metrics'])} frames")
    return result


if __name__ == "__main__":
    main()
