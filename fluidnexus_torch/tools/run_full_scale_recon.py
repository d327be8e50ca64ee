"""The reconstruction at the reference's whole workload, on the card
(counterpart of the repository's ``tools/run_full_scale_recon.py``).

It first makes a ground-truth plume: the real PBF solver from a jittered
lattice, rendered at 960 x 544 from 5 training cameras and 1 held-out camera
a frame. Then it runs the whole ``train_physical_particle`` stage on it at the
reference's counts (configs/fluid_nexus_smoke_dynamics.json: 120 frames,
1 000 fit iterations a frame, 10 Jacobi projections a tick, 32 768 hidden
slots with ~27 720 alive, batch 1) and writes ``<out>/RUN.md``: the card, the
wall clock of the ground truth and of phases A, B and C, the median ms of a
phase-C fit iteration, the capacity-overflow reports (the solver's grids and
the splat's query list), per-frame loss and held-out PSNR, and the visual
particles alive at the last frame. It writes nothing outside ``--out``.

Usage (the whole run, on the card):
    python -m fluidnexus_torch.tools.run_full_scale_recon --out runs/full_scale_torch

A small run on the CPU (the kernels' plain versions):
    python -m fluidnexus_torch.tools.run_full_scale_recon --frames 2 --iters 5 \\
        --first_iters 5 --width 96 --height 56 --hidden_delta 0.04 --stable_iters 1 --cpu
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import time

import numpy as np
import torch

from fluidnexus_torch import resolve_device


def build_cameras(width: int, height: int, n_train: int = 5, n_test: int = 1):
    """A ring of cameras around the plume column (init_x_mid 0.326, z_mid
    -0.3), the reference's 5-view capture geometry: a list of (kind, index,
    Camera keyword arguments), the training views first."""
    center = np.array([0.326, 0.35, -0.3])
    cams = []
    angles = np.linspace(-0.65, 0.65, n_train)
    for kind, angs in (("train", angles), ("test", [0.25] if n_test else [])):
        for i, ang in enumerate(angs):
            ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                           [-np.sin(ang), 0, np.cos(ang)]])
            R = ry @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
            pos = center + ry @ np.array([0.0, 0.0, 2.2])
            cams.append((kind, i, dict(R=R, T=-R.T @ pos, fovx=0.9, fovy=0.6,
                                       width=width, height=height)))
    return cams


def simulate_gt(cfg, frames: int, cam_specs, log=print, device="cuda"):
    """The true plume: a jittered lattice and the real solver (20 stable
    ticks, then a tick a frame), each frame rendered gray from every camera
    of ``cam_specs``. Returns a ``SceneInfo`` of the training and held-out
    cameras with their images."""
    from fluidnexus_torch.data.cameras import Camera
    from fluidnexus_torch.data.readers import SceneInfo
    from fluidnexus_torch.pipelines.train_physical_particle import (
        pbf_params_from_config, raster_config_from, solver_tick)
    from fluidnexus_torch.sim.pbf import confirm_guess, remove_invalid
    from fluidnexus_torch.sim.state import make_particle_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_hidden_points
    from fluidnexus_torch.splat.render import render_particles_with_background, to_gray3

    dev = resolve_device(device)
    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    gt_rng = np.random.default_rng(12345)
    pts = create_hidden_points(m)
    # jittered, so that the reconstruction's own lattice cannot match it trivially
    pts = pts + gt_rng.uniform(-0.4, 0.4, pts.shape).astype(np.float32) * \
        m.init_hidden_delta * 100.0
    log(f"GT hidden init: {pts.shape[0]} particles")
    state = make_particle_state(m.hidden_capacity, pts, init_velocity_y=o.init_hidden_velocity,
                                gravity_alpha_buoyancy=np.array([0, -9.8, 0]) * o.alpha,
                                device=dev)
    rcfg = raster_config_from(cfg)
    attrs = constant_visual_attrs(m.hidden_capacity, channels=1, device=dev)
    views = [(kind, i, spec, Camera(uid=0, **spec)) for kind, i, spec in cam_specs]

    def render(cam):
        with torch.no_grad():
            out = render_particles_with_background(
                state.estimate_xyz / params.scale_factor, state.alive, attrs, None,
                view_matrix=torch.as_tensor(cam.world_view, device=dev),
                proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                height=cam.height, bg_color=torch.zeros(1, device=dev), config=rcfg)
            return torch.clamp(to_gray3(out.color), 0.0, 1.0)

    for _ in range(o.stable_iterations):
        state = remove_invalid(state, params)
        state, _ = solver_tick(state, params, o.solver_iterations, use_wind=False, stable=True)
        state = confirm_guess(state, params)

    t0 = time.time()
    train_cams, test_cams = [], []
    uid = 0
    for t in range(frames):
        if t > 0:
            state = remove_invalid(state, params)
            state, _ = solver_tick(state, params, o.solver_iterations, use_wind=False)
            state = confirm_guess(state, params)
        for kind, i, spec, cam in views:
            img = render(cam).permute(1, 2, 0).cpu().numpy().astype(np.float32)   # (H, W, 3)
            shot = Camera(uid=uid, image=img, image_real=img, image_name=f"{kind}0{i}",
                          time_idx=t, **spec)
            uid += 1
            (train_cams if kind == "train" else test_cams).append(shot)
        if t % 20 == 0:
            log(f"GT frame {t}/{frames}: alive={int(state.num_alive)} ({time.time() - t0:.0f}s)")
    log(f"GT simulation+render done in {time.time() - t0:.1f}s "
        f"(final alive={int(state.num_alive)})")
    return SceneInfo(point_cloud=None, train_cameras=train_cams, test_cameras=test_cams,
                     nerf_normalization={"radius": 2.2, "translate": np.zeros(3)})


def reference_config(args):
    """The reference's fluid_nexus_smoke_dynamics.json operating point at the
    run's counts, with the results under ``<out>/recon``."""
    from fluidnexus_torch.core.config import Config

    cfg = Config()
    o, m = cfg.optim, cfg.model
    m.model_path = os.path.join(args.out, "recon")
    m.hidden_capacity = 32768
    m.visual_capacity = 65536
    o.iterations_per_time_first = args.first_iters
    o.iterations_per_time_current = args.iters
    o.iterations_per_time_current_max = args.iters
    o.stable_iterations = args.stable_iters
    o.solver_iterations = 10
    o.secs = 0.033
    o.alpha = 0.0
    o.p0 = 1.5
    o.k = 3.0
    o.H = 2.0
    o.init_hidden_velocity = 100.0
    o.emit_ratio_hidden = 0.0      # the smoke config emits no hidden particles
    o.emit_ratio_visual = 1.0
    o.batch = 1
    o.lambda_dssim = 0.2
    o.lambda_exyz = 0.1
    o.lambda_gas_constraints = 1.0
    o.lambda_next_gas_constraints = 0.1
    o.lambda_first_distance = 1.0
    o.lambda_current_distance = 0.1
    m.init_hidden_radius_max = 0.1
    m.init_hidden_y_min = -0.1
    m.init_hidden_y_max = 0.8
    m.init_hidden_delta = args.hidden_delta
    m.init_visual_num_pts = 500
    m.init_thick_visual_num_pts = 550
    cfg.pipe.tile_x = 32
    cfg.pipe.tile_y = 32
    cfg.pipe.tile_capacity = 384
    cfg.pipe.chunk = 32
    cfg.pipe.dup_x = 3
    cfg.pipe.dup_y = 3
    return cfg


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if dev.type != "cuda":
        return "cpu (--cpu: the kernels' plain versions; no device time)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = f"{torch.cuda.get_device_name(dev)}, power limit not read (nvidia-smi failed)"
    return smi


def phase_times(marks, t_start, t_end):
    """Phases A, B and C's wall clock (s) and each phase-C frame's fit span
    (s), from the times ``train``'s log lines came: phase A ends at "phase A
    done", phase B at "phase B done"; a frame's span runs from its emission
    line to its loss line, so it holds its fit and, besides, its solver tick,
    commit and held-out render."""
    done, emitted, lossed = {}, {}, {}
    for t, line in marks:
        hit = re.match(r"phase ([AB]) done", line)
        if hit:
            done[hit.group(1)] = t
        hit = re.match(r"frame (\d+): emitted", line)
        if hit:
            emitted[int(hit.group(1))] = t
        hit = re.match(r"frame (\d+)/\d+: loss=", line)
        if hit:
            lossed[int(hit.group(1))] = t
    a, b = done.get("A", t_end), done.get("B", t_end)
    spans = {f: lossed[f] - emitted[f] for f in emitted if f in lossed}
    return (a - t_start, b - a, t_end - b), spans


def report(args, dev, metrics, t_gt, t_fit, phases, spans, overflow_lines):
    """RUN.md's lines."""
    psnrs = [mm["psnr"] for mm in metrics if "psnr" in mm]
    losses = [mm["loss"] for mm in metrics]
    drops = [mm.get("query_drops", 0) for mm in metrics]
    ms_iter = [1e3 * spans[mm["frame"]] / args.iters for mm in metrics if mm["frame"] in spans]
    n_frames = len(metrics)
    lines = [
        "# RUN — the full-scale reconstruction, PyTorch port",
        "",
        f"- workload: {args.frames} frames x {args.iters} fit iterations a frame "
        f"({args.first_iters} for frame 0), {args.width}x{args.height}, 5 train + 1 held-out "
        "cameras, hidden capacity 32768, 10 Jacobi projections a tick, batch 1, tiles 32x32 "
        "/ 384 / dup 3x3 (the reference's operating point: "
        "configs/fluid_nexus_smoke_dynamics.json)",
        f"- device: {device_line(dev)}",
        f"- GT simulation+render wall clock: {t_gt:.1f}s",
        f"- reconstruction wall clock: {t_fit:.1f}s ({t_fit / max(n_frames, 1):.1f}s a frame "
        "on average, set-up included)",
        f"- phases: A {phases[0]:.1f}s ({args.first_iters} iterations), B {phases[1]:.1f}s "
        f"({args.stable_iters} stable ticks), C {phases[2]:.1f}s ({n_frames} frames)",
        (f"- phase C: median {np.median(ms_iter):.3f} ms a fit iteration (min "
         f"{min(ms_iter):.3f}, max {max(ms_iter):.3f} over the frames; a frame's span from its "
         "emission to its loss line, over its iterations: its tick, commit and held-out render "
         "included)" if ms_iter else "- phase C: no frame"),
        f"- capacity-overflow warnings: {overflow_lines} (the solver's grids and the splat's "
        f"query list); visual particles the query list dropped: {sum(drops)} over the frames, "
        f"{drops[-1] if drops else 0} at the last",
        f"- frames completed: {n_frames}/{args.frames - 1}"
        + ("" if args.frames >= 120 else f" (cut from the reference's 120 to {args.frames})"),
        (f"- loss: first {losses[0]:.5f} -> last {losses[-1]:.5f} (median "
         f"{np.median(losses):.5f})" if losses else "- no frames"),
        (f"- held-out PSNR: first {psnrs[0]:.2f} dB -> last {psnrs[-1]:.2f} dB (median "
         f"{np.median(psnrs):.2f}, min {min(psnrs):.2f})" if psnrs else "- no held-out PSNR"),
        (f"- alive at the last frame: {metrics[-1]['visual']} visual, {metrics[-1]['hidden']} "
         "hidden particles" if metrics else "- alive at the last frame: no frame"),
        "",
        "Per-frame metrics: metrics.npy; TensorBoard events under this directory; per-frame npy "
        "checkpoints: recon/checkpoint/; the log: run.log.",
    ]
    return lines


def main(argv=None):
    """The run: the ground truth, then ``train``; returns ``train``'s result
    with the report's lines (``report``), the configuration (``config``),
    the ground truth's scene (``scene``) and the count of capacity-overflow
    log lines (``overflow_lines``). Raises without a card unless
    ``--cpu`` is given."""
    ap = argparse.ArgumentParser(description="the reconstruction at the reference's workload")
    ap.add_argument("--out", default="runs/full_scale_torch")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--first_iters", type=int, default=1000)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--stable_iters", type=int, default=20)
    ap.add_argument("--hidden_delta", type=float, default=0.01,
                    help="lattice spacing; 0.01 -> ~28k particles")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    from fluidnexus_torch.pipelines.train_physical_particle import train
    from fluidnexus_torch.utils.tb import TrainLogger

    os.makedirs(args.out, exist_ok=True)
    marks, overflow = [], {"count": 0}
    with open(os.path.join(args.out, "run.log"), "a", buffering=1) as logf:
        def log(*a):
            line = " ".join(str(x) for x in a)
            marks.append((time.perf_counter(), line))
            if "capacity" in line.lower() and "overflow" in line.lower():
                overflow["count"] += 1
            stamp = time.strftime("%H:%M:%S")
            print(f"[{stamp}] {line}", flush=True)
            logf.write(f"[{stamp}] {line}\n")

        cfg = reference_config(args)
        cam_specs = build_cameras(args.width, args.height)
        log(f"=== GT simulation ({args.frames} frames, {args.width}x{args.height}, "
            f"{len(cam_specs)} cams) on {device_line(dev)} ===")
        t_gt = time.perf_counter()
        scene = simulate_gt(cfg, args.frames, cam_specs, log, device=dev)
        t_gt = time.perf_counter() - t_gt

        log(f"=== reconstruction (iters/frame={args.iters}) ===")
        t_fit = time.perf_counter()
        result = train(cfg, scene_info=scene, writer=TrainLogger(args.out), log=log, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        phases, spans = phase_times(marks, t_fit, t_end)
        metrics = result["metrics"]
        np.save(os.path.join(args.out, "metrics.npy"), np.asarray(metrics, dtype=object),
                allow_pickle=True)
        n_overflow = overflow["count"]   # before the report's own line, which names them
        lines = report(args, dev, metrics, t_gt, t_end - t_fit, phases, spans, n_overflow)
        with open(os.path.join(args.out, "RUN.md"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log("\n".join(lines))
    result.update(report=lines, config=cfg, scene=scene, overflow_lines=n_overflow)
    return result


if __name__ == "__main__":
    main()
