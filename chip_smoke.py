"""The port's main path on one NVIDIA card (H100): build the CUDA kernels from
the checkout, hold each against its plain PyTorch version at the shapes the
main path gives it, run phase A of the reconstruction
(``fluidnexus_torch.pipelines.train_physical_particle.fit_first_frame``) at
the smoke configuration's full widths, time kernels and fit iterations, and
profile a few fit iterations (the card's busy share, host and device ms per
``fnx.*`` span).

Run from the root of a checkout:  python3 chip_smoke.py
It needs one card and exits non-zero, printing no result, without one.
The last line of its output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Workload (no dataset or stage-1 background ships with the repository):
- configs/smoke_dynamics.json through the port's Config, with
  iterations_per_time_first cut from 1000 to 30; visual capacity 65 536 with
  the config's 500 + 550 live visual particles;
- 5 training cameras at frame 0 (train_views "20134"), 960 x 544, around the
  smoke column; the ground truth is the port's own render of a second seeded
  column over the background;
- 32 768 seeded background splats in place of the stage-1 PLY;
- 16 x 16 tiles (T = 60 x 34 = 2040, P = 256), tile_capacity 512, dup 8 x 8.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, same sheet
SEED = 0
FIT_ITERS = 30
TIMED_ITERS = 20
PROFILE_ITERS = 10


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def smoke_scene(width=960, height=544):
    """Five cameras at frame 0 looking at the smoke column (x 0.326, z -0.3)
    from 2 units away, spread over 1.4 rad, like the five smoke views."""
    from fluidnexus_torch.data.cameras import Camera
    from fluidnexus_torch.data.readers import SceneInfo, nerf_pp_norm

    fovx = 0.7
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    cams = []
    for i, name in enumerate("20134"):
        ang = (i - 2) * 0.35
        ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        R = ry @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
        center = np.array([0.326, 0.15, -0.3]) + ry @ np.array([0.0, 0.0, 2.0])
        cams.append(Camera(uid=i, R=R, T=-R.T @ center, fovx=fovx, fovy=fovy, width=width,
                           height=height, image_name=f"train0{name}", time_idx=0))
    return SceneInfo(point_cloud=None, train_cameras=cams, test_cameras=[],
                     nerf_normalization=nerf_pp_norm(cams))


def synthetic_background(n, device):
    """Seeded stand-in for the stage-1 background: splats on a wall behind the
    column and a floor below it, 1-3 cm across."""
    from fluidnexus_torch.splat.dynamics import BackgroundSplats

    rng = np.random.default_rng(SEED + 1)
    nw = n * 3 // 4
    wall = np.stack([rng.uniform(-0.7, 1.35, nw), rng.uniform(-0.6, 0.9, nw),
                     rng.uniform(-1.3, -0.9, nw)], 1)
    floor = np.stack([rng.uniform(-0.7, 1.35, n - nw), rng.uniform(-0.25, -0.2, n - nw),
                      rng.uniform(-1.3, 0.3, n - nw)], 1)
    d = dict(xyz=np.concatenate([wall, floor]), color=rng.uniform(0.05, 0.6, (n, 3)),
             scaling=rng.uniform(-4.6, -3.5, (n, 3)), rotation=rng.normal(size=(n, 4)),
             opacity=rng.normal(0.0, 1.5, (n, 1)))
    return BackgroundSplats(**{k: torch.as_tensor(v, dtype=torch.float32, device=device)
                               for k, v in d.items()})


def render_ground_truth(cfg, scene, bg, device):
    """Gray renders of a second seeded column (the port's own renderer)."""
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.sim.state import make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_visual_points
    from fluidnexus_torch.splat.render import render_particles_with_background, to_gray3

    m = cfg.model
    pts = create_visual_points(m, np.random.default_rng(SEED + 2))
    pts[:, 1] += 0.02  # the target sits a little higher than the initial column
    vis = make_visual_state(m.visual_capacity, pts, device=device)
    attrs = constant_visual_attrs(m.visual_capacity, 1, device=device)
    with torch.no_grad():
        for cam in scene.train_cameras:
            out = render_particles_with_background(
                vis.xyz, vis.alive, attrs, bg,
                view_matrix=torch.as_tensor(cam.world_view, device=device),
                proj_matrix=torch.as_tensor(cam.full_proj, device=device),
                tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                height=cam.height, bg_color=torch.zeros(3, device=device),
                config=raster_config_from(cfg))
            cam.image = to_gray3(out.color.clamp(0, 1)).permute(1, 2, 0).cpu().numpy()


def main_path_tiles(cfg, scene, bg, device):
    """The packed per-tile rows of camera 0 exactly as the fit builds them."""
    from fluidnexus_torch.ops.rasterizer import tile_packed
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.sim.state import make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_visual_points
    from fluidnexus_torch.splat.render import compose_splats

    m = cfg.model
    cam = scene.train_cameras[0]
    vis = make_visual_state(m.visual_capacity, create_visual_points(m, np.random.default_rng(SEED)),
                            device=device)
    attrs = constant_visual_attrs(m.visual_capacity, 1, device=device)
    splats = compose_splats(vis.xyz, vis.alive, attrs, bg)
    with torch.no_grad():
        tl = tile_packed(*splats, view_matrix=torch.as_tensor(cam.world_view, device=device),
                         proj_matrix=torch.as_tensor(cam.full_proj, device=device),
                         tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                         height=cam.height, config=raster_config_from(cfg))
    return tl.packed.contiguous(), tl.gauss, tl.counts, tl.tiles_x, splats[0].shape[0]


def check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc):
    """Each kernel against its plain version on the same inputs; returns the
    per-kernel errors and the tensors the timing phase reuses."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    tx, ty = rc.tile_x, rc.tile_y
    gen = torch.Generator(device=packed_t.device).manual_seed(SEED)
    accum, ft, med, ckpt = tc.composite_fwd(packed_t, counts, tiles_x, tx, ty)
    pk = packed_t.clone().requires_grad_(True)
    acc_p, ft_p, med_p = tc.composite_plain(pk, counts, tiles_x, tx, ty, rc.chunk)
    torch.cuda.synchronize()
    # the median is the depth where T crosses 0.5. Where T lands within
    # rounding of 0.5, one version sees the crossing and the other sees none
    # and keeps the default 15: such flips are allowed on at most 1e-5 of the
    # pixels; every other pixel is held to 1e-4
    off = (med - med_p).abs() > 1e-4
    flips = off & ((med == 15.0) | (med_p == 15.0))
    fwd_err = {"accum": (accum - acc_p).abs().max().item(),
               "final_t": (ft - ft_p).abs().max().item(),
               "median": (med - med_p).abs()[~flips].max().item()}
    med_mismatch = int(off.sum())
    med_flips_ok = int(flips.sum()) == med_mismatch and med_mismatch <= max(1, 1e-5 * med.numel())

    gacc = torch.randn(accum.shape, generator=gen, device=accum.device)
    gft = torch.randn(ft.shape, generator=gen, device=ft.device)
    dpk = tc.composite_bwd(packed_t, counts, gacc, gft, ft, ckpt, tiles_x, tx, ty)
    (dpk_p,) = torch.autograd.grad((acc_p * gacc).sum() + (ft_p * gft).sum(), pk)
    live = (torch.arange(packed_t.shape[1], device=pk.device)[None, :] < counts[:, None])[..., None]
    dpk_p = dpk_p * live  # dead slots are never combined; the kernel leaves them 0
    # each field of the packed gradient against its own scale: the conic
    # columns grow with dx^2 in pixels and are ~1e3 times the colour and
    # opacity columns, so one scale over all fields would pass a wrong one.
    # Kernel and plain version both take power from dx, dy and agree to
    # under 1e-6 of each field's scale; a kernel that drops the T >= 1e-4 mask
    # is off by 2e-4 to 7e-4 of it, so the limit is 1e-4 of the scale
    g_scale = dpk_p.abs().amax((0, 1)).tolist()
    g_err = (dpk - dpk_p).abs().amax((0, 1)).tolist()
    bwd_err = max(g_err)

    out = tc.combine_rows(dpk, tile_gauss, counts, n)
    out_p = tc.combine_plain(dpk, tile_gauss, counts, n)
    torch.cuda.synchronize()
    comb_abs = (out - out_p).abs().max().item()
    comb_rel = comb_abs / max(out_p.abs().max().item(), 1e-30)

    print(f"kernel check: composite_fwd max|err| accum {fwd_err['accum']:.3e} final_t "
          f"{fwd_err['final_t']:.3e} median {fwd_err['median']:.3e} "
          f"(0.5-crossing flips {med_mismatch} of {med.numel()} pixels) "
          f"[tol 1e-4; flips <= 1e-5 of the pixels]")
    fields = ["dx", "dy", "dca", "dcb", "dcc", "dop"] + [f"dcolor{i}" for i in range(len(g_scale) - 7)] \
        + ["ddepth"]
    print("kernel check: composite_bwd max|err| / max|g| per field [tol 1e-4 x max|g| of the field]: "
          + ", ".join(f"{n} {e:.3e} / {s:.3e}" for n, e, s in zip(fields, g_err, g_scale)))
    print(f"kernel check: combine_rows max|err| {comb_abs:.3e} rel {comb_rel:.3e} [tol 1e-5 rel]")
    failures = [k for k, v in fwd_err.items() if not v <= 1e-4]
    if not med_flips_ok:
        failures.append("median flips")
    failures += [f"composite_bwd {n}" for n, e, s in zip(fields, g_err, g_scale) if not e <= 1e-4 * s]
    if not comb_rel <= 1e-5:
        failures.append("combine_rows")
    if failures:
        _fail(f"kernels disagree with their plain versions: {failures}")
    return (dict(composite_fwd=max(fwd_err.values()), composite_bwd=bwd_err, combine_rows=comb_abs),
            dict(ft=ft, ckpt=ckpt, gacc=gacc, gft=gft, dpk=dpk))


def time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved):
    """Kernel, plain version and (where one exists) library times at the main
    path's shapes, with the bound each is held to."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    tx, ty = rc.tile_x, rc.tile_y
    t, k, f = packed_t.shape
    c, p = f - 7, tx * ty
    live_slots = int(counts.sum())
    out = {}

    # The bounds count the function's own inputs and outputs, over the live
    # slots only. The transmittance checkpoints are left out: they are this
    # design's way of carrying T from the forward to the backward.
    ms = cuda_ms(lambda: tc.composite_fwd(packed_t, counts, tiles_x, tx, ty))
    plain = cuda_ms(lambda: tc.composite_plain(packed_t, counts, tiles_x, tx, ty, rc.chunk), iters=3)
    # bytes: live rows + counts read; accum, final T, median written.
    # operations per (live slot, pixel): dx, dy 2, power 9, exp 1, op*exp 1,
    # min 1, T update 2, weight 1, colour accumulate 2C
    nbytes = 4 * (live_slots * f + t) + 4 * t * p * (c + 2)
    out["composite_fwd"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                bound=bound_ms(nbytes, live_slots * p * (17 + 2 * c)))

    ms = cuda_ms(lambda: tc.composite_bwd(packed_t, counts, saved["gacc"], saved["gft"], saved["ft"],
                                          saved["ckpt"], tiles_x, tx, ty))
    pk = packed_t.clone().requires_grad_(True)
    acc_p, ft_p, _ = tc.composite_plain(pk, counts, tiles_x, tx, ty, rc.chunk)
    loss_p = (acc_p * saved["gacc"]).sum() + (ft_p * saved["gft"]).sum()
    plain = cuda_ms(lambda: torch.autograd.grad(loss_p, pk, retain_graph=True), iters=3)
    del acc_p, ft_p, loss_p
    # bytes: live rows, counts, gacc, gT, final T read; the live slots' packed
    # gradient written. operations per (live slot, pixel), alpha taken once:
    # alpha 14 (as in the forward), T update 1, 2C for colour . g, 2 weight,
    # 6 da, 1 dpower, 14 for the geometry and opacity gradients, C colour
    # gradients, 2 suffix, and 6 + C adds of the reduction over pixels
    nbytes = 4 * (live_slots * f + t + t * p * (c + 2)) + 4 * live_slots * f
    out["composite_bwd"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                bound=bound_ms(nbytes, live_slots * p * (46 + 4 * c)))

    dpk = saved["dpk"]
    ms = cuda_ms(lambda: tc.combine_rows(dpk, tile_gauss, counts, n), iters=20)
    plain = cuda_ms(lambda: tc.combine_plain(dpk, tile_gauss, counts, n), iters=20)
    live = (torch.arange(k, device=dpk.device)[None, :] < counts[:, None]).reshape(-1)
    gid_live, g_live = tile_gauss.reshape(-1)[live], dpk.reshape(-1, f)[live]
    acc = torch.zeros((n, f), device=dpk.device)
    library = cuda_ms(lambda: acc.zero_().index_add_(0, gid_live, g_live), iters=20)
    # bytes: live gradient rows and their int64 ids, counts read; (N, F) written
    nbytes = live_slots * (4 * f + 8) + 4 * t + 4 * n * f
    out["combine_rows"] = dict(ms=ms, plain_ms=plain, library_ms=library,
                               bound=bound_ms(nbytes, live_slots * f))
    return out, live_slots


def device_busy_ms(prof):
    """Union of the intervals of the kernels and copies that ran on the card,
    in ms. The spans' own ranges on the card's timeline are left out: they
    cover the gaps between their kernels."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def profile_fit(cfg, scene, bg, ms_iter):
    """PROFILE_ITERS fit iterations (with their set-up) under torch.profiler:
    the card's busy share, and each ``fnx.*`` span's host ms and the device
    ms of the kernels launched inside it. The backward's kernels are launched
    from autograd's own thread, so the ``fnx.backward`` span shows host time
    only; they show in the op table."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnexus_torch.pipelines.train_physical_particle import fit_first_frame

    cfg.optim.iterations_per_time_first = PROFILE_ITERS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / PROFILE_ITERS
    busy = device_busy_ms(prof) / PROFILE_ITERS
    ka = prof.key_averages()
    dev_key = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    print(f"profile, {PROFILE_ITERS} fit iterations with set-up: {wall:.3f} ms per iteration under "
          f"the profiler; the card busy {busy:.3f} ms per iteration ({100 * busy / wall:.1f} % of "
          f"that); against the unprofiled {ms_iter:.3f} ms per iteration the card idles "
          f"{100 * (1 - busy / ms_iter):.1f} %")
    print("span | host ms per iteration | device ms per iteration (kernels launched inside)")
    spans = [e for e in ka if e.key.startswith("fnx.")
             and e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(spans, key=lambda e: -e.cpu_time_total):
        print(f"{e.key} | {e.cpu_time_total / 1e3 / PROFILE_ITERS:.3f} | "
              f"{getattr(e, dev_key) / 1e3 / PROFILE_ITERS:.3f} | calls {e.count}")
    print(ka.table(sort_by="self_" + dev_key, row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


def main():
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines.train_physical_particle import fit_first_frame, raster_config_from

    torch.backends.cuda.matmul.allow_tf32 = False   # SSIM's blur products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    built = cuda_build.build(["rasterizer"])
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.1f} s -> {info['path']}")
        print(info["log"].strip())

    cfg = load_config("configs/smoke_dynamics.json")
    cfg.optim.iterations_per_time_first = FIT_ITERS
    cfg.seed = SEED
    rc = raster_config_from(cfg)
    scene = smoke_scene()
    bg = synthetic_background(32768, dev)
    render_ground_truth(cfg, scene, bg, dev)
    print(f"config: visual capacity {cfg.model.visual_capacity}, live "
          f"{cfg.model.init_visual_num_pts + cfg.model.init_thick_visual_num_pts}, background "
          f"{bg.n}, {len(scene.train_cameras)} cameras {scene.train_cameras[0].width}x"
          f"{scene.train_cameras[0].height}, tiles {rc.tile_x}x{rc.tile_y} K {rc.tile_capacity} "
          f"dup {rc.dup_x}x{rc.dup_y}")

    # ---- kernels against their plain versions at the main path's shapes
    packed_t, tile_gauss, counts, tiles_x, n = main_path_tiles(cfg, scene, bg, dev)
    print(f"camera 0 tiles: T {packed_t.shape[0]} K {packed_t.shape[1]} F {packed_t.shape[2]} "
          f"live slots {int(counts.sum())} max count {int(counts.max())}")
    errors, saved = check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc)

    # ---- phase A on the card: the main path. A 2-iteration warm-up first, so
    # the timed runs below do not carry the process's one-time costs (lazy
    # kernel loading, library handles, the SSIM blur matrices)
    cfg.optim.iterations_per_time_first = 2
    fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
    cfg.optim.iterations_per_time_first = FIT_ITERS
    torch.cuda.synchronize()
    tc.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    visual, attrs, losses = fit_first_frame(cfg, scene, bg=bg, log=print, device="cuda")
    end.record()
    end.synchronize()
    launches = dict(tc.LAUNCHES)
    ms_full = start.elapsed_time(end)
    for it, loss in enumerate(losses.tolist(), 1):
        print(f"fit iteration {it}: loss {loss:.6f}")
    print(f"launches in phase A ({FIT_ITERS} iterations): {launches}")
    if not torch.isfinite(losses).all():
        _fail("non-finite phase-A loss")
    if tuple(visual.xyz.shape) != (cfg.model.visual_capacity, 3) or not torch.isfinite(visual.xyz).all():
        _fail("phase-A positions are not finite (capacity, 3)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        _fail(f"the main path launched no {missing}")

    # mean ms over the last TIMED_ITERS iterations: the same fit cut to the
    # first FIT_ITERS - TIMED_ITERS iterations, timed alike, is subtracted.
    # One run's total moves by over 100 ms from run to run (host stalls), so
    # each length runs three times, alternating, and the medians are taken
    def fit_ms(iters):
        cfg.optim.iterations_per_time_first = iters
        start.record()
        fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    long_ms, short_ms = [ms_full], [fit_ms(FIT_ITERS - TIMED_ITERS)]
    for _ in range(2):
        long_ms.append(fit_ms(FIT_ITERS))
        short_ms.append(fit_ms(FIT_ITERS - TIMED_ITERS))
    ms_iter = (statistics.median(long_ms) - statistics.median(short_ms)) / TIMED_ITERS
    print(f"phase A: {', '.join(f'{t:.1f}' for t in long_ms)} ms for {FIT_ITERS} iterations "
          f"with set-up, {', '.join(f'{t:.1f}' for t in short_ms)} ms for "
          f"{FIT_ITERS - TIMED_ITERS}; {ms_iter:.3f} ms per fit iteration over the last "
          f"{TIMED_ITERS} (medians; batch {cfg.optim.batch} camera)")

    small_reference_check(dev)
    profile_fit(cfg, scene, bg, ms_iter)

    times, live_slots = time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved)
    sources = {"composite_fwd": "fluidnexus_tpu/ops/rasterizer_pallas.py:139",
               "composite_bwd": "fluidnexus_tpu/ops/rasterizer_pallas.py:246",
               "combine_rows": "fluidnexus_tpu/ops/rasterizer_pallas.py:368"}
    kernels = []
    for name, tm in times.items():
        b_ms, b_by = tm["bound"]
        print(f"{name}: {tm['ms']:.4f} ms (plain {tm['plain_ms']:.4f} ms, library "
              f"{tm['library_ms'] if tm['library_ms'] is None else round(tm['library_ms'], 4)} ms, "
              f"bound {b_ms:.4f} ms by {b_by}), {launches[name] / FIT_ITERS:g} launches "
              f"per fit iteration, {live_slots} live slots")
        kernels.append({"name": name, "route": "cuda", "source": "fluidnexus_torch/csrc/rasterizer.cu",
                        "replaces": sources[name], "launches": launches[name],
                        "max_abs_err": errors[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": tm["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def small_reference_check(dev):
    """Phase A at a small size through the kernels and through the plain CPU
    path, from one seed: the losses agree to 1e-3 and the positions within
    the Adam bound (eps 1e-15 moves a particle with a ~0 gradient by +-lr on
    its sign alone)."""
    from fluidnexus_torch.core.config import Config
    from fluidnexus_torch.pipelines.train_physical_particle import fit_first_frame
    from fluidnexus_torch.utils.maths import expon_lr

    cfg = Config()
    m, o, p = cfg.model, cfg.optim, cfg.pipe
    m.visual_capacity, m.init_visual_num_pts, m.init_thick_visual_num_pts = 1024, 300, 100
    o.iterations_per_time_first, o.batch, o.lambda_first_distance = 4, 2, 1.0
    o.distance_threshold_visual = 0.002
    p.tile_capacity, p.chunk = 128, 32
    scene = smoke_scene(width=160, height=96)
    bg = synthetic_background(2048, torch.device("cpu"))
    bg_dev = synthetic_background(2048, dev)
    render_ground_truth(cfg, scene, bg, torch.device("cpu"))
    v_cpu, _, l_cpu = fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cpu")
    v_dev, _, l_dev = fit_first_frame(cfg, scene, bg=bg_dev, log=lambda *a: None, device=dev)
    extent = scene.nerf_normalization["radius"]
    lr_max = max(expon_lr(it, o.position_lr_init * extent * o.pos_lr_scale_factor,
                          o.position_lr_final * extent, lr_delay_mult=o.position_lr_delay_mult,
                          max_steps=o.position_lr_max_steps)
                 for it in range(1, o.iterations_per_time_first + 1))
    dl = (l_dev.cpu() - l_cpu).abs().max().item() / l_cpu.abs().max().item()
    dx = (v_dev.xyz.cpu() - v_cpu.xyz).abs().max().item()
    bound = 100 * 2 * o.iterations_per_time_first * lr_max
    print(f"small phase A, card vs plain CPU path: loss rel diff {dl:.3e} [tol 1e-3], "
          f"max|dxyz| {dx:.3e} [bound {bound:.3e}]")
    if not (dl <= 1e-3 and dx <= bound):
        _fail("phase A on the card disagrees with the plain CPU path")


if __name__ == "__main__":
    main()
