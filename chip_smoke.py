"""The port's main path on one NVIDIA card (H100): build the CUDA kernels from
the checkout, hold each against its plain PyTorch version at the shapes the
main path gives it, run phases A and B of the reconstruction at the smoke
configuration's full widths, then the whole stage A -> B -> C through
``train``, time kernels, fit iterations, solver ticks and phase-C frames, and
(``python3 chip_smoke.py profiles``: the default run and these profiles)
profile a few of each (the card's busy share, host and device ms per
``fnx.*`` span).

Run from the root of a checkout:  python3 chip_smoke.py
It needs one card and exits non-zero, printing no result, without one.
``python3 chip_smoke.py mutants [attention|rasterizer|pairs]`` builds broken
copies of the kernels (six of the attention backward: three of the mma.sync
pair, three of the Hopper kernel; eight of the rasterizer: five of its
backward and combine (one sums a chunked tile's first chunk alone), three of
its forward; twenty-four of the pair
kernels: two each of the density's adjoint, the density, the splat adjoint
and the splat forward, two of phase 2's body, two of its dsum epilogue, four
of phase 1's body, two of phase 1 v2 alone, four of phase 2 v1 alone, and
two of phase 1 v1 alone: its self pair taken by d2 = 0 instead of by index,
and its skip's reach tightened to 0.95 h^2) and shows that each fails a
check; ``python3 chip_smoke.py raster [PARENT]`` checks and times the
rasterizer kernels alone at camera 0's tiles (beside another checkout's,
PARENT, in turns and bit for bit), then at its 12 x 12 and 64 x 32 tiles;
``python3 chip_smoke.py pairs [PARENT]`` does the same for the pair kernels
of rows 4-13 of PERF.md's kernel table (the gas-loss density, its adjoint
and both splat kernels at the first phase-C fit iteration's inputs, phases
1 and 2 of the PBF tick, 1 and 2 v2 and 1 and 2 v1 at phase B's first tick,
and 1 and 2 v2 and v1 at the rigid rollout's first iteration), with their
launch floors (every count 0; the splat forward also with every source
count 0, the splat adjoint with every query count 0); ``python3
chip_smoke.py pbf-variants PARENT VARIANT...`` holds source variants of the
PBF kernels to PARENT bit for bit and times phases 1 and 2 v2 in turns;
``python3 chip_smoke.py encode-probe`` tries the
video training batch's whole-clip VAE encode; ``python3 chip_smoke.py
attention-time`` times the attention forward kernels alone at the 5B shape,
``python3 chip_smoke.py attention-bwd`` checks the backward kernels at ragged
shapes and times them there; ``python3 chip_smoke.py tick-flips`` counts how
often the PBF tick's backends part at a pair that crosses the kernel radius;
``python3 chip_smoke.py stages`` runs the stages phase alone,
``python3 chip_smoke.py refine`` the refinement phase alone,
``python3 chip_smoke.py novel-view`` the Zero123 phase alone,
``python3 chip_smoke.py text-data`` the text-and-data phase alone,
``python3 chip_smoke.py port-eval`` the port-and-metrics phase alone,
``python3 chip_smoke.py port-5b`` the ``port`` stage on the 42-layer SAT DiT
and the ``--vgg16`` sFID finding (VGG16 on 10 000 + 10 000 images, scipy's
sqrtm timed),
``python3 chip_smoke.py scalar`` the ScalarFlow phase alone,
``python3 chip_smoke.py refine-encode-probe`` tries the refinement windows'
whole VAE encode beside the resident 5B DiT, and
``python3 chip_smoke.py png-time`` times the PNG decode on any CPU.
The last line of its output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The scene (no dataset or stage-1 background ships with the repository):
5 training cameras per frame for frames 0-2 (train_views "20134"), 960 x 544,
around the smoke column; each frame's ground truth is the port's own render
of a second seeded column, moved up from frame to frame, over 32 768 seeded
background splats that stand in for the stage-1 PLY.

Phase A (``fit_first_frame``): configs/smoke_dynamics.json through the
port's Config, with iterations_per_time_first cut from 1000 to 30; visual
capacity 65 536 with the config's 500 + 550 live visual particles; 16 x 16
tiles (T = 60 x 34 = 2040, P = 256), tile_capacity 512, dup 8 x 8; the
rasterizer kernels are also held to their plain versions at camera 0's 12 x
12 and 64 x 32 tiles (two chunks a tile); then 3 fit iterations each at 8 x
4, 12 x 12 and 64 x 32 tiles, and ``train`` refusing a tile with no pixel
before any work.

Phase B (``stabilize_hidden``): the same config with init_hidden_delta 0.01,
the reference operating point of tools/run_full_scale_recon.py (the Config
default 0.009 gives 38 885 points, over the 32 768-slot hidden capacity):
27 720 hidden particles, h = 2, a dense grid of 4 096 cells x 32 slots,
20 ticks of 10 Jacobi iterations.

Phase C (``train``, phases A -> B -> C in one call): the same config with
iterations_per_time_current and _max cut from 1000 to 30, frames 1-2; the
config's batch 1, emit_ratio_visual 1.0, extra_visual_ratio 0.01 and
emit_ratio_hidden 0. Each fit iteration builds one hidden grid of 4 096 x 32
and one visual query list of 4 096 rows. ``train`` writes its npy
checkpoints to a temporary directory.

Future (``predict``, stage 4): configs/smoke_future_simulation.json from
phase C's frame-2 checkpoint, future_pred_frames cut from the README's 60 to
10, wind_force [35, 0, 0] (configs/smoke_wind_simulation.json) from future
frame 3 on, the config's rigid cylinder from future frame 5 on; renders of
frame 0's 5 cameras at 960 x 544 over the same background.

Rigid rollout: from the same checkpoint, ticks of guess -> ``solver_loop``
with the cylinder (10 Jacobi iterations, the grid rebuilt every iteration:
the v2 kernels) -> confirm -> ``update_visual``; the v2 and v1 kernels held
against their plain versions and each other at the first iteration's inputs.

Stages (``run_stages``): a capture written to a temporary folder at the
same geometry (transforms files, ``train0{c}/{t:03d}.png`` for frames 0-2,
``train0{c}_bg/000.png``, the fake-view folders, every PNG written by
``save_image`` from the port's renders), then the four stage ``main``s in
process on the card: ``train_background`` on configs/smoke_background.json
at full width (100 000 initial Gaussians, capacity 120 000) for 400 of its
15 000 iterations with the densify, opacity-reset and large-prune intervals
cut so that each fires, ``train_physical_particle`` from its PLY (frames
0-2, 10 + 2 x 5 fit iterations), ``train_visual_particle`` (stage 3) from
its checkpoints on configs/smoke_dynamics.json at full width (visual
capacity 65 536, 3 colour channels, the four fields fitted over the PLY,
``--init_scales_w_xyz_dist`` on), 21 iterations a frame of its 250 -> 1 000;
``dataset_builders smooth_visual`` on stage 3's checkpoints, then
``future_simulation`` (2 frames) from level one and again from the smoothed
level two; last the DataProcessing hand-offs on the card's host through
their CLIs (``convert`` original_to_zero123, zero123_cams,
zero123_to_cogvideox, cogvideox_to_original; ``dataset_builders``
simulation_to_cogvideox on stage 4's renders, cogvideox_dataset and
cogvideox_paths on the capture). The process must end with no jax, JAX
package, PIL or cv2 module loaded.

ScalarFlow (``run_scalar``): 6 seeded raw stacks of 5 cameras at 1 062 x
600 in ScalarFlow's (5, H, W) float layout (frame 0 a static background with
noise, frames 1-5 add the port's gray render of configs/scalar_dynamics.json's
seeded column) through ``dataset_builders scalar_flow_preprocess``'s CLI
(the nlmeans kernel, 5 launches a stack), the kernel held bit for bit
against ``denoise_plain`` at those frames, uniform noise, 0 / 255 halves and
16 x 12, 7 x 5 and 1 x 1, timed beside the plain version and OpenCV (in a
subprocess, where the machine has it); then a ScalarReal capture of the
no_bg frames (``colmap_frames/colmap_{20-24}``, the fake views 0134) through
``train_physical_particle --loader scalar_real`` (configs/scalar_dynamics.json:
gm_fluid, no background, gray; cut: frames 20-22, 10 + 2 x 5 fit iterations)
and ``future_simulation`` (configs/scalar_future_simulation.json, 3 of 60
future frames), every rasterizer launch at C = 1.

Video (``sample_video.main`` at its defaults): the CogVideoX-5B DiT and VAE on
seeded random weights, 49 frames at 480 x 720 (13 latents, 17 776 tokens),
hash text, batch-2 CFG, ``--num_steps`` cut from 50 to 4, the PNGs written
to a temporary folder; every forward on the Hopper flash-attention kernel
(TMA, wgmma; bf16 at head_dim 64), which is held against the plain version at
layer 0's inputs of the first step and at ragged shapes, and timed beside the
mma.sync kernel (which serves f32 and the other head_dims, held there too)
and the library call.

In the default run the video, video-training, refinement and text-data
phases cut the 5B DiT to SMOKE_DIT_LAYERS (6) of its 42 blocks, at its full
width and token counts, so every attention kernel sees the 5B shapes; the
single-phase commands (``refine``, ``text-data``) run all 42.

Video training (``train_video.train``, LoRA finetuning): the CogVideoX-5B DiT
(hidden 3 072, 48 heads of 64, text 226 x 4 096) at batch 2 on
one clip of 49 seeded 480 x 720 PNGs (13 x 60 x 90 latents, 17 776 tokens),
rank 128, per-block rematerialisation, a bf16 base, 3 clean prefix latents,
hash text; cut: 2 iterations (of 10 000), then 1 with ``--quant_base`` on 9
frames and one eval fork (2 sampler steps, no checkpoints written); weights drawn from
a seed, with the adaLN projections and lora_b drawn small and non-zero (the
JAX init zeroes them, and then attention never reaches the loss and the
backward kernels see a zero upstream gradient). Every backward on the
Hopper flash-attention backward kernel (one pass on wgmma, dQ summed in f32;
bf16 at head_dim 64), held against the plain backward at ragged shapes and
at layer 0's captured q, k, v and upstream gradient, and timed beside the
mma.sync pair (which serves f32 and the other head_dims: held at f32 through
the f32 kernels against an f32 and an f64 plain version, and in a small
card-vs-CPU training run) and the library's backward.

Refinement (``gen_refine_video.main --preset refine_smoke`` and
``gen_future_video.main --preset future_smoke``): the CogVideoX-5B DiT and
VAE on seeded weights, hash text, batch-2 CFG, the presets' windows at 480 x
720: one 65-frame window (17 latents, 23 176 tokens; prefix 9, frame_step
2, strength 0.5) over a seeded input folder of ``frame_%06d.png`` and a GT
folder of ``%03d.png`` at the capture's 960 x 544 (resampled by LANCZOS),
then one 73-frame window (19 latents, 25 876 tokens; strength 0.75) over a
seeded render folder and reconstruction frames; cut: ``--num_steps`` 8 and
6 (4 DiT steps a window at those strengths; the CLIs run 50),
``--num_windows`` 1 (of 3); both with ``--pack_video``. Row 14 held and
timed at each run's layer-0 inputs, and a small card-vs-CPU refinement of
two chained windows.

Novel view (``run_novel_view``, Zero123): a seeded capture of 3 frames x 5
cameras at 960 x 544 (the stages phase's cameras) through ``convert
original_to_zero123`` (512-px PNGs) and ``zero123_cams``; ``python -m
fluidnexus_torch train_novel_view`` at the full geometry (UNet 320 x (1, 2,
4, 4), CLIP ViT-L/14, KL-VAE 128, 256 px) on seeded weights with the EMA,
the iteration-5 checkpoints and TensorBoard grids (10 DDIM steps); cut:
batch 96 -> 8, iterations 52 000 -> 5; ``infer_novel_view`` from the
checkpoint for 1 frame (4 views, 10 DDIM steps of its 50, CFG 3.0);
``convert zero123_to_cogvideox`` on a view's frames; the UNet (batch 2, both
CFG halves), CLIP and the VAE on the card against the CPU, both held to a
float64 CPU run. ``python3 chip_smoke.py novel-view`` also probes the
training step at batch 96 and profiles a DDIM step and a training step. No
hand-written kernel is on this path: it adds no ``kernels`` entry and
prints the launch counts, all 0.

Text and data (``run_text_data``): the T5-XXL encoder at its full geometry
(24 blocks, d_model 4 096, 64 heads of 64, d_ff 10 240, gated-gelu, vocab
32 128, f32) on seeded weights, 2 prompts at 226 tokens through a WordLevel
tokenizer the script writes (the t5-v1_1-xxl files do not ship); its first
two blocks at full width card against CPU, then written as a Hugging Face
Flax directory (a msgpack writer of the script's own) that ``--t5_dir``
reads: ``sample_video`` at the 5B width (2 of 50 steps, 9 frames) and
``train_video`` at the 5B width (1 LoRA step each, batch 2, 9 frames) on an mp4
root and on webdataset tar shards that the script writes with OpenCV at 480
x 720, 49 frames at 8 fps; whether tensorstore (the orbax reader) imports.
No hand-written kernel is added: the DiT's attention kernels carry it.

Port and metrics (``run_port_eval``): seeded checkpoints in the reference's
layouts (a Zero123 Lightning ``.ckpt`` at the full geometry with the
upstream 4-channel input conv, a SAT ``{"module": ...}`` at the 5B width in
the raw SAT-lora2 layout at rank 128, a 3D-VAE under
``first_stage_model.``, the text-data phase's Flax T5 directory) through
``python -m fluidnexus_torch port ... --out_dir ... --quant_base``; cut: the
SAT DiT has 2 of its 42 layers (the 42-layer file is 21 GB; ``port-5b``
runs it through the CLI); ``infer_novel_view --ckpt`` on the saved Zero123
for one view of 10 DDIM steps (50 in the CLI). Then ``evaluate_adm`` on 10
000 + 10 000 seeded images at 256 px (the reference evaluator's block),
``--vgg16`` at 64 px (it raises on the reference's NHWC images, as in JAX),
FVD on 256 + 256 clips of 16 x 224 x 224 and the
perceptual similarity of 64 pairs at 256 px, each held card against CPU on
a few. Row 14 runs in the DiT's forward, at (1, 48, 258, 64).

Parallel (``run_parallel``, item 16; ``python3 chip_smoke.py parallel``
alone): two ranks on cuda:0 under gloo with a ``file://`` rendezvous (NCCL
refuses two ranks on one device) run ``sample_video --tp 2`` and ``--dp 2``
at the 5B width (48 heads, 24 a rank) with 2 of its 42 blocks, 2 sampler
steps, 9 frames and the training phase's non-zero init, one ``train_video
--tp 2`` LoRA step (9 frames), and one phase-C fit iteration at ``pipe.dp`` 2 from
the phase-C reconstruction (5 cameras padded to 6); this process runs each
on one rank and holds the ranks to it. The VAE's time-sharded encode and
decode run at n = 1 under a one-rank NCCL group: gloo's point-to-point
takes no CUDA tensor, so the halo ring cannot run on two ranks of one card.
Rows 14 and 15 at (2, 24, 17 776, 64) add their own ``kernels`` entries,
with the launches at 24 heads on rank 0.

The root tools and examples (``run_full_scale_cut``, ``run_orbit``,
``run_demo``, ``run_profile_raster``): the reference-scale reconstruction
tool at full width (960 x 544, 5 + 1 cameras, ~27 720 hidden particles,
32 x 32 tiles of 384, dup 3 x 3) with 2 of its 120 frames and 30 of its
1 000 + 1 000 fit iterations, its rasterizer kernels held at its tiles;
``render_orbit`` of a seeded 32 768-splat PLY, 12 frames at 960 x 544;
the fit-and-rollout demo in full; ``profile_raster`` at the bench
workload. Each checks its launches exactly. ``python3 chip_smoke.py
full-scale [FRAMES]`` runs the tool at the reference's counts, prints each
frame's fullest query cell and the queries past 128 in a cell, and fails
on any query drop. Rows 10 and 11 are held against their plain versions in
NaN-filled blocks and timed at phase C's first iteration, at a seeded pile
of 1 100 queries in one cell of h (and 600 over three cells) in its hidden
cloud and at ScalarReal's last frame (``splat_list_check``). None adds a
``kernels`` entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, same sheet
H100_BF16_TC_FLOPS = 989e12  # bf16 on the tensor cores, dense, same sheet
H100_EXP_PER_S = 3.9e12      # exponentials on the special-function units (FlashAttention-3 paper)
SEED = 0
FIT_ITERS = 30
TIMED_ITERS = 20
PROFILE_ITERS = 10
PROFILES = True               # profile_run on; the default run (main) sets it off


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


def kernel_device_ms(fn, kernel, iters=50, windows=10):
    """Mean device ms per launch of the kernels whose name holds ``kernel``,
    from calls of ``fn`` under torch.profiler, and the text "R of L" that
    says how many launches the profiler recorded of how many were made.
    Leaves out the wrapper's host work (checks, allocation, ctypes), which for
    a kernel of ~0.1 ms is as long as the kernel and would make an event
    timing of the calls measure the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the tracer drops records (49, 38 and at most 44 of 50 seen on H100s),
    # and each record it keeps is a whole launch: windows of ``iters`` calls
    # are traced until they hold at least ``iters`` records, and the mean is
    # taken over all of them
    times = []
    for w in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times += [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) >= iters:
            return sum(times) / 1e3 / len(times), f"{len(times)} of {w * iters}"
    _fail(f"the profiler recorded {len(times)} launches of {kernel} of the {windows * iters} "
          f"made in {windows} windows, fewer than {iters}")


def bound_ms(nbytes, flops, peak=H100_F32_FLOPS):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def smoke_scene(width=960, height=544, n_frames=3):
    """Five cameras per frame looking at the smoke column (x 0.326, z -0.3)
    from 2 units away, spread over 1.4 rad, like the five smoke views."""
    from fluidnexus_torch.data.cameras import Camera
    from fluidnexus_torch.data.readers import SceneInfo, nerf_pp_norm

    fovx = 0.7
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    cams = []
    for t in range(n_frames):
        for i, name in enumerate("20134"):
            ang = (i - 2) * 0.35
            ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                           [-np.sin(ang), 0, np.cos(ang)]])
            R = ry @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
            center = np.array([0.326, 0.15, -0.3]) + ry @ np.array([0.0, 0.0, 2.0])
            cams.append(Camera(uid=5 * t + i, R=R, T=-R.T @ center, fovx=fovx, fovy=fovy,
                               width=width, height=height, image_name=f"train0{name}",
                               time_idx=t))
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
    """Gray renders of a second seeded column (the port's own renderer),
    0.02 above the initial column at frame 0 and 0.01 higher each frame."""
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.sim.state import make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_visual_points
    from fluidnexus_torch.splat.render import render_particles_with_background, to_gray3

    m = cfg.model
    pts = create_visual_points(m, np.random.default_rng(SEED + 2))
    attrs = constant_visual_attrs(m.visual_capacity, 1, device=device)
    with torch.no_grad():
        for cam in scene.train_cameras:
            moved = pts + np.array([0.0, 0.02 + 0.01 * cam.time_idx, 0.0], np.float32)
            vis = make_visual_state(m.visual_capacity, moved, device=device)
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


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def fwd_outputs(packed_t, counts, tiles_x, tx, ty, box_skip=True):
    """composite_fwd with its outputs in NaN-filled blocks, so an element it
    leaves unwritten shows."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from tests.torch_helpers import leave_nan_blocks

    t, k, f = packed_t.shape
    p = tx * ty
    leave_nan_blocks(packed_t.device, (t, f - 7, p), (t, 1, p), (t, 1, p), (t, -(-k // tc.CKPT), p))
    return tc.composite_fwd(packed_t, counts, tiles_x, tx, ty, box_skip=box_skip)


def exact_skip_and_resweep(packed_t, counts, tiles_x, tx, ty, what):
    """The forward's two exact claims, bit for bit: its box skip changes no
    output (against the same kernel walking every live slot at every pixel:
    accum, final T, median and the checkpoints of the live windows), and the
    backward's re-sweep reaches, at the end of each live window, the T the
    forward saved at the next window's start, and its final T after the last.
    Returns the failures, each named with ``what``."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    outs = fwd_outputs(packed_t, counts, tiles_x, tx, ty)
    full = fwd_outputs(packed_t, counts, tiles_x, tx, ty, box_skip=False)
    k = packed_t.shape[1]
    nck = -(-k // tc.CKPT)
    nwin = (counts.long() + tc.CKPT - 1) // tc.CKPT
    live_win = torch.arange(nck, device=counts.device)[None, :] < nwin[:, None]  # (T, nck)
    changed = [name for name, a, b in zip(("accum", "final_t", "median"), outs[:3], full[:3])
               if not bits_equal(a, b)]
    if not bits_equal(outs[3][live_win], full[3][live_win]):
        changed.append("the checkpoints")
    _, ft, _, ckpt = outs
    gen = torch.Generator(device=packed_t.device).manual_seed(SEED)
    g = [torch.randn(a.shape, generator=gen, device=a.device) for a in outs[:2]]
    _, t_end = tc.composite_bwd(packed_t, counts, *g, ft, ckpt, tiles_x, tx, ty, resweep=True)
    last = torch.arange(nck, device=counts.device)[None, :] == nwin[:, None] - 1
    want = torch.where(last[..., None], ft, torch.cat([ckpt[:, 1:], ckpt[:, :1]], 1))
    resweep_ok = bits_equal(t_end[live_win], want[live_win])
    print(f"exact checks, {what}: the box skip changed {changed or 'no bit'} of the walk of every "
          f"slot; the backward's re-sweep T at {int(live_win.sum())} window ends "
          f"{'is' if resweep_ok else 'is NOT'} bit-identical to the forward's checkpoints and "
          f"final T")
    failures = [f"{what}: the box skip changed {changed}"] if changed else []
    if not resweep_ok:
        failures.append(f"{what}: the backward's re-sweep T differs from the forward's")
    return failures


# The compositing's cut-offs: a slot draws where power <= 0 and alpha >=
# 1/255, a pixel stops once T < 1e-4, and the median is the depth where T
# crosses 0.5. The kernel takes power by fma and alpha by CUDA's expf, the
# plain version by torch's separately rounded operations, so an alpha within
# an ulp or two of 1/255 may draw in one and not in the other (then accum
# and T part by ~alpha, 3.9e-3, and the backward at that pixel with them),
# and a T within rounding of 0.5 may cross at one slot in one and at the
# next in the other. The bands are ~10x the f32 error of each quantity: one
# rounding of power and expf for alpha (~1e-6 relative), T's product over a
# few hundred slots (~1e-6 absolute at 0.5, ~3e-5 relative at 1e-4).
NEAR_ALPHA, NEAR_POWER, NEAR_HALF, NEAR_STOP = 1e-5, 1e-5, 1e-5, 3e-4
# most pixels that may lie near a cut-off: the dense main-path tiles of the
# reconstruction (409 011 live slots, 115 tiles full at K 512) put 0.32 %
# there, most of them pixels whose T walks past 1e-4 in small steps
NEAR_SHARE = 1e-2


def near_cutoff_pixels(packed_t, counts, tiles_x, tx, ty, tiles=32):
    """{cut-off: (T, P) bool} of the pixels where, walked in f64, a live
    slot's alpha lies within NEAR_ALPHA (relative) of 1/255 ("alpha"), a
    drawing slot's power within NEAR_POWER of its terms' size from 0 (an
    exact 0 is no cut-off; "power"), or T before or after a drawing slot
    within NEAR_HALF of 0.5 ("half") or before one within NEAR_STOP
    (relative) of 1e-4 ("stop"): pixels that rounding may put on either side
    of a cut-off."""
    t, k, f = packed_t.shape
    p = tx * ty
    dev = packed_t.device
    pix = torch.arange(p, device=dev)
    out = {c: torch.zeros((t, p), dtype=torch.bool, device=dev)
           for c in ("alpha", "power", "half", "stop")}
    kmax = int(counts.max()) if t else 0
    for t0 in range(0, t, tiles):
        rows = packed_t[t0:t0 + tiles, :kmax].double()
        tid = torch.arange(t0, t0 + rows.shape[0], device=dev)
        px = (((tid % tiles_x) * tx)[:, None] + (pix % tx)[None]).double()[:, None]
        py = (((tid // tiles_x) * ty)[:, None] + (pix // tx)[None]).double()[:, None]
        dx, dy = rows[..., 0:1] - px, rows[..., 1:2] - py
        quad, cross = rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy, rows[..., 3:4] * dx * dy
        power = -0.5 * quad - cross
        alpha = torch.clamp(rows[..., 5:6] * torch.exp(power), max=0.99)
        live = (torch.arange(kmax, device=dev)[None] < counts[t0:t0 + tiles, None])[..., None]
        draw = live & (power <= 0) & (alpha >= 1 / 255)
        t_after = torch.cumprod(torch.where(draw, 1 - alpha, torch.ones_like(alpha)), 1)
        t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
        near = {"alpha": live & (power <= 0) & ((alpha * 255 - 1).abs() <= NEAR_ALPHA),
                "power": live & (alpha >= 1 / 255)
                & (power.abs() < NEAR_POWER * (0.5 * quad.abs() + cross.abs())),
                "half": draw & (((t_before - 0.5).abs() <= NEAR_HALF)
                                | ((t_after - 0.5).abs() <= NEAR_HALF)),
                "stop": draw & ((t_before * 1e4 - 1).abs() <= NEAR_STOP)}
        for c, m in near.items():
            out[c][t0:t0 + tiles] = m.any(1)
    return out


def check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc):
    """Each kernel against its plain version on the same inputs, the
    forward's outputs in NaN-filled blocks; the forward's skip and the
    backward's re-sweep bit for bit (``exact_skip_and_resweep``). Returns the
    per-kernel errors and the tensors the timing phase reuses."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    tx, ty = rc.tile_x, rc.tile_y
    gen = torch.Generator(device=packed_t.device).manual_seed(SEED)
    exact_failures = exact_skip_and_resweep(packed_t, counts, tiles_x, tx, ty,
                                            f"{packed_t.shape[0]} tiles of {tx} x {ty}")
    accum, ft, med, ckpt = fwd_outputs(packed_t, counts, tiles_x, tx, ty)
    pk = packed_t.clone().requires_grad_(True)
    acc_p, ft_p, med_p = tc.composite_plain(pk, counts, tiles_x, tx, ty, rc.chunk)
    torch.cuda.synchronize()
    # a pixel near a cut-off (``near_cutoff_pixels``) may take either side of
    # it: such pixels may part on at most 1e-5 of the pixels, and take no
    # upstream gradient in the backward's check; every other pixel is held
    # to 1e-4
    by_cut = near_cutoff_pixels(packed_t, counts, tiles_x, tx, ty)
    near = (by_cut["alpha"] | by_cut["power"] | by_cut["half"] | by_cut["stop"])[:, None, :]
    far = ~near
    fwd_err = {"accum": ((accum - acc_p).abs() * far).max().item(),
               "final_t": ((ft - ft_p).abs() * far).max().item(),
               "median": ((med - med_p).abs() * far).max().item()}
    off = (((accum - acc_p).abs() > 1e-4).any(1, keepdim=True) | ((ft - ft_p).abs() > 1e-4)
           | ((med - med_p).abs() > 1e-4))
    n_near, n_off = int(near.sum()), int(off.sum())
    cut_ok = n_near <= max(1, NEAR_SHARE * med.numel()) and n_off <= max(1, 1e-5 * med.numel())

    gacc = torch.randn(accum.shape, generator=gen, device=accum.device) * far
    gft = torch.randn(ft.shape, generator=gen, device=ft.device) * far
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
          f"{fwd_err['final_t']:.3e} median {fwd_err['median']:.3e} away from the cut-offs "
          f"[tol 1e-4]; {n_near} of {med.numel()} pixels near a cut-off (by cut-off "
          f"{ {c: int(m.sum()) for c, m in by_cut.items()} }) [tol {NEAR_SHARE:g} of them], "
          f"{n_off} of them part by more than 1e-4 [tol 1e-5 of the pixels]")
    fields = ["dx", "dy", "dca", "dcb", "dcc", "dop"] + [f"dcolor{i}" for i in range(len(g_scale) - 7)] \
        + ["ddepth"]
    print("kernel check: composite_bwd max|err| / max|g| per field [tol 1e-4 x max|g| of the field]: "
          + ", ".join(f"{n} {e:.3e} / {s:.3e}" for n, e, s in zip(fields, g_err, g_scale)))
    print(f"kernel check: combine_rows max|err| {comb_abs:.3e} rel {comb_rel:.3e} [tol 1e-5 rel]")
    failures = exact_failures + [k for k, v in fwd_err.items() if not v <= 1e-4]
    if not cut_ok:
        failures.append("pixels near a cut-off")
    failures += [f"composite_bwd {n}" for n, e, s in zip(fields, g_err, g_scale) if not e <= 1e-4 * s]
    if not comb_rel <= 1e-5:
        failures.append("combine_rows")
    if failures:
        _fail(f"kernels disagree with their plain versions: {failures}")
    return (dict(composite_fwd=max(fwd_err.values()), composite_bwd=bwd_err, combine_rows=comb_abs),
            dict(ft=ft, ckpt=ckpt, gacc=gacc, gft=gft, dpk=dpk))


def device_kernels(fn, calls=5):
    """Names of the kernels ``fn`` runs on the card, in order of first
    launch, from ``calls`` calls under the profiler (it drops records: a
    window with none is traced again, up to five times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return list(dict.fromkeys(names))
    return []


def device_ms_with_others(fn, kernel):
    """(device ms of ``kernel`` per call, records, device ms of the call's
    other kernels, their count)."""
    ms, rec = kernel_device_ms(fn, kernel)
    others = [nm for nm in device_kernels(fn) if kernel not in nm]
    return ms, rec, sum(kernel_device_ms(fn, nm)[0] for nm in others), len(others)


def device_total_ms(fn, iters=20):
    """Device ms per call of ``fn``, summed over every kernel it runs (the
    profiler's records; it may drop some, so this can read low), and the
    number of records kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in ev) / 1e3 / iters, len(ev)


def drawn_share(packed_t, counts, tiles_x, tile_x, tile_y, group=64):
    """Of the live (slot, pixel) pairs, the share a slot draws (alpha at
    least 1/255, power <= 0), and of the live (slot, group of ``group``
    consecutive pixels) pairs, the share where it draws on any pixel."""
    t, k, f = packed_t.shape
    p = tile_x * tile_y
    pix = torch.arange(p, device=packed_t.device)
    drawn = groups = 0
    for t0 in range(0, t, 64):
        rows = packed_t[t0:t0 + 64]
        tid = torch.arange(t0, t0 + rows.shape[0], device=rows.device)
        px = (((tid % tiles_x) * tile_x)[:, None] + (pix % tile_x)[None]).float()[:, None]
        py = (((tid // tiles_x) * tile_y)[:, None] + (pix // tile_x)[None]).float()[:, None]
        dx, dy = rows[..., 0:1] - px, rows[..., 1:2] - py
        power = -0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy) - rows[..., 3:4] * dx * dy
        a = torch.clamp(rows[..., 5:6] * torch.exp(power), max=0.99)
        live = (torch.arange(k, device=rows.device)[None] < counts[t0:t0 + 64, None])[..., None]
        ok = (power <= 0) & (a >= 1 / 255) & live
        drawn += int(ok.sum())
        groups += int(ok.reshape(*ok.shape[:2], p // group, group).any(-1).sum())
    live_slots = int(counts.sum())
    return drawn / (live_slots * p), groups / (live_slots * (p // group))


def count_distribution(counts, k):
    """Camera 0's tiles: how the live slots spread over them."""
    c = counts.long()
    return (f"camera 0 tile counts: max {int(c.max())}, median {int(c.median())}, mean "
            f"{float(c.float().mean()):.1f}, {int((c == k).sum())} of {c.numel()} tiles at K {k}, "
            f"{int((c > k // 2).sum())} above K/2, {int((c == 0).sum())} empty")


def time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved):
    """Kernel, plain version and (where one exists) library times at the main
    path's shapes, with the bound each is held to. The kernels and the
    library call are timed on the device (``kernel_device_ms``): an event
    timing of a wrapper call also holds its checks, allocation and ctypes
    call, which are as long as a kernel of ~0.1 ms. That event time is kept
    beside it as ``call_ms``."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    tx, ty = rc.tile_x, rc.tile_y
    t, k, f = packed_t.shape
    c, p = f - 7, tx * ty
    live_slots = int(counts.sum())
    out = {}

    # The bounds count the function's own inputs and outputs, over the live
    # slots only. The transmittance checkpoints are left out: they are this
    # design's way of carrying T from the forward to the backward.
    # each composite C entry launches the tile order first: its time counts in the row
    fwd = lambda: tc.composite_fwd(packed_t, counts, tiles_x, tx, ty)
    ms, rec, order_ms, n_other = device_ms_with_others(fwd, "composite_fwd_kernel")
    print(f"composite_fwd: composite_fwd_kernel {ms:.4f} ms on the card, the call's {n_other} other "
          f"kernel(s) {order_ms:.4f} ms")
    ms += order_ms
    plain = cuda_ms(lambda: tc.composite_plain(packed_t, counts, tiles_x, tx, ty, rc.chunk), iters=3)
    # bytes: live rows + counts read; accum, final T, median written.
    # operations per (live slot, pixel): dx, dy 2, power 9, exp 1, op*exp 1,
    # min 1, T update 2, weight 1, colour accumulate 2C
    nbytes = 4 * (live_slots * f + t) + 4 * t * p * (c + 2)
    out["composite_fwd"] = dict(ms=ms, recorded=rec, call_ms=cuda_ms(fwd, iters=20), plain_ms=plain,
                                library_ms=None,
                                bound=bound_ms(nbytes, live_slots * p * (17 + 2 * c)))

    bwd = lambda: tc.composite_bwd(packed_t, counts, saved["gacc"], saved["gft"], saved["ft"],
                                   saved["ckpt"], tiles_x, tx, ty)
    ms, rec, order_ms, n_other = device_ms_with_others(bwd, "composite_bwd_kernel")
    print(f"composite_bwd: composite_bwd_kernel {ms:.4f} ms on the card, the call's {n_other} other "
          f"kernel(s) {order_ms:.4f} ms")
    ms += order_ms
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
    out["composite_bwd"] = dict(ms=ms, recorded=rec, call_ms=cuda_ms(bwd, iters=20),
                                plain_ms=plain, library_ms=None,
                                bound=bound_ms(nbytes, live_slots * p * (46 + 4 * c)))

    dpk = saved["dpk"]
    comb = lambda: tc.combine_rows(dpk, tile_gauss, counts, n)
    ms, rec = kernel_device_ms(comb, "combine_kernel")
    plain = cuda_ms(lambda: tc.combine_plain(dpk, tile_gauss, counts, n), iters=20)

    # the yardstick: index_add_ on the live rows, compacted beforehand; the
    # compaction is timed apart and is not part of it
    def compact():
        live = (torch.arange(k, device=dpk.device)[None, :] < counts[:, None]).reshape(-1)
        return tile_gauss.reshape(-1)[live], dpk.reshape(-1, f)[live]

    compact_ms, compact_rec = device_total_ms(compact)
    gid_live, g_live = compact()
    acc = torch.zeros((n, f), device=dpk.device)
    lib = lambda: acc.index_add_(0, gid_live, g_live)
    names = device_kernels(lib)
    lib_kernel = next((nm for nm in names if "index" in nm.lower()), None)
    if lib_kernel is None:
        _fail(f"index_add_ ran no kernel named for indexing: {names}")
    library, lib_rec = kernel_device_ms(lib, lib_kernel)
    print(f"combine_rows yardstick: index_add_ runs {names}; its kernel {library:.4f} ms on the "
          f"card ({lib_rec} recorded), the compaction of the live rows before it "
          f"{compact_ms:.4f} ms on the card ({compact_rec} kernel records in 20 calls), not part "
          f"of the yardstick")
    # bytes: live gradient rows and their int64 ids, counts read; (N, F) written
    nbytes = live_slots * (4 * f + 8) + 4 * t + 4 * n * f
    out["combine_rows"] = dict(ms=ms, recorded=rec, call_ms=cuda_ms(comb, iters=20), plain_ms=plain,
                               library_ms=library, bound=bound_ms(nbytes, live_slots * f))
    cmp = "above" if ms > library else "at or below"
    print(f"combine_rows {ms:.4f} ms on the card is {cmp} index_add_'s {library:.4f} ms")
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


def profile_run(label, run, n, ms_unit):
    """``run()`` (``n`` units of work with their set-up) under torch.profiler:
    the card's busy share, and each ``fnx.*`` span's host ms and the device
    ms of the kernels launched inside it, per unit. Kernels launched from
    autograd's own thread show in the op table, not under a span. A
    measurement, not a check: it runs only with PROFILES (``python3
    chip_smoke.py profiles``), so the default run stays well inside its limit."""
    from torch.profiler import ProfilerActivity, profile

    if not PROFILES:
        return

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / n
    busy = device_busy_ms(prof) / n
    ka = prof.key_averages()
    dev_key = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    print(f"profile, {n} {label} with set-up: {wall:.3f} ms per unit under the profiler; the "
          f"card busy {busy:.3f} ms per unit ({100 * busy / wall:.1f} % of that); against the "
          f"unprofiled {ms_unit:.3f} ms per unit the card idles {100 * (1 - busy / ms_unit):.1f} %")
    print(f"span | host ms per unit | device ms per unit (kernels launched inside)")
    spans = [e for e in ka if e.key.startswith("fnx.")
             and e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(spans, key=lambda e: -e.cpu_time_total):
        print(f"{e.key} | {e.cpu_time_total / 1e3 / n:.3f} | "
              f"{getattr(e, dev_key) / 1e3 / n:.3f} | calls {e.count}")
    print(ka.table(sort_by="self_" + dev_key, row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


def main(profiles=False):
    """The default run; with ``profiles`` also the profiles of every phase
    and the Zero123 batch probe (``python3 chip_smoke.py profiles``)."""
    import time

    global PROFILES
    PROFILES = profiles

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False   # SSIM's blur products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    built = cuda_build.build(["rasterizer", "pbf", "splat", "attention", "attention_bwd",
                              "nlmeans"])
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.1f} s -> {info['path']}")
        print(info["log"].strip())

    seconds = {}
    t_run = time.perf_counter()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]} s")
        return out

    with tempfile.TemporaryDirectory(prefix="fnx_smoke_") as tmp:
        kernels = timed("A", run_phase_a, dev) + timed("B", run_phase_b, dev)
        phase_c_kernels, recon = timed("C", run_phase_c, dev, os.path.join(tmp, "recon"))
        kernels += phase_c_kernels + timed("future", run_future, dev, recon,
                                           os.path.join(tmp, "future"))
        kernels += timed("full_scale_cut", run_full_scale_cut, dev, os.path.join(tmp, "full_scale"))
        kernels += timed("orbit", run_orbit, dev, os.path.join(tmp, "orbit"))
        kernels += timed("demo", run_demo, dev)
        kernels += timed("profile_raster", run_profile_raster, dev,
                         os.path.join(tmp, "raster_profile"))
        kernels += timed("stages", run_stages, dev, os.path.join(tmp, "stages"))
        kernels += timed("scalar", run_scalar, dev, os.path.join(tmp, "scalar"))
        with dit_depth(SMOKE_DIT_LAYERS):
            kernels += timed("video", run_video, dev, os.path.join(tmp, "video"))
            kernels += timed("video_train", run_video_train, dev,
                             os.path.join(tmp, "video_train"))
            kernels += timed("refine", run_refine, dev, os.path.join(tmp, "refine"))
        kernels += timed("novel_view", run_novel_view, dev, os.path.join(tmp, "novel_view"),
                         probes=profiles)
        with dit_depth(SMOKE_DIT_LAYERS):
            kernels += timed("text_data", run_text_data, dev, os.path.join(tmp, "text_data"))
        kernels += timed("port_eval", run_port_eval, dev, os.path.join(tmp, "port_eval"),
                         t5_dir=os.path.join(tmp, "text_data", "t5_xxl_depth2"))
        kernels += timed("parallel", run_parallel, dev, os.path.join(tmp, "parallel"),
                         os.path.join(tmp, "recon"))
    print(f"phase seconds {seconds}")
    print(f"chip_smoke: the default run took {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def reset_all_launches():
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.ops import nlmeans_cuda as nc
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    tc.reset_launches()
    pc.reset_launches()
    sc.reset_launches()
    ac.reset_launches()
    nc.reset_launches()


def all_launches():
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.ops import nlmeans_cuda as nc
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    return {**tc.LAUNCHES, **pc.LAUNCHES, **sc.LAUNCHES, **ac.LAUNCHES, **nc.LAUNCHES}


def run_phase_a(dev):
    """Phase A: the rasterizer kernels against their plain versions, the
    fit on the card, its timing and profile, the kernel times. Returns the
    three kernels' entries of the ``kernels`` line."""
    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines.train_physical_particle import fit_first_frame, raster_config_from

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
    print(count_distribution(counts, rc.tile_capacity))
    print(f"rasterizer kernels (registers, shared bytes, threads, blocks per SM): "
          f"{tc.occupancy(packed_t.shape[2] - 7, rc.tile_x, rc.tile_y)}")
    errors, saved = check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc)
    other_tile_checks(cfg, scene, bg, dev)

    # ---- phase A on the card: the main path. A 2-iteration warm-up first, so
    # the timed runs below do not carry the process's one-time costs (lazy
    # kernel loading, library handles, the SSIM blur matrices)
    cfg.optim.iterations_per_time_first = 2
    fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
    cfg.optim.iterations_per_time_first = FIT_ITERS
    torch.cuda.synchronize()
    reset_all_launches()
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
    if launches["composite_bwd"] != FIT_ITERS or launches["combine_rows"] != FIT_ITERS:
        _fail(f"phase A launched {launches}, expected one composite_bwd and one combine_rows "
              f"a fit iteration")

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
    cfg.optim.iterations_per_time_first = PROFILE_ITERS
    profile_run("fit iterations", lambda: fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None,
                                                          device="cuda"), PROFILE_ITERS, ms_iter)

    tile_limit_checks(scene, bg)
    times, live_slots = time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved)
    return raster_entries(times, live_slots, errors, launches, FIT_ITERS)


def tile_limit_checks(scene, bg, iters=3):
    """Phase A on the card at tiles beside the main path's 16 x 16: ``iters``
    fit iterations each through ``fit_first_frame`` at 8 x 4 (32 pixels, no
    multiple of 64), 12 x 12 (144, no multiple of 32) and 64 x 32 (2 048, two
    chunks a tile), with finite losses and one ``composite_bwd`` launch an
    iteration; then ``train`` refuses a tile with no pixel (0 x 16) with
    ValueError before any work, launching nothing."""
    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.pipelines import train_physical_particle as tp

    cfg = load_config("configs/smoke_dynamics.json")
    cfg.seed = SEED
    cfg.optim.iterations_per_time_first = iters
    for tile in ((8, 4),) + OTHER_TILES:
        cfg.pipe.tile_x, cfg.pipe.tile_y = tile
        reset_all_launches()
        _, _, losses = tp.fit_first_frame(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
        launches = all_launches()
        print(f"phase A at {tile[0]} x {tile[1]} tiles, {iters} iterations: losses "
              f"{losses.tolist()}, launches composite_fwd {launches['composite_fwd']} "
              f"composite_bwd {launches['composite_bwd']}")
        if not (torch.isfinite(losses).all() and launches["composite_fwd"] >= iters
                and launches["composite_bwd"] == iters):
            _fail(f"phase A at {tile[0]} x {tile[1]} tiles did not run through both kernels to "
                  f"finite losses")
    cfg.pipe.tile_x, cfg.pipe.tile_y = 0, 16
    reset_all_launches()
    try:
        tp.train(cfg, scene, bg=bg, log=print, device="cuda")
        _fail("train took 0 x 16 tiles on the card")
    except ValueError as e:
        print(f"train with 0 x 16 tiles on the card: ValueError before any work: {e}")
    if any(all_launches().values()):
        _fail(f"train launched kernels before refusing its tile: {all_launches()}")


# tiles beside the main path's 16 x 16 at which camera 0's tiles are checked:
# no multiple of 32 pixels, and over 1 024 (two chunks a tile)
OTHER_TILES = ((12, 12), (64, 32))


def other_tile_checks(cfg, scene, bg, dev, timed=False):
    """The three rasterizer kernels against their plain versions at camera
    0's tiles of each size of OTHER_TILES (``check_kernels``), with the
    occupancy of the instantiations they take; with ``timed``, their times
    beside their plain versions', bounds and the library's
    (``time_kernels``)."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from

    saved_tile = cfg.pipe.tile_x, cfg.pipe.tile_y
    try:
        for tile in OTHER_TILES:
            cfg.pipe.tile_x, cfg.pipe.tile_y = tile
            rc = raster_config_from(cfg)
            packed_t, tile_gauss, counts, tiles_x, n = main_path_tiles(cfg, scene, bg, dev)
            print(f"camera 0 at {tile[0]} x {tile[1]} tiles: T {packed_t.shape[0]} K "
                  f"{packed_t.shape[1]} live slots {int(counts.sum())}, {tc.chunks(tile[0] * tile[1])} "
                  f"chunk(s) a tile; rasterizer kernels (registers, shared bytes, threads, blocks "
                  f"per SM): {tc.occupancy(packed_t.shape[2] - 7, *tile)}")
            errors, saved = check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc)
            if timed:
                times, live_slots = time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved)
                print(f"at {tile[0]} x {tile[1]} tiles:")
                raster_entries(times, live_slots, errors, {k: 0 for k in times}, 1)
    finally:
        cfg.pipe.tile_x, cfg.pipe.tile_y = saved_tile


RASTER_SOURCES = {"composite_fwd": "fluidnexus_tpu/ops/rasterizer_pallas.py:139",
                  "composite_bwd": "fluidnexus_tpu/ops/rasterizer_pallas.py:246",
                  "combine_rows": "fluidnexus_tpu/ops/rasterizer_pallas.py:368"}


def raster_entries(times, live_slots, errors, launches, iters):
    """Prints the rasterizer kernels' times and returns their entries of the
    ``kernels`` line (``launches`` from ``iters`` fit iterations)."""
    kernels = []
    for name, tm in times.items():
        b_ms, b_by = tm["bound"]
        lib = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
        print(f"{name}: {tm['ms']:.4f} ms on the card per launch (mean of the {tm['recorded']} "
              f"launches the profiler recorded; a wrapper call {tm['call_ms']:.4f} ms; plain "
              f"{tm['plain_ms']:.4f} ms, library {lib}, bound {b_ms:.5f} ms by {b_by}), "
              f"{launches[name] / iters:g} launches per fit iteration, {live_slots} live slots")
        kernels.append({"name": name, "route": "cuda", "source": "fluidnexus_torch/csrc/rasterizer.cu",
                        "replaces": RASTER_SOURCES[name], "launches": launches[name],
                        "max_abs_err": errors[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": tm["library_ms"]})
    return kernels


# --------------------------------- phase B ----------------------------------

PHASE_B_DELTA = 0.01          # tools/run_full_scale_recon.py's reference operating point
JAX_ALIVE_FIRST_TICK = 25179  # the JAX package on the CPU keeps these after remove_invalid
PROFILE_TICKS = 5
# f32 operations the pair passes need (a compare or an rsqrt counts as one).
# Every live candidate pair: 3 subtractions, 5 for d2 and the in-radius test.
# A pair in radius adds 12 for w, rsqrt, rlen and cg; then phase 1 adds 12
# for its sums, phase 2 (non-self pairs only) 14 and e_p - 1 multiplies for
# the s_corr power. Each live slot's epilogue: lambda 20 in phase 1, the
# scaled update 14 in phase 2.
CANDIDATE_OPS = 9
PHASE1_IN_RADIUS_OPS = 12 + 12
PHASE2_IN_RADIUS_OPS = 12 + 14
PHASE1_SLOT_OPS = 20
PHASE2_SLOT_OPS = 14
PBF_KERNELS = {"pbf_phase1": "phase1_kernel", "pbf_phase2": "phase2_kernel",  # CUDA kernel names
               "pbf_phase1_v2": "phase1_v2_kernel", "pbf_phase2_v2": "phase2_v2_kernel",
               "pbf_phase1_v1": "phase1_v1_kernel", "pbf_phase2_v1": "phase2_v1_kernel"}


def phase_b_config():
    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.pipelines.train_physical_particle import pbf_params_from_config

    cfg = load_config("configs/smoke_dynamics.json")
    cfg.seed = SEED
    print(f"phase B: init_hidden_delta {cfg.model.init_hidden_delta} -> {PHASE_B_DELTA}, the "
          f"reference operating point of tools/run_full_scale_recon.py (the default lattice "
          f"overflows the {cfg.model.hidden_capacity}-slot hidden capacity)")
    cfg.model.init_hidden_delta = PHASE_B_DELTA
    return cfg, pbf_params_from_config(cfg)


def first_tick_inputs(cfg, params, dev):
    """The first phase-B tick's pair-pass inputs, rebuilt with the port's own
    functions in ``stabilize_hidden``'s order: the pillar's state,
    remove_invalid, the stable guess with counts = solver_iterations, the
    dense grid and its planes."""
    from fluidnexus_torch.pipelines.train_physical_particle import tick_guess
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim.pbf import remove_invalid
    from fluidnexus_torch.sim.pbf_dense import tick_slots
    from fluidnexus_torch.sim.state import make_particle_state
    from fluidnexus_torch.splat.dynamics import create_hidden_points

    o, m = cfg.optim, cfg.model
    pts = create_hidden_points(m)
    state = make_particle_state(m.hidden_capacity, pts, init_velocity_y=o.init_hidden_velocity,
                                gravity_alpha_buoyancy=np.array([0, -9.8, 0]) * o.alpha,
                                device=dev)
    state = remove_invalid(state, params)
    alive = int(state.alive.sum())
    print(f"phase B first tick: {alive} of {len(pts)} hidden particles alive after remove_invalid "
          f"(the JAX package on the CPU keeps {JAX_ALIVE_FIRST_TICK})")
    if alive != JAX_ALIVE_FIRST_TICK:
        _fail(f"remove_invalid keeps {alive} particles, the JAX package {JAX_ALIVE_FIRST_TICK}")
    state = tick_guess(state, params, o.solver_iterations, use_wind=False, stable=True)
    grid, cnt, xyz, imass, counts, _ = tick_slots(state, params)
    c = grid.max_cells
    occupied = cnt[:c] > 0
    pairs = int((cnt[:c].long() * cnt[grid.nbr.long()].long().sum(1)).sum())
    lists = cnt[grid.nbr.long()].sum(1)[occupied].float()
    print(f"phase B first-tick grid: C {c} M {grid.capacity}, {int(occupied.sum())} occupied "
          f"cells, fullest {int(cnt.max())}, mean {float(cnt[:c][occupied].float().mean()):.2f}, "
          f"{int(grid.bmask.sum())} live slots, {pairs} live candidate pairs, overflow "
          f"{int(grid.overflow)}; a live row's neighbourhood list holds "
          f"{float(lists.mean()):.1f} live slots on average, at most {int(lists.max())}")
    row_stats(cnt, c, "phase B first-tick rows")
    return dict(nbr=grid.nbr, cnt=cnt, xyz=xyz, imass=imass, counts=counts,
                live=grid.bmask, k=pc.pair_consts(params), pairs=pairs,
                rows=int(occupied.sum()))


def check_pbf_kernels(inp):
    """Both PBF kernels against their plain versions on the first tick's
    inputs, live slots only, each with its outputs in NaN-filled blocks:
    phase 1 as ``held_phase1`` holds it, with nl's flips at d2 = h^2 allowed
    on at most 1e-5 of the live slots, and phase 2 (on the kernel's lambda
    and nc) as ``held_phase2`` holds it."""
    nbr, cnt, xyz, k, live = inp["nbr"], inp["cnt"], inp["xyz"], inp["k"], inp["live"]
    n_live = int(live.sum())
    e_p1, failures, (lam, _, nl, _, s_edges) = held_phase1(
        (nbr, cnt, *xyz, inp["imass"], k), live, "pbf kernel check", int(1e-5 * n_live))
    nc = (nl + inp["counts"]).contiguous()
    e_upd, failed, s_ns = held_phase2((nbr, cnt, *xyz, lam, nc, k), live, "pbf kernel check")
    failures += failed
    if failures:
        _fail(f"the PBF kernels disagree with their plain versions: {failures}")
    # the in-radius pair counts the bounds need: s_edges counts the pairs
    # with d2 <= h^2, self pairs included; s_ns the non-self ones
    return ({"pbf_phase1": e_p1, "pbf_phase2": e_upd},
            dict(lam=lam, nc=nc, in_radius1=int(s_edges), in_radius2=s_ns))


def _rel_held(what, name, a, b, failures):
    """A global sum at 1e-5 relative; prints a line, adds ``name`` to
    ``failures`` where it fails."""
    rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    print(f"{what}: {name} {float(a):.6e} against {float(b):.6e}, rel {rel:.3e} [tol 1e-5]"
          + ("" if rel <= 1e-5 else " FAILED"))
    if not rel <= 1e-5:
        failures.append(name)


def held_phase1(args, live, what, flips=0):
    """Phase 1 v3 at ``args`` (nbr, cnt, x, y, z, imass, k) with its outputs in
    NaN-filled blocks (so a slot left unwritten shows), against its plain
    version on the same inputs: lambda and pi_raw at 1e-4 of their own scale
    over the live slots, nl exact but on at most ``flips`` live slots (a pair
    at d2 = h^2), exactly 0 at dead slots, empty rows and row C, and the
    global sums s_p6 and s_edges at 1e-5 relative. Prints a line per output;
    returns (max|err| of lambda and pi_raw, the names of the outputs that
    failed, the kernel's outputs (lam, pi_raw, nl, s_p6, s_edges))."""
    from fluidnexus_torch.sim import pbf_cuda as pc
    from tests.torch_helpers import leave_nan_blocks

    x = args[2]
    want = pc.phase1_plain(*args)
    leave_nan_blocks(x.device, *(tuple(x.shape),) * 3)
    got = pc.phase1_slots(*args)
    torch.cuda.synchronize()
    worst, failures = 0.0, []
    for name, a, b in zip(("lambda", "pi_raw"), got, want):
        err = float((a - b)[live].abs().max())
        scale = float(b[live].abs().max())
        ok = err <= 1e-4 * scale
        print(f"{what}: phase1 {name} max|err| {err:.3e} / scale {scale:.3e} [tol 1e-4 x scale]"
              + ("" if ok else " FAILED"))
        worst = max(worst, err)
        if not ok:
            failures.append(f"phase1 {name}")
    n_flips = int((got[2] != want[2])[live].sum())
    print(f"{what}: phase1 nl differs on {n_flips} of {int(live.sum())} live slots [tol {flips}]")
    if n_flips > flips:
        failures.append("phase1 nl")
    dead_zero = all(bool((a[~live] == 0).all()) for a in got[:3])  # a NaN left unwritten is not 0
    print(f"{what}: phase1 dead slots, empty rows and row C 0: {dead_zero}"
          + ("" if dead_zero else " FAILED"))
    if not dead_zero:
        failures.append("phase1 dead slots")
    for name, a, b in zip(("s_p6", "s_edges"), got[3:], want[3:]):
        _rel_held(what, f"phase1 {name}", a, b, failures)
    return worst, failures, got


def held_phase2(args, live, what):
    """Phase 2 v3 at ``args`` (nbr, cnt, x, y, z, lam, nc, k) with its outputs
    in NaN-filled blocks (so a slot or a row's partial sums left unwritten
    show), against its plain version on the same inputs: each axis of the
    Jacobi update (new - old coordinates) at 1e-4 of its own scale over the
    live slots (the update is held, not the coordinate, whose scale ~h would
    hide it), dead slots, empty rows and row C keeping their coordinates bit
    for bit, and the global sums s_corr and s_ns at 1e-5 relative. Prints a
    line per output; returns (max|err| of the update, the names of the
    outputs that failed, the plain version's s_ns)."""
    from fluidnexus_torch.sim import pbf_cuda as pc
    from tests.torch_helpers import leave_nan_blocks

    xyz = args[2:5]
    *new_p, s_corr_p, s_ns_p = pc.phase2_plain(*args)
    leave_nan_blocks(xyz[0].device, *(tuple(x.shape) for x in xyz), (args[1].numel(), 2))
    *new, s_corr, s_ns = pc.phase2_slots(*args)
    torch.cuda.synchronize()
    worst, failures = 0.0, []
    for a, n, n_p, x in zip("xyz", new, new_p, xyz):
        err = float(((n - x) - (n_p - x))[live].abs().max())
        scale = float((n_p - x)[live].abs().max())
        kept = bool((n[~live] == x[~live]).all())  # a NaN left unwritten is a change
        ok = err <= 1e-4 * scale and kept
        print(f"{what}: phase2 update {a} max|err| {err:.3e} / scale {scale:.3e} [tol 1e-4 x "
              f"scale]; coordinate max|err| {float((n - n_p)[live].abs().max()):.3e} / scale "
              f"{float(n_p[live].abs().max()):.3e}; dead slots kept: {kept}"
              + ("" if ok else " FAILED"))
        worst = max(worst, err)
        if not ok:
            failures.append(f"phase2 {a}")
    for name, a, b in (("s_corr", s_corr, s_corr_p), ("s_ns", s_ns, s_ns_p)):
        _rel_held(what, f"phase2 {name}", a, b, failures)
    return worst, failures, int(s_ns_p)


def held_phase2_raw(name, args, live, what):
    """Phase 2 v2 (``name`` pbf_phase2_v2, ``args`` (nbr, cnt, x, y, z, lam,
    k)) or v1 (pbf_phase2_v1, (ncnt, xng, lng, x, y, z, lam, k)) through
    its C entry with dsum and the per-row partial sums in NaN-filled blocks,
    against its plain version on the same inputs: each axis of dsum at 1e-4
    of its own scale over the live slots and exactly 0 at dead slots, empty
    rows and row C; each row's partial s_corr at 1e-5 of the rows' largest,
    its s_ns exactly, and both 0 at empty rows; the wrapper's global sums at
    1e-5 relative. Prints a line per output; returns (max|err| of dsum, the
    names of the outputs that failed)."""
    from fluidnexus_torch.sim import pbf_cuda as pc
    from tests.torch_helpers import leave_nan_blocks, phase2_part, plain_row_partials

    v1 = name == "pbf_phase2_v1"
    label = "phase2 v1" if v1 else "phase2 v2"
    wrapper, plain = (pc.phase2_v1_slots, pc.phase2_v1_plain) if v1 else \
        (pc.phase2_v2_slots, pc.phase2_v2_plain)
    cnt, lam = pc._own_counts(args[0]) if v1 else args[1], args[-2]
    dsum_p, s_corr_p, s_ns_p = plain(*args)
    part_p = plain_row_partials(args[0], cnt, *args[-5:], gathered=args[:3] if v1 else None)
    leave_nan_blocks(lam.device, tuple(dsum_p.shape), (cnt.numel(), 2))
    dsum, part = phase2_part(pc, name, args)
    _, s_corr, s_ns = wrapper(*args)
    torch.cuda.synchronize()
    worst, failures = 0.0, []
    for a, axis in enumerate("xyz"):
        err = float((dsum[..., a] - dsum_p[..., a])[live].abs().max())
        scale = float(dsum_p[..., a][live].abs().max())
        dead_zero = bool((dsum[..., a][~live] == 0).all())  # a NaN left unwritten is not 0
        ok = err <= 1e-4 * scale and dead_zero
        print(f"{what}: {label} dsum {axis} max|err| {err:.3e} / scale {scale:.3e} [tol 1e-4 x "
              f"scale]; dead slots 0: {dead_zero}" + ("" if ok else " FAILED"))
        worst = max(worst, err)
        if not ok:
            failures.append(f"{label} dsum {axis}")
    e_corr = float((part[:, 0] - part_p[:, 0]).abs().max())
    s_corr_scale = float(part_p[:, 0].abs().max())
    ns_same = torch.equal(part[:, 1], part_p[:, 1])
    empty_zero = bool((part[cnt == 0] == 0).all())
    ok = e_corr <= 1e-5 * s_corr_scale and ns_same and empty_zero
    print(f"{what}: {label} per-row partials: s_corr max|err| {e_corr:.3e} / scale "
          f"{s_corr_scale:.3e} [tol 1e-5 x scale], s_ns exact {ns_same}, empty rows 0 "
          f"{empty_zero}" + ("" if ok else " FAILED"))
    if not ok:
        failures.append(f"{label} part")
    for nm, a, b in (("s_corr", s_corr, s_corr_p), ("s_ns", s_ns, s_ns_p)):
        _rel_held(what, f"{label} {nm}", a, b, failures)
    return worst, failures


def pbf_plain_saved(inp):
    """What phase 2 takes at the first tick's inputs, from the plain versions
    on the card (so no kernel of this checkout runs to make it): lambda, nc
    and the in-radius pair counts of ``check_pbf_kernels``, and the v1
    pre-gathers of the rows and of that lambda."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, xyz, k = inp["nbr"], inp["cnt"], inp["xyz"], inp["k"]
    lam, _, nl, _, s_edges = pc.phase1_plain(nbr, cnt, *xyz, inp["imass"], k)
    lam = lam.contiguous()
    nc = (nl + inp["counts"]).contiguous()
    s_ns = pc.phase2_plain(nbr, cnt, *xyz, lam, nc, k)[4]
    ncnt, xng = pc.gather_v1(nbr, cnt, *xyz)
    return dict(lam=lam, nc=nc, in_radius1=int(s_edges), in_radius2=int(s_ns), ncnt=ncnt,
                xng=xng, lng=pc.gather_lam_v1(nbr, lam))


def pbf_plans(inp, saved):
    """Phase B's pair kernels at the first tick's inputs: {name: (wrapper,
    plain version, arguments, bytes, operations)} for phases 1 and 2 (v3,
    rows 12 and 13)."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, xyz, k = inp["nbr"], inp["cnt"], inp["xyz"], inp["k"]
    n_live, rows, pairs = int(inp["live"].sum()), inp["rows"], inp["pairs"]
    in1, in2 = saved["in_radius1"], saved["in_radius2"]
    ops1 = pairs * CANDIDATE_OPS + in1 * PHASE1_IN_RADIUS_OPS + n_live * PHASE1_SLOT_OPS
    ops2 = pairs * CANDIDATE_OPS + in2 * (PHASE2_IN_RADIUS_OPS + max(k.int_pow, 1) - 1)
    print(f"pbf bounds: {pairs} live candidate pairs, {in1} in radius (self included), "
          f"{in2} non-self in radius; {ops1} and {ops2 + n_live * PHASE2_SLOT_OPS} f32 "
          f"operations")
    # bytes: the live slots of the input planes, cnt and the occupied rows of
    # nbr read once; the live slots of the output planes written once (phase 2
    # also writes its two per-row partial sums)
    table = 4 * (cnt.numel() + 27 * rows)
    lam, nc = saved["lam"], saved["nc"]
    return {"pbf_phase1": (pc.phase1_slots, pc.phase1_plain, (nbr, cnt, *xyz, inp["imass"], k),
                           table + 4 * n_live * (4 + 3), ops1),
            "pbf_phase2": (pc.phase2_slots, pc.phase2_plain, (nbr, cnt, *xyz, lam, nc, k),
                           table + 4 * n_live * (5 + 3) + 8 * rows,
                           ops2 + n_live * PHASE2_SLOT_OPS)}


def v2_v1_plans(inp, saved):
    """Phases 1 and 2 v2 and v1 (rows 6, 7, 4 and 5) at the inputs ``inp``
    (phase B's first tick, or the rigid rollout's first iteration) with
    ``saved``'s lambda, v1 pre-gathers and in-radius pair counts: {name:
    (wrapper, plain version, arguments, bytes, operations)}."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, xyz, k = inp["nbr"], inp["cnt"], inp["xyz"], inp["k"]
    lam, ncnt, xng, lng = saved["lam"], saved["ncnt"], saved["xng"], saved["lng"]
    n_live, rows, pairs = int(inp["live"].sum()), inp["rows"], inp["pairs"]
    in1, in2 = saved["in_radius1"], saved["in_radius2"]
    ops1 = pairs * CANDIDATE_OPS + in1 * PHASE1_IN_RADIUS_OPS + n_live * RAW_SLOT_OPS
    ops2 = (pairs * CANDIDATE_OPS + in2 * (PHASE2_IN_RADIUS_OPS + max(k.int_pow, 1) - 1)
            + n_live * RAW_SLOT_OPS)
    # bytes: the occupied rows' table read once (nbr and cnt for v2, the
    # gathered counts for v1), the live centre slots' planes read once, the
    # live slots' outputs written once; v1 also reads, of the occupied rows'
    # gathered blocks (27 x 3 x M coordinates, 27 x M lambdas), the live
    # entries, which is all its kernels touch
    table = 4 * 27 * rows
    table2 = table + 4 * cnt.numel()
    gathered_live = int(ncnt[cnt[:ncnt.shape[0]] > 0].sum())
    return {
        "pbf_phase1_v2": (pc.phase1_v2_slots, pc.phase1_v2_plain, (nbr, cnt, *xyz, k),
                          table2 + 4 * n_live * (3 + 6), ops1),
        "pbf_phase2_v2": (pc.phase2_v2_slots, pc.phase2_v2_plain, (nbr, cnt, *xyz, lam, k),
                          table2 + 4 * n_live * (4 + 3) + 8 * rows, ops2),
        "pbf_phase1_v1": (pc.phase1_v1_slots, pc.phase1_v1_plain, (ncnt, xng, *xyz, k),
                          table + 4 * 3 * gathered_live + 4 * n_live * (3 + 6), ops1),
        "pbf_phase2_v1": (pc.phase2_v1_slots, pc.phase2_v1_plain,
                          (ncnt, xng, lng, *xyz, lam, k),
                          table + 4 * 4 * gathered_live + 4 * n_live * (4 + 3) + 8 * rows, ops2),
    }


def row_stats(cnt, c, what):
    """Prints the live rows of a C-row grid (``cnt`` (C+1,)) as the row-group
    kernels deal them: occupied rows, live slots, the fullest row, the rows
    over 8, 16 and 24 live slots (a lane of 8 holds two centre slots past 8,
    three past 16; a pass of two slots a lane covers 16, of 16 lanes 32), the
    warps of four rows (8 lanes a row) holding a row over 8, and of two rows
    (16 lanes a row) holding one over 16, among the warps holding a live row."""
    rows = cnt[:c]
    occ = rows[rows > 0]
    over = ", ".join(f"{int((rows > t).sum())} over {t}" for t in (8, 16, 24))
    w4, w2 = rows[:c // 4 * 4].view(-1, 4), rows[:c // 2 * 2].view(-1, 2)
    print(f"{what}: {int(occ.numel())} occupied rows of {c}, {int(rows.sum())} live slots, "
          f"fullest {int(rows.max())}, mean {float(occ.float().mean()):.2f}; rows {over}; "
          f"warps of 4 rows holding a row over 8: {int((w4 > 8).any(1).sum())} of "
          f"{int((w4 > 0).any(1).sum())}; warps of 2 rows holding a row over 16: "
          f"{int((w2 > 16).any(1).sum())} of {int((w2 > 0).any(1).sum())}")


def time_pbf_kernels(inp, saved):
    """Each PBF kernel's device time, its launch floor (every count 0) and
    its plain version's time at the first tick's shapes, with its bound; the
    event-timed wrapper call (with its global sums) beside them. No single
    PyTorch call computes these pair sums, so there is no library time."""
    out = {}
    for name, (fn, plain, args, nbytes, ops) in pbf_plans(inp, saved).items():
        kernel = PBF_KERNELS[name]
        ms, recorded = kernel_device_ms(lambda: fn(*args), kernel)
        floor_args = launch_floors(name, args)["every count 0"]
        floor_ms, _ = kernel_device_ms(lambda: fn(*floor_args), kernel)
        call_ms = cuda_ms(lambda: fn(*args), iters=50)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3)
        out[name] = dict(ms=ms, recorded=recorded, floor_ms=floor_ms, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=None, bound=bound_ms(nbytes, ops))
    return out


def small_phase_b_check(dev):
    """Phase B at a small size through the kernels and through the plain CPU
    path: a 0.02-radius pillar, 2 ticks x 3 iterations, dense caps 512 x 32.
    The alive masks must be identical and the positions within 1e-4 scaled
    units."""
    import dataclasses

    from fluidnexus_torch.core.config import Config
    from fluidnexus_torch.pipelines.train_physical_particle import (
        pbf_params_from_config, stabilize_hidden,
    )

    cfg = Config()
    o, m = cfg.optim, cfg.model
    m.init_hidden_radius_max, m.init_hidden_y_min, m.init_hidden_y_max = 0.02, -0.1, 0.8
    m.hidden_capacity = 2048
    o.stable_iterations, o.solver_iterations = 2, 3
    o.min_neighbors, o.init_hidden_velocity, o.alpha = 1, 100.0, 0.0
    params = dataclasses.replace(pbf_params_from_config(cfg), dense_max_cells=512,
                                 dense_cell_capacity=32)
    s_cpu, _ = stabilize_hidden(cfg, params, log=lambda *a: None, device="cpu")
    s_dev, _ = stabilize_hidden(cfg, params, log=lambda *a: None, device=dev)
    same = bool((s_dev.alive.cpu() == s_cpu.alive).all())
    a = s_cpu.alive
    dx = float((s_dev.xyz.cpu() - s_cpu.xyz)[a].abs().max())
    print(f"small phase B, card vs plain CPU path: {int(a.sum())} alive, masks identical {same}, "
          f"max|dxyz| {dx:.3e} scaled units [tol 1e-4]")
    if not (same and dx <= 1e-4):
        _fail("phase B on the card disagrees with the plain CPU path")


def run_phase_b(dev):
    """Phase B: the main path (stabilize_hidden at the full width), its
    per-tick diagnostics and timing, both PBF kernels against their plain
    versions at the first tick's shapes, the small reference check, a
    profile of a few ticks and the kernel times. Returns the two kernels'
    entries of the ``kernels`` line."""
    import copy

    from fluidnexus_torch.pipelines.train_physical_particle import stabilize_hidden
    from fluidnexus_torch.sim import pbf_cuda as pc

    cfg, params = phase_b_config()
    o = cfg.optim
    ticks = o.stable_iterations
    print(f"phase B config: capacity {cfg.model.hidden_capacity}, h {params.h}, dense grid "
          f"{params.dense_max_cells} x {params.dense_cell_capacity}, {ticks} ticks x "
          f"{o.solver_iterations} Jacobi iterations, min_neighbors {params.min_neighbors}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(log):
        start.record()
        out = stabilize_hidden(cfg, params, log=log, device="cuda")
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    torch.cuda.synchronize()
    reset_all_launches()
    (state, diags), ms_first = run(print)
    launches = {k: pc.LAUNCHES[k] for k in ("pbf_phase1", "pbf_phase2")}
    for t, d in enumerate(diags, 1):
        print(f"tick {t}: overflow {int(d['overflow'].sum())} p_ratio {float(d['p_ratio'][-1]):.6f} "
              f"lambdas {float(d['lambdas'][-1]):.6f} neighbors {float(d['neighbors'][-1]):.4f}")
    n_alive = int(state.alive.sum())
    print(f"phase B: {n_alive} hidden particles alive after {ticks} ticks; launches {launches}")
    if not bool(torch.isfinite(state.xyz).all()):
        _fail("phase-B positions are not finite")
    if n_alive == 0:
        _fail("phase B left no hidden particle alive")
    want = ticks * o.solver_iterations
    if any(v != want for v in launches.values()):
        _fail(f"phase B launched the PBF kernels {launches} times, expected {want} each")

    totals = [ms_first] + [run(lambda *a: None)[1] for _ in range(2)]
    ms_tick = statistics.median(totals) / ticks
    print(f"phase B: {', '.join(f'{t:.1f}' for t in totals)} ms for {ticks} ticks with set-up; "
          f"{ms_tick:.3f} ms per tick (median of three)")

    inp = first_tick_inputs(cfg, params, dev)
    errors, saved = check_pbf_kernels(inp)
    small_phase_b_check(dev)
    cfg_prof = copy.deepcopy(cfg)
    cfg_prof.optim.stable_iterations = PROFILE_TICKS
    profile_run("phase-B ticks", lambda: stabilize_hidden(cfg_prof, params, log=lambda *a: None,
                                                          device="cuda"), PROFILE_TICKS, ms_tick)

    times = time_pbf_kernels(inp, saved)
    sources = {"pbf_phase1": "fluidnexus_tpu/sim/pbf_pallas.py:1071",
               "pbf_phase2": "fluidnexus_tpu/sim/pbf_pallas.py:1140"}
    kernels = []
    for name, tm in times.items():
        b_ms, b_by = tm["bound"]
        print(f"{name}: {tm['ms']:.4f} ms on the card per launch (mean of the {tm['recorded']} "
              f"launches the profiler recorded; launch floor, every count 0, "
              f"{tm['floor_ms']:.4f} ms; a wrapper call with its "
              f"global sums {tm['call_ms']:.4f} ms; plain {tm['plain_ms']:.4f} ms, library none, "
              f"bound {b_ms:.5f} ms by {b_by}), {launches[name] / ticks:g} launches per tick, "
              f"{inp['pairs']} live candidate pairs")
        kernels.append({"name": name, "route": "cuda", "source": "fluidnexus_torch/csrc/pbf.cu",
                        "replaces": sources[name], "launches": launches[name],
                        "max_abs_err": errors[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "floor_ms": tm["floor_ms"]})
    return kernels


# --------------------------------- phase C ----------------------------------

PHASE_C_ITERS = 30            # iterations_per_time_current and _max, cut from 1000
SHORT_FRAME_ITERS = 10
PROFILE_C_ITERS = 10
# f32 operations of the phase-C kernels beyond the 9 of every live candidate
# pair (csrc/pbf.cu, csrc/splat.cu): per pair in radius, the density 5 (t2,
# c6 t2^3, the sum), its adjoint 12 (t2, W', (g_i + g_s), 2, three
# multiply-adds), the splat forward 10 (t2, t2^3, ws, three multiply-adds)
# and its adjoint 24 (t2, W, W', the dot product less q, f W', six
# multiply-adds); and 3 per live source slot for the adjoint's factor 2
DENSITY_IN_RADIUS_OPS = 5
DENSITY_BWD_IN_RADIUS_OPS = 12
SPLAT_FWD_IN_RADIUS_OPS = 10
SPLAT_BWD_IN_RADIUS_OPS = 24
SPLAT_BWD_SLOT_OPS = 3
PHASE_C_KERNELS = {  # name: (source, replaces, CUDA kernel name)
    "density_fwd": ("fluidnexus_torch/csrc/pbf.cu", "fluidnexus_tpu/sim/pbf_pallas.py:626",
                    "density_kernel"),
    "density_bwd": ("fluidnexus_torch/csrc/pbf.cu", "fluidnexus_tpu/sim/pbf_pallas.py:664",
                    "density_bwd_kernel"),
    "splat_fwd": ("fluidnexus_torch/csrc/splat.cu", "fluidnexus_tpu/sim/pbf_pallas.py:800",
                  "splat_fwd_kernel"),
    "splat_bwd": ("fluidnexus_torch/csrc/splat.cu", "fluidnexus_tpu/sim/pbf_pallas.py:853",
                  "splat_bwd_kernel"),
}


def phase_c_config():
    from fluidnexus_torch.core.config import load_config

    cfg = load_config("configs/smoke_dynamics.json")
    cfg.seed = SEED
    cfg.optim.iterations_per_time_first = FIT_ITERS
    cfg.model.init_hidden_delta = PHASE_B_DELTA
    cfg.optim.iterations_per_time_current = PHASE_C_ITERS
    cfg.optim.iterations_per_time_current_max = PHASE_C_ITERS
    return cfg


def phase_c_start(cfg, scene, bg, dev, params=None, log=lambda *a: None):
    """What phase C starts from, made as ``train`` makes it (phases A and B
    from one generator), and what a frame needs."""
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.splat.dynamics import EmitterPoints

    params = params or tp.pbf_params_from_config(cfg)
    rng = np.random.default_rng(cfg.seed)
    visual, attrs, _ = tp.fit_first_frame(cfg, scene, bg=bg, log=log, device=dev, rng=rng)
    state, _ = tp.stabilize_hidden(cfg, params, log=log, device=dev)
    emitters = EmitterPoints.from_config(cfg.model)
    cam0 = scene.train_cameras[0]
    step = tp.make_current_frame_step(bg, tp.raster_config_from(cfg), cam0.width, cam0.height,
                                      params, cfg.optim, 3)
    return dict(cfg=cfg, scene=scene, bg=bg, dev=dev, params=params, rng=rng, state=state,
                visual=visual, attrs=attrs, emitters=emitters,
                caps=tp.emission_caps(cfg, emitters), step=step)


def run_frame_1(ctx, iters):
    """Frame 1 of phase C from the saved start, as ``_phase_c`` runs it:
    simulate, ``iters`` fit iterations, commit. Returns (state, visual,
    losses, emitted)."""
    import copy

    from fluidnexus_torch.data.scene import cameras_by_time
    from fluidnexus_torch.pipelines import train_physical_particle as tp

    cfg, params, dev = ctx["cfg"], ctx["params"], ctx["dev"]
    rng = copy.deepcopy(ctx["rng"])
    state, visual, _, emitted = tp.simulate_frame(cfg, params, 1, ctx["state"], ctx["visual"],
                                                  ctx["emitters"], ctx["caps"], rng,
                                                  log=lambda *a: None)
    cams = cameras_by_time(ctx["scene"].train_cameras)[1]
    nn, losses = tp.fit_frame(cfg, params, ctx["step"], state, visual, ctx["attrs"], cams, iters,
                              ctx["scene"].nerf_normalization["radius"], rng, dev)
    state, visual, _ = tp.commit_frame(params, state, visual, nn)
    return state, visual, losses, emitted


def first_iteration_inputs(ctx):
    """Frame 1's state after its simulation, the two grids of its first fit
    iteration, and the four phase-C kernels' arguments as that iteration
    passes them, recorded from one step."""
    import copy

    from fluidnexus_torch.data.scene import cameras_by_time
    from fluidnexus_torch.ops.neighbors import build_dense_grid, sort_queries
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    cfg, params, dev = ctx["cfg"], ctx["params"], ctx["dev"]
    state, visual, _, emitted = tp.simulate_frame(cfg, params, 1, ctx["state"], ctx["visual"],
                                                  ctx["emitters"], ctx["caps"],
                                                  copy.deepcopy(ctx["rng"]), log=print)
    nn = state.estimate_xyz / params.scale_factor
    C, M = params.dense_max_cells, params.dense_cell_capacity
    grid = build_dense_grid(nn * params.scale_factor, params.h, state.alive, C, M)
    ql = sort_queries(grid, params.h, visual.xyz, visual.alive, C)
    print(f"phase C frame 1: {int(state.alive.sum())} hidden and {int(visual.alive.sum())} visual "
          f"particles alive after its simulation; emitted {emitted[0]} hidden and {emitted[1]} "
          f"visual candidates")
    cnt = grid.bmask.sum(-1)
    print(f"phase C first iteration, hidden grid: C {grid.max_cells} M {grid.capacity}, "
          f"{int((cnt > 0).sum())} occupied cells, fullest {int(cnt.max())}, "
          f"{int(grid.bmask.sum())} of {int(state.alive.sum())} points binned, overflow "
          f"{int(grid.overflow)}")
    print(f"phase C first iteration, visual query list: C {ql.max_cells}, "
          f"{int((ql.cnt > 0).sum())} occupied cells, fullest {int(ql.cnt.max())}, "
          f"{int(ql.start[-1])} of {int(visual.alive.sum())} queries listed; {int(ql.overflow)} "
          f"in cells past C dropped (they get delta 0)")

    rec = {name: [] for name in PHASE_C_KERNELS}
    hooks = ((pc, "density", "density_fwd"), (pc, "density_bwd", "density_bwd"),
             (sc, "splat_fwd", "splat_fwd"), (sc, "splat_bwd", "splat_bwd"))
    originals = [(mod, fn, getattr(mod, fn)) for mod, fn, _ in hooks]
    for (mod, fn, orig), (_, _, key) in zip(originals, hooks):
        def record(*a, _orig=orig, _key=key):
            rec[_key].append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
            return _orig(*a)
        setattr(mod, fn, record)
    try:
        cams = cameras_by_time(ctx["scene"].train_cameras)[1][:1]
        views, projs, fovs = tp._cam_tensors(cams, dev)
        one = torch.ones((1,), device=dev)
        ctx["step"](nn, tp.adam_init({"nn": nn}), state, visual, ctx["attrs"], (views, projs, fovs),
                    tp._gts(cams, 3, dev), 1e-4, one, one[0])
    finally:
        for mod, fn, orig in originals:
            setattr(mod, fn, orig)
    torch.cuda.synchronize()
    # the gas loss's density runs on the shared hidden grid; its adjoint is
    # the one whose table is that grid's
    fwd = rec["density_fwd"][0]
    bwd = next(a for a in rec["density_bwd"] if torch.equal(a[0], fwd[0]))
    return dict(density_fwd=fwd, density_bwd=bwd, splat_fwd=rec["splat_fwd"][0],
                splat_bwd=rec["splat_bwd"][0], state=state, visual=visual,
                calls={k: len(v) for k, v in rec.items()})


def phase_c_calls():
    """Per phase-C kernel, and phases 1 v2 and v1 (held at phase B's first
    tick in ``pairs``): (wrapper, plain version, its per-slot output
    fields)."""
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    return {"density_fwd": (pc.density_slots, pc.density_plain, ("pi",)),
            "density_bwd": (pc.density_bwd_slots, pc.density_bwd_plain, ("dpi/dx",)),
            "splat_fwd": (sc.splat_fwd_slots, sc.splat_fwd_plain, ("wv", "ws")),
            "splat_bwd": (sc.splat_bwd_slots, sc.splat_bwd_plain, ("g_est", "g_vel")),
            "pbf_phase1_v2": (pc.phase1_v2_slots, pc.phase1_v2_plain,
                              ("pi_raw", "sg", "c2d2", "nlen")),
            "pbf_phase1_v1": (pc.phase1_v1_slots, pc.phase1_v1_plain,
                              ("pi_raw", "sg", "c2d2", "nlen"))}


def held_in_nan_blocks(name, args, what):
    """Pair kernel ``name`` (of ``phase_c_calls``) at ``args`` with its outputs
    in NaN-filled blocks (so a slot it leaves unwritten shows), against its
    plain version on the same inputs: each output field at 1e-4 of its own
    scale over the live centre slots (the count at args[1], the planes' width
    at args[2]; for phase 1 v1 its gathered counts' own, ncnt[:, 13], and
    args[2]), and exactly 0 at dead slots; for the splat forward each column
    of its (Nq+1, 4) output over the listed queries (qstart and qcnt at
    args[1:3]) and exactly 0 at entry Nq (it writes no entry past the rows).
    Prints a line per field; returns (max|err|, the names of the fields that
    failed)."""
    from fluidnexus_torch.sim import pbf_cuda as pc
    from tests.torch_helpers import leave_nan_blocks, listed_mask

    wrapper, plain, fields = phase_c_calls()[name]
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    leave_nan_blocks(args[2].device, *(tuple(w.shape) for w in want))
    got = wrapper(*args)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    if name == "splat_fwd":
        listed = listed_mask(args[1], args[2], args[3].shape[0])
        last = torch.zeros_like(listed)
        last[-1] = True
        got, want = (got[0][:, :3], got[0][:, 3]), (want[0][:, :3], want[0][:, 3])
        masks = [(listed[:, None].expand(-1, 3), last[:, None].expand(-1, 3)), (listed, last)]
    else:
        cnt = pc._own_counts(args[0]) if name == "pbf_phase1_v1" else args[1]
        live = pc._live(cnt, args[2].shape[1])
        masks = [(lv, ~lv) for lv in (live if g.dim() == 2 else live[..., None].expand_as(g)
                                      for _, g in zip(fields, got))]
    worst, failures = 0.0, []
    for field, g, w, (lv, dead) in zip(fields, got, want, masks):
        err = float((g - w)[lv].abs().max())
        scale = float(w[lv].abs().max())
        dead_zero = not bool(g[dead].any())
        ok = err <= 1e-4 * scale and scale > 0 and dead_zero
        print(f"{what}: {name} {field} max|err| {err:.3e} / scale {scale:.3e} [tol 1e-4 x scale], "
              f"dead slots 0: {dead_zero}" + ("" if ok else " FAILED"))
        worst = max(worst, err)
        if not ok:
            failures.append(f"{name} {field}")
    return worst, failures


def check_phase_c_kernels(inp):
    """The four phase-C kernels against their plain versions at the first
    fit iteration's inputs, each output written into NaN-filled blocks: pi,
    the density gradient, wv, ws, g_est and g_vel each at 1e-4 of its own
    scale over live slots, 0 at dead slots. Returns the max abs error per
    kernel."""
    errors, failures = {}, []
    for name in PHASE_C_KERNELS:
        errors[name], failed = held_in_nan_blocks(name, inp[name], "phase C kernel check")
        failures += failed
    if failures:
        _fail(f"the phase-C kernels disagree with their plain versions: {failures}")
    return errors


def launch_floors(name, args):
    """The launch floors of pair kernel ``name`` (phase C's, or phase B's
    ``pbf_*``) at ``args``: the same launch with every count 0 (for v1 the
    gathered counts too) and, for the splat forward, with every source count
    0 and the queries live, for the splat adjoint with every query count 0
    and the sources live (most of its source rows have no query in reach on
    the main path). {label: arguments}."""
    zero = torch.zeros_like
    if name in ("pbf_phase1_v1", "pbf_phase2_v1"):  # a row's count is its copy's
        return {"every count 0": (zero(args[0]),) + tuple(args[1:])}
    if name == "splat_fwd":  # (qnbr, qstart, qcnt, xq, yq, zq, scnt, ...)
        return {"every count 0": tuple(args[:2]) + (zero(args[2]),) + tuple(args[3:6])
                + (zero(args[6]),) + tuple(args[7:]),
                "every source count 0": tuple(args[:6]) + (zero(args[6]),) + tuple(args[7:])}
    if name != "splat_bwd":
        return {"every count 0": (args[0], zero(args[1])) + tuple(args[2:])}
    # (rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, ...)
    return {"every count 0": (args[0], zero(args[1])) + tuple(args[2:7]) + (zero(args[7]),)
            + tuple(args[8:]),
            "every query count 0": tuple(args[:7]) + (zero(args[7]),) + tuple(args[8:])}


def _candidates(nbr, cnt_c, cnt_n):
    """Live candidate pairs of a pair walk: each live centre slot against
    every live slot of its 27 neighbour rows."""
    rows = nbr.shape[0]
    return int((cnt_c[:rows].long() * cnt_n[nbr.long()].long().sum(1)).sum())


def density_counts(d):
    """What the gas-loss density's pair walk does at its arguments ``d``
    (nbr, cnt, x, y, z, k): occupied rows, live slots, live candidate pairs,
    pairs in radius (self included), and the bytes of its table (cnt and the
    occupied rows' 27 neighbours)."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, k = d[0], d[1], d[5]
    rows = int((cnt[:-1] > 0).sum())
    return dict(rows=rows, n_src=int(cnt.sum()), cand=_candidates(nbr, cnt, cnt),
                in_radius=int(pc.phase1_plain(nbr, cnt, *d[2:5], torch.ones_like(d[2]), k)[4]),
                table=4 * (cnt.numel() + 27 * rows))


def density_bwd_work(dc):
    """(bytes, operations) of the density's adjoint: the table, four planes
    read and three written at the live slots; 9 operations a live candidate
    pair and DENSITY_BWD_IN_RADIUS_OPS more a pair in radius."""
    return (dc["table"] + 4 * dc["n_src"] * 7,
            9 * dc["cand"] + DENSITY_BWD_IN_RADIUS_OPS * dc["in_radius"])


def splat_bwd_reach(s):
    """The splat adjoint's work at its arguments ``s``: the live source rows
    that have a query in reach, the sources they hold, and their query
    lists' lengths (tensor)."""
    rnbr, scnt, qcnt = s[0].long(), s[1], s[7]
    lists = qcnt[rnbr].sum(1)
    active = (scnt[:-1] > 0) & (lists > 0)
    return int(active.sum()), int(scnt[:-1][active].sum()), lists[active].float()


def splat_work(f, s):
    """(bytes, operations) of the splat forward at its arguments ``f`` and of
    its adjoint at ``s``, with the counts they are made of (printed by the
    callers). The forward reads the query list (start and cnt whole, 3 floats
    of each listed query), the 27 source rows of each occupied query row and
    only the source rows that those reach, and writes 4 floats a listed query
    and entry Nq; the adjoint reads the source rows that have a query in
    reach (6 floats a source), the 27 query rows of each occupied source row
    and the queries of the query rows those reach (their start and cnt, 7
    floats a query), and writes 6 floats a live source. 9 operations a live
    candidate pair, SPLAT_FWD_IN_RADIUS_OPS / SPLAT_BWD_IN_RADIUS_OPS more a
    pair in radius."""
    from fluidnexus_torch.sim import splat_cuda as sc

    qnbr, qstart, qcnt, scnt, h = f[0], f[1], f[2], f[6], f[11]
    rnbr, cs, cq = s[0].long(), scnt.numel() - 1, qcnt.numel() - 1
    n_src, n_q = int(scnt.sum()), int(qcnt.sum())
    cand = _candidates(qnbr, qcnt, scnt)
    ent, row_of = sc.listed_entries(qstart, qcnt, torch.arange(cq, device=qcnt.device))
    one = torch.ones(len(ent) + 1, dtype=qcnt.dtype, device=qcnt.device)
    in_radius = sum(int(inside.sum()) for _, inside, _, _ in sc._two_set(
        qnbr[row_of], one, (f[3][ent, None], f[4][ent, None], f[5][ent, None]), scnt, f[7:10], h,
        1, int(scnt.max())))
    src_rows = torch.unique(qnbr[qcnt[:-1] > 0].long())
    src_rows = src_rows[src_rows < cs]
    n_src_reached = int(scnt[src_rows].sum())
    q_rows = torch.unique(rnbr[scnt[:-1] > 0])
    q_rows = q_rows[q_rows < cq]
    n_q_reached = int(qcnt[q_rows].sum())
    n_src_active = splat_bwd_reach(s)[1]
    qrows, srows = int((qcnt[:-1] > 0).sum()), int((scnt[:-1] > 0).sum())
    counts = dict(cand=cand, in_radius=in_radius, n_src=n_src, n_q=n_q, src_rows=len(src_rows),
                  n_src_reached=n_src_reached, n_src_active=n_src_active, q_rows=len(q_rows),
                  n_q_reached=n_q_reached)
    fwd = (4 * (2 * (cq + 1) + 27 * qrows + len(src_rows)) + 4 * (n_q * 7 + n_src_reached * 6)
           + 16, 9 * cand + SPLAT_FWD_IN_RADIUS_OPS * in_radius)
    bwd = (4 * (cs + 1 + 27 * srows + 2 * len(q_rows))
           + 4 * (n_src_active * 6 + n_q_reached * 7 + n_src * 6),
           9 * cand + SPLAT_BWD_IN_RADIUS_OPS * in_radius + SPLAT_BWD_SLOT_OPS * n_src)
    return fwd, bwd, counts


def phase_c_plans(inp):
    """Each phase-C kernel's wrapper, plain version, arguments, bytes and
    operations at the first fit iteration's inputs (the counts the bounds
    are made of, printed)."""
    d = inp["density_fwd"]
    dc = density_counts(d)
    fwd, bwd, c = splat_work(inp["splat_fwd"], inp["splat_bwd"])
    print(f"phase C bounds: density {dc['cand']} live candidate pairs, {dc['in_radius']} in "
          f"radius (self included); splat {c['cand']} live candidate pairs, {c['in_radius']} in "
          f"radius; {c['n_src']} live source slots and {c['n_q']} listed queries; the forward "
          f"reaches {c['src_rows']} source rows holding {c['n_src_reached']} sources, the "
          f"adjoint {c['n_src_active']} sources with a query in reach and {c['q_rows']} query "
          f"rows holding {c['n_q_reached']} queries")
    calls = phase_c_calls()
    work = {
        "density_fwd": (dc["table"] + 4 * dc["n_src"] * 4,
                        9 * dc["cand"] + DENSITY_IN_RADIUS_OPS * dc["in_radius"]),
        "density_bwd": density_bwd_work(dc),
        "splat_fwd": fwd,
        "splat_bwd": bwd,
    }
    return {name: (calls[name][0], calls[name][1], inp[name], *work[name]) for name in work}


# the kernels of a phase-C C entry that launches more than its own: the
# forward's entry runs its chunk scan just before it
ENTRY_KERNELS = {"splat_fwd": ("chunk_ends_kernel", "splat_fwd_kernel")}


def entry_device_ms(fn, name):
    """Device ms per call ``fn`` of phase-C function ``name``: the means per
    launch of the kernels its C entry launches (``ENTRY_KERNELS``, else its
    own alone), summed; and the text of each mean with its records."""
    kernels = ENTRY_KERNELS.get(name, (PHASE_C_KERNELS[name][2],))
    times = [kernel_device_ms(fn, k) for k in kernels]
    return sum(t for t, _ in times), "; ".join(
        f"{k} {t:.4f} ms, {rec} launches recorded" for k, (t, rec) in zip(kernels, times))


def time_phase_c_kernels(inp):
    """Each phase-C kernel's device time a call (``entry_device_ms``), its
    launch floor (every count 0), its plain version's time and its bound at
    the first fit iteration's inputs. No single PyTorch call computes these
    pair sums, so there is no library time."""
    out = {}
    for name, (fn, plain, args, nbytes, ops) in phase_c_plans(inp).items():
        ms, recorded = entry_device_ms(lambda: fn(*args), name)
        floor_args = launch_floors(name, args)["every count 0"]
        floor_ms, _ = entry_device_ms(lambda: fn(*floor_args), name)
        call_ms = cuda_ms(lambda: fn(*args), iters=50)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3)
        out[name] = dict(ms=ms, recorded=recorded, floor_ms=floor_ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound=bound_ms(nbytes, ops), nbytes=nbytes, ops=ops)
    return out


def small_phase_c_check(dev):
    """Phase C at a small size through the kernels and through the plain CPU
    path from one start: a 0.02-radius pillar, 200 visual particles, 160 x 96
    cameras, frames 1-2 x 3 fit iterations, dense caps 512 x 32. Per-frame
    losses agree to 1e-3 relative, alive masks exactly, positions within
    1e-4 scaled units."""
    import dataclasses

    from fluidnexus_torch.core.config import Config
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.sim.state import ParticleState, VisualState
    from fluidnexus_torch.splat.dynamics import VisualAttrs

    cfg = Config()
    o, m, p = cfg.optim, cfg.model, cfg.pipe
    m.hidden_capacity, m.visual_capacity = 2048, 1024
    m.init_hidden_radius_max, m.init_hidden_y_min, m.init_hidden_y_max = 0.02, 0.0, 0.4
    m.init_visual_num_pts, m.init_thick_visual_num_pts = 150, 50
    o.iterations_per_time_first, o.stable_iterations, o.solver_iterations = 2, 2, 3
    o.iterations_per_time_current = o.iterations_per_time_current_max = 3
    o.alpha, o.init_hidden_velocity, o.min_neighbors, o.batch = 0.0, 100.0, 1, 2
    o.emit_ratio_hidden = o.emit_ratio_visual = 1.0
    o.extra_visual_ratio = 0.05
    o.lambda_current_distance, o.lambda_exyz = 0.1, 0.1
    o.lambda_gas_constraints, o.lambda_next_gas_constraints = 1.0, 0.1
    p.tile_capacity, p.chunk = 128, 32
    params = dataclasses.replace(tp.pbf_params_from_config(cfg), dense_max_cells=512,
                                 dense_cell_capacity=32)
    cpu = torch.device("cpu")
    scene = smoke_scene(width=160, height=96)
    bg = {cpu: synthetic_background(2048, cpu), dev: synthetic_background(2048, dev)}
    render_ground_truth(cfg, scene, bg[cpu], cpu)
    start = phase_c_start(cfg, scene, bg[cpu], cpu, params=params)

    def run(device):
        import copy

        to = lambda tree, cls: cls(*(x.to(device) for x in tree))  # noqa: E731
        return tp._phase_c(cfg, scene, to(start["state"], ParticleState),
                           to(start["visual"], VisualState), to(start["attrs"], VisualAttrs),
                           bg[device], tp.raster_config_from(cfg), params,
                           copy.deepcopy(start["rng"]), None, lambda *a: None, None)

    r_cpu, r_dev = run(cpu), run(dev)
    l_cpu = np.array([mm["loss"] for mm in r_cpu["metrics"]])
    l_dev = np.array([mm["loss"] for mm in r_dev["metrics"]])
    dl = float(np.abs(l_dev - l_cpu).max() / np.abs(l_cpu).max())
    same = all(bool((r_dev[k].alive.cpu() == r_cpu[k].alive).all()) for k in ("state", "visual"))
    dx = {k: float((r_dev[k].xyz.cpu() - r_cpu[k].xyz)[r_cpu[k].alive].abs().max())
          for k in ("state", "visual")}
    print(f"small phase C, card vs plain CPU path: losses {l_cpu.tolist()} / {l_dev.tolist()}, "
          f"rel diff {dl:.3e} [tol 1e-3]; {int(r_cpu['state'].alive.sum())} hidden and "
          f"{int(r_cpu['visual'].alive.sum())} visual alive, masks identical {same}; max|dxyz| "
          f"hidden {dx['state']:.3e}, visual {dx['visual']:.3e} scaled units [tol 1e-4]")
    if not (dl <= 1e-3 and same and max(dx.values()) <= 1e-4):
        _fail("phase C on the card disagrees with the plain CPU path")


def run_phase_c(dev, model_path):
    """Phase C: the main path (``train``, phases A -> B -> C, at the smoke
    widths, its npy checkpoints under ``model_path``), its launch counts; the
    two grids and the four kernels against their plain versions at the first
    fit iteration; the small reference check; ms per fit iteration and per
    frame; a profile of 10 fit iterations; the kernel times. Returns the four
    kernels' entries of the ``kernels`` line and what the future stage
    starts from."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    cfg = phase_c_config()
    scene = smoke_scene()
    bg = synthetic_background(32768, dev)
    render_ground_truth(cfg, scene, bg, dev)
    o = cfg.optim
    n_frames = 2
    print(f"phase C config: frames 1-{n_frames} x {PHASE_C_ITERS} fit iterations, batch "
          f"{o.batch}, emit_ratio_visual {o.emit_ratio_visual}, extra_visual_ratio "
          f"{o.extra_visual_ratio}, emit_ratio_hidden {o.emit_ratio_hidden}, lambdas image "
          f"{o.lambda_image} current_distance {o.lambda_current_distance} exyz {o.lambda_exyz} "
          f"gas {o.lambda_gas_constraints} next_gas {o.lambda_next_gas_constraints}")

    # ---- the main path: train, A -> B -> C
    torch.cuda.synchronize()
    reset_all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cfg.model.model_path = model_path
    start.record()
    res = tp.train(cfg, scene, bg=bg, log=print, device="cuda")
    end.record()
    cfg.model.model_path = ""
    end.synchronize()
    launches = {**{k: v for k, v in pc.LAUNCHES.items()}, **sc.LAUNCHES, **tc.LAUNCHES}
    print(f"train A -> B -> C: {start.elapsed_time(end):.1f} ms; launches {launches}")
    metrics = res["metrics"]
    for mm in metrics:
        print(f"phase C frame {mm['frame']}: loss {mm['loss']:.6f} hidden {mm['hidden']} "
              f"visual {mm['visual']}, {mm['query_drops']} dropped by the splat's query list")
    if len(metrics) != n_frames or not all(np.isfinite(mm["loss"]) for mm in metrics):
        _fail("phase C did not give a finite loss for each frame")
    for name in ("state", "visual"):
        xyz = res[name].xyz
        if not bool(torch.isfinite(xyz).all()):
            _fail(f"phase-C {name} positions are not finite")
    fit_iters = n_frames * PHASE_C_ITERS
    want = {"density_fwd": 2 * fit_iters, "density_bwd": 2 * fit_iters,
            "splat_fwd": fit_iters + n_frames, "splat_bwd": fit_iters,
            "composite_bwd": FIT_ITERS + fit_iters, "combine_rows": FIT_ITERS + fit_iters}
    if any(launches[k] != v for k, v in want.items()):
        _fail(f"phase C launched the kernels {launches}, expected {want}")
    print(f"phase C launch counts as expected: {want} ({fit_iters} fit iterations, "
          f"{n_frames} commits; the rasterizer's backward also in phase A's {FIT_ITERS})")

    # ---- the first fit iteration's grids and kernel inputs
    ctx = phase_c_start(cfg, scene, bg, dev)
    inp = first_iteration_inputs(ctx)
    errors = check_phase_c_kernels(inp)
    from fluidnexus_torch.ops.neighbors import build_dense_grid

    params, st = ctx["params"], inp["state"]
    grid = build_dense_grid(st.estimate_xyz, params.h, st.alive, params.dense_max_cells,
                            params.dense_cell_capacity)
    vel = (st.estimate_xyz - st.xyz) / params.secs
    splat_list_check("phase C first iteration", grid, vel, inp["visual"].xyz,
                     inp["visual"].alive, params)
    pile = splat_list_check(f"a pile of {SPLAT_PILE} and {SPLAT_SPREAD} over three cells", grid,
                            vel, *pile_queries(st, inp["visual"], params), params)
    if pile["fullest"] < 1000 or pile["dropped"]:
        _fail(f"the pile check's fullest query row holds {pile['fullest']} (under 1 000) or it "
              f"dropped {pile['dropped']}")
    small_phase_c_check(dev)

    # ---- ms per fit iteration and per frame, from the same saved start
    def frame_ms(iters):
        start.record()
        run_frame_1(ctx, iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    frame_ms(2)   # warm-up
    long_ms, short_ms = [], []
    for _ in range(3):
        long_ms.append(frame_ms(PHASE_C_ITERS))
        short_ms.append(frame_ms(SHORT_FRAME_ITERS))
    ms_iter = (statistics.median(long_ms) - statistics.median(short_ms)) / (
        PHASE_C_ITERS - SHORT_FRAME_ITERS)
    print(f"phase C frame 1: {', '.join(f'{t:.1f}' for t in long_ms)} ms with "
          f"{PHASE_C_ITERS} fit iterations, {', '.join(f'{t:.1f}' for t in short_ms)} ms with "
          f"{SHORT_FRAME_ITERS}; {ms_iter:.3f} ms per phase-C fit iteration; "
          f"{statistics.median(long_ms):.3f} ms per phase-C frame at {PHASE_C_ITERS} iterations "
          f"with its solver tick (medians of three)")

    # ---- a profile of 10 fit iterations on frame 1's simulated state
    from fluidnexus_torch.data.scene import cameras_by_time

    cams = cameras_by_time(scene.train_cameras)[1]
    rng = np.random.default_rng(SEED)
    profile_run("phase-C fit iterations", lambda: tp.fit_frame(
        cfg, ctx["params"], ctx["step"], inp["state"], inp["visual"], ctx["attrs"], cams,
        PROFILE_C_ITERS, scene.nerf_normalization["radius"], rng, dev), PROFILE_C_ITERS, ms_iter)

    times = time_phase_c_kernels(inp)
    kernels = []
    for name, tm in times.items():
        b_ms, b_by = tm["bound"]
        source, replaces, _ = PHASE_C_KERNELS[name]
        print(f"{name}: {tm['ms']:.4f} ms on the card a call ({tm['recorded']}; "
              f"launch floor, every count 0, "
              f"{tm['floor_ms']:.4f} ms; a wrapper call {tm['call_ms']:.4f} ms; "
              f"plain {tm['plain_ms']:.4f} ms, library none, bound {b_ms:.5f} ms by {b_by}: "
              f"{tm['nbytes']} bytes, {tm['ops']} f32 operations), {launches[name]} launches in "
              f"{fit_iters} fit iterations and {n_frames} commits")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errors[name], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "floor_ms": tm["floor_ms"]})
    return kernels, dict(path=model_path, scene=scene, bg=bg)


# ---------------- the stages from disk (1 -> 2 -> 3 -> smoothing -> 4 -> hand-offs) ----------------

STAGE1_ITERS = 400            # of configs/smoke_background.json's 15 000
STAGE1_EVENTS = dict(densify_from_iter=100, densification_interval=100,
                     opacity_reset_interval=250, prune_large_interval=350)
# densify_grad_threshold, cut from 0.0002: the mean screen-space gradient
# densify compares with it is taken in pixels, and on this capture it stays
# near 1e-5 at most, so at 0.0002 no densify clones or splits. 0.0002 x 2 /
# 960 is that threshold in pixels of a 960-wide frame for a gradient taken in
# NDC units (x W / 2); with it every densify clones and splits at full width
STAGE1_GRAD_THRESHOLD = 0.0002 * 2 / 960
STAGE1_WINDOW = 20            # iterations a timing window holds
STAGE2_FIRST_ITERS = 10       # iterations_per_time_first, cut from 1000
STAGE2_ITERS = 5              # iterations_per_time_current and _max, cut from 1000
STAGE_FRAMES = 3              # the capture's frames 0-2 (duration, cut from 120 / 180)
STAGE4_FRAMES = 2             # future_pred_frames, cut from the README's 60
STAGE3_ITERS = 21             # iterations_per_time_current_level_two and _max, cut from 250 -> 1 000
STAGE3_WINDOW = 5             # iterations a stage-3 timing window holds (4 windows a frame)
KNN_REPS = 5                  # timed knn calls at each size
CAPTURE_COLUMN_RISE = 0.01    # the rendered column moves up this much a frame


def capture_cameras(root, n_frames, width=960, height=544, **read):
    """transforms_train.json, transforms_test.json and transforms.json for
    ``smoke_scene``'s five cameras at ``width`` x ``height`` (OpenGL c2w, as
    a FluidNexus capture holds them), and the cameras the port's reader makes
    of them (``read`` goes to it: the ScalarReal layout's
    ``dataset_style``, say): camera hacks and all, so the frames are rendered
    from the poses ``read_scene`` gives."""
    from fluidnexus_torch.data.readers import read_cameras_real_capture

    scene = smoke_scene(width=width, height=height, n_frames=1)
    frames = []
    for cam in scene.train_cameras:
        c2w = np.eye(4)
        c2w[:3, :3] = cam.R
        c2w[:3, 3] = cam.camera_center.astype(np.float64)
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": cam.image_name, "transform_matrix": c2w.tolist(),
                       "camera_hw": [cam.height, cam.width], "camera_angle_x": cam.fovx})
    test = [f for f in frames if f["file_path"] == "train02"]
    for name, sel in (("transforms.json", frames), ("transforms_test.json", test),
                      ("transforms_train.json", [f for f in frames if f not in test])):
        with open(os.path.join(root, name), "w") as f:
            json.dump({"frames": sel}, f)
    return read_cameras_real_capture(root, "transforms.json", duration=n_frames, read_image=False,
                                     **read)


def write_capture(root, dev, fake_views, refined_strength):
    """A capture at the FluidNexus-Smoke geometry: 5 cameras at 960 x 544,
    ``train0{c}_bg/000.png`` (the seeded background splats in colour, what
    stage 1 fits) and ``train0{c}/{t:03d}.png`` for frames 0-2 (the smoke
    column, moved up a little each frame, in gray over that background),
    copied into the fake-view folders of ``fake_views``. Every PNG is written
    by the port's ``save_image`` from the port's renders. Returns the
    seconds the writing took."""
    import time

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.data.readers import fake_view_folder
    from fluidnexus_torch.ops.rasterizer import rasterize
    from fluidnexus_torch.pipelines.train_background import save_image
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.sim.state import make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_visual_points
    from fluidnexus_torch.splat.render import render_particles_with_background, to_gray3
    from fluidnexus_torch.utils.maths import normalize

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    cams = capture_cameras(root, STAGE_FRAMES)
    cfg = load_config("configs/smoke_dynamics.json")
    rc = raster_config_from(cfg)
    bg = synthetic_background(32768, dev)
    m = cfg.model
    pts = create_visual_points(m, np.random.default_rng(SEED + 2))
    attrs = constant_visual_attrs(m.visual_capacity, 1, device=dev)
    with torch.no_grad():
        for cam in cams:
            kw = dict(view_matrix=torch.as_tensor(cam.world_view, device=dev),
                      proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                      tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                      height=cam.height, bg_color=torch.zeros(3, device=dev), config=rc)
            name, t = cam.image_name, cam.time_idx
            if t == 0:
                out = rasterize(bg.xyz, bg.color, torch.sigmoid(bg.opacity[:, 0]),
                                torch.exp(bg.scaling), normalize(bg.rotation), **kw)
                save_image(os.path.join(root, f"{name}_bg", "000.png"), out.color)
            moved = pts + np.array([0.0, 0.02 + CAPTURE_COLUMN_RISE * t, 0.0], np.float32)
            vis = make_visual_state(m.visual_capacity, moved, device=dev)
            out = render_particles_with_background(vis.xyz, vis.alive, attrs, bg, **kw)
            img = to_gray3(out.color.clamp(0, 1))
            save_image(os.path.join(root, name, f"{t:03d}.png"), img)
            if name[-1] in fake_views:
                save_image(os.path.join(root, fake_view_folder("smoke", "2", name[-1],
                                                               refined_strength),
                                        f"frame_{t:06d}.png"), img)
    return time.perf_counter() - t0


def derived_config(src, path, changes):
    """``src`` with ``changes`` (JSON wins over the CLI, so the cuts go into a
    copy), written to ``path``; prints each change beside the value the
    configuration had (its own, or the Config default it leaves)."""
    from fluidnexus_torch.core.config import load_config

    with open(src) as f:
        data = json.load(f)
    cfg = load_config(src)
    for k, v in changes.items():
        had = next((getattr(part, k) for part in (cfg.model, cfg.optim, cfg.pipe, cfg)
                    if hasattr(part, k)), "(none)")
        print(f"  {src}: {k} {data[k] if k in data else f'{had} (default)'} -> {v}")
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


def run_stages(dev, tmp):
    """The four stage CLIs in process, in order, on the card, from a capture
    on disk (``write_capture``): stage 1 (``train_background.main``,
    configs/smoke_background.json at full width: 100 000 initial Gaussians
    in a 120 000 capacity, 16 x 16 tiles, K 512, dup 8 x 8) for
    STAGE1_ITERS iterations with every host event firing, its launches (one
    of each rasterizer kernel an iteration), ms per iteration, the densify
    counts, a profile, and the three rasterizer kernels against their plain
    versions and timed at the last iteration's inputs; then stage 2
    (``train_physical_particle.main``) from stage 1's PLY for frames 1-2,
    stage 3 (``run_stage3``), the smoothing of its attributes, stage 4
    (``future_simulation.main``) for 2 future frames from level one and from
    the smoothed level two (``run_stage4``), and the hand-offs
    (``run_hand_offs``). Returns the rasterizer kernels' entries at stage 1's
    and at stage 3's shapes."""
    import time

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.ops.rasterizer import tile_packed
    from fluidnexus_torch.pipelines import future_simulation as tf
    from fluidnexus_torch.pipelines import train_background as tbg
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.utils.maths import normalize

    os.makedirs(tmp, exist_ok=True)
    cap, bg_dir = os.path.join(tmp, "capture"), os.path.join(tmp, "background")
    recon, future = os.path.join(tmp, "recon"), os.path.join(tmp, "future")
    dyn = load_config("configs/smoke_dynamics.json").model
    secs = write_capture(cap, dev, dyn.train_views_fake, dyn.refined_strength)
    n_png = sum(len(fs) for _, _, fs in os.walk(cap))
    print(f"stages: wrote the capture ({n_png} files under {cap}) in {secs:.2f} s")

    read_s = {}

    def timed_read(stage, real):
        def read(cfg, *a, **kw):
            t0 = time.perf_counter()
            out = real(cfg, *a, **kw)
            read_s[stage] = time.perf_counter() - t0
            n = sum(1 for c in out.train_cameras + out.test_cameras if c.image is not None)
            print(f"stage {stage}: read_scene read {n} camera images "
                  f"({len(out.train_cameras)} train, {len(out.test_cameras)} test, "
                  f"{out.train_cameras[0].width}x{out.train_cameras[0].height}) in "
                  f"{read_s[stage]:.3f} s")
            return out
        return read

    # ---- stage 1
    print("stage 1 config (configs/smoke_background.json, cut):")
    cfg1 = derived_config("configs/smoke_background.json", os.path.join(tmp, "stage1.json"),
                          dict(iterations=STAGE1_ITERS, save_iterations=[STAGE1_ITERS],
                               densify_grad_threshold=STAGE1_GRAD_THRESHOLD, **STAGE1_EVENTS))
    events, grads_seen = [], []
    real_make, real_read, real_densify = tbg.make_train_step, tbg.read_scene, tbg.densify_and_prune

    def densify_seen(model, *a, **kw):
        """The mean screen gradients densify compares with its threshold."""
        seen = model.alive & (model.denom > 0)
        g = (model.xyz_gradient_accum[seen] / model.denom[seen]).double()
        q = torch.quantile(g, torch.tensor([0.5, 0.99, 0.999], device=g.device, dtype=g.dtype))
        grads_seen.append((int(seen.sum()), *q.tolist(), float(g.max()),
                           int((g >= STAGE1_GRAD_THRESHOLD).sum()), int((g >= 0.0002).sum())))
        return real_densify(model, *a, **kw)

    def timed_make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(*sa, **skw):
            out = step(*sa, **skw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out
        return timed

    tbg.make_train_step, tbg.read_scene = timed_make, timed_read(1, real_read)
    tbg.densify_and_prune = densify_seen
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        model, stats = tbg.main(["--config", cfg1, "--data_path", cap, "--model_path", bg_dir,
                                 "--seed", str(SEED)], device="cuda")
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        tbg.make_train_step, tbg.read_scene = real_make, real_read
        tbg.densify_and_prune = real_densify
    launches1 = all_launches()
    want = {k: STAGE1_ITERS for k in ("composite_fwd", "composite_bwd", "combine_rows")}
    if any(launches1[k] != v for k, v in want.items()) or any(
            v for k, v in launches1.items() if k not in want):
        _fail(f"stage 1 launched {launches1}, expected {want} and no other kernel")
    print(f"stage 1 launch counts as expected: {want} (one of each an iteration; a full "
          f"15 000-iteration run launches 15 000 of each)")
    if len(events) != STAGE1_ITERS:
        _fail(f"stage 1 ran {len(events)} steps, expected {STAGE1_ITERS}")
    windows = [events[i].elapsed_time(events[i + STAGE1_WINDOW]) / STAGE1_WINDOW
               for i in range(0, STAGE1_ITERS - STAGE1_WINDOW, STAGE1_WINDOW)]
    ms1 = statistics.median(windows)
    print(f"stage 1: {STAGE1_ITERS} iterations in {wall1:.2f} s of main with the read and set-up; "
          f"ms per iteration over windows of {STAGE1_WINDOW}: "
          f"{', '.join(f'{w:.3f}' for w in windows)}; median {ms1:.3f} ms per iteration")
    # ``pruned`` is counted as the JAX package counts it: with the screen-size
    # prune on, dead slots whose (unused) scale passes 0.1 x extent count too
    for d, (n, q50, q99, q999, gmax, over, over_cfg) in zip(stats["densify"], grads_seen):
        print(f"stage 1 densify at {d['iteration']}: alive {d['alive']} (cloned {d['cloned']}, "
              f"split {d['split']}, pruned {d['pruned']} dead slots included, dropped "
              f"{d['dropped']}); mean screen gradient of the {n} Gaussians seen: median "
              f"{q50:.4g}, p99 {q99:.4g}, p99.9 {q999:.4g}, max {gmax:.4g}; {over} at or over "
              f"{STAGE1_GRAD_THRESHOLD:.4g}, {over_cfg} at or over the config's 0.0002")
    if not sum(d["cloned"] for d in stats["densify"]) or not sum(
            d["split"] for d in stats["densify"]):
        _fail("stage 1's densify cloned or split nothing: its writes never ran on the card")
    if [d["iteration"] for d in stats["densify"]] != list(range(
            STAGE1_EVENTS["densify_from_iter"] + STAGE1_EVENTS["densification_interval"],
            STAGE1_ITERS + 1, STAGE1_EVENTS["densification_interval"])):
        _fail(f"stage 1 densified at {[d['iteration'] for d in stats['densify']]}")
    alive = int(model.num_alive)
    ply = os.path.join(bg_dir, "point_cloud", f"iteration_{STAGE1_ITERS}", "point_cloud.ply")
    print(f"stage 1 wrote {ply} ({os.path.getsize(ply)} bytes, {alive} Gaussians of "
          f"{model.capacity})")
    for name in tbg.TRAINABLE:
        if not bool(torch.isfinite(getattr(model, name)[model.alive]).all()):
            _fail(f"stage 1's {name} is not finite")

    # the last iteration's rasterizer inputs: camera 0, the model as the step renders it
    cfg = load_config(cfg1)
    rc = tp.raster_config_from(cfg)
    from fluidnexus_torch.data.scene import read_scene
    cfg.model.data_path, cfg.model.is_bg = cap, True
    cam = read_scene(cfg).train_cameras[0]
    kw = dict(view_matrix=torch.as_tensor(cam.world_view, device=dev),
              proj_matrix=torch.as_tensor(cam.full_proj, device=dev), tan_fovx=cam.tan_fovx,
              tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)
    with torch.no_grad():
        tl = tile_packed(model.xyz, model.color, torch.sigmoid(model.opacity),
                         torch.exp(model.scaling), normalize(model.rotation), model.alive,
                         config=rc, **kw)
    packed_t = tl.packed.contiguous()
    print(f"stage 1 camera 0 tiles: T {packed_t.shape[0]} K {packed_t.shape[1]} F "
          f"{packed_t.shape[2]} live slots {int(tl.counts.sum())} max count "
          f"{int(tl.counts.max())}; tiles {rc.tile_x}x{rc.tile_y} dup {rc.dup_x}x{rc.dup_y}")
    print(count_distribution(tl.counts, rc.tile_capacity))
    errors, saved = check_kernels(packed_t, tl.gauss, tl.counts, tl.tiles_x, model.capacity, rc)

    step = tbg.make_train_step(cam.width, cam.height, rc, cfg.optim.lambda_dssim,
                               cfg.optim.lambda_reg_scaling, cfg.optim.scaling_reg_ratio_threshold)
    from fluidnexus_torch.core.optim import adam_init

    gt = torch.tensor(cam.image.transpose(2, 0, 1), device=dev)
    fovs = torch.tensor([cam.tan_fovx, cam.tan_fovy], device=dev)
    lrs = dict(xyz=1e-5, color=2.5e-3, scaling=5e-3, rotation=1e-3, opacity=5e-2)

    def steps(n):
        m, opt = model, adam_init(tbg._trainable(model))
        for _ in range(n):
            m, opt, _, _ = step(m, opt, kw["view_matrix"], kw["proj_matrix"], fovs, gt,
                                torch.zeros(3, device=dev), lrs)

    profile_run("stage-1 iterations", lambda: steps(5), 5, ms1)
    times, live_slots = time_kernels(packed_t, tl.gauss, tl.counts, tl.tiles_x, model.capacity, rc,
                                     saved)
    kernels = []
    for entry in raster_entries(times, live_slots, errors, launches1, STAGE1_ITERS):
        entry["name"] += "_stage1"
        kernels.append(entry)

    # ---- stage 2 from stage 1's PLY
    it5 = os.path.join(bg_dir, "point_cloud", f"iteration_{STAGE1_ITERS:05d}")
    os.symlink(f"iteration_{STAGE1_ITERS}", it5)
    print(f"stages: stage 1 writes iteration_{STAGE1_ITERS}, stages 2 and 4 read "
          f"iteration_{STAGE1_ITERS:05d} (the JAX package's hand-off): linked {it5}")
    cut = dict(duration=STAGE_FRAMES, start_time=0, time_step=1,
               bg_load_iteration=STAGE1_ITERS)
    print("stage 2 config (configs/smoke_dynamics.json, cut):")
    cfg2 = derived_config("configs/smoke_dynamics.json", os.path.join(tmp, "stage2.json"),
                          dict(cut, init_hidden_delta=PHASE_B_DELTA,
                               iterations_per_time_first=STAGE2_FIRST_ITERS,
                               iterations_per_time_current=STAGE2_ITERS,
                               iterations_per_time_current_max=STAGE2_ITERS))
    real_read = tp.read_scene
    tp.read_scene = timed_read(2, real_read)
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        res = tp.main(["--config", cfg2, "--data_path", cap, "--model_path", recon,
                       "--bg_load_path", bg_dir, "--seed", str(SEED)], device="cuda")
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        tp.read_scene = real_read
    frames2 = [mm["frame"] for mm in res["metrics"]]
    print(f"stage 2: main in {wall2:.2f} s; frames {frames2}; launches {all_launches()}")
    if frames2 != list(range(1, STAGE_FRAMES)) or not all(
            np.isfinite(mm["loss"]) for mm in res["metrics"]):
        _fail("stage 2 did not give a finite loss for each frame")

    # ---- stage 3 from stage 2's checkpoints, the smoothing, stage 4 from both
    level2 = os.path.join(tmp, "level_two")
    kernels += run_stage3(dev, tmp, cap, recon, bg_dir, level2, cut, timed_read)
    from fluidnexus_torch.data import dataset_builders as db

    window = load_config("configs/smoke_dynamics.json").optim.smoothed_window_size
    ckpt2 = os.path.join(level2, "checkpoint_level_two")
    n_smoothed = db.main(["smooth_visual", "--ckpt_dir", ckpt2, "--window", str(window)])
    smoothed = sorted(f for f in os.listdir(ckpt2) if f"_smoothed_ws{window}" in f)
    print(f"dataset_builders smooth_visual (window {window}): {n_smoothed} frames, "
          f"{len(smoothed)} files")
    if n_smoothed != STAGE_FRAMES or len(smoothed) != 4 * STAGE_FRAMES:
        _fail("smooth_visual did not write the four smoothed attributes of every frame")

    print("stage 4 config (configs/smoke_future_simulation.json, cut):")
    cfg4 = derived_config("configs/smoke_future_simulation.json",
                          os.path.join(tmp, "stage4.json"),
                          dict(cut, future_pred_frames=STAGE4_FRAMES))
    argv4 = ["--config", cfg4, "--data_path", cap, "--load_path", recon, "--bg_load_path",
             bg_dir, "--seed", str(SEED)]
    y_one = run_stage4(argv4, future, timed_read, "4")
    y_two = run_stage4(argv4 + ["--level_two_load_path", level2, "--use_level_two_in_future",
                                "--use_level_two_smoothed_in_future"],
                       os.path.join(tmp, "future_level_two"), timed_read, "4 from level two")
    vis2 = np.percentile(np.load(os.path.join(
        ckpt2, f"frame_{STAGE_FRAMES - 1:03d}_visual_xyz.npy"))[:, 1], [0, 50, 100])
    print(f"stage 4's first future frame (frame {STAGE_FRAMES}), the visual particles' y as "
          f"saved (positions / 100; min, median, max): from level one "
          f"{', '.join(f'{v:.6f}' for v in y_one)}; from level two "
          f"{', '.join(f'{v:.6f}' for v in y_two)}. Stage 3's frame {STAGE_FRAMES - 1} holds y "
          f"{', '.join(f'{v:.6f}' for v in vis2)} in world units (saved unscaled): stage 4 loads "
          f"them unscaled beside hidden particles and emitted visual particles in scaled units "
          f"(x 100), so they are advected and rendered 100x too close to the origin, as in the "
          f"JAX package (future_simulation.py:66-78, splat/dynamics.py:278)")

    run_hand_offs(tmp, cap, os.path.join(tmp, "future_level_two"))
    imported = [m for m in ("jax", "fluidnexus_tpu", "PIL", "cv2") if m in sys.modules] + [
        m for m in sys.modules if m.startswith(("fluidnexus_tpu.", "jax.", "PIL.", "cv2."))]
    if imported:
        _fail(f"the stages imported {imported}")
    print(f"stages: capture reads {', '.join(f'stage {k} {v:.3f} s' for k, v in read_s.items())}; "
          f"no jax, fluidnexus_tpu, PIL or cv2 in the process")
    return kernels


def run_stage4(argv, out, timed_read, stage, n_frames=STAGE4_FRAMES):
    """``future_simulation.main`` with ``argv`` into ``out`` on the card (the
    run called stage ``stage`` in what it prints), ``n_frames`` future
    frames: a
    finite p_ratio each future frame, its renders, exactly its launches
    (``solver_iterations_future`` of each v3 PBF kernel, one splat forward
    and one composite forward a rendered camera each frame) and no other.
    Returns the y range of the first future frame's visual particles as
    saved."""
    import time

    from fluidnexus_torch.core.config import parse_cli
    from fluidnexus_torch.data.scene import cameras_by_time
    from fluidnexus_torch.pipelines import future_simulation as tf

    label, scenes = f"stage {stage}", []

    def read(cfg, *a, **kw):
        scenes.append(timed_read(stage, real_read)(cfg, *a, **kw))
        return scenes[-1]

    real_read = tf.read_scene
    tf.read_scene = read
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        frames = tf.main(argv + ["--model_path", out], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tf.read_scene = real_read
    launches = all_launches()
    o = parse_cli(argv).optim
    scene = scenes[-1]
    cams = cameras_by_time(scene.train_cameras)[0] + cameras_by_time(scene.test_cameras).get(0, [])
    n_cams, n_names = len(cams), len({c.image_name for c in cams})
    print(f"{label}: main in {wall:.2f} s; p_ratio {[f['p_ratio'] for f in frames]}; "
          f"launches {launches}")
    if len(frames) != n_frames or not all(np.isfinite(f["p_ratio"]) for f in frames):
        _fail(f"{label} did not give a finite p_ratio for each future frame")
    renders = os.listdir(os.path.join(out, "training_render"))
    print(f"{label} wrote {len(renders)} renders ({n_cams} cameras a frame rendered under "
          f"{n_names} names: a camera in both the training and the test set writes one file)")
    if len(renders) != n_frames * n_names:
        _fail(f"{label} wrote {len(renders)} renders, expected {n_frames * n_names}")
    want = {"pbf_phase1": n_frames * o.solver_iterations_future,
            "pbf_phase2": n_frames * o.solver_iterations_future,
            "splat_fwd": n_frames, "composite_fwd": n_frames * n_cams}
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        _fail(f"{label} launched {launches}, expected {want} and no other kernel")
    y = np.load(os.path.join(out, "checkpoint", f"frame_{frames[0]['frame']:03d}_visual_xyz.npy"))
    if not np.isfinite(y).all():
        _fail(f"{label}'s visual particles are not finite")
    return np.percentile(y[:, 1], [0, 50, 100])


def run_stage3(dev, tmp, cap, recon, bg_dir, level2, cut, timed_read):
    """Stage 3 (``train_visual_particle.main``) on the card from stage 2's
    checkpoints of frames 0-2 and stage 1's PLY: configs/smoke_dynamics.json
    at full width (visual capacity 65 536, 3 colour channels, all four fields
    fitted with their inherit, consistency and regulariser settings, 16 x 16
    tiles, K 512, batch 1) with ``--init_scales_w_xyz_dist`` on and the
    iterations cut to STAGE3_ITERS a frame. Checks exactly STAGE3_ITERS x
    frames launches of each rasterizer kernel and no other, a finite loss a
    frame and every checkpoint file; prints ms per iteration (CUDA events
    after each step, median of windows), the knn's ms at 65 536 (this run's
    live rows, and every row live), a profile, and holds and times the three
    rasterizer kernels at the last iteration's attributes through camera 0.
    Returns their ``_stage3`` entries of the ``kernels`` line."""
    import time

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.core.optim import adam_init
    from fluidnexus_torch.data.scene import cameras_by_time, read_scene
    from fluidnexus_torch.ops.knn import mean_dist_to_knn
    from fluidnexus_torch.ops.rasterizer import tile_packed
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.pipelines import train_visual_particle as tvp
    from fluidnexus_torch.splat.render import compose_splats

    print("stage 3 config (configs/smoke_dynamics.json, cut):")
    cfg3 = derived_config("configs/smoke_dynamics.json", os.path.join(tmp, "stage3.json"),
                          dict(cut, iterations_per_time_current_level_two=STAGE3_ITERS,
                               iterations_per_time_current_level_two_max=STAGE3_ITERS))
    print("stage 3: --init_scales_w_xyz_dist on, a choice of this run (no shipped config sets "
          "it): the simple-knn scale init runs on the card")
    argv = ["--config", cfg3, "--data_path", cap, "--load_path", recon, "--model_path", level2,
            "--bg_load_path", bg_dir, "--init_scales_w_xyz_dist", "--seed", str(SEED)]
    events, last, knn_ms = [], {}, []
    real_make, real_read, real_knn = tvp.make_level_two_step, tvp.read_scene, tvp.mean_dist_to_knn

    def timed_make(*a, **kw):
        step = real_make(*a, **kw)
        last["make"] = (a, kw)

        def timed(*sa):
            out = step(*sa)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            last["args"], last["out"] = sa, out
            return out
        return timed

    def timed_knn(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_knn(*a, **kw)
        end.record()
        end.synchronize()
        knn_ms.append(start.elapsed_time(end))
        return out

    tvp.make_level_two_step, tvp.read_scene = timed_make, timed_read(3, real_read)
    tvp.mean_dist_to_knn = timed_knn
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        results = tvp.main(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tvp.make_level_two_step, tvp.read_scene = real_make, real_read
        tvp.mean_dist_to_knn = real_knn
    launches = all_launches()
    cfg = tvp.parse_cli(argv)
    o, m = cfg.optim, cfg.model
    n_iters = STAGE3_ITERS * STAGE_FRAMES
    src = load_config("configs/smoke_dynamics.json").optim
    print(f"stage 3: main in {wall:.2f} s; visual capacity {m.visual_capacity}, "
          f"{'3 colour channels' if m.level_two_color_3ch else '1 colour channel'}, fitted "
          f"{[f for f in tvp.FIELDS if getattr(o, f'fit_{f}')]}, batch {o.batch}, tiles "
          f"{cfg.pipe.tile_x} x {cfg.pipe.tile_y}, K {cfg.pipe.tile_capacity}; {STAGE3_ITERS} "
          f"iterations a frame (the config's {src.iterations_per_time_current_level_two} -> "
          f"{src.iterations_per_time_current_level_two_max} over the frames, cut)")
    for r in results:
        print(f"stage 3 frame {r['frame']}: loss {r['loss']:.6f} l1 {r['l1']:.6f}")
    if [r["frame"] for r in results] != list(range(STAGE_FRAMES)) or not all(
            np.isfinite(r["loss"]) for r in results):
        _fail("stage 3 did not give a finite loss for each frame")
    want = {k: n_iters for k in ("composite_fwd", "composite_bwd", "combine_rows")}
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        _fail(f"stage 3 launched {launches}, expected {want} and no other kernel")
    print(f"stage 3 launch counts as expected: {want} (one of each an iteration)")
    ckpt = os.path.join(level2, "checkpoint_level_two")
    names = {f"frame_{t:03d}_visual_{f}.npy" for t in range(STAGE_FRAMES)
             for f in ("xyz", "color", "scales", "rotation", "opacity")}
    if not names <= set(os.listdir(ckpt)) or not os.path.exists(
            os.path.join(level2, "cfg_args.json")):
        _fail(f"stage 3's checkpoint_level_two lacks {sorted(names - set(os.listdir(ckpt)))}")
    color = np.load(os.path.join(ckpt, f"frame_{STAGE_FRAMES - 1:03d}_visual_color.npy"))
    print(f"stage 3 wrote {len(names)} checkpoint files; frame {STAGE_FRAMES - 1}: {len(color)} "
          f"visual particles, colour {tuple(color.shape)} in {color.min():.4f} .. "
          f"{color.max():.4f}")
    if color.shape[1] != 3 or not np.isfinite(color).all():
        _fail("stage 3's colours are not finite (N, 3)")
    if len(events) != n_iters:
        _fail(f"stage 3 ran {len(events)} steps, expected {n_iters}")
    windows = [events[f * STAGE3_ITERS + i].elapsed_time(events[f * STAGE3_ITERS + i
                                                                + STAGE3_WINDOW]) / STAGE3_WINDOW
               for f in range(STAGE_FRAMES)
               for i in range(0, STAGE3_ITERS - STAGE3_WINDOW, STAGE3_WINDOW)]
    ms3 = statistics.median(windows)
    print(f"stage 3: ms per iteration over windows of {STAGE3_WINDOW} inside each frame: "
          f"{', '.join(f'{w:.3f}' for w in windows)}; median {ms3:.3f} ms per iteration")

    # the knn: this run's calls (65 536 rows, the live ones taking part), then
    # every row of a 65 536 capacity live, each held to its CPU value
    (trainable, fixed, _, _, vxyz, alive, _, cams, gts, lrs) = last["args"]
    n_live = int(alive.sum())
    print(f"knn in stage 3 (mean_dist_to_knn over {vxyz.shape[0]} rows, {n_live} live): "
          f"{', '.join(f'{t:.3f}' for t in knn_ms)} ms a frame (CUDA events)")
    got = mean_dist_to_knn(vxyz, alive=alive)
    ref = mean_dist_to_knn(vxyz.cpu(), alive=alive.cpu())
    knn_err = float((got.cpu() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    full = (torch.rand((m.visual_capacity, 3), generator=gen) * torch.tensor([0.06, 0.4, 0.06])
            + torch.tensor([0.296, 0.0, -0.33])).to(dev)
    times = {}
    for what, args in (("stage 3's rows", (vxyz, alive)), ("every row live", (full, None))):
        ts = []
        for _ in range(KNN_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mean_dist_to_knn(args[0], alive=args[1])
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        times[what] = statistics.median(ts)
        print(f"knn at {m.visual_capacity} rows, {what}: {', '.join(f'{t:.3f}' for t in ts)} ms "
              f"(median {times[what]:.3f})")
    sub = full[:4096]
    sub_err = float((mean_dist_to_knn(sub).cpu() - mean_dist_to_knn(sub.cpu())).abs().max())
    print(f"knn on the card against the CPU: {knn_err:.3g} of the largest at stage 3's rows; "
          f"{sub_err:.3g} max abs over 4 096 rows all live")
    if knn_err > 1e-6 or sub_err > 1e-6 * float(mean_dist_to_knn(sub.cpu()).max()):
        _fail("the knn on the card disagrees with the CPU")

    # rows 1-3 at the last iteration's attributes through frame 2's camera 0
    rc = tp.raster_config_from(cfg)
    attrs = fixed._replace(**last["out"][0])
    bg = tp._load_background(cfg, None, dev, lambda *a: None)
    cam = cameras_by_time(read_scene(cfg).train_cameras)[STAGE_FRAMES - 1][0]
    kw = dict(view_matrix=torch.as_tensor(cam.world_view, device=dev),
              proj_matrix=torch.as_tensor(cam.full_proj, device=dev), tan_fovx=cam.tan_fovx,
              tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)
    with torch.no_grad():
        means, col, ops, scales, rots, live = compose_splats(vxyz, alive, attrs, bg)
        tl = tile_packed(means, col, ops, scales, rots, live, config=rc, **kw)
    packed_t = tl.packed.contiguous()
    print(f"stage 3 camera 0 tiles ({cam.image_name}, frame {STAGE_FRAMES - 1}): T "
          f"{packed_t.shape[0]} K {packed_t.shape[1]} F {packed_t.shape[2]} live slots "
          f"{int(tl.counts.sum())} max count {int(tl.counts.max())}; {means.shape[0]} splats "
          f"({n_live} visual live of {vxyz.shape[0]}, {bg.n} background)")
    print(count_distribution(tl.counts, rc.tile_capacity))
    errors, saved = check_kernels(packed_t, tl.gauss, tl.counts, tl.tiles_x, means.shape[0], rc)

    (a, akw) = last["make"]
    step = real_make(*a, **akw)

    def steps(n):
        tr, opt = trainable, adam_init(trainable)
        for _ in range(n):
            tr, opt, _, _ = step(tr, fixed, fixed, 1.0, vxyz, alive, opt, cams, gts, lrs)

    profile_run("stage-3 iterations", lambda: steps(5), 5, ms3)
    times_k, live_slots = time_kernels(packed_t, tl.gauss, tl.counts, tl.tiles_x, means.shape[0],
                                       rc, saved)
    kernels = []
    for entry in raster_entries(times_k, live_slots, errors, launches, n_iters):
        entry["name"] += "_stage3"
        kernels.append(entry)
    return kernels


def run_hand_offs(tmp, cap, future):
    """The DataProcessing hand-offs on the card's host, each through its CLI:
    ``python -m fluidnexus_torch convert`` original_to_zero123 on the
    capture, zero123_cams on its transforms.json, zero123_to_cogvideox and
    cogvideox_to_original on what they made; ``dataset_builders``
    simulation_to_cogvideox (with the un-shift) on stage 4's renders, and
    cogvideox_dataset (2-frame clips, packed) and cogvideox_paths on the
    capture laid out as one sequence. Checks each output's count and size."""
    import time

    from fluidnexus_torch.__main__ import main as runner
    from fluidnexus_torch.data import dataset_builders as db
    from fluidnexus_torch.utils.png import read_png

    out = os.path.join(tmp, "hand_offs")
    n_cams = 5

    def held(label, folder, count, shape, t0):
        names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        shapes = {read_png(os.path.join(folder, n)).shape for n in names}
        print(f"hand-off {label}: {len(names)} PNGs of {sorted(shapes)} in "
              f"{time.perf_counter() - t0:.2f} s")
        if len(names) != count or shapes != {shape}:
            _fail(f"hand-off {label} wrote {len(names)} PNGs of {shapes}, expected {count} of "
                  f"{shape}")

    z123 = os.path.join(out, "zero123")
    t0 = time.perf_counter()
    runner(["convert", "original_to_zero123", "--data_root", cap, "--out_root", z123,
            "--camera_prefix", "train"])
    for t in range(STAGE_FRAMES):
        held(f"original_to_zero123 frame {t}", os.path.join(z123, f"frame_{t:03d}"), n_cams,
             (512, 512, 3), t0)
    t0 = time.perf_counter()
    runner(["convert", "zero123_cams", "--transforms_json", os.path.join(cap, "transforms.json"),
            "--out_dir", os.path.join(out, "camera")])
    rts = [np.load(os.path.join(out, "camera", f"{c:02d}.npy")) for c in range(n_cams)]
    ortho = max(float(np.abs(rt[:, :3] @ rt[:, :3].T - np.eye(3)).max()) for rt in rts)
    print(f"hand-off zero123_cams: {len(rts)} W2C (3, 4) npys, |R R^T - I| at most {ortho:.2g}, "
          f"in {time.perf_counter() - t0:.2f} s")
    if any(rt.shape != (3, 4) for rt in rts) or ortho > 1e-5:
        _fail("zero123_cams did not write a rotation and translation a camera")
    t0 = time.perf_counter()
    runner(["convert", "zero123_to_cogvideox", "--zero123_folder",
            os.path.join(z123, "frame_000"), "--out_folder", os.path.join(out, "cogvideox")])
    held("zero123_to_cogvideox", os.path.join(out, "cogvideox"), n_cams, (480, 720, 3), t0)
    t0 = time.perf_counter()
    runner(["convert", "cogvideox_to_original", "--refined_folder", os.path.join(out, "cogvideox"),
            "--out_folder", os.path.join(out, "rawsize")])
    held("cogvideox_to_original", os.path.join(out, "rawsize"), n_cams, (1920, 1080, 3), t0)

    renders = sorted(os.listdir(os.path.join(future, "training_render")))
    size = read_png(os.path.join(future, "training_render", renders[0])).shape
    t0 = time.perf_counter()
    db.main(["simulation_to_cogvideox", "--exp_path", future, "--unshift"])
    held("simulation_to_cogvideox", os.path.join(future, "training_render_for_cogvideox"),
         len(renders), (480, 720, 3), t0)
    held("simulation_to_cogvideox (un-shifted)", os.path.join(future, "training_render_unshift"),
         len(renders), size, t0)

    root = os.path.join(out, "captures")
    os.makedirs(os.path.join(root, "smoke"))
    with open(os.path.join(root, "capture_set.csv"), "w") as f:
        f.write("sequence\nsmoke\n")
    for c in range(n_cams):
        os.symlink(os.path.join(cap, f"train0{c}"), os.path.join(root, "smoke", f"camera{c:02d}"))
    cvx = os.path.join(out, "cogvideox_dataset")
    t0 = time.perf_counter()
    db.main(["cogvideox_dataset", "--capture_root", root, "--out_root", cvx, "--num_cams",
             str(n_cams), "--min_frame_id", "0", "--num_all_frames", str(STAGE_FRAMES),
             "--start_frame_step", "1", "--frame_step", "1", "--num_frames", "2", "--pack_video"])
    clips = sorted(os.listdir(os.path.join(cvx, "videos")))
    for clip in clips:
        held(f"cogvideox_dataset {clip}", os.path.join(cvx, "videos", clip), 2, (480, 720, 3), t0)
    db.main(["cogvideox_paths", "--capture_root", root, "--out_root", cvx, "--num_val", "1"])
    with open(os.path.join(cvx, "all_val_paths20.json")) as f:
        val = json.load(f)
    avis = sorted(os.listdir(os.path.join(cvx, "avi")))
    labels = sorted(os.listdir(os.path.join(cvx, "labels")))
    print(f"hand-off cogvideox_dataset: {len(clips)} clips, {len(avis)} AVIs "
          f"({os.path.getsize(os.path.join(cvx, 'avi', avis[0]))} bytes each), {len(labels)} "
          f"captions; cogvideox_paths: {len(val)} validation clips")
    if len(clips) != n_cams or len(avis) != n_cams or len(labels) != n_cams or val != clips:
        _fail("cogvideox_dataset or cogvideox_paths wrote other clips than expected")


# ------------------------------ future (stage 4) ------------------------------

FUTURE_FRAMES = 10            # future_pred_frames, cut from the README's 60
WIND_FROM, RIGID_FROM = 3, 5  # future frames the wind and the cylinder start at
RIGID_TICKS = 5
RIGID_ITERS = 10
PROFILE_RIGID_TICKS = 3
# f32 operations per live slot of the v2 and v1 epilogues: sg = (sum cg) x_i
# - sum cg x_s and dsum = (sum b) x_i - sum b x_s, 2 per axis
RAW_SLOT_OPS = 6
FUTURE_KERNELS = {  # name: (replaces, CUDA kernel name)
    "pbf_phase1_v2": ("fluidnexus_tpu/sim/pbf_pallas.py:259", "phase1_v2_kernel"),
    "pbf_phase2_v2": ("fluidnexus_tpu/sim/pbf_pallas.py:317", "phase2_v2_kernel"),
    "pbf_phase1_v1": ("fluidnexus_tpu/sim/pbf_pallas.py:125", "phase1_v1_kernel"),
    "pbf_phase2_v1": ("fluidnexus_tpu/sim/pbf_pallas.py:173", "phase2_v1_kernel"),
}


def future_config(recon_path, model_path):
    from fluidnexus_torch.core.config import load_config

    cfg = load_config("configs/smoke_future_simulation.json")
    wind = load_config("configs/smoke_wind_simulation.json").optim.wind_force
    o, m = cfg.optim, cfg.model
    cfg.seed = SEED
    m.load_path, m.model_path = recon_path, model_path
    n_frames = 3                                # the scene's frames 0-2
    o.future_pred_frames = FUTURE_FRAMES
    o.wind_since, o.wind_force = n_frames + WIND_FROM, list(wind)
    o.rigid_since = n_frames + RIGID_FROM
    print(f"future config: {FUTURE_FRAMES} frames (the README runs 60) x "
          f"{o.solver_iterations_future} Jacobi iterations, p0 {o.p0} -> {o.p0_future} over "
          f"{o.decay_frames_future_p0} frames, emit ratios hidden {o.emit_ratio_hidden} visual "
          f"{o.emit_ratio_visual}, wind {o.wind_force} from frame {o.wind_since}, rigid "
          f"{o.rigid_body} at {o.rigid_body_center} radius {o.rigid_cylinder_radius} "
          f"{o.rigid_cylinder_num} particles of radius {o.rigid_particle_radius} from frame "
          f"{o.rigid_since}")
    return cfg


def run_future(dev, recon, tmp):
    """Stage 4: ``predict`` at the smoke widths from phase C's checkpoint, its
    launch counts and ms per future frame with and without renders; the
    rigid rollout; the four v2 and v1 kernels against their plain versions;
    the small card-vs-CPU checks; profiles; the kernel times. Returns the
    four kernels' entries of the ``kernels`` line."""
    import copy

    from fluidnexus_torch.pipelines.future_simulation import predict

    cfg = future_config(recon["path"], os.path.join(tmp, "run"))
    o = cfg.optim
    scene, bg = recon["scene"], recon["bg"]
    n_cams = len([c for c in scene.train_cameras if c.time_idx == 0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(c, log=lambda *a: None, renders=True):
        start.record()
        frames = predict(c, scene, log=log, save_renders=renders, bg=bg, device=dev)
        end.record()
        end.synchronize()
        return frames, start.elapsed_time(end)

    torch.cuda.synchronize()
    reset_all_launches()
    frames, ms_first = run(cfg, log=print)
    launches = all_launches()
    print(f"predict: {FUTURE_FRAMES} future frames in {ms_first:.1f} ms with set-up; launches "
          f"{launches}")
    if len(frames) != FUTURE_FRAMES or not all(np.isfinite(f["p_ratio"]) for f in frames):
        _fail("predict did not give a finite p_ratio for each future frame")
    renders = sorted(os.listdir(os.path.join(cfg.model.model_path, "training_render")))
    last = np.load(os.path.join(cfg.model.model_path, "checkpoint",
                                f"frame_{frames[-1]['frame']:03d}_xyz.npy"))
    vis_y = np.load(os.path.join(cfg.model.model_path, "checkpoint",
                                 f"frame_{frames[-1]['frame']:03d}_visual_xyz.npy"))[:, 1] * 100.0
    print(f"predict wrote {len(renders)} renders; the last checkpoint holds {last.shape[0]} "
          f"hidden particles (y {100.0 * last[:, 1].min():.2f} .. {100.0 * last[:, 1].max():.2f}) "
          f"and {vis_y.shape[0]} visual (y {vis_y.min():.2f} .. {vis_y.max():.2f} scaled units)")
    if len(renders) != FUTURE_FRAMES * n_cams or not np.isfinite(last).all() or \
            last.shape != (frames[-1]["hidden"], 3):
        _fail("predict's renders or checkpoints are missing or not finite")
    if not any(f["rigid_hidden"] > 0 for f in frames[RIGID_FROM:]):
        _fail("the rigid cylinder moved no hidden particle")
    want = {"pbf_phase1": FUTURE_FRAMES * o.solver_iterations_future,
            "pbf_phase2": FUTURE_FRAMES * o.solver_iterations_future,
            "splat_fwd": FUTURE_FRAMES, "composite_fwd": FUTURE_FRAMES * n_cams}
    idle = [k for k, v in launches.items() if k not in want and v]
    if any(launches[k] != v for k, v in want.items()) or idle:
        _fail(f"predict launched the kernels {launches}, expected {want} and no other")
    print(f"predict launch counts as expected: {want}")

    # ms per future frame: the median of three 10-frame runs less the median
    # of three 0-frame runs (the checkpoint load and set-up), over 10
    def timed(frames_, renders):
        c = copy.deepcopy(cfg)
        c.optim.future_pred_frames = frames_
        return run(c, renders=renders)[1]

    per_frame = {}
    zero = [timed(0, True) for _ in range(3)]
    for renders in (True, False):
        runs = [timed(FUTURE_FRAMES, renders) for _ in range(3)]
        per_frame[renders] = (statistics.median(runs) - statistics.median(zero)) / FUTURE_FRAMES
        print(f"predict {'with' if renders else 'without'} renders: "
              f"{', '.join(f'{t:.1f}' for t in runs)} ms for {FUTURE_FRAMES} frames, set-up "
              f"{', '.join(f'{t:.1f}' for t in zero)} ms; {per_frame[renders]:.3f} ms per future "
              f"frame (medians of three)")
    c = copy.deepcopy(cfg)
    c.optim.future_pred_frames, c.optim.wind_since, c.optim.rigid_since = 2, 0, 0
    profile_run("future frames (wind and cylinder on)", lambda: run(c), 2, per_frame[True])

    kernels = run_rigid(dev, cfg)
    small_future_check(dev)
    return kernels


def rigid_state(cfg, dev):
    """The rollout's start: phase C's frame-2 checkpoint, hidden and visual,
    and the config's cylinder drawn from a new generator of the seed."""
    from fluidnexus_torch.pipelines.train_physical_particle import pbf_params_from_config
    from fluidnexus_torch.sim.pbf import RigidSpec, create_rigid_body
    from fluidnexus_torch.splat.dynamics import load_hidden, load_visual

    o, m = cfg.optim, cfg.model
    params = pbf_params_from_config(cfg)
    ckpt = os.path.join(m.load_path, "checkpoint")
    state = load_hidden(ckpt, 2, m.hidden_capacity, params, device=dev)
    visual, _ = load_visual(ckpt, 2, m.visual_capacity, device=dev)
    spec = RigidSpec(kind=o.rigid_body, particle_radius=o.rigid_particle_radius,
                     center=tuple(o.rigid_body_center), cylinder_radius=o.rigid_cylinder_radius,
                     cylinder_num=tuple(o.rigid_cylinder_num))
    return params, state, visual, create_rigid_body(spec, np.random.default_rng(cfg.seed),
                                                    device=dev)


def rigid_tick(params, state, visual, rb, iterations=RIGID_ITERS):
    """guess -> solver_loop with the body -> confirm -> update_visual."""
    from fluidnexus_torch.sim.pbf import confirm_guess, guess_hidden, solver_loop, update_visual

    state = guess_hidden(state, params)
    state, diags = solver_loop(state, params, iterations, rigid=rb)
    state = confirm_guess(state, params)
    return state, update_visual(visual, state, params), diags


def run_rigid(dev, cfg):
    """The rigid rollout: RIGID_TICKS ticks with their launch counts and ms
    per tick; the kernels at the first iteration's inputs; v3, v2 and v1
    ticks against each other; a profile; the kernel times."""
    from fluidnexus_torch.sim.pbf import guess_hidden, inside_rigid_body

    params, state0, visual0, rb = rigid_state(cfg, dev)
    print(f"rigid rollout: {int(state0.num_alive)} hidden and {int(visual0.num_alive)} visual "
          f"particles, cylinder of {rb.xyz.shape[0]} surface particles over "
          f"{rb.xyz.min(0).values.tolist()} .. {rb.xyz.max(0).values.tolist()}; {RIGID_TICKS} "
          f"ticks x {RIGID_ITERS} iterations, grid {params.dense_max_cells} x "
          f"{params.dense_cell_capacity} rebuilt every iteration")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def ticks(n, log=False):
        state, visual = state0, visual0
        start.record()
        for t in range(n):
            if log:
                guessed = guess_hidden(state, params)
                inside = int((inside_rigid_body(rb, guessed.estimate_xyz) & guessed.alive).sum())
            state, visual, d = rigid_tick(params, state, visual, rb)
            if log:
                print(f"rigid tick {t + 1}: {inside} hidden estimates inside the cylinder after "
                      f"the guess; overflow {int(d['overflow'].sum())}, p_ratio "
                      f"{float(d['p_ratio'][-1]):.6f}, neighbors {float(d['neighbors'][-1]):.3f}, "
                      f"{int(state.num_alive)} hidden alive")
        end.record()
        end.synchronize()
        return state, visual, start.elapsed_time(end)

    ticks(1)                                            # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    state, visual, _ = ticks(RIGID_TICKS, log=True)
    launches = all_launches()
    print(f"rigid rollout launches: {launches}")
    if not (torch.isfinite(state.xyz).all() and torch.isfinite(visual.xyz).all()):
        _fail("the rigid rollout's positions are not finite")
    inside = int((inside_rigid_body(rb, state.xyz) & state.alive).sum())
    print(f"rigid rollout: {inside} hidden particles inside the cylinder or on its surface "
          f"after {RIGID_TICKS} ticks")
    want = {"pbf_phase1_v2": RIGID_TICKS * RIGID_ITERS, "pbf_phase2_v2": RIGID_TICKS * RIGID_ITERS,
            "splat_fwd": RIGID_TICKS}
    idle = [k for k, v in launches.items() if k not in want and v]
    if any(launches[k] != v for k, v in want.items()) or idle:
        _fail(f"the rigid rollout launched the kernels {launches}, expected {want} and no other")
    runs = [ticks(RIGID_TICKS)[2] for _ in range(3)]
    ms_tick = statistics.median(runs) / RIGID_TICKS
    print(f"rigid rollout: {', '.join(f'{t:.1f}' for t in runs)} ms for {RIGID_TICKS} ticks; "
          f"{ms_tick:.3f} ms per rigid tick of {RIGID_ITERS} iterations (median of three)")

    inp = rigid_first_inputs(params, state0)
    errors, saved = check_rigid_kernels(inp)
    v1_launches = compare_backends(params, state0)
    launches.update({n: v1_launches[n] for n in ("pbf_phase1_v1", "pbf_phase2_v1")})
    profile_run("rigid ticks", lambda: ticks(PROFILE_RIGID_TICKS), PROFILE_RIGID_TICKS, ms_tick)

    times = time_rigid_kernels(inp, saved)
    kernels = []
    for name, tm in times.items():
        b_ms, b_by = tm["bound"]
        replaces, _ = FUTURE_KERNELS[name]
        path = f"{RIGID_TICKS} rigid ticks" if "v2" in name else "the v1 backend's tick"
        print(f"{name}: {tm['ms']:.4f} ms on the card per launch (mean of the {tm['recorded']} "
              f"launches the profiler recorded; a wrapper call {tm['call_ms']:.4f} ms; "
              f"plain {tm['plain_ms']:.4f} ms, library none, bound {b_ms:.5f} ms by {b_by}: "
              f"{tm['nbytes']} bytes, {tm['ops']} f32 operations), {launches[name]} launches in "
              f"{path}")
        kernels.append({"name": name, "route": "cuda", "source": "fluidnexus_torch/csrc/pbf.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errors[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return kernels


def rigid_first_inputs(params, state0):
    """The first rigid tick's first Jacobi iteration, rebuilt with the port's
    own functions in ``solver_loop``'s order: the guess (counts 0), the grid
    of ``project_gas_constraints_dense`` and its planes, imass at slots."""
    from fluidnexus_torch.ops.neighbors import build_dense_grid, slot_gather
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim.pbf import guess_hidden

    state = guess_hidden(state0, params)
    grid = build_dense_grid(state.estimate_xyz, params.h, state.alive, params.dense_max_cells,
                            params.dense_cell_capacity)
    cnt, *xyz = pc.planes(grid)
    imass = torch.where(grid.bmask, slot_gather(grid, state.imass), 1.0)
    c = grid.max_cells
    occupied = cnt[:c] > 0
    pairs = _candidates(grid.nbr, cnt, cnt)
    print(f"rigid first iteration grid: C {c} M {grid.capacity}, {int(occupied.sum())} occupied "
          f"cells, fullest {int(cnt.max())}, {int(grid.bmask.sum())} live slots of "
          f"{int(state.num_alive)} alive, {pairs} live candidate pairs, overflow "
          f"{int(grid.overflow)}")
    row_stats(cnt, c, "rigid first iteration rows")
    return dict(nbr=grid.nbr, cnt=cnt, xyz=xyz, imass=imass, live=grid.bmask,
                k=pc.pair_consts(params), params=params, pairs=pairs, rows=int(occupied.sum()))


def _lambda(params, live, pi_raw, sg, c2d2, imass):
    """Lambda between the v2 passes, as ``sim/pbf_dense._project_core``
    forms it."""
    p0 = params.p0
    lam = -(pi_raw / imass / p0 - 1.0) / (c2d2 / (p0 * p0) + ((sg / p0) ** 2).sum(-1)
                                          + params.relaxation)
    return torch.where(live, lam, 0.0).contiguous()


def check_rigid_kernels(inp):
    """The v2 and v1 kernels against their plain versions at the first
    iteration's inputs, live slots only: pi_raw, c2d2 and each axis of sg and
    of dsum at 1e-4 of their own scale, nlen exactly (flips at d2 = h^2
    allowed on at most 1e-5 of the live slots), the four global sums at 1e-5
    relative, dead slots 0. Then phase 1 v2 and v1 against phase 1 v1's
    checking mode, the walk (``phase1_v1_slots(..., walk=True)``), whose sums
    in its order they keep: v1 identical, v2 identical or within 1e-6 of each
    field's scale; and phase 2 v1 against v2: one body over copies of the
    same rows, so identical, or within 1e-6."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, xyz, k, live = inp["nbr"], inp["cnt"], inp["xyz"], inp["k"], inp["live"]
    ncnt, xng = pc.gather_v1(nbr, cnt, *xyz)
    p1 = {"v2": pc.phase1_v2_slots(nbr, cnt, *xyz, k), "v1": pc.phase1_v1_slots(ncnt, xng, *xyz, k)}
    walk = pc.phase1_v1_slots(ncnt, xng, *xyz, k, walk=True)
    p1_plain = {"v2": pc.phase1_v2_plain(nbr, cnt, *xyz, k),
                "v1": pc.phase1_v1_plain(ncnt, xng, *xyz, k)}
    lam = _lambda(inp["params"], live, *p1["v2"][:3], inp["imass"])
    lng = pc.gather_lam_v1(nbr, lam)
    p2 = {"v2": pc.phase2_v2_slots(nbr, cnt, *xyz, lam, k),
          "v1": pc.phase2_v1_slots(ncnt, xng, lng, *xyz, lam, k)}
    p2_plain = {"v2": pc.phase2_v2_plain(nbr, cnt, *xyz, lam, k),
                "v1": pc.phase2_v1_plain(ncnt, xng, lng, *xyz, lam, k)}
    torch.cuda.synchronize()
    n_live = int(live.sum())
    failures, errors = [], {}

    def held(kernel, name, a, b, tol):
        err = float((a - b)[live].abs().max())
        scale = float(b[live].abs().max())
        ok = err <= tol * scale and scale > 0 and not bool(a[~live].any())
        print(f"rigid kernel check: {kernel} {name} max|err| {err:.3e} / scale {scale:.3e} "
              f"[tol {tol:g} x scale], dead slots 0" + ("" if ok else " FAILED"))
        if not ok:
            failures.append(f"{kernel} {name}")
        errors[kernel] = max(errors.get(kernel, 0.0), err)

    for v in ("v2", "v1"):
        got, want = p1[v], p1_plain[v]
        held(f"pbf_phase1_{v}", "pi_raw", got[0], want[0], 1e-4)
        for a, axis in enumerate("xyz"):
            held(f"pbf_phase1_{v}", f"sg {axis}", got[1][..., a], want[1][..., a], 1e-4)
        held(f"pbf_phase1_{v}", "c2d2", got[2], want[2], 1e-4)
        flips = int((got[3] != want[3])[live].sum())
        print(f"rigid kernel check: pbf_phase1_{v} nlen differs on {flips} of {n_live} live slots "
              f"[tol {int(1e-5 * n_live)}]")
        if flips > int(1e-5 * n_live):
            failures.append(f"pbf_phase1_{v} nlen")
        for a, axis in enumerate("xyz"):
            held(f"pbf_phase2_{v}", f"dsum {axis}", p2[v][0][..., a], p2_plain[v][0][..., a], 1e-4)
        sums = (("s_p6", got[4], want[4]), ("s_edges", got[5], want[5]),
                ("s_corr", p2[v][1], p2_plain[v][1]), ("s_ns", p2[v][2], p2_plain[v][2]))
        for name, a, b in sums:
            rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
            print(f"rigid kernel check: {v} {name} {float(a):.6e} against {float(b):.6e}, rel "
                  f"{rel:.3e} [tol 1e-5]")
            if not rel <= 1e-5:
                failures.append(f"{v} {name}")
    fields = ("pi_raw", "sg", "c2d2", "nlen")
    pairs_v1 = [(f"v{v} against the walk", f"phase 1 {name}", a, b, tol)
                for v, tol in (("1", 0.0), ("2", 1e-6))
                for name, a, b in zip(fields, p1["v" + v][:4], walk[:4])] + [
        ("v1 against v2", "phase 2 dsum", p2["v1"][0], p2["v2"][0], 1e-6)]
    for which, name, a, b, tol in pairs_v1:
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        same = bits_equal(a, b)
        print(f"rigid kernel check: {which}, {name}: {'identical' if same else f'max|err| {err:.3e} / scale {scale:.3e}'} "
              f"[identical{f', or {tol:g} x scale' if tol else ''}]")
        if not (same or err <= tol * scale):
            failures.append(f"{which} {name}")
    if failures:
        _fail(f"the v2 and v1 kernels disagree: {failures}")
    return errors, dict(lam=lam, ncnt=ncnt, xng=xng, lng=lng, in_radius1=int(p1["v2"][5]),
                        in_radius2=int(p2["v2"][2]))


BACKEND_PAIRS = (("v2", "v3", 1e-4, 1e-4), ("v1", "v3", 1e-4, 1e-4), ("v1", "v2", 1e-6, 1e-6))


def _tick_gap(got, ref, alive):
    """Two ``project_iterations_dense`` results: the largest |estimate|
    difference in scaled units, the force's largest difference, the force's
    scale (ref's largest |force|), and whether every iteration's sum of
    in-radius counts is the same (a sum of integers, so exact)."""
    (sg, dg), (sr, dr) = got, ref
    return (float((sg.estimate_xyz - sr.estimate_xyz)[alive].abs().max()),
            float((sg.force - sr.force)[alive].abs().max()), float(sr.force[alive].abs().max()),
            torch.equal(dg["neighbors"], dr["neighbors"]))


def compare_backends(params, state0):
    """One grid-reuse tick (``project_iterations_dense``, RIGID_ITERS
    iterations, counts + 1 each) from the guessed state through the v3, v2
    and v1 passes, each run with the launch counts set to 0 just before it
    and read just after (RIGID_ITERS launches of its two kernels, no other),
    held as BACKEND_PAIRS says: the estimates within 1e-4 scaled units and
    the force within 1e-4 of its scale of v3's; v1 identical to v2, or within
    1e-6. Then ``backend_steps``. Returns the v1 run's launch counts:
    ``backend="v1"`` is the path of the v1 kernels.

    Each update is divided by n_i + counts, n_i the in-radius count d2 <= h^2.
    v3 folds lambda and the update into its kernels and rounds otherwise than
    v2 and v1, so after a few iterations a pair whose d2 lies within a
    rounding of h^2 can count for one and not the other, and its particles
    then move by up to |delta| / (n_i + counts) apart (a chip run of
    ``python3 chip_smoke.py tick-flips`` counts how often), and the force,
    which reads the positions through the density, follows. Where a pair
    against v3 has its in-radius sums differ, its end-of-tick estimates and
    force are printed and not held; ``backend_steps`` holds it in every run."""
    from fluidnexus_torch.sim.pbf import guess_hidden
    from fluidnexus_torch.sim.pbf_dense import project_iterations_dense

    state = guess_hidden(state0, params)
    torch.cuda.synchronize()
    out, launches = {}, {}
    for b, names in (("v3", ("pbf_phase1", "pbf_phase2")),
                     ("v2", ("pbf_phase1_v2", "pbf_phase2_v2")),
                     ("v1", ("pbf_phase1_v1", "pbf_phase2_v1"))):
        reset_all_launches()
        out[b] = project_iterations_dense(state, params, RIGID_ITERS, counts_step=1.0, backend=b)
        launches[b] = all_launches()
        want = {n: RIGID_ITERS for n in names}
        if any(v != want.get(n, 0) for n, v in launches[b].items()):
            _fail(f"the {b} tick launched the kernels {launches[b]}, expected {want} and no other")
    print(f"tick backends: each of v3, v2 and v1 launched its two kernels {RIGID_ITERS} times "
          f"and no other kernel")
    failures = []
    for b, ref, pos_tol, f_tol in BACKEND_PAIRS:
        dx, df, f_scale, same_counts = _tick_gap(out[b], out[ref], state.alive)
        held = same_counts or ref != "v3"
        print(f"tick backends: {b} against {ref}: max|d estimate| {dx:.3e} scaled units "
              f"[tol {pos_tol:g}], max|d force| {df:.3e} / scale {f_scale:.3e} [tol {f_tol:g} x "
              f"scale]" + ("" if held else "; not held: the in-radius sums differ, a pair "
                           "crossed d2 = h^2"))
        if held and not (dx <= pos_tol and df <= f_tol * f_scale):
            failures.append(f"{b} against {ref}")
    failures += backend_steps(params, state)
    if failures:
        _fail(f"the tick's backends disagree: {failures}")
    return launches["v1"]


def backend_steps(params, state):
    """The v3, v2 and v1 passes held one iteration at a time on shared
    inputs: RIGID_ITERS one-iteration ticks (the grid built from the shared
    state, counts + 1 each), each from v3's state after the last, held as
    BACKEND_PAIRS says, with every in-radius sum the same. From one input
    the backends form the same d2, so no pair can count for one and not
    another. Returns the pairs that failed."""
    from fluidnexus_torch.sim.pbf_dense import BACKENDS, project_iterations_dense

    worst = {(b, ref): [0.0, 0.0, True] for b, ref, _, _ in BACKEND_PAIRS}
    for _ in range(RIGID_ITERS):
        out = {b: project_iterations_dense(state, params, 1, counts_step=1.0, backend=b)
               for b in BACKENDS}
        for b, ref, _, _ in BACKEND_PAIRS:
            dx, df, f_scale, same_counts = _tick_gap(out[b], out[ref], state.alive)
            w = worst[(b, ref)]
            w[0], w[1], w[2] = max(w[0], dx), max(w[1], df / max(f_scale, 1e-30)), \
                w[2] and same_counts
        state = out["v3"][0]
    failures = []
    for b, ref, pos_tol, f_tol in BACKEND_PAIRS:
        dx, df_rel, same_counts = worst[(b, ref)]
        ok = dx <= pos_tol and df_rel <= f_tol and same_counts
        print(f"tick backends, {RIGID_ITERS} single iterations on shared inputs: {b} against "
              f"{ref}: max|d estimate| {dx:.3e} scaled units [tol {pos_tol:g}], max|d force| / "
              f"scale {df_rel:.3e} [tol {f_tol:g}], in-radius sums "
              f"{'the same' if same_counts else 'DIFFER'}" + ("" if ok else " FAILED"))
        if not ok:
            failures.append(f"{b} against {ref}, single iterations")
    return failures


def time_rigid_kernels(inp, saved):
    """Each v2 and v1 kernel's device time, its plain version's time and its
    bound at the first rigid iteration's inputs, and the v1 pre-gathers
    timed apart. No single PyTorch call computes these pair sums."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    nbr, cnt, xyz = inp["nbr"], inp["cnt"], inp["xyz"]
    lam, ncnt, xng, lng = saved["lam"], saved["ncnt"], saved["xng"], saved["lng"]
    g1 = cuda_ms(lambda: pc.gather_v1(nbr, cnt, *xyz), iters=20)
    g2 = cuda_ms(lambda: pc.gather_lam_v1(nbr, lam), iters=20)
    plans = v2_v1_plans(inp, saved)
    print(f"rigid bounds: {inp['pairs']} live candidate pairs, {saved['in_radius1']} in radius "
          f"(self included), {saved['in_radius2']} non-self in radius; "
          f"{plans['pbf_phase1_v2'][4]} and {plans['pbf_phase2_v2'][4]} f32 operations. The v1 "
          f"pre-gather (plain torch, all {nbr.shape[0]} rows): coordinates {g1:.4f} ms, lambdas "
          f"{g2:.4f} ms; {xng.numel() * 4} + {lng.numel() * 4} bytes; the v1 kernels read "
          f"{int(ncnt[cnt[:ncnt.shape[0]] > 0].sum())} live entries of the {inp['rows']} occupied "
          f"rows' {inp['rows'] * 27 * xyz[0].shape[1]} gathered neighbour slots")
    out = {}
    for name, (fn, plain, args, nbytes, ops) in plans.items():
        ms, recorded = kernel_device_ms(lambda: fn(*args), FUTURE_KERNELS[name][1])
        call_ms = cuda_ms(lambda: fn(*args), iters=50)
        plain_ms = cuda_ms(lambda: plain(*args), iters=3)
        out[name] = dict(ms=ms, recorded=recorded, call_ms=call_ms, plain_ms=plain_ms,
                         bound=bound_ms(nbytes, ops), nbytes=nbytes, ops=ops)
    return out


def small_future_check(dev):
    """Stage 4 at a small size through the kernels and through the plain CPU
    path from one checkpoint: a 300-point hidden cloud and 150 visual
    particles, 3 future frames at 160 x 96 with wind and a small cylinder
    from the second frame on, and 3 rigid ticks. Alive counts exactly,
    p_ratio 1e-4 relative, positions within 1e-4 scaled units."""
    import dataclasses

    from fluidnexus_torch.core.config import Config
    from fluidnexus_torch.pipelines.future_simulation import predict
    from fluidnexus_torch.pipelines.train_physical_particle import pbf_params_from_config
    from fluidnexus_torch.sim.pbf import RigidSpec, create_rigid_body
    from fluidnexus_torch.sim.state import make_particle_state, make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, save_hidden, save_visual

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 3)
    cfg = Config()
    o, m = cfg.optim, cfg.model
    m.hidden_capacity, m.visual_capacity = 1024, 512
    o.future_pred_frames, o.solver_iterations_future = 3, 3
    o.p0_future, o.decay_frames_future_p0 = 1.2, 2
    o.alpha, o.emit_ratio_hidden, o.emit_ratio_visual, o.init_hidden_velocity = 0.0, 1.0, 1.0, 100.0
    o.wind_since, o.wind_force = 3, [35.0, 0.0, 0.0]
    o.rigid_since, o.rigid_body, o.rigid_body_center = 3, "cylinder", [0.326, 0.08, -0.3]
    o.rigid_cylinder_radius, o.rigid_cylinder_num = 2.0, [16, 8]
    cfg.pipe.tile_capacity, cfg.pipe.chunk = 128, 32
    params = pbf_params_from_config(cfg)
    with tempfile.TemporaryDirectory(prefix="fnx_small_future_") as tmp:
        m.load_path = os.path.join(tmp, "recon")
        base = np.array([32.6, 7.0, -30.0], np.float32)
        st = make_particle_state(256, rng.uniform(-3, 3, (100, 3)).astype(np.float32) + base,
                                 init_velocity_y=50.0, device=cpu)
        vis = make_visual_state(128, rng.uniform(-3, 3, (60, 3)).astype(np.float32) + base,
                                device=cpu)
        save_hidden(st, params, os.path.join(m.load_path, "checkpoint"), 1)
        save_visual(vis, constant_visual_attrs(128, 1, device=cpu),
                    os.path.join(m.load_path, "checkpoint"), 1)
        scene = smoke_scene(width=160, height=96, n_frames=2)
        runs = {}
        for name, device in (("cpu", cpu), ("card", dev)):
            m.model_path = os.path.join(tmp, name)
            frames = predict(cfg, scene, log=lambda *a: None, bg=None, device=device)
            last = np.load(os.path.join(m.model_path, "checkpoint", "frame_004_xyz.npy"))
            runs[name] = (frames, last * params.scale_factor)
    (f_cpu, x_cpu), (f_dev, x_dev) = runs["cpu"], runs["card"]
    counts_same = all((a["hidden"], a["visual"], a["killed"], a["rigid_hidden"], a["rigid_visual"])
                      == (b["hidden"], b["visual"], b["killed"], b["rigid_hidden"], b["rigid_visual"])
                      for a, b in zip(f_cpu, f_dev))
    dp = max(abs(a["p_ratio"] - b["p_ratio"]) / abs(a["p_ratio"]) for a, b in zip(f_cpu, f_dev))
    dx = float(np.abs(x_dev - x_cpu).max()) if x_dev.shape == x_cpu.shape else float("inf")
    print(f"small future, card vs plain CPU path: counts identical {counts_same} "
          f"({[(f['hidden'], f['visual'], f['rigid_hidden'], f['rigid_visual']) for f in f_cpu]}), "
          f"p_ratio rel {dp:.3e} [tol 1e-4], max|dxyz| {dx:.3e} scaled units [tol 1e-4]")
    if not (counts_same and dp <= 1e-4 and dx <= 1e-4):
        _fail("stage 4 on the card disagrees with the plain CPU path")
    if not any(f["rigid_hidden"] > 0 and f["rigid_visual"] > 0 for f in f_dev):
        _fail("in the small future run the cylinder moved no hidden and visual particle in "
              "one frame")

    # the rigid rollout alone: 3 ticks of 3 iterations over a cloud the
    # push-out puts no two points into one place in (such a pair carries a
    # spiky coefficient of ~s45 h^2 / sqrt(eps), and its rounding noise would
    # be the comparison's)
    rng = np.random.default_rng(SEED + 3)
    pts = (rng.uniform(-2.5, 2.5, (400, 3)) + np.array([32.0, 10.0, -30.0])).astype(np.float32)
    p_small = dataclasses.replace(params, h=1.0, dense_max_cells=512, dense_cell_capacity=32)
    spec = RigidSpec(kind="cylinder", center=(0.32, 0.1, -0.3), cylinder_radius=0.7,
                     cylinder_num=(24, 6), particle_radius=0.15)

    def rollout(device):
        state = make_particle_state(800, pts, init_velocity_y=10.0, device=device)
        visual = make_visual_state(256, pts[:200] + 0.3, device=device)
        rb = create_rigid_body(spec, np.random.default_rng(0), device=device)
        for _ in range(3):
            state, visual, _ = rigid_tick(p_small, state, visual, rb, iterations=3)
        return state, visual

    s_cpu, v_cpu = rollout(cpu)
    s_dev, v_dev = rollout(dev)
    same = bool((s_dev.alive.cpu() == s_cpu.alive).all())
    dx = max(float((s_dev.xyz.cpu() - s_cpu.xyz)[s_cpu.alive].abs().max()),
             float((v_dev.xyz.cpu() - v_cpu.xyz)[v_cpu.alive].abs().max()))
    print(f"small rigid rollout, card vs plain CPU path: masks identical {same}, max|dxyz| "
          f"{dx:.3e} scaled units [tol 1e-4]")
    if not (same and dx <= 1e-4):
        _fail("the rigid rollout on the card disagrees with the plain CPU path")


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
    scene = smoke_scene(width=160, height=96, n_frames=1)
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


# ---------------------------------- video ------------------------------------

VIDEO_STEPS = 4               # --num_steps, cut from the CLI's 50
VIDEO_FRAMES = 49             # sample_video's default clip, 13 latents
# blocks of the 5B DiT's 42 in the default run's video, video_train, refine
# and text_data phases: the width, the token counts and so every attention
# kernel's shape stay the 5B clip's; the single-phase commands run all 42
SMOKE_DIT_LAYERS = 6
VIDEO_PAIRS = ((0, 0), (0, 47), (1, 13), (1, 47))   # (b, h) held against the plain version
RAGGED_S = (1, 47, 64, 65, 127, 128, 129, 777, 2274)   # 127-129 about the 128-row tiles
# bf16 output and bf16 P each round to 2^-9 of a value: a weight that
# dominates its row carries P's rounding straight into the output, so the
# error reaches ~4e-3 of max|ref| there; f32 is held to 1e-5 of max|ref|
BF16_MAX_TOL, BF16_MEAN_TOL, F32_TOL = 1e-2, 2e-3, 1e-5
# the backward in f32: dK and dV sum over every query, dQ over every key, and
# dS = P (dP - D) cancels, so its error is held to 2e-5 of each output's own
# max|ref| (the bf16 limits as for the forward, P and dS rounded to bf16)
BWD_F32_TOL = 2e-5
LSE_TOL = 1e-5                # of max(1, max|ref|)
LOW_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}   # the every-logit-near--150 case


def attention_errors(out, ref):
    err = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    return float(err.max()), float(err.mean()), scale


def attention_ok(dtype, emax, emean, scale):
    if dtype == torch.float32:
        return emax <= F32_TOL * scale
    return emax <= BF16_MAX_TOL * scale and emean <= BF16_MEAN_TOL * scale


def bwd_errors(grads, refs):
    """Per output (dq, dk, dv): (max|err|, mean|err|, scale), the scale that
    output's max|ref|, floored at 1e-3 of the largest output's: dq and dk
    are exactly 0 where the softmax has one key (s = 1)."""
    errs = [attention_errors(g, r) for g, r in zip(grads, refs)]
    floor = 1e-3 * max(e[2] for e in errs)
    return [(e[0], e[1], max(e[2], floor)) for e in errs]


def bwd_ok(dtype, errs):
    if dtype == torch.float32:
        return all(e[0] <= BWD_F32_TOL * e[2] for e in errs)
    return all(e[0] <= BF16_MAX_TOL * e[2] and e[1] <= BF16_MEAN_TOL * e[2] for e in errs)


def _ragged_inputs(gen, dev, dtype, s, d, shift=0.0):
    q, k, v = (torch.randn((2, 3, s, d), generator=gen, device=dev) for _ in range(3))
    q, k = q + shift, k - shift
    dout = torch.randn((2, s, 3, d), generator=gen, device=dev)
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    v_view = torch.cat([q, k, v], -1).transpose(1, 2).contiguous()[..., 2 * d:].transpose(1, 2)
    return q, k, v, v_view, dout


def bwd_from_o(q, k, v, o, dout):
    """dq, dk, dv ``(b, h, s, d)`` by the backward's formulas in f64, with
    D = rowsum(dO o) taken from the ``o`` given ``(b, s, h, d)``: the plain
    backward fed the O that the kernels are handed, where ``attention_bwd_plain``
    recomputes O in f32."""
    qd, kd, vd = (x.double() for x in (q, k, v))
    od, dod = (x.double().transpose(1, 2) for x in (o, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(qd @ kd.transpose(-1, -2) * scale, -1)
    ds = p * (dod @ vd.transpose(-1, -2) - (dod * od).sum(-1, keepdim=True))
    return ds @ kd * scale, ds.transpose(-1, -2) @ qd * scale, p.transpose(-1, -2) @ dod


def low_logit_witness(gen, dev):
    """The bf16 backward at s = 65 with every logit near -150 and near -500,
    read (not held) against the plain backward (O recomputed in f32) and
    against ``bwd_from_o`` fed the kernels' own bf16 O: where the second is
    much the smaller, the first's excess is the rounding of O in D, not the
    kernels'."""
    from fluidnexus_torch.ops import attention_cuda as ac

    rows = []
    for d in (16, 64, 128):
        for logit in (150.0, 500.0):
            q, k, v, v_view, dout = _ragged_inputs(gen, dev, torch.bfloat16, 65, d,
                                                   math.sqrt(logit / math.sqrt(d)))
            out, lse = ac.attention_fwd(q, k, v_view, lse=True)
            grads = ac.attention_bwd(q, k, v_view, out, lse, dout)
            worst = [max(e[0] / e[2] for e in bwd_errors(grads, refs)) for refs in
                     (ac.attention_bwd_plain(q, k, v, dout), bwd_from_o(q, k, v, out, dout))]
            rows.append(f"d{d} -{logit:.0f}: {worst[0]:.2e} / {worst[1]:.2e}")
    print("attention bf16 backward at s = 65, logits near -150 and -500: worst max|err| / "
          "max|ref| over dq, dk, dv against the plain backward (O in f32) / against the "
          "formulas fed the kernels' bf16 O: " + ", ".join(rows))


def check_attention_ragged(dev):
    """The forward kernels, their row log-sum-exp and the backward kernels
    against their plain versions at ragged sequence lengths, each head_dim the
    DiT configs use and one more, in both types; v a strided view of a (b,
    s, h, 3d) projection, as in the DiT. bf16 at d = 64 goes through the
    Hopper kernels, forward and backward (``attention_fwd``'s and
    ``attention_bwd``'s own choice, checked by the launch counts), and the
    mma.sync kernels are held there too (forward and LSE through
    ``_attention_fwd_mma_sync``, the backward pair through
    ``_attention_bwd_mma_sync``); the backward is fed the Hopper kernel's O
    and LSE. Each gradient is held at a fraction of its own max|ref|. At 2 274 keys the f32 kernels are also read against an f64
    plain version. One more case per type and head_dim, at s = 65, has every
    logit near -150 (q + c, k - c): a pad key's P = exp(0 - lse) overflows
    there, and an unmasked one turns dQ into NaN (and takes weight 1 against
    2^-216 in O). Its values carry f32's rounding at that magnitude (~1e-5
    of a logit) and peaked softmaxes, so it is held to LOW_TOL, which a NaN
    fails."""
    from fluidnexus_torch.ops import attention_cuda as ac

    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures, worst, worst_bwd, worst_low, lse_worst, f64 = [], {}, {}, {}, 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for d in (16, 64, 128):
            wgmma = ac.takes_wgmma(dtype, d)
            for s, low in [(s, False) for s in RAGGED_S] + [(65, True)]:
                shift = math.sqrt(150.0 / math.sqrt(d)) if low else 0.0
                q, k, v, v_view, dout = _ragged_inputs(gen, dev, dtype, s, d, shift)
                before = dict(ac.LAUNCHES)
                out, lse = ac.attention_fwd(q, k, v_view, lse=True)
                grads = ac.attention_bwd(q, k, v_view, out, lse, dout)
                ran = {n: ac.LAUNCHES[n] - before[n] for n in ac.LAUNCHES}
                want = {"attention_fwd": 1, "attention_fwd_wgmma": int(wgmma),
                        "attention_bwd_wgmma": int(wgmma), "attention_dq": 1 - int(wgmma),
                        "attention_dkv": 1 - int(wgmma)}
                if ran != want:
                    failures.append(("kernel choice", dtype, d, ran))
                ref = ac.attention_plain(q, k, v)
                fwd = attention_errors(out, ref)
                bwd_refs = ac.attention_bwd_plain(q, k, v, dout)
                errs = bwd_errors(grads, bwd_refs)
                key = (str(dtype).split(".")[-1] + (" wgmma" if wgmma else ""), d)
                # the mma.sync kernels where the Hopper kernels serve: (key, O,
                # LSE) and (key, the pair's errors, its gradients)
                outs, pairs = [(key, out, lse)], []
                if wgmma:
                    k_m = ("bfloat16 mma.sync", d)
                    outs.append((k_m, *ac._attention_fwd_mma_sync(q, k, v_view, lse=True)))
                    g_m = ac._attention_bwd_mma_sync(q, k, v_view, out, lse, dout)
                    pairs.append((k_m, bwd_errors(g_m, bwd_refs), g_m))
                if low:
                    finite = all(bool(torch.isfinite(g).all()) for g in grads)
                    worst_low[key] = (max(e[0] / e[2] for e in [fwd] + errs) if finite
                                      else float("nan"))
                    if not (finite and worst_low[key] <= LOW_TOL[dtype]):
                        failures.append(("low logits", key, finite, fwd, errs))
                    for k_o, o_o, _ in outs[1:]:
                        e = attention_errors(o_o, ref)
                        worst_low[k_o] = e[0] / e[2] if bool(torch.isfinite(o_o).all()) else float("nan")
                        if not worst_low[k_o] <= LOW_TOL[dtype]:
                            failures.append(("low logits", k_o, e))
                    for k_m, e_m, g_m in pairs:
                        finite = all(bool(torch.isfinite(g).all()) for g in g_m)
                        worst_low[k_m] = (max([worst_low[k_m]] + [e[0] / e[2] for e in e_m])
                                          if finite else float("nan"))
                        if not worst_low[k_m] <= LOW_TOL[dtype]:
                            failures.append(("low logits", k_m, finite, e_m))
                    continue
                lse_ref = ac.attention_lse_plain(q, k)
                for k_o, o_o, l_o in outs:
                    e = attention_errors(o_o, ref)
                    worst[k_o] = max(worst.get(k_o, 0.0), e[0] / e[2])
                    if not attention_ok(dtype, *e):
                        failures.append(("fwd", k_o, s, e))
                    lse_err = float((l_o - lse_ref).abs().max()) / max(1.0, float(lse_ref.abs().max()))
                    lse_worst = max(lse_worst, lse_err)
                    if lse_err > LSE_TOL:
                        failures.append(("lse", k_o, s, lse_err))
                for k_b, e_b in [(key, errs)] + [(k_m, e_m) for k_m, e_m, _ in pairs]:
                    worst_bwd[k_b] = max([worst_bwd.get(k_b, 0.0)] + [e[0] / e[2] for e in e_b])
                    if not bwd_ok(dtype, e_b):
                        failures.append(("bwd", k_b, s, e_b))
                if dtype == torch.float32 and s == 2274:
                    e64 = bwd_errors(grads, ac.attention_bwd_plain(q, k, v, dout, torch.float64))
                    o64 = attention_errors(out, ac.attention_plain(q.double(), k.double(),
                                                                   v.double()))
                    f64.append((d, o64[0] / o64[2], [e[0] / e[2] for e in errs],
                                [e[0] / e[2] for e in e64]))
    torch.cuda.synchronize()
    print("attention ragged check, s in " + str(RAGGED_S) + ": forward worst max|err| / max|ref| "
          + ", ".join(f"{t} d{d} {r:.2e}" for (t, d), r in worst.items())
          + f" [tol bf16 max {BF16_MAX_TOL:g} mean {BF16_MEAN_TOL:g}, f32 {F32_TOL:g}]; "
          f"row log-sum-exp worst |err| / max(1, max|ref|) {lse_worst:.2e} [tol {LSE_TOL:g}]")
    print("attention backward ragged check: worst max|err| / max|ref| over dq, dk, dv "
          + ", ".join(f"{t} d{d} {r:.2e}" for (t, d), r in worst_bwd.items())
          + f" [tol bf16 max {BF16_MAX_TOL:g} mean {BF16_MEAN_TOL:g}, f32 {BWD_F32_TOL:g}]")
    print("attention at s = 65 with every logit near -150: worst max|err| / max|ref| over o, "
          "dq, dk, dv (nan: a gradient not finite) "
          + ", ".join(f"{t} d{d} {r:.2e}" for (t, d), r in worst_low.items())
          + f" [tol bf16 {LOW_TOL[torch.bfloat16]:g}, f32 {LOW_TOL[torch.float32]:g}]")
    for d, o64, e32, e64 in f64:
        print(f"attention f32 at 2 274 keys, d {d}: forward against f64 {o64:.2e}; dq, dk, dv "
              f"against the f32 plain version {', '.join(f'{e:.2e}' for e in e32)}, against "
              f"f64 {', '.join(f'{e:.2e}' for e in e64)} (max|err| / max|ref|)")
    low_logit_witness(gen, dev)
    if failures:
        _fail(f"the attention kernels disagree with their plain versions: {failures[:6]}")


def run_video(dev, out_folder):
    """The video DiT sampling path through ``sample_video.main`` at its
    defaults (CogVideoX-5B, 49 x 480 x 720, 17 776 tokens, batch-2 CFG,
    hash text) with ``--num_steps`` cut to 4: launch counts, ms per sampler
    step, the VAE decode, peak memory, PNGs (every forward on the Hopper
    kernel); the forward kernels against the plain version at layer 0's
    inputs of the first step (the Hopper and the mma.sync kernel in bf16, the
    f32 kernel on a few pairs in f32) and at ragged shapes; their times
    beside the library's; the small card-vs-CPU sampling. Returns the two
    forward kernels' entries of the ``kernels`` line: the Hopper kernel's,
    with the mma.sync bf16 kernel's time beside it, and the f32 kernel's."""
    import time

    import torch.nn.functional as F

    from fluidnexus_torch.diffusion.video import dit as dit_mod
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.pipelines import sample_video

    check_attention_ragged(dev)
    argv = ["--prompt", "smoke rising past a cylinder", "--out_folder", out_folder,
            "--num_steps", str(VIDEO_STEPS), "--allow_fake_conditioning"]
    cfg = sample_video.configs(VIDEO_FRAMES, 480, 720, tiny=False)[0]
    n_layers = cfg.num_layers
    print(f"video: sample_video.main({argv}) at its defaults: the CogVideoX-5B DiT (hidden "
          f"{cfg.hidden_size}, {n_layers} layers, {cfg.num_heads} heads of {cfg.head_dim}) on "
          f"seeded random weights, {VIDEO_FRAMES} frames at 480 x 720, hash text, batch-2 CFG; "
          f"cut: --num_steps {VIDEO_STEPS} (the CLI runs 50), the PNGs go to a temporary folder")

    # layer 0's attention inputs of the first step, and an event at the
    # start of every DiT forward and around the decode
    captured, steps, decode = {}, [], []
    real_attn, real_apply, real_decode = (dit_mod.joint_attention, VideoEngine.dit_apply,
                                          VideoEngine.decode_first_stage)

    def recording_attn(q, k, v):
        if not captured:
            captured.update(q=q, k=k, v=v)
        return real_attn(q, k, v)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed_apply(self, *a):
        steps.append(event())
        return real_apply(self, *a)

    def timed_decode(self, *a, **kw):
        decode.append(event())
        out = real_decode(self, *a, **kw)
        decode.append(event())
        return out

    dit_mod.joint_attention = recording_attn
    VideoEngine.dit_apply, VideoEngine.decode_first_stage = timed_apply, timed_decode
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        decoded = sample_video.main(argv, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
    finally:
        dit_mod.joint_attention = real_attn
        VideoEngine.dit_apply, VideoEngine.decode_first_stage = real_apply, real_decode
    peak = torch.cuda.max_memory_allocated()
    q, k, v = captured["q"], captured["k"], captured["v"]
    b, h, s, d = q.shape
    step_ms = [a.elapsed_time(z) for a, z in zip(steps, steps[1:] + decode[:1])]
    decode_ms = decode[0].elapsed_time(decode[1])
    pngs = sorted(os.listdir(out_folder))
    print(f"video: q/k/v at layer 0 of step 1: {tuple(q.shape)} {q.dtype} ({s} tokens = 226 text "
          f"+ {s - 226} video); v strides {v.stride()}")
    print(f"video: launches {launches}; ms per sampler step "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} (median {statistics.median(step_ms):.1f}); "
          f"VAE decode 13 latents -> {decoded.shape[1]} frames (chunks 3 + 2 x 5, f32, TF32 "
          f"off) {decode_ms:.1f} ms; main end to end {seconds:.2f} s; peak allocated "
          f"{peak / 2**30:.2f} GiB; {len(pngs)} PNGs")
    # every forward of the path on the Hopper kernel (bf16, head_dim 64)
    want = {"attention_fwd": n_layers * VIDEO_STEPS, "attention_fwd_wgmma": n_layers * VIDEO_STEPS}
    idle = [n for n, c in launches.items() if n not in want and c]
    if any(launches[n] != c for n, c in want.items()) or idle:
        _fail(f"sample_video launched {launches}, expected {want} and no other kernel")
    if len(steps) != VIDEO_STEPS or len(decode) != 2:
        _fail(f"expected {VIDEO_STEPS} DiT forwards and one decode, saw {len(steps)} and "
              f"{len(decode) // 2}")
    if tuple(decoded.shape) != (1, VIDEO_FRAMES, 480, 720, 3) or not torch.isfinite(decoded).all():
        _fail(f"the decoded clip is not finite (1, {VIDEO_FRAMES}, 480, 720, 3): "
              f"{tuple(decoded.shape)}")
    if len(pngs) != VIDEO_FRAMES:
        _fail(f"sample_video wrote {len(pngs)} PNGs, expected {VIDEO_FRAMES}")

    # ---- the kernels at the main path's own inputs, then their times: the
    # Hopper kernel that the path runs, and the mma.sync kernel beside it
    with torch.inference_mode():
        errs = {}
        for name, fwd in (("wgmma", ac.attention_fwd), ("mma.sync", ac._attention_fwd_mma_sync)):
            out = fwd(q, k, v)
            errs[name] = []
            for bi, hi in VIDEO_PAIRS:
                sl = (slice(bi, bi + 1), slice(hi, hi + 1))
                errs[name].append(attention_errors(out[bi:bi + 1, :, hi:hi + 1],
                                                   ac.attention_plain(q[sl], k[sl], v[sl])))
            torch.cuda.synchronize()
            del out
            print(f"video: attention ({name} kernel) at layer 0's inputs, (b, h) "
                  + str(VIDEO_PAIRS) + ": max|err| "
                  + ", ".join(f"{e[0]:.3e}" for e in errs[name]) + "; mean|err| "
                  + ", ".join(f"{e[1]:.3e}" for e in errs[name]) + "; max|ref| "
                  + ", ".join(f"{e[2]:.3e}" for e in errs[name])
                  + f" [tol max {BF16_MAX_TOL:g}, mean {BF16_MEAN_TOL:g} x max|ref|]")
            if not all(attention_ok(q.dtype, *e) for e in errs[name]):
                _fail(f"the {name} attention kernel disagrees with its plain version at layer "
                      f"0's inputs")
        # the same pairs' inputs in f32, through the f32 instantiation: bf16's
        # rounding hides a fault that shrinks every output by ~5e-4, as the
        # ragged last key tile left unmasked does here (16 pad keys that score
        # 0 against 17 776 logits of spread ~1); f32 at 1e-5 of max|ref| does not
        errs32 = []
        for bi, hi in VIDEO_PAIRS:
            q32, k32, v32 = (x[bi:bi + 1, hi:hi + 1].float() for x in (q, k, v))
            errs32.append(attention_errors(ac.attention_fwd(q32, k32, v32),
                                           ac.attention_plain(q32, k32, v32)))
        torch.cuda.synchronize()
        print("video: attention at layer 0's inputs in f32, the same pairs: max|err| / max|ref| "
              + ", ".join(f"{e[0] / e[2]:.3e}" for e in errs32) + f" [tol {F32_TOL:g}]")
        if not all(attention_ok(torch.float32, *e) for e in errs32):
            _fail("the f32 attention kernel disagrees with its plain version at layer 0's inputs")

        # tens of ms a launch: the wrapper's host work hides under the
        # device's, so CUDA events time the two kernels and the library alike
        # (the profiler's records of them were dropped: 15 of 20 in five
        # windows on the H100)
        ms = cuda_ms(lambda: ac.attention_fwd(q, k, v), iters=20)
        ms_mma = cuda_ms(lambda: ac._attention_fwd_mma_sync(q, k, v), iters=20)
        sl = (slice(0, 1), slice(0, 1))
        plain_ms = cuda_ms(lambda: ac.attention_plain(q[sl], k[sl], v[sl]), iters=3,
                           warmup=1) * b * h
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc), iters=10)
    flops = 4 * b * h * s * s * d
    b_ms, b_by = bound_ms(2 * 4 * b * h * s * d, flops, peak=H100_BF16_TC_FLOPS)
    exp_ms = b * h * s * s / H100_EXP_PER_S * 1e3
    print(f"attention_fwd_wgmma (the Hopper kernel, TMA + wgmma): {ms:.3f} ms (CUDA events over "
          f"20 calls; {flops / ms / 1e9:.1f} TFLOP/s); the mma.sync kernel at the same "
          f"inputs {ms_mma:.3f} ms ({flops / ms_mma / 1e9:.1f} TFLOP/s), "
          f"{ms_mma / ms:.2f}x the Hopper kernel's time; bound {b_ms:.3f} ms by {b_by} (bf16 "
          f"tensor cores; the {b * h * s * s:.3g} exponentials alone {exp_ms:.3f} ms), plain "
          f"{plain_ms:.1f} ms (one (b, h) pair x {b * h}), scaled_dot_product_attention "
          f"{library_ms:.3f} ms ({library_ms / ms:.2f}x the Hopper kernel's time); {n_layers} "
          f"launches per sampler step: {n_layers * ms:.0f} ms of the median step's "
          f"{statistics.median(step_ms):.0f}")
    # the mma.sync bf16 kernel runs on no path: its time is a yardstick of
    # the Hopper kernel's entry, not an entry of its own
    hopper = {"name": "attention_fwd_wgmma", "route": "cuda",
              "source": "fluidnexus_torch/csrc/attention.cu",
              "replaces": "fluidnexus_tpu/diffusion/video/dit.py:213",
              "launches": launches["attention_fwd_wgmma"],
              "max_abs_err": max(e[0] for e in errs["wgmma"]), "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "mma_sync_ms": ms_mma}
    return [hopper, small_video_check(dev)]


def _random_weights(module, seed):
    """Every parameter drawn from numpy: 2-D and larger weights normal /
    sqrt(fan_in), norm scales 1 + 0.1 normal, the rest (biases, LN biases)
    0.1 normal; the adaLN projections included, so the block gates are not 0."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                x = rng.normal(size=p.shape) / np.sqrt(np.prod(p.shape[1:]))
            elif name.endswith("scale"):
                x = 1.0 + 0.1 * rng.normal(size=p.shape)
            else:
                x = 0.1 * rng.normal(size=p.shape)
            p.copy_(torch.as_tensor(x, dtype=p.dtype))
    return module


def small_video_check(dev):
    """``sample_video --tiny``'s DiT and VAE (hidden 64, 2 layers, 4 heads,
    f32) at 9 frames x 64 x 96 (80 tokens: two key tiles, the last ragged),
    every weight from numpy with a seed: 4 DPM++ steps with one set of noise
    draws (made on the CPU, replayed on the card) and the decode, on the card
    through the f32 kernel and on the CPU through the plain version. Latents
    and frames at 1e-4 of their scale. Returns the ``kernels`` entry of the
    (mma.sync) f32 kernel: the card run's launches, and its error, time and
    bound at that run's first attention inputs."""
    import copy

    import torch.nn.functional as F

    from fluidnexus_torch.diffusion.video import dit as dit_mod
    from fluidnexus_torch.diffusion.video import sampling
    from fluidnexus_torch.diffusion.video.dit import init_video_dit
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.diffusion.video.vae3d import init_vae
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.pipelines.sample_video import configs

    cpu = torch.device("cpu")
    dit_cfg, vae_cfg = configs(9, 64, 96, tiny=True)
    gen = torch.Generator().manual_seed(SEED)
    dit = _random_weights(init_video_dit(dit_cfg, gen), SEED + 5)
    vae = _random_weights(init_vae(vae_cfg, gen), SEED + 6)
    text = torch.as_tensor(np.random.default_rng(SEED + 7).normal(size=(1, 8, 64)), dtype=torch.float32)
    engine = VideoEngine(dit_cfg, vae_cfg)
    shape = (1, 3, 16, 8, 12)
    draws, real = [], sampling._normal

    def recording(shape_, generator, device):
        x = real(shape_, generator, device)
        draws.append(x)
        return x

    def replaying(shape_, generator, device):
        x = draws[len(replayed)]
        replayed.append(x)
        return x.to(device)

    captured, real_attn = {}, dit_mod.joint_attention

    def recording_attn(q, k, v):
        if q.is_cuda and not captured:
            captured.update(q=q, k=k, v=v)
        return real_attn(q, k, v)

    replayed, runs = [], {}
    dit_mod.joint_attention = recording_attn
    try:
        for name, device in (("cpu", cpu), ("card", dev)):
            sampling._normal = recording if name == "cpu" else replaying
            d, v = copy.deepcopy(dit).to(device), copy.deepcopy(vae).to(device)
            ac.reset_launches()
            lat = engine.sample(d, shape, text.to(device), torch.zeros_like(text).to(device),
                                rng=torch.Generator(device=device).manual_seed(SEED),
                                num_steps=VIDEO_STEPS)
            frames = engine.decode_first_stage(v, lat.permute(0, 1, 3, 4, 2))
            runs[name] = (lat.cpu(), frames.cpu(), ac.LAUNCHES["attention_fwd"])
    finally:
        sampling._normal = real
        dit_mod.joint_attention = real_attn
    (l_cpu, f_cpu, n_cpu), (l_dev, f_dev, n_dev) = runs["cpu"], runs["card"]
    dl = float((l_dev - l_cpu).abs().max()) / float(l_cpu.abs().max())
    df = float((f_dev - f_cpu).abs().max()) / float(f_cpu.abs().max())
    print(f"small video, card (f32 kernel, {n_dev} launches) vs plain CPU path ({n_cpu}): "
          f"{len(draws)} noise draws replayed; latents rel {dl:.3e}, frames rel {df:.3e} "
          f"[tol 1e-4]")
    if not (n_cpu == 0 and n_dev == 2 * VIDEO_STEPS and ac.LAUNCHES["attention_fwd_wgmma"] == 0
            and len(replayed) == len(draws) and dl <= 1e-4 and df <= 1e-4):
        _fail("the small video run on the card disagrees with the plain CPU path")

    q, k, v = captured["q"], captured["k"], captured["v"]
    b, h, s, d = q.shape
    with torch.inference_mode():
        err = attention_errors(ac.attention_fwd(q, k, v), ac.attention_plain(q, k, v))
        if not attention_ok(q.dtype, *err):
            _fail(f"the f32 attention kernel disagrees with its plain version at the small "
                  f"run's inputs: max|err| {err[0]:.3e} on max|ref| {err[2]:.3e}")
        ms, recorded = kernel_device_ms(lambda: ac.attention_fwd(q, k, v), "attention_f32_kernel")
        plain_ms = cuda_ms(lambda: ac.attention_plain(q, k, v))
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc))
    b_ms, b_by = bound_ms(4 * 4 * b * h * s * d, 4 * b * h * s * s * d)
    print(f"attention_fwd (the mma.sync f32 kernel) at the small run's {tuple(q.shape)} "
          f"{q.dtype}: max|err| {err[0]:.3e} on max|ref| {err[2]:.3e} [tol {F32_TOL:g} x "
          f"max|ref|]; {ms:.4f} ms ({recorded} launches recorded), bound {b_ms:.6f} ms "
          f"by {b_by} (f32 outside the tensor cores), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms")
    return {"name": "attention_fwd", "route": "cuda", "source": "fluidnexus_torch/csrc/attention.cu",
            "replaces": "fluidnexus_tpu/diffusion/video/dit.py:213", "launches": n_dev,
            "max_abs_err": err[0], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


# ------------------------------ video training -------------------------------

TRAIN_ITERS = 2               # --iterations, cut from the CLI's 10 000 (3 before the
QUANT_ITERS = 1               # parallel phase came, 2 here: an iteration is 21 s)
QUANT_FRAMES = 9              # the --quant_base run's --num_frames (its eval fork decodes them)
EVAL_STEPS = 2                # the eval fork's sampler steps (the CLI's default 20)
LORA_RANK = 128
TRAINABLES_A_BLOCK = 6_291_456   # rank 128 over qkv, out, fc1, fc2 (264 241 152 in 42 blocks)
ADALN_STD = 0.1               # x lecun: gates ~0.1, so attention reaches the loss
LORA_B_STD = 0.01             # / sqrt(rank): the adapters add ~1 % to a projection


def _train_init(real):
    """``VideoEngine.init_params`` with the JAX init's zeros drawn small and
    non-zero: every adaLN projection (ADALN_STD x lecun), lora_b
    (LORA_B_STD / sqrt(rank)) and, under --quant_base, the int8 base (the
    JAX init leaves kernel_q 0): uniform in [-127, 127] with a lecun-std
    scale."""
    from fluidnexus_torch.diffusion.video.dit import LoRADense

    def init(self, generator):
        model = real(self, generator)
        gen = torch.Generator(device=generator.device).manual_seed(SEED + 10)
        with torch.no_grad():
            for name, mod in model.named_modules():
                if not isinstance(mod, LoRADense):
                    continue
                std = ADALN_STD if name.endswith("adaLN") else 1.0
                if mod.quant:
                    fan_in = mod.kernel_q.shape[0]
                    mod.kernel_q.copy_(torch.randint(-127, 128, mod.kernel_q.shape, generator=gen,
                                                     device=mod.kernel_q.device))
                    mod.kernel_scale.fill_(std * math.sqrt(3.0 / fan_in) / 127)
                elif name.endswith("adaLN"):
                    w = torch.empty(mod.weight.shape, device=mod.weight.device)
                    mod.weight.copy_(w.normal_(0.0, std / math.sqrt(mod.weight.shape[1]),
                                               generator=gen))
                if mod.lora_b is not None:
                    mod.lora_b.normal_(0.0, LORA_B_STD / math.sqrt(mod.lora_b.shape[0]),
                                       generator=gen)
        return model

    return init


def write_train_clip(root, frames=49, height=480, width=720):
    """One clip folder of seeded PNGs (blocks of 32 x 32 pixels, written by
    the port's save_image) and its caption."""
    from fluidnexus_torch.pipelines.train_background import save_image

    rng = np.random.default_rng(SEED + 11)
    for i in range(frames):
        low = rng.uniform(0, 1, (3, -(-height // 32), -(-width // 32)))
        img = np.kron(low, np.ones((1, 32, 32)))[:, :height, :width]
        save_image(os.path.join(root, "videos", "clip0", f"frame_{i:06d}.png"), img)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    with open(os.path.join(root, "labels", "clip0.txt"), "w") as f:
        f.write("smoke rising past a cylinder")


def run_train(argv, timer=None):
    """``train_video.train`` with the non-zero init; returns its result,
    the launch counts, seconds, peak memory, the last (trainer, latents,
    text) seen by a step, the step losses, the last attention_bwd inputs and
    the decoded eval clips."""
    import time

    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.pipelines import train_video as ttv

    seen = {"losses": [], "decoded": []}
    real_init, real_step, real_bwd = VideoEngine.init_params, ttv.VideoTrainer.step, ac.attention_bwd
    real_decode = VideoEngine.decode_first_stage

    def step(self, latents, text_emb, rng):
        loss = real_step(self, latents, text_emb, rng)
        seen.update(trainer=self, latents=latents, text=text_emb)
        seen["losses"].append(float(loss))
        return loss

    def bwd(*a):
        seen["bwd"] = tuple(x.detach() for x in a)
        return real_bwd(*a)

    def decode(self, *a, **kw):
        out = real_decode(self, *a, **kw)
        seen["decoded"].append(out)
        return out

    VideoEngine.init_params, ttv.VideoTrainer.step, ac.attention_bwd = (
        _train_init(real_init), step, bwd)
    VideoEngine.decode_first_stage = decode
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = ttv.train(ttv.build_argparser().parse_args(argv), log=print, device="cuda",
                           timer=timer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
    finally:
        VideoEngine.init_params, ttv.VideoTrainer.step, ac.attention_bwd = (
            real_init, real_step, real_bwd)
        VideoEngine.decode_first_stage = real_decode
    return result, launches, seconds, torch.cuda.max_memory_allocated(), seen


def check_train_launches(launches, what, fwd, bwd):
    """Every forward and backward (bf16, head_dim 64) on the Hopper kernels,
    ``fwd`` and ``bwd`` times, and no other kernel: no mma.sync ``dq`` or
    ``dkv``."""
    want = {"attention_fwd": fwd, "attention_fwd_wgmma": fwd, "attention_bwd_wgmma": bwd,
            "attention_dq": 0, "attention_dkv": 0}
    other = [n for n, c in launches.items() if n not in want and c]
    if any(launches[n] != c for n, c in want.items()) or other:
        _fail(f"{what} launched {launches}, expected {want} and no other kernel")


def run_video_train(dev, root):
    """LoRA training of the 5B DiT through ``train_video.train`` (2
    iterations), then 1 iteration with ``--quant_base`` on QUANT_FRAMES
    frames ending in an eval fork: launch counts, trainables, losses, ms per
    step (CUDA events, the last step), the VAE encode, peak memory, the card's
    idle share in one more step; the Hopper backward against the plain backward at
    layer 0's captured inputs (and run twice); its time beside the mma.sync
    pair's and the library's; the small card-vs-CPU training run. Returns the
    ``kernels`` line's entries of the Hopper backward and of the f32 pair
    (``small_video_train_check``)."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.pipelines import sample_video, train_video
    from fluidnexus_torch.utils.profiling import StageTimer

    write_train_clip(root)
    cfg = sample_video.configs(VIDEO_FRAMES, 480, 720, tiny=False)[0]
    n_layers = cfg.num_layers
    base = ["--data_root", root, "--batch", "2", "--lora_rank", str(LORA_RANK),
            "--allow_fake_conditioning", "--log_every", "1", "--fixed_frames", "3"]
    chunk = train_video.build_argparser().get_default("encode_chunk")
    print(f"video training: train_video.train at the CogVideoX-5B geometry (hidden "
          f"{cfg.hidden_size}, {n_layers} layers, {cfg.num_heads} heads of {cfg.head_dim}, text "
          f"{cfg.text_length} x {cfg.text_hidden_size}), batch 2 of one clip of {VIDEO_FRAMES} "
          f"seeded 480 x 720 PNGs, LoRA rank {LORA_RANK}, per-block remat, bf16 base, "
          f"--fixed_frames 3, hash text, the port's default --encode_chunk {chunk} (JAX's 0, the "
          f"whole clip, does not fit); cut: --iterations {TRAIN_ITERS} (of 10 000), then "
          f"{QUANT_ITERS} with --quant_base and an eval fork of {EVAL_STEPS} sampler steps, "
          f"weights from a seed with adaLN and lora_b drawn non-zero")

    # ---- the LoRA run: the main path
    timer = StageTimer()
    (dit, loss, ema), launches, seconds, peak, seen = run_train(
        base + ["--iterations", str(TRAIN_ITERS)], timer)
    trainer = seen["trainer"]
    n_train = sum(p.numel() for p in trainer.params.values())
    step_ms, enc_ms = timer.ms["train_step"], timer.ms["vae_encode"]
    step_med = statistics.median(step_ms[1:])
    print(f"video training: launches {launches}; trainables {n_train}; losses "
          f"{', '.join(f'{x:.5f}' for x in seen['losses'])}; ms per LoRA step "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} (median of steps 2-{TRAIN_ITERS} "
          f"{step_med:.1f}); VAE encode of the batch {', '.join(f'{t:.1f}' for t in enc_ms)} ms; "
          f"train end to end {seconds:.2f} s; peak allocated {peak / 2**30:.2f} GiB")
    check_train_launches(launches, "the LoRA run", 2 * n_layers * TRAIN_ITERS,
                         n_layers * TRAIN_ITERS)
    if n_train != TRAINABLES_A_BLOCK * n_layers:
        _fail(f"{n_train} trainables, expected {TRAINABLES_A_BLOCK * n_layers}")
    lb = trainer.params["block_0.attn.qkv.lora_b"]
    if not (all(math.isfinite(x) for x in seen["losses"]) and math.isfinite(loss)
            and all(bool(torch.isfinite(p).all()) for p in trainer.params.values())
            and all(bool(torch.isfinite(e).all()) for e in trainer.ema.values())):
        _fail("the LoRA run gave a non-finite loss, trainable or EMA leaf")
    if not float(lb.detach().abs().max()) > 0:
        _fail("lora_b did not move")
    cap = seen["bwd"]     # layer 0's attention backward of the last step

    # ---- the card's idle share in one more step on the last batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(seen["latents"], seen["text"], torch.Generator(device=dev).manual_seed(SEED))
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    busy = device_busy_ms(prof)
    ka = prof.key_averages()
    dev_key = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
    print(f"video training, one more LoRA step under torch.profiler: {wall:.1f} ms, the card "
          f"busy {busy:.1f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    print(ka.table(sort_by="self_" + dev_key, row_limit=12))
    del prof, ka, trainer, dit, ema, seen
    torch.cuda.empty_cache()

    # ---- the int8 base, ending in the eval fork
    qtimer = StageTimer()
    (qdit, qloss, _), qlaunches, qseconds, qpeak, qseen = run_train(
        base + ["--iterations", str(QUANT_ITERS), "--quant_base", "--eval_interval",
                str(QUANT_ITERS), "--eval_steps", str(EVAL_STEPS), "--num_frames",
                str(QUANT_FRAMES)], qtimer)
    qstep = qtimer.ms["train_step"]
    print(f"video training --quant_base: launches {qlaunches}; losses "
          f"{', '.join(f'{x:.5f}' for x in qseen['losses'])}; ms per step "
          f"{', '.join(f'{t:.1f}' for t in qstep)} (step 2 {qstep[-1]:.1f}); with the eval fork "
          f"(a loss, {EVAL_STEPS} sampler steps, the decode) train took {qseconds:.2f} s; peak "
          f"allocated {qpeak / 2**30:.2f} GiB")
    # the eval fork: one loss forward and EVAL_STEPS batch-2 CFG forwards, no gradient
    check_train_launches(qlaunches, "the --quant_base run",
                         2 * n_layers * QUANT_ITERS + n_layers * (1 + EVAL_STEPS),
                         n_layers * QUANT_ITERS)
    clips = qseen["decoded"]
    if not (len(clips) == 1 and tuple(clips[0].shape) == (1, QUANT_FRAMES, 480, 720, 3)
            and bool(torch.isfinite(clips[0]).all()) and math.isfinite(qloss)
            and all(math.isfinite(x) for x in qseen["losses"])):
        _fail("the --quant_base run or its eval clip is not finite or of the expected shape")
    del qdit, qseen, clips
    torch.cuda.empty_cache()

    # ---- the backward kernels at layer 0's inputs, then their times
    errs = check_layer0_backward(cap)
    q, k, v, out, lse, dout = cap
    b, h, s, d = q.shape
    with torch.no_grad():
        # tens of ms a launch: CUDA events time the kernel, the pair and the
        # library alike; new, pair, pair, new, since the clock falls under
        # sustained load
        calls = {"wgmma": lambda: ac.attention_bwd(q, k, v, out, lse, dout),
                 "mma.sync": lambda: ac._attention_bwd_mma_sync(q, k, v, out, lse, dout)}
        times = {n: [] for n in calls}
        for name in ("wgmma", "mma.sync", "mma.sync", "wgmma"):
            times[name].append(cuda_ms(calls[name], iters=10))
        ms, ms_mma = statistics.mean(times["wgmma"]), statistics.mean(times["mma.sync"])
        kernel_ms, prep_ms = bwd_kernel_ms(q, k, v, out, lse, dout)
    sl = (slice(0, 1), slice(0, 1))
    plain_ms = cuda_ms(lambda: ac.attention_bwd_plain(q[sl], k[sl], v[sl], dout[:1, :, :1]),
                       iters=2, warmup=1) * b * h
    lib_bwd = sdpa_bwd_ms(q, k, v, dout)
    prod = 2 * b * h * s * s * d
    io = b * h * s * d * 2
    # the gradient's bound: q, k, v, O, dO and the LSE read once, dq, dk, dv
    # written once, the 5 products
    bound = bound_ms(8 * io + 4 * b * h * s, 5 * prod, peak=H100_BF16_TC_FLOPS)
    exp_ms = b * h * s * s / H100_EXP_PER_S * 1e3
    print(f"attention_bwd_wgmma (the Hopper backward, one pass): {ms:.3f} ms a backward "
          f"({', '.join(f'{t:.3f}' for t in times['wgmma'])}; CUDA events over 10 calls; "
          f"{5 * prod / ms / 1e9:.1f} TFLOP/s in its 5 products), of which the kernel "
          f"{kernel_ms:.3f} and D, the rows, the zeroed workspace and the cast {prep_ms:.3f}; the "
          f"mma.sync pair at the same inputs {ms_mma:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times['mma.sync'])}), {ms_mma / ms:.2f}x; bound "
          f"{bound[0]:.3f} ms by {bound[1]} ({ms / bound[0]:.2f}x; the {b * h * s * s:.3g} "
          f"exponentials alone {exp_ms:.3f} ms); the plain backward {plain_ms:.1f} ms (one (b, h) "
          f"pair x {b * h}); scaled_dot_product_attention's backward {lib_bwd:.3f} ms (its "
          f"forward and backward less its forward; {lib_bwd / ms:.2f}x); {n_layers} launches per "
          f"LoRA step: {n_layers * ms:.0f} ms of the median step's {step_med:.0f}")
    f32_entries = small_video_train_check(dev)
    del cap, q, k, v, out, lse, dout
    torch.cuda.empty_cache()
    return [{"name": "attention_bwd_wgmma", "route": "cuda",
             "source": "fluidnexus_torch/csrc/attention_bwd.cu",
             "replaces": "fluidnexus_tpu/diffusion/video/dit.py:256",
             "launches": launches["attention_bwd_wgmma"], "max_abs_err": max(errs.values()),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib_bwd, "mma_sync_ms": ms_mma, "kernel_ms": kernel_ms}] + f32_entries


def bwd_kernel_ms(q, k, v, out, lse, dout, iters=10):
    """The Hopper backward's kernel alone (CUDA events over ``iters``
    launches on inputs prepared once, its workspace summing on) and the
    torch work around it in ``attention_bwd`` (D, the rows, the zeroed
    workspace, the cast), ms."""
    from fluidnexus_torch.ops import attention_cuda as ac

    grads = ac._bwd_grads(q, k, v, out, lse, dout)
    rows, dq_acc = ac._bwd_wgmma_scratch(out, lse, dout)
    ms = cuda_ms(lambda: ac._launch_bwd_wgmma(q, k, v, dout, rows, dq_acc, grads[1], grads[2]),
                 iters=iters)
    prep_ms = cuda_ms(lambda: (ac._bwd_wgmma_scratch(out, lse, dout), grads[0].copy_(dq_acc)),
                      iters=iters)
    return ms, prep_ms


def sdpa_bwd_ms(q, k, v, dout, iters=5):
    """scaled_dot_product_attention's backward at these inputs: its forward
    and backward less its forward, by CUDA events (timed only; the port
    never calls it)."""
    import torch.nn.functional as F

    qc, kc, vc = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    do_c = dout.transpose(1, 2)

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(F.scaled_dot_product_attention(qc, kc, vc), (qc, kc, vc), do_c)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qc, kc, vc)

    return cuda_ms(fwd_bwd, iters=iters) - cuda_ms(fwd, iters=iters)


def check_layer0_backward(cap):
    """The backward kernels at layer 0's captured inputs (q, k, v, the
    forward's O and log-sum-exp, the upstream gradient) on VIDEO_PAIRS, one
    (b, h) pair at a time against the plain backward: in bf16 (the Hopper
    kernel), then the pair's inputs cast to f32 through the f32 kernels,
    against an f32 and an f64 plain version. The Hopper kernel sums dQ in f32
    across key blocks in an order that changes from run to run: a second
    run's dQ is held to the first within the bf16 limit (not bit for bit).
    Returns the bf16 max|err| of each output."""
    from fluidnexus_torch.ops import attention_cuda as ac

    q, k, v, out, lse, dout = cap
    with torch.no_grad():
        grads = ac.attention_bwd(q, k, v, out, lse, dout)
        again = ac.attention_bwd(q, k, v, out, lse, dout)
    rerun = [attention_errors(a, g) for a, g in zip(again, grads)]
    same = [bool(torch.equal(a, g)) for a, g in zip(again, grads)]
    del again
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    lines, fails = [], []
    for bi, hi in VIDEO_PAIRS:
        sl = (slice(bi, bi + 1), slice(hi, hi + 1))
        do_p = dout[bi:bi + 1, :, hi:hi + 1]
        errs = bwd_errors([g[sl] for g in grads], ac.attention_bwd_plain(q[sl], k[sl], v[sl], do_p))
        lse_ref = ac.attention_lse_plain(q[sl], k[sl])
        lse_err = float((lse[sl] - lse_ref).abs().max()) / max(1.0, float(lse_ref.abs().max()))
        for name, e in zip(("dq", "dk", "dv"), errs):
            worst[name] = max(worst[name], e[0])
        q32, k32, v32, d32 = (x.float() for x in (q[sl], k[sl], v[sl], do_p))
        o32, l32 = ac.attention_fwd(q32, k32, v32, lse=True)
        g32 = ac.attention_bwd(q32, k32, v32, o32, l32, d32)
        e32 = bwd_errors(g32, ac.attention_bwd_plain(q32, k32, v32, d32))
        e64 = bwd_errors(g32, ac.attention_bwd_plain(q32, k32, v32, d32, torch.float64))
        o64 = attention_errors(o32, ac.attention_plain(q32.double(), k32.double(), v32.double()))
        torch.cuda.synchronize()
        lines.append(f"({bi}, {hi}): bf16 dq, dk, dv max|err| / max|ref| "
                     f"{', '.join(f'{e[0] / e[2]:.2e}' for e in errs)} (mean "
                     f"{', '.join(f'{e[1] / e[2]:.1e}' for e in errs)}); lse {lse_err:.1e}; f32 "
                     f"against f32 {', '.join(f'{e[0] / e[2]:.2e}' for e in e32)}, against f64 "
                     f"{', '.join(f'{e[0] / e[2]:.2e}' for e in e64)}; f32 forward against f64 "
                     f"{o64[0] / o64[2]:.2e}")
        if not (bwd_ok(torch.bfloat16, errs) and bwd_ok(torch.float32, e32)
                and bwd_ok(torch.float32, e64) and lse_err <= LSE_TOL
                and o64[0] <= F32_TOL * o64[2]):
            fails.append((bi, hi))
    print(f"attention backward at layer 0's inputs ({tuple(q.shape)} {q.dtype}, v strides "
          f"{v.stride()}) [tol bf16 max {BF16_MAX_TOL:g} mean {BF16_MEAN_TOL:g}, f32 "
          f"{BWD_F32_TOL:g}, lse {LSE_TOL:g}]:\n  " + "\n  ".join(lines))
    print("attention backward run twice at layer 0's inputs: dq, dk, dv max|diff| / max|first| "
          + ", ".join(f"{e[0] / e[2]:.2e}" for e in rerun) + f" [tol {BF16_MAX_TOL:g}]; bit for "
          f"bit {same}")
    if not all(e[0] <= BF16_MAX_TOL * e[2] for e in rerun):
        fails.append("rerun")
    if fails:
        _fail(f"the attention backward disagrees with its plain version at layer 0's inputs, "
              f"(b, h) {fails}")
    return worst


def small_video_train_check(dev):
    """The tiny DiT of ``train_video --tiny`` (hidden 64, 2 layers, 4 heads,
    f32) with LoRA rank 4 and every weight from numpy with a seed (adaLN and
    lora_b included), on latents of 3 x 8 x 12 (80 tokens: two key tiles,
    the last ragged) and one clean prefix latent: the first step's LoRA
    gradients, then two LoRA steps with EMA, on the card through the f32
    kernels and on the CPU through the plain versions, with one set of draws
    (made on the CPU, replayed on the card). Loss at 1e-5, gradients at 1e-4
    of each leaf's max|ref|, the leaves after two steps at a mean |err| of
    1e-2 of lr (Adam's first steps move each element by ~lr sign(g), so an
    element whose gradient lies below the kernels' error can flip). Returns
    the ``kernels`` entries of the f32 ``dq`` and ``dkv`` kernels: the card
    run's launches, and each kernel's error, time and bound at that run's
    first backward inputs."""
    import copy

    from fluidnexus_torch.diffusion.video import engine as eng_mod
    from fluidnexus_torch.diffusion.video import sampling
    from fluidnexus_torch.diffusion.video.dit import init_video_dit
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.pipelines.sample_video import configs
    from fluidnexus_torch.pipelines.train_video import VideoTrainer

    lr = 1e-3
    cfg = dataclasses.replace(configs(9, 64, 96, tiny=True)[0], lora_rank=4)
    dit = _random_weights(init_video_dit(cfg, torch.Generator().manual_seed(SEED)), SEED + 12)
    rng = np.random.default_rng(SEED + 13)
    lat = torch.as_tensor(rng.normal(size=(2, 3, 16, 8, 12)), dtype=torch.float32)
    txt = torch.as_tensor(rng.normal(size=(2, 8, 64)), dtype=torch.float32)
    draws, replayed = [], []
    real_normal, real_randint = sampling._normal, eng_mod._randint

    def recorder(real):
        def f(*a):
            x = real(*a)
            draws.append(x)
            return x
        return f

    def replay(*a):
        x = draws[len(replayed)]
        replayed.append(x)
        return x.to(a[-1])

    runs, captured, real_bwd = {}, {}, ac.attention_bwd

    def recording_bwd(*a):
        if not captured:
            captured["bwd"] = tuple(x.detach() for x in a)
        return real_bwd(*a)

    ac.attention_bwd = recording_bwd
    try:
        for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
            if name == "cpu":
                sampling._normal, eng_mod._randint = recorder(real_normal), recorder(real_randint)
            else:
                sampling._normal = eng_mod._randint = replay
            engine = VideoEngine(cfg, fixed_frames=1)
            trainer = VideoTrainer(engine, copy.deepcopy(dit).to(device), lr, 0.9)
            ac.reset_launches()
            gen = torch.Generator(device=device).manual_seed(SEED)
            la, tx = lat.to(device), txt.to(device)
            g = torch.autograd.grad(engine.loss_fn(trainer.dit, la, tx, gen)[0],
                                    list(trainer.params.values()))
            losses = [float(trainer.step(la, tx, gen)) for _ in range(2)]
            runs[name] = ([x.cpu() for x in g], losses,
                          {n: p.detach().cpu() for n, p in trainer.params.items()},
                          dict(ac.LAUNCHES))
    finally:
        sampling._normal, eng_mod._randint = real_normal, real_randint
        ac.attention_bwd = real_bwd
    (g_c, l_c, p_c, n_c), (g_d, l_d, p_d, n_d) = runs["cpu"], runs["card"]
    dl = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_c))
    dg = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_d, g_c))
    dp = max(float((p_d[n] - p_c[n]).abs().max()) for n in p_c)
    dmean = sum(float((p_d[n] - p_c[n]).abs().sum()) for n in p_c) / sum(
        p.numel() for p in p_c.values())
    print(f"small video training, card (f32 kernels, launches {n_d}) vs plain CPU path: "
          f"{len(draws)} draws replayed; losses {', '.join(f'{x:.6f}' for x in l_c)}, rel "
          f"{dl:.2e} [tol 1e-5]; first-step LoRA gradients, worst leaf max|err| / max|ref| "
          f"{dg:.2e} [tol 1e-4]; LoRA leaves after 2 steps mean|err| {dmean:.2e} [tol "
          f"{1e-2 * lr:g}], max|err| {dp:.2e} (Adam moves an element by ~lr sign(g) at first: "
          f"one whose gradient is below the kernels' error may flip)")
    want = {"attention_fwd": 12, "attention_fwd_wgmma": 0, "attention_bwd_wgmma": 0,
            "attention_dq": 6, "attention_dkv": 6}
    if not (all(c == 0 for c in n_c.values()) and all(n_d[k] == c for k, c in want.items())
            and len(replayed) == len(draws) and dl <= 1e-5 and dg <= 1e-4
            and dmean <= 1e-2 * lr):
        _fail("the small video training run on the card disagrees with the plain CPU path")

    # the f32 pair at the card run's first backward inputs
    q, k, v, out, lse, dout = captured["bwd"]
    b, h, s, d = q.shape
    with torch.no_grad():
        grads = ac.attention_bwd(q, k, v, out, lse, dout)
        refs = ac.attention_bwd_plain(q, k, v, dout)
        err = [float((g - r).abs().max()) for g, r in zip(grads, refs)]
        scale = [float(r.abs().max()) for r in refs]
        fn = lambda: ac.attention_bwd(q, k, v, out, lse, dout)   # noqa: E731
        ms_dq, rec_dq = kernel_device_ms(fn, "attention_dq_f32_kernel")
        ms_dkv, rec_dkv = kernel_device_ms(fn, "attention_dkv_f32_kernel")
        plain_ms = cuda_ms(lambda: ac.attention_bwd_plain(q, k, v, dout))
    lib_bwd = sdpa_bwd_ms(q, k, v, dout, iters=10)
    if not all(e <= BWD_F32_TOL * max(c, 1e-3 * max(scale)) for e, c in zip(err, scale)):
        _fail(f"the f32 backward pair disagrees with its plain version at the small run's "
              f"inputs: max|err| {err} on max|ref| {scale}")
    prod = 2 * b * h * s * s * d
    io = b * h * s * d * 4
    # the gradient's bound split so that the two add up to it: dkv takes S =
    # QK^T, dP = dO V^T, dV and dK with q, k, v, dO, the LSE, dk and dv; dq
    # takes dS K with O and dq (its own recomputation of S and dP is not work
    # the gradient needs)
    dkv_bound = bound_ms(6 * io + 4 * b * h * s, 4 * prod)
    dq_bound = bound_ms(2 * io, prod)
    print(f"attention_dq and attention_dkv (the mma.sync f32 pair) at the small run's "
          f"{tuple(q.shape)} {q.dtype}: dq, dk, dv max|err| {', '.join(f'{e:.3e}' for e in err)} "
          f"on max|ref| {', '.join(f'{c:.3e}' for c in scale)} [tol {BWD_F32_TOL:g} x max|ref|]; "
          f"dq {ms_dq:.4f} ms ({rec_dq} recorded), bound {dq_bound[0]:.6f} by "
          f"{dq_bound[1]}; dkv {ms_dkv:.4f} ms ({rec_dkv}), bound {dkv_bound[0]:.6f} by "
          f"{dkv_bound[1]} (f32 outside the tensor cores); plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention's backward {lib_bwd:.4f} ms")
    common = {"route": "cuda", "source": "fluidnexus_torch/csrc/attention_bwd.cu",
              "replaces": "fluidnexus_tpu/diffusion/video/dit.py:256", "plain_ms": plain_ms,
              "library_ms": lib_bwd}
    return [{"name": "attention_dq", **common, "launches": n_d["attention_dq"],
             "max_abs_err": err[0], "ms": ms_dq, "bound_ms": dq_bound[0],
             "bound_by": dq_bound[1]},
            {"name": "attention_dkv", **common, "launches": n_d["attention_dkv"],
             "max_abs_err": max(err[1:]), "ms": ms_dkv, "bound_ms": dkv_bound[0],
             "bound_by": dkv_bound[1]}]


# ----------------------------- the refinement stage ---------------------------

REFINE_STEPS = 8              # --num_steps, cut from 50: at strength 0.5 the sampler runs 4
REFINE_WINDOWS = 1            # --num_windows, cut from the preset's 3 (the chained windows:
                              # small_refine_check's two, card against CPU)
REFINE_BODY_STARTS = (3, 115)  # --window_start_indices: frames 3, 5, ..., 113, then 115, ..., 225
REFINE_GT_START = 1           # --gt_prefix_start: GT frames 1, 3, ..., 17
FUTURE_STEPS = 6              # --num_steps, cut from 50: at strength 0.75 the sampler runs 4
FUTURE_SINCE = 9              # --gen_future_since: reconstruction 0-8, renders 9, 11, ..., 135
CAPTURE_HW = (544, 960)       # the FluidNexus capture's frame, resampled to 480 x 720 on reading


def plume_frames(indices, seed):
    """Seeded (H, W, 3) uint8 frames at the capture's size, one for each
    index: a soft column rising with the index over a dim background, and
    pixel noise."""
    h, w = CAPTURE_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    for i in indices:
        cy = h - 60.0 - 1.5 * i
        col = np.exp(-((x - w / 2 - 20 * np.sin(0.1 * i)) ** 2 / (2 * 70.0 ** 2)
                       + (y - cy) ** 2 / (2 * 160.0 ** 2)))
        img = np.stack([200 * col + 20, 210 * col + 24, 220 * col + 30], -1)
        yield i, (img + rng.normal(0, 3, img.shape)).clip(0, 255).astype(np.uint8)


def write_frames(folder, pattern, indices, seed):
    """The frames of ``plume_frames`` as PNGs ``folder/(pattern % i)``,
    written on 8 threads (zlib lets go of the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from fluidnexus_torch.utils.png import write_png

    os.makedirs(folder, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda f: write_png(os.path.join(folder, pattern % f[0]), f[1]),
                      plume_frames(indices, seed)))
    return folder


def timed_cli(main, argv):
    """``main(argv, device="cuda")`` with a CUDA event at the start and the
    end of every DiT forward, VAE encode, VAE decode and sampler call, layer
    0's attention inputs of the first forward captured and every attention
    call counted. Returns (main's result, {"seconds", "launches", "peak",
    "q", "k", "v", "attention_calls", "steps" (ms per sampler step, by
    sampler call), "encode", "decode" (ms), "decoded" (shape and finiteness
    of each decode)})."""
    import time

    from fluidnexus_torch.diffusion.video import dit as dit_mod
    from fluidnexus_torch.diffusion.video.engine import VideoEngine

    names = ("dit_apply", "encode_first_stage", "decode_first_stage", "sample")
    real = {n: getattr(VideoEngine, n) for n in names}
    real_attn = dit_mod.joint_attention
    events, captured, calls, decoded = [], {}, [0], []

    def wrapped(n):
        def call(self, *a, **kw):
            events.append((n, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()
            out = real[n](self, *a, **kw)
            events.append((n + "_end", torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()
            if n == "decode_first_stage":
                decoded.append((tuple(out.shape), bool(torch.isfinite(out).all())))
            return out
        return call

    def recording_attn(q, k, v):
        calls[0] += 1
        if not captured:
            captured.update(q=q, k=k, v=v)
        return real_attn(q, k, v)

    for n in names:
        setattr(VideoEngine, n, wrapped(n))
    dit_mod.joint_attention = recording_attn
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = main(argv, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
    finally:
        for n in names:
            setattr(VideoEngine, n, real[n])
        dit_mod.joint_attention = real_attn
    info = dict(seconds=seconds, launches=launches, peak=torch.cuda.max_memory_allocated(),
                attention_calls=calls[0], decoded=decoded, steps=[], encode=[], decode=[],
                **captured)
    for i, (n, a) in enumerate(events):
        if n == "sample":
            info["steps"].append([])
        elif n == "dit_apply":
            # a sampler step: this forward's start to the next one's or the sampler's end
            nxt = next(ev for kind, ev in events[i + 1:] if kind in ("dit_apply", "sample_end"))
            info["steps"][-1].append(a.elapsed_time(nxt))
        elif n in ("encode_first_stage", "decode_first_stage"):
            info[n.split("_")[0]].append(a.elapsed_time(events[i + 1][1]))
    return out, info


def refine_attention_entry(name, info, forwards, n_layers, pairs=VIDEO_PAIRS):
    """Row 14 at one run's layer-0 inputs of its first forward: the Hopper
    kernel against the plain version on ``pairs`` (default VIDEO_PAIRS) in bf16 and, on the
    same pairs cast to f32, the f32 kernel (which sees a missing mask of the
    ragged last key tile); its time beside the plain version's and
    scaled_dot_product_attention's by CUDA events; the run's launches, all
    on the Hopper kernel. Returns the ``kernels`` entry."""
    import torch.nn.functional as F

    from fluidnexus_torch.ops import attention_cuda as ac

    launches, q, k, v = info["launches"], info["q"], info["k"], info["v"]
    want = {"attention_fwd": n_layers * forwards, "attention_fwd_wgmma": n_layers * forwards}
    idle = [n for n, c in launches.items() if n not in want and c]
    if any(launches[n] != c for n, c in want.items()) or idle \
            or info["attention_calls"] != want["attention_fwd_wgmma"]:
        _fail(f"{name}: {info['attention_calls']} attention calls launched {launches}, expected "
              f"{want} and no other kernel")
    b, h, s, d = q.shape
    with torch.inference_mode():
        out = ac.attention_fwd(q, k, v)
        errs = []
        for bi, hi in pairs:
            sl = (slice(bi, bi + 1), slice(hi, hi + 1))
            errs.append(attention_errors(out[bi:bi + 1, :, hi:hi + 1],
                                         ac.attention_plain(q[sl], k[sl], v[sl])))
        del out
        errs32 = []
        for bi, hi in pairs:
            q32, k32, v32 = (x[bi:bi + 1, hi:hi + 1].float() for x in (q, k, v))
            errs32.append(attention_errors(ac.attention_fwd(q32, k32, v32),
                                           ac.attention_plain(q32, k32, v32)))
        torch.cuda.synchronize()
        print(f"{name}: attention (wgmma kernel) at layer 0's inputs {tuple(q.shape)} {q.dtype} "
              f"({s} tokens = 226 text + {s - 226} video, ragged: {s} = {s // 64} x 64 + "
              f"{s % 64}), (b, h) {pairs}: max|err| "
              + ", ".join(f"{e[0]:.3e}" for e in errs) + "; mean|err| "
              + ", ".join(f"{e[1]:.3e}" for e in errs) + "; max|ref| "
              + ", ".join(f"{e[2]:.3e}" for e in errs)
              + f" [tol max {BF16_MAX_TOL:g}, mean {BF16_MEAN_TOL:g} x max|ref|]; in f32 "
              + ", ".join(f"{e[0] / e[2]:.3e}" for e in errs32) + f" [tol {F32_TOL:g}]")
        if not all(attention_ok(q.dtype, *e) for e in errs) \
                or not all(attention_ok(torch.float32, *e) for e in errs32):
            _fail(f"{name}: the attention kernel disagrees with its plain version at layer 0's "
                  f"inputs")
        ms = cuda_ms(lambda: ac.attention_fwd(q, k, v), iters=20)
        sl = (slice(0, 1), slice(0, 1))
        plain_ms = cuda_ms(lambda: ac.attention_plain(q[sl], k[sl], v[sl]), iters=3,
                           warmup=1) * b * h
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc), iters=10)
    flops = 4 * b * h * s * s * d
    b_ms, b_by = bound_ms(2 * 4 * b * h * s * d, flops, peak=H100_BF16_TC_FLOPS)
    exp_ms = b * h * s * s / H100_EXP_PER_S * 1e3
    print(f"{name}: attention_fwd_wgmma {ms:.3f} ms (CUDA events over 20 calls; "
          f"{flops / ms / 1e9:.1f} TFLOP/s), bound {b_ms:.3f} ms by {b_by} (bf16 tensor cores; "
          f"the {b * h * s * s:.3g} exponentials alone {exp_ms:.3f} ms), {ms / b_ms:.2f}x it; "
          f"plain {plain_ms:.1f} ms (one (b, h) pair x {b * h}); scaled_dot_product_attention "
          f"{library_ms:.3f} ms ({library_ms / ms:.2f}x the kernel's time); "
          f"{launches['attention_fwd_wgmma']} launches in {forwards} DiT forwards")
    return {"name": f"attention_fwd_wgmma_{name}", "route": "cuda",
            "source": "fluidnexus_torch/csrc/attention.cu",
            "replaces": "fluidnexus_tpu/diffusion/video/dit.py:213",
            "launches": launches["attention_fwd_wgmma"], "max_abs_err": max(e[0] for e in errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [b, h, s, d]}


def print_cli_times(name, info):
    steps = [t for run in info["steps"] for t in run]
    print(f"{name}: ms per sampler step " + "; ".join(
        ", ".join(f"{t:.1f}" for t in run) for run in info["steps"])
        + f" (median {statistics.median(steps):.1f}); VAE encode "
        + ", ".join(f"{t:.1f}" for t in info["encode"]) + " ms a window; VAE decode "
        + ", ".join(f"{t:.1f}" for t in info["decode"]) + f" ms; main end to end "
        f"{info['seconds']:.2f} s; peak allocated {info['peak'] / 2**30:.2f} GiB")


def check_frames_folder(name, folder, names):
    """The folder holds exactly ``names``, 480 x 720 RGB PNGs."""
    from fluidnexus_torch.utils.png import read_png

    got = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    shapes = {read_png(os.path.join(folder, n)).shape for n in (got[0], got[-1])} if got else set()
    print(f"{name}: {folder}: {len(got)} PNGs, {got[0] if got else None} .. "
          f"{got[-1] if got else None}, {sorted(shapes)}")
    if got != sorted(names) or shapes != {(480, 720, 3)}:
        _fail(f"{name}: {folder} holds {len(got)} PNGs of {sorted(shapes)}, expected "
              f"{len(names)} ({names[0]} .. {names[-1]}) of (480, 720, 3)")
    return got


def check_packed_video(name, path, folder, n):
    """The packed video holds n frames of 480 x 720; an uncompressed AVI
    (the port's last resort) holds the PNGs' pixels exactly."""
    from fluidnexus_torch.utils.png import read_png
    from fluidnexus_torch.utils.video_io import read_video_with_fps

    frames, fps = read_video_with_fps(path)
    names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    exact = None
    if path.endswith(".avi"):
        exact = all(np.array_equal(frames[i], read_png(os.path.join(folder, names[i])))
                    for i in (0, n // 2, n - 1))
    print(f"{name}: packed video {path} ({os.path.getsize(path) / 2**20:.1f} MiB), "
          f"{frames.shape} at {fps:g} fps" + ("" if exact is None else
                                               f"; frames 0, {n // 2}, {n - 1} equal to the PNGs: {exact}"))
    if frames.shape != (n, 480, 720, 3) or exact is False:
        _fail(f"{name}: the packed video {path} does not hold the {n} frames")


def run_refine(dev, root):
    """The refinement stage through its two CLIs at the CogVideoX-5B
    geometry on seeded weights, with the shipped presets (module docstring):
    ``gen_refine_video.main --preset refine_smoke`` (REFINE_WINDOWS 65-frame
    windows, 23 176 tokens) and ``gen_future_video.main --preset future_smoke`` (one
    73-frame window, 25 876 tokens) on seeded input folders at the capture's
    960 x 544; launch counts, ms per sampler step, encode and decode ms, peak
    memory, the frames written and the packed video; row 14 held and timed at
    each run's layer-0 inputs; the small card-vs-CPU refinement. Returns the
    ``kernels`` entries of row 14 at the two shapes."""
    from fluidnexus_torch.data.readers import future_view_folder
    from fluidnexus_torch.pipelines import gen_future_video, gen_refine_video
    from fluidnexus_torch.pipelines.sample_video import configs

    step = 2   # both presets' frame_step
    starts = REFINE_BODY_STARTS[:REFINE_WINDOWS]
    n_written = [65] + [56] * (REFINE_WINDOWS - 1)   # a later window repeats 9 prefix frames
    n_layers = configs(65, 480, 720, tiny=False)[0].num_layers
    inp = write_frames(os.path.join(root, "zero123"), "frame_%06d.png",
                       [s + step * i for s in starts for i in range(56)], SEED + 11)
    gt = write_frames(os.path.join(root, "gt"), "%03d.png",
                      [REFINE_GT_START + step * i for i in range(9)], SEED + 12)
    renders = write_frames(os.path.join(root, "renders"), "render_frame%03d_train00_0000.png",
                           [FUTURE_SINCE + step * i for i in range(64)], SEED + 13)
    recon = write_frames(os.path.join(root, "recon"), "%03d.png", range(FUTURE_SINCE), SEED + 14)

    out = os.path.join(root, "refined")
    argv = ["--preset", "refine_smoke", "--input_folder", inp, "--gt_prefix_folder", gt,
            "--out_folder", out, "--num_steps", str(REFINE_STEPS), "--num_windows",
            str(REFINE_WINDOWS), "--window_start_indices", *map(str, starts),
            "--gt_prefix_start", str(REFINE_GT_START), "--allow_fake_conditioning",
            "--pack_video"]
    print(f"refine: gen_refine_video.main({argv}): the CogVideoX-5B DiT ({n_layers} layers) and "
          f"VAE on seeded weights, the preset's 65-frame windows at 480 x 720 (17 latents, "
          f"23 176 tokens), prefix 9, frame_step 2, strength 0.5, hash text, batch-2 CFG; "
          f"inputs at {CAPTURE_HW[1]} x {CAPTURE_HW[0]}, resampled by LANCZOS; cut: --num_steps "
          f"{REFINE_STEPS} (4 DiT steps a window at strength 0.5; the preset's CLI runs 50), "
          f"--num_windows {REFINE_WINDOWS} (of 3); encode chunk "
          f"{gen_refine_video.ENCODE_CHUNK} (0: the whole window)")
    (written, video), info = timed_cli(gen_refine_video.main, argv)
    print_cli_times("refine", info)
    forwards = sum(len(r) for r in info["steps"])
    if written != n_written or forwards != REFINE_WINDOWS * 4 \
            or len(info["encode"]) != REFINE_WINDOWS \
            or info["decoded"] != [((1, 65, 480, 720, 3), True)] * REFINE_WINDOWS:
        _fail(f"refine: wrote {written} frames in {forwards} DiT forwards, "
              f"{len(info['encode'])} encodes and decodes {info['decoded']}; expected "
              f"{n_written}, {REFINE_WINDOWS * 4}, {REFINE_WINDOWS} and {REFINE_WINDOWS} finite "
              f"(1, 65, 480, 720, 3)")
    check_frames_folder("refine", out, [f"frame_{i:06d}.png" for i in range(sum(n_written))])
    check_packed_video("refine", video, out, sum(n_written))
    entries = [refine_attention_entry("refine", info, forwards, n_layers)]
    del info

    out_root = os.path.join(root, "future")
    argv = ["--preset", "future_smoke", "--sim_render_folder", renders, "--recon_frames_folder",
            recon, "--out_root", out_root, "--gen_future_since", str(FUTURE_SINCE),
            "--num_steps", str(FUTURE_STEPS), "--allow_fake_conditioning", "--pack_video"]
    print(f"future: gen_future_video.main({argv}): the same model, the preset's 73-frame window "
          f"(19 latents, 25 876 tokens), prefix 9, frame_step 2, strength 0.75, camera train00; "
          f"cut: --num_steps {FUTURE_STEPS} (4 DiT steps at strength 0.75; the CLI runs 50)")
    (folder, video), info = timed_cli(gen_future_video.main, argv)
    print_cli_times("future", info)
    forwards = sum(len(r) for r in info["steps"])
    want = os.path.join(out_root, future_view_folder("smoke", "0", "0d75", FUTURE_SINCE, False))
    if folder != want or forwards != 4 or len(info["encode"]) != 1 \
            or info["decoded"] != [((1, 73, 480, 720, 3), True)]:
        _fail(f"future: wrote {folder} in {forwards} DiT forwards, {len(info['encode'])} "
              f"encodes and decodes {info['decoded']}; expected {want}, 4, 1 and one finite "
              f"(1, 73, 480, 720, 3)")
    check_frames_folder("future", folder,
                        [f"frame_{FUTURE_SINCE + i:06d}.png" for i in range(64)])
    check_packed_video("future", video, folder, 64)
    entries.append(refine_attention_entry("future", info, forwards, n_layers))
    del info
    small_refine_check(dev, root)
    return entries


def small_refine_check(dev, root):
    """``refine_long_video`` with ``sample_video --tiny``'s DiT and VAE
    (f32, every weight from numpy with a seed) at 64 x 96, 9-frame windows,
    prefix 5, 2 windows, frame_step 2 and body starts (3, 11), 4 steps at
    strength 0.5: on the CPU (the plain attention), then on the card (the
    f32 kernel) with the CPU's noise draws replayed. Decoded frames at 1e-4
    of their scale, the PNGs within one level, the same names."""
    import copy

    from fluidnexus_torch.diffusion.video import sampling
    from fluidnexus_torch.diffusion.video.dit import init_video_dit
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.diffusion.video.vae3d import init_vae
    from fluidnexus_torch.pipelines.gen_refine_video import RefineConfig, refine_long_video
    from fluidnexus_torch.pipelines.sample_video import configs
    from fluidnexus_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(SEED + 15)
    inp, gt = os.path.join(root, "small_in"), os.path.join(root, "small_gt")
    for folder, pattern, idx in ((inp, "frame_%06d.png", range(3, 18)), (gt, "%03d.png", range(10))):
        os.makedirs(folder, exist_ok=True)
        for i in idx:
            write_png(os.path.join(folder, pattern % i),
                      rng.integers(0, 256, (80, 120, 3)).astype(np.uint8))
    dit_cfg, vae_cfg = configs(9, 64, 96, tiny=True)
    gen = torch.Generator().manual_seed(SEED)
    dit = _random_weights(init_video_dit(dit_cfg, gen), SEED + 16)
    vae = _random_weights(init_vae(vae_cfg, gen), SEED + 17)
    text = torch.as_tensor(np.random.default_rng(SEED + 18).normal(size=(1, 8, 64)),
                           dtype=torch.float32)
    engine = VideoEngine(dit_cfg, vae_cfg)
    cfg = RefineConfig(window_frames=9, prefix_frames=5, num_windows=2, sdedit_strength=0.5,
                       num_steps=4, height=64, width=96, frame_step=2,
                       window_start_indices=(3, 11), gt_prefix_start=1)
    draws, replayed, real, real_decode = [], [], sampling._normal, VideoEngine.decode_first_stage

    def recording(shape, generator, device):
        draws.append(real(shape, generator, device))
        return draws[-1]

    def replaying(shape, generator, device):
        replayed.append(draws[len(replayed)])
        return replayed[-1].to(device)

    decoded, run = {}, []

    def keep_decode(self, vae_, z, chunk=2):
        out = real_decode(self, vae_, z, chunk)
        decoded.setdefault(run[-1], []).append(out.cpu())
        return out

    VideoEngine.decode_first_stage = keep_decode
    try:
        for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
            sampling._normal = recording if name == "cpu" else replaying
            run.append(name)
            reset_all_launches()
            written = refine_long_video(engine, copy.deepcopy(dit).to(device),
                                        copy.deepcopy(vae).to(device), text.to(device),
                                        torch.zeros_like(text).to(device), inp, gt,
                                        os.path.join(root, f"small_out_{name}"), cfg,
                                        torch.Generator(device=device).manual_seed(SEED),
                                        log=lambda *a: None)
            if written != [9, 4]:
                _fail(f"small refine on the {name} wrote {written}, expected [9, 4]")
        launches = all_launches()
    finally:
        sampling._normal = real
        VideoEngine.decode_first_stage = real_decode
    rel = max(float((c - g).abs().max()) / float(g.abs().max())
              for c, g in zip(decoded["card"], decoded["cpu"]))
    names = sorted(os.listdir(os.path.join(root, "small_out_cpu")))
    levels = max(int(np.abs(read_png(os.path.join(root, "small_out_card", n)).astype(int)
                            - read_png(os.path.join(root, "small_out_cpu", n))).max())
                 for n in names)
    print(f"small refine, card (f32 kernel, {launches['attention_fwd']} launches) vs plain CPU "
          f"path: {len(draws)} noise draws replayed; decoded frames rel {rel:.3e} [tol 1e-4], "
          f"{len(names)} PNGs, at most {levels} levels apart [tol 1]")
    if not (len(replayed) == len(draws) and rel <= 1e-4 and levels <= 1
            and names == sorted(os.listdir(os.path.join(root, "small_out_card")))
            and launches["attention_fwd"] == 2 * 2 * 2 and launches["attention_fwd_wgmma"] == 0):
        _fail("the small refinement on the card disagrees with the plain CPU path")


def refine_only():
    """``python3 chip_smoke.py refine``: builds ``attention`` only, runs
    ``run_refine`` and prints its ``kernels`` entries."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"build attention: {cuda_build.build(['attention'])['attention']['seconds']:.1f} s")
    with tempfile.TemporaryDirectory(prefix="fnx_refine_") as tmp:
        print(json.dumps({"kernels": run_refine(torch.device("cuda"), tmp)}))


def refine_encode_probe():
    """``python3 chip_smoke.py refine-encode-probe``: the refinement windows'
    VAE encode (65 frames, refine_smoke; 73, future_smoke; 480 x 720, the
    posterior drawn) with the 5B DiT and the VAE resident, whole (the JAX
    package's) and in chunks of 2 latents (train_video's default), each with
    its time and its peak memory above what is resident, or the
    out-of-memory error: the reading that ``gen_refine_video.ENCODE_CHUNK``
    follows."""
    import time

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the probe runs on an NVIDIA card")
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.pipelines.sample_video import configs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    engine = VideoEngine(*configs(65, 480, 720, tiny=False))
    dit = engine.init_params(torch.Generator(device=dev).manual_seed(0))
    vae = engine.init_vae_params(torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    print(f"resident: the DiT {sum(p.numel() * p.element_size() for p in dit.parameters()) / 2**30:.2f}"
          f" GiB, the VAE {sum(p.numel() * p.element_size() for p in vae.parameters()) / 2**30:.2f}"
          f" GiB; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
    for frames in (65, 73):
        x = torch.rand((1, frames, 480, 720, 3), generator=gen, device=dev) * 2 - 1
        for chunk in (0, 2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                z = engine.encode_first_stage(vae, x, gen, chunk=chunk)
                torch.cuda.synchronize()
                print(f"encode {frames} frames, chunk {chunk} (0: the whole window): "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms, peak "
                      f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the "
                      f"resident {base / 2**30:.2f} GiB, latents {tuple(z.shape)}")
                del z
            except torch.OutOfMemoryError as e:
                print(f"encode {frames} frames, chunk {chunk} (0: the whole window): out of "
                      f"memory after {time.perf_counter() - t0:.2f} s: {str(e).splitlines()[0]}")
        del x


# ------------------------- mutants and the encode probe ----------------------

# Broken copies of the attention backward: (file, source text, replacement),
# each replaced wherever it occurs. The first three break the mma.sync pair,
# the wgmma_ ones the Hopper kernel and its wrapper.
BWD_SRC = "fluidnexus_torch/csrc/attention_bwd.cu"
BWD_MUTANTS = {
    "no_key_mask": [
        (BWD_SRC, "        if (ragged && t * BK + j * 8 + tg * 2 + (e & 1) >= S) p = 0.f;   "
         "// keys past s\n", ""),
        (BWD_SRC, "      const float p = t * BK + j < S ? ex2(fmaf(s, scale_log2, -lse2)) : 0.f;   "
         "// keys past s: 0", "      const float p = ex2(fmaf(s, scale_log2, -lse2));"),
    ],
    "no_D_term": [
        (BWD_SRC, "s_acc[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));", "s_acc[j][e] = p * dp[j][e];"),
        (BWD_SRC, "s_acc[j][e] *= dp[j][e] - dd[j * 8 + tg * 2 + (e & 1)];", "s_acc[j][e] *= dp[j][e];"),
        (BWD_SRC, "p * (dpv - drow)", "p * dpv"),
        (BWD_SRC, "p * (dpv - rows[BQ + i])", "p * dpv"),
    ],
    "lse_base_2": [(BWD_SRC, " * LOG2E : 0.f;", " : 0.f;")],
    "wgmma_no_key_mask": [(BWD_SRC, "= live0 ? ex2(", "= true ? ex2("),
                          (BWD_SRC, "= live1 ? ex2(", "= true ? ex2(")],
    "wgmma_no_D_term": [(BWD_SRC, " - dd.x);", ");"), (BWD_SRC, " - dd.y);", ");")],
    "wgmma_lse_base_2": [("fluidnexus_torch/ops/attention_cuda.py", "lse * _LOG2E", "lse")],
}
_MUTANT_CHECK = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs._fail = lambda msg: print("FAIL:", str(msg)[:1500], flush=True)
dev = torch.device("cuda")
cs.check_attention_ragged(dev)
cs.small_video_train_check(dev)
"""
RASTER_SRC = "fluidnexus_torch/csrc/rasterizer.cu"
RASTER_MUTANTS = {
    "bwd_no_t_min_mask": [(RASTER_SRC, "const float tba = tb[q] >= T_MIN ? tb[q] : 0.0f;",
                           "const float tba = tb[q];")],
    "bwd_no_suffix": [(RASTER_SRC, "__fdividef(suffix[q] + g_t_term[q],", "__fdividef(g_t_term[q],")],
    "bwd_drops_a_lane_group": [
        (RASTER_SRC, "u[i] = (up ? hi : lo) + __shfl_xor_sync(FULL_MASK, up ? lo : hi, O);",
         "u[i] = (up ? hi : lo) + (O == 4 ? 0.0f : __shfl_xor_sync(FULL_MASK, up ? lo : hi, O));")],
    "combine_one_slot_short": [(RASTER_SRC, "const int n = counts[t] * per_row;",
                                "const int n = (counts[t] - 1) * per_row;")],
    "bwd_sums_the_first_chunk_alone": [(RASTER_SRC, "for (int c = 0; c < nch; ++c) acc +=",
                                        "for (int c = 0; c < 1; ++c) acc +=")],
    "fwd_box_no_slack": [(RASTER_SRC, "const float slack = 1e-5f * ", "const float slack = 0.0f * ")],
    "fwd_drops_second_pixel": [(RASTER_SRC, "if (!ok) continue;  // skipped: T as it was",
                                "if (!ok || q == 1) continue;")],
    "fwd_ignores_last_bucket": [(RASTER_SRC, "const int t = tc.t, cnt = counts[t];",
                                 "const int t = tc.t, cnt = counts[t];\n"
                                 "  if (cnt == 0) return;")],
}
PAIR_SRC = "fluidnexus_torch/csrc/pair_common.cuh"
PBF_SRC = "fluidnexus_torch/csrc/pbf.cu"
SPLAT_SRC = "fluidnexus_torch/csrc/splat.cu"
PAIRS_MUTANTS = {
    "density_bwd_skips_neighbour_26": [
        (PAIR_SRC, "n[q] = src.count(nb[q]);", "n[q] = sub * PER + q != 26 ? src.count(nb[q]) : 0;")],
    "density_bwd_stages_one_short": [(PAIR_SRC, "const int c1 = min(c0 + CH, n_tot);",
                                      "const int c1 = min(c0 + CH, n_tot) - 1;")],
    "density_skips_the_self_entry": [(PBF_SRC, "wa[c] = d2 < h2 ? fmaf(",
                                      "wa[c] = d2 > 0.0f && d2 < h2 ? fmaf(")],
    "density_stages_one_short": [(PBF_SRC, "left > 0 ? n_tot : 0, kn, src, h, sub);",
                                  "left > 0 ? n_tot - 1 : 0, kn, src, h, sub);")],
    "splat_bwd_empty_rows_unwritten": [(SPLAT_SRC, "gx4[i] = gv4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);",
                                        ";")],
    "splat_bwd_fd_by_a_product": [
        (SPLAT_SRC, "const float fd = d2 < h2 ? (a.v0", "const float fd = (float)(d2 < h2) * (a.v0"),
        (SPLAT_SRC, "(-3.0f * t2 * t2)\n                               : 0.0f;", "(-3.0f * t2 * t2);")],
    "splat_fwd_unreached_unwritten": [(SPLAT_SRC, "if (live) out[e] = make_float4(a0, a1, a2, aw);",
                                       "if (live && n_tot > 0) out[e] = make_float4(a0, a1, a2, aw);")],
    "splat_fwd_entry_nq_unwritten": [(SPLAT_SRC, "threadIdx.x == 0) out[Nq] =",
                                      "threadIdx.x == 64) out[Nq] =")],
    "splat_fwd_stages_one_short": [(SPLAT_SRC, "c0, n_tot, kn, src, h,", "c0, n_tot - 1, kn, src, h,")],
    # the query list
    "splat_list_start_one_off": [(PAIR_SRC, "return h < C ? start[h] : 0;",
                                  "return h < C ? start[h] + 1 : 0;")],
    "splat_fwd_start_one_off": [(SPLAT_SRC, "const size_t e = (size_t)qstart[row] + i0 + sub;",
                                 "const size_t e = (size_t)qstart[row] + 1 + i0 + sub;")],
    "splat_fwd_scan_drops_the_carry": [(SPLAT_SRC, "carry += warp_sums[31];", ";")],
    "splat_fwd_skips_a_piles_last_chunk": [
        (SPLAT_SRC, "const int left = n_c - i0;",
         "const int left = n_c > SPF_QUERIES && i0 + SPF_QUERIES >= n_c ? 0 : n_c - i0;")],
    # phase 2's body, shared by v3 (row 13), v2 (row 7) and v1 (row 5)
    "phase2_self_by_d2": [(PBF_SRC, "const bool self = c0 + e == ci.self_e;",
                           "const bool self = norm2_rn(__fsub_rn(ci.x, s.x), __fsub_rn(ci.y, s.y), "
                           "__fsub_rn(ci.z, s.z)) == 0.0f;")],
    "phase2_dead_slots_in_part": [(PBF_SRC, "const float cr_i = live[i] ? c[i].a.cra : 0.0f,",
                                   "const float cr_i = c[i].a.cra,")],
    # phase 1's body, shared by v3 (row 12) and v2 (row 6)
    "phase1_self_by_d2": [(PBF_SRC, "s.z, c0 + e == ci.self_e, k);",
                           "s.z, norm2_rn(__fsub_rn(ci.x, s.x), __fsub_rn(ci.y, s.y), "
                           "__fsub_rn(ci.z, s.z)) == 0.0f, k);")],
    "phase1_c2a_unselected": [(PBF_SRC, "ci.a.c2a = p.cg != 0.0f ? fmaf(p.cg * p.cg, p.d2, ci.a.c2a) "
                               ": ci.a.c2a;", "ci.a.c2a = fmaf(p.cg * p.cg, p.d2, ci.a.c2a);")],
    "phase1_stages_one_short": [(PBF_SRC, "fnx::NO_W>(list, tab, c0, left > 0 ? g.n_tot : 0,",
                                 "fnx::NO_W>(list, tab, c0, left > 0 ? g.n_tot - 1 : 0,")],
    "phase1_empty_rows_unwritten": [(PBF_SRC, "if (g.row <= C) {  // dead slots, or the row's every slot",
                                     "if (g.row <= C && g.n_c > 0) {")],
    # the DSUM epilogue (v2 and v1)
    "phase2_v2_dead_slots_in_part": [(PBF_SRC, "const float cr_i = live[i] ? c[i].a.cra : 0.0f,",
                                      "const float cr_i = live[i] || OUT == DSUM ? c[i].a.cra : 0.0f,")],
    "phase2_v2_empty_rows_unwritten": [(PBF_SRC, "zero_span<ROW_LANES>(xo + (size_t)row * M * 3,",
                                        "if (n_c > 0) zero_span<ROW_LANES>(xo + (size_t)row * M * 3,")],
    # row 6 alone: its RAW zeros, and its launches (inv_p0 = 0) taking c2a unselected
    "phase1_v2_empty_rows_unwritten": [(PBF_SRC, "      zero_span<L>(o1 + 3 * o, 3 * g.n_c, 3 * M, g.sub, all4);",
                                        "      if (g.n_c > 0) zero_span<L>(o1 + 3 * o, 3 * g.n_c, 3 * M, g.sub, all4);")],
    "phase1_v2_c2a_unselected": [(PBF_SRC, "ci.a.c2a = p.cg != 0.0f ? fmaf(",
                                  "ci.a.c2a = p.cg != 0.0f || k.inv_p0 == 0.0f ? fmaf(")],
    # row 5 alone: the gathered source
    "gathered_stages_one_short": [(PBF_SRC, "(list, tab, c0, left > 0 ? g.n_tot : 0, kn,",
                                   "(list, tab, c0, left > 0 ? g.n_tot - (int)Src::GATHERED : 0, kn,")],
    "gathered_self_by_d2": [
        (PBF_SRC, "Cen2 (&c)[ROW_CPL], const PairConsts& k0) {",
         "Cen2 (&c)[ROW_CPL], const PairConsts& k0, bool by_d2 = false) {"),
        (PBF_SRC, "const bool self = c0 + e == ci.self_e;",
         "const bool self = by_d2 ? norm2_rn(__fsub_rn(ci.x, s.x), __fsub_rn(ci.y, s.y), "
         "__fsub_rn(ci.z, s.z)) == 0.0f : c0 + e == ci.self_e;"),
        (PBF_SRC, "(list, c0, kn, c, k);\n      else\n        phase2_sweep<ROW_CPL, IP>(list, c0, kn, c, k);",
         "(list, c0, kn, c, k, Src::GATHERED);\n      else\n"
         "        phase2_sweep<ROW_CPL, IP>(list, c0, kn, c, k, Src::GATHERED);")],
    "row_c_reads_ncnt": [(PAIR_SRC, "return active ? row * 27 + j : -1;",
                          "return active || j < 27 ? row * 27 + j : -1;")],
    "phase2_v1_dead_slots_in_part": [(PBF_SRC, "const float cr_i = live[i] ? c[i].a.cra : 0.0f,",
                                      "const float cr_i = live[i] || Src::GATHERED ? c[i].a.cra : 0.0f,")],
    # row 4 alone: phase 1's body over the gathered rows
    "row4_self_by_d2": [
        (PBF_SRC, "Cen1 (&c)[CPL],\n                                             const PairConsts& k) {",
         "Cen1 (&c)[CPL],\n                                             const PairConsts& k, bool by_d2 = false) {"),
        (PBF_SRC, "s.z, c0 + e == ci.self_e, k);",
         "s.z, by_d2 ? norm2_rn(__fsub_rn(ci.x, s.x), __fsub_rn(ci.y, s.y), "
         "__fsub_rn(ci.z, s.z)) == 0.0f : c0 + e == ci.self_e, k);"),
        (PBF_SRC, "(list, c0, kn, c, k);\n      else\n        phase1_sweep<CPL, CPL, SKIP>(list, c0, kn, c, k);",
         "(list, c0, kn, c, k, Src::GATHERED);\n      else\n"
         "        phase1_sweep<CPL, CPL, SKIP>(list, c0, kn, c, k, Src::GATHERED);")],
    "row4_skip_tightened": [
        (PBF_SRC, "Cen1 (&c)[CPL],\n                                             const PairConsts& k) {",
         "Cen1 (&c)[CPL],\n                                             const PairConsts& k, bool tight = false) {"),
        (PBF_SRC, "__fsub_rn(c[i].z, s.z)) <= k.h2 * P1_REACH;",
         "__fsub_rn(c[i].z, s.z)) <= k.h2 * (tight ? 0.95f : P1_REACH);"),
        (PBF_SRC, "(list, c0, kn, c, k);\n      else\n        phase1_sweep<CPL, CPL, SKIP>(list, c0, kn, c, k);",
         "(list, c0, kn, c, k, Src::GATHERED);\n      else\n"
         "        phase1_sweep<CPL, CPL, SKIP>(list, c0, kn, c, k, Src::GATHERED);")],
}
_RASTER_MUTANT_CHECK = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs._fail = lambda msg: print("FAIL:", str(msg)[:1500], flush=True)
cs.raster_checks(torch.device("cuda"))
"""
_PAIRS_MUTANT_CHECK = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs._fail = lambda msg: print("FAIL:", str(msg)[:1500], flush=True)
cs.pairs_checks(torch.device("cuda"))
"""
# name: (mutants, the libraries they build, the checks they run)
MUTANT_GROUPS = {"attention": (BWD_MUTANTS, ["attention", "attention_bwd"], _MUTANT_CHECK),
                 "rasterizer": (RASTER_MUTANTS, ["rasterizer"], _RASTER_MUTANT_CHECK),
                 "pairs": (PAIRS_MUTANTS, ["pbf", "splat"], _PAIRS_MUTANT_CHECK)}


def raster_checks(dev):
    """The rasterizer kernels against their plain versions at camera 0's
    main-path tiles, at its tiles of OTHER_TILES and at each edge case of
    ``tests/torch_helpers.edge_tiles``
    (C = 1 and 3), and the forward's skip and the backward's re-sweep bit for
    bit there and at ``threshold_tiles``: what a rasterizer mutant has to get
    past."""
    import types

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from tests.torch_helpers import EDGE_CASES, edge_tiles, threshold_tiles

    cfg = load_config("configs/smoke_dynamics.json")
    cfg.seed = SEED
    rc = raster_config_from(cfg)
    scene, bg = smoke_scene(), synthetic_background(32768, dev)
    check_kernels(*main_path_tiles(cfg, scene, bg, dev), rc)
    other_tile_checks(cfg, scene, bg, dev)
    for case in EDGE_CASES:
        for c in (1, 3):
            print(f"edge case {case}, C = {c}:")
            packed, counts, gid, n, tiles_x = edge_tiles(case, c, seed=c)
            check_kernels(*(torch.as_tensor(a, device=dev) for a in (packed, gid, counts)),
                          tiles_x, n, types.SimpleNamespace(tile_x=16, tile_y=16, chunk=32))
    failures = []
    for c in (1, 3):
        packed, counts, tiles_x = threshold_tiles(c, seed=c)
        failures += exact_skip_and_resweep(torch.as_tensor(packed, device=dev),
                                           torch.as_tensor(counts, device=dev), tiles_x, 16, 16,
                                           f"threshold tiles, C = {c}")
    if failures:
        _fail(f"the rasterizer's exact checks failed: {failures}")


def run_mutants(groups=tuple(MUTANT_GROUPS)):
    """``python3 chip_smoke.py mutants [GROUP]``: each mutant of the groups
    (MUTANT_GROUPS: the attention backward's, the rasterizer's) in a copy of
    the checkout under a temporary directory (all built in parallel), then
    its group's checks on it, with ``_fail`` made to print. A mutant must
    fail at least one check."""
    import shutil

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the mutants run on an NVIDIA card")
    root = os.path.dirname(os.path.abspath(__file__))
    mutants = {name: (edits, libs, check) for g in groups
               for edits_by_name, libs, check in [MUTANT_GROUPS[g]]
               for name, edits in edits_by_name.items()}
    with tempfile.TemporaryDirectory(prefix="fnx_mutants_") as tmp:
        procs = {}
        for name, (edits, libs, _) in mutants.items():
            dst = os.path.join(tmp, name)
            shutil.copytree(root, dst, ignore=shutil.ignore_patterns(
                "_build", "chiprun_out", "_checkout", ".git", "__pycache__"))
            for rel, old, new in edits:
                path = os.path.join(dst, rel)
                with open(path) as f:
                    src = f.read()
                if old not in src:
                    _fail(f"mutant {name}: {old!r} is not in {rel}")
                with open(path, "w") as f:
                    f.write(src.replace(old, new))
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", "from fluidnexus_torch.ops import cuda_build; "
                 f"cuda_build.build({libs!r})"], cwd=dst)
        if any(p.wait() for p in procs.values()):
            _fail("a mutant did not build")
        survived = []
        for name, (_, _, check) in mutants.items():
            out = subprocess.run([sys.executable, "-c", check], capture_output=True,
                                 text=True, cwd=os.path.join(tmp, name))
            print(f"===== mutant {name} (rc {out.returncode})\n{out.stdout[-6000:]}"
                  f"{out.stderr[-1500:]}", flush=True)
            if out.returncode != 0 or "FAIL:" not in out.stdout:
                survived.append(name)
    if survived:
        _fail(f"mutants that failed no check (or did not run): {survived}")
    print(f"every mutant of {list(mutants)} failed a check")


def _parent_module(parent, tmp, lib, module):
    """The wrappers of another checkout (root ``parent``): its module
    ``module`` (a path under the root) loaded as a module of its own and bound
    to that checkout's ``fluidnexus_torch/csrc/<lib>.cu``, built into
    ``tmp`` (the pbf wrappers through ``_counts_first``). Returns (module,
    the nvcc process to wait for)."""
    import ctypes
    import importlib.util
    import types
    from fluidnexus_torch.ops import cuda_build

    lib_path = os.path.join(tmp, f"libparent_{lib}.so")
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib_path,
                             os.path.join(parent, f"fluidnexus_torch/csrc/{lib}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spec = importlib.util.spec_from_file_location(f"parent_{lib}_wrappers",
                                                  os.path.join(parent, module))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(lib_path), check=cuda_build.check,
        raise_on=cuda_build.raise_on, require_cuda=cuda_build.require_cuda)
    return (_counts_first(mod) if lib == "pbf" else mod), proc


def _wait_parent_build(proc, lib):
    log, _ = proc.communicate()
    print(f"build of the parent's {lib}.cu:\n{log.strip()}")
    if proc.returncode != 0:
        _fail(f"the parent's {lib}.cu did not build")


def in_turns(name, kernel, call, pmod, this):
    """``call(module)`` timed on the card for the parent's wrappers and this
    checkout's in turns (parent, this, this, parent); prints the row."""
    row = []
    for who, m in (("parent", pmod), ("this", this), ("this", this), ("parent", pmod)):
        ms, rec, extra, n_other = device_ms_with_others(lambda: call(m), kernel)
        row.append(f"{who} {ms:.4f} ({rec}) + {extra:.4f} in {n_other} other kernels")
    print(f"{name} on the card, ms per call in turns: {', '.join(row)}")


def raster_time(parent=None):
    """``python3 chip_smoke.py raster [PARENT]``: the rasterizer kernels alone
    at camera 0's main-path tiles (the phase-A scene, without its fit): builds
    ``rasterizer`` only, prints the tiles' count distribution and the
    kernels' occupancy, holds each kernel against its plain version and
    times it on the card beside its plain version and ``index_add_``. With
    the root of another checkout as PARENT (a ``git archive`` of the parent
    commit), that checkout's ``csrc/rasterizer.cu`` is built as well and its
    three kernels are held bit for bit and timed through its own wrappers in
    turns with this checkout's (parent, this, this, parent) on the same
    inputs (``parent_in_turns``). Last, ``other_tile_checks`` holds and times
    this checkout's kernels at camera 0's tiles of OTHER_TILES."""
    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="fnx_raster_") as tmp:
        pmod, proc = (_parent_module(parent, tmp, "rasterizer", "fluidnexus_torch/ops/rasterizer_cuda.py")
                      if parent else (None, None))
        try:
            built = cuda_build.build(["rasterizer"])
        except RuntimeError as e:  # the parent's kernels are still timed below
            built = e
        if proc is not None:
            _wait_parent_build(proc, "rasterizer")
        cfg = load_config("configs/smoke_dynamics.json")
        cfg.seed = SEED
        rc = raster_config_from(cfg)
        scene = smoke_scene()
        bg = synthetic_background(32768, dev)
        packed_t, tile_gauss, counts, tiles_x, n = main_path_tiles(cfg, scene, bg, dev)
        print(f"camera 0 tiles: T {packed_t.shape[0]} K {packed_t.shape[1]} F {packed_t.shape[2]} "
              f"live slots {int(counts.sum())}")
        print(count_distribution(counts, rc.tile_capacity))
        tx, ty = rc.tile_x, rc.tile_y
        if pmod is not None:  # the parent alone first, whatever this checkout's build did
            p_acc, p_ft, _, p_ckpt = pmod.composite_fwd(packed_t, counts, tiles_x, tx, ty)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            pg = [torch.randn(a.shape, generator=gen, device=dev) for a in (p_acc, p_ft)]
            for name, kernel, fn in (
                    ("composite_fwd", "composite_fwd_kernel",
                     lambda: pmod.composite_fwd(packed_t, counts, tiles_x, tx, ty)),
                    ("composite_bwd", "composite_bwd_kernel",
                     lambda: pmod.composite_bwd(packed_t, counts, *pg, p_ft, p_ckpt, tiles_x, tx, ty))):
                ms, rec, extra, n_other = device_ms_with_others(fn, kernel)
                print(f"parent alone: {name} {ms:.4f} ms on the card ({rec}) + {extra:.4f} in "
                      f"{n_other} other kernels")
        if isinstance(built, RuntimeError):
            raise built
        for name, info in built.items():
            print(f"build {name}: {info['seconds']:.1f} s\n{info['log'].strip()}")
        px_share, group_share = drawn_share(packed_t, counts, tiles_x, rc.tile_x, rc.tile_y)
        print(f"live slots draw on {100 * px_share:.1f} % of their (slot, pixel) pairs and on some "
              f"pixel of {100 * group_share:.1f} % of their (slot, 64-pixel warp group) pairs")
        print(f"rasterizer kernels (registers, shared bytes, threads, blocks per SM): "
              f"{tc.occupancy(packed_t.shape[2] - 7, rc.tile_x, rc.tile_y)}")
        errors, saved = check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc)
        times, live_slots = time_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc, saved)
        raster_entries(times, live_slots, errors, {k: 0 for k in times}, 1)
        if pmod is not None:
            parent_in_turns(pmod, packed_t, tile_gauss, counts, tiles_x, n, rc, saved)
        other_tile_checks(cfg, scene, bg, dev, timed=True)


def parent_in_turns(pmod, packed_t, tile_gauss, counts, tiles_x, n, rc, saved):
    """The parent's rasterizer wrappers ``pmod`` against this checkout's at
    camera 0's tiles: whether each kernel's outputs are bit-identical to the
    parent's on the same inputs (the forward's accum, final T, median and its
    checkpoints of the live windows, the only ones it writes; the backward's
    packed gradient; the combine's rows at one slot a row, since at the main
    path's ids, a Gaussian in many tiles, its atomics add in no fixed order,
    and two runs of one build part too, which is printed beside it), the
    backward's difference per field, then the three kernels timed in turns
    (parent, this, this, parent)."""
    from fluidnexus_torch.ops import rasterizer_cuda as tc

    tx, ty = rc.tile_x, rc.tile_y
    g = (saved["gacc"], saved["gft"], saved["ft"], saved["ckpt"])
    k = packed_t.shape[1]
    nwin = (counts.long() + tc.CKPT - 1) // tc.CKPT
    live_win = torch.arange(-(-k // tc.CKPT), device=counts.device)[None, :] < nwin[:, None]
    fwd_p = pmod.composite_fwd(packed_t, counts, tiles_x, tx, ty)
    fwd_t = tc.composite_fwd(packed_t, counts, tiles_x, tx, ty)
    same = {"composite_fwd": all(bits_equal(a, b) for a, b in zip(fwd_p[:3], fwd_t[:3]))
            and bits_equal(fwd_p[3][live_win], fwd_t[3][live_win])}
    dpk_parent = pmod.composite_bwd(packed_t, counts, *g, tiles_x, tx, ty)
    dpk_this = tc.composite_bwd(packed_t, counts, *g, tiles_x, tx, ty)
    same["composite_bwd"] = bits_equal(dpk_parent, dpk_this)
    one = torch.arange(counts.numel() * k, device=counts.device).view(counts.numel(), k)
    same["combine_rows at one slot a row"] = bits_equal(
        pmod.combine_rows(saved["dpk"], one, counts, one.numel()),
        tc.combine_rows(saved["dpk"], one, counts, one.numel()))
    same["combine_rows at the main path's ids"] = bits_equal(
        pmod.combine_rows(saved["dpk"], tile_gauss, counts, n),
        tc.combine_rows(saved["dpk"], tile_gauss, counts, n))
    same["combine_rows at those ids, this twice"] = bits_equal(
        tc.combine_rows(saved["dpk"], tile_gauss, counts, n),
        tc.combine_rows(saved["dpk"], tile_gauss, counts, n))
    print(f"this against the parent at {tx} x {ty} tiles, bit-identical: {same}")
    scale = dpk_parent.abs().amax((0, 1)).clamp_min(1e-30)
    print("composite_bwd this against the parent, max|diff| / max|parent| per field: "
          + ", ".join(f"{v:.2e}" for v in ((dpk_this - dpk_parent).abs().amax((0, 1))
                                           / scale).tolist()))
    calls = {
        "composite_fwd": ("composite_fwd_kernel",
                          lambda m: m.composite_fwd(packed_t, counts, tiles_x, tx, ty)),
        "composite_bwd": ("composite_bwd_kernel",
                          lambda m: m.composite_bwd(packed_t, counts, *g, tiles_x, tx, ty)),
        "combine_rows": ("combine_kernel",
                         lambda m: m.combine_rows(saved["dpk"], tile_gauss, counts, n))}
    for name, (kernel, call) in calls.items():
        in_turns(name, kernel, call, pmod, tc)


PAIRS_ROWS = {"density_fwd": 8, "density_bwd": 9, "splat_fwd": 10, "splat_bwd": 11,  # rows of
              "pbf_phase1": 12, "pbf_phase2": 13, "pbf_phase1_v2": 6,  # PERF.md's kernel table
              "pbf_phase2_v2": 7, "pbf_phase1_v1": 4, "pbf_phase2_v1": 5}
PAIRS_LIBS = {name: "splat" if name.startswith("splat") else "pbf" for name in PAIRS_ROWS}
PAIRS_PART = ("pbf_phase2", "pbf_phase2_v2", "pbf_phase2_v1")  # rows with per-row partial sums
V2_V1_ROWS = ("pbf_phase1_v2", "pbf_phase2_v2", "pbf_phase1_v1", "pbf_phase2_v1")
SPLAT_CHUNK = 256  # list entries either splat kernel stages at once (csrc/splat.cu)
SPLAT_EDGES = ((32, 0), (128, 0), (32, 1100))  # (source capacity, queries piled in one cell)
P1_CHUNK = 256  # list entries phase 1 (v3 and v2) stages at once (csrc/pbf.cu)
P2_CHUNK = 256  # list entries phase 2 (v3, v2 and v1) stages at once (csrc/pbf.cu)
PHASE_B, RIGID, PHASE_C = "phase B's first tick", "the rigid inputs", "phase C"


def pair_kernel(name):
    """The CUDA kernel name of pair kernel ``name`` (a row of PAIRS_ROWS)."""
    return PHASE_C_KERNELS[name][2] if name in PHASE_C_KERNELS else PBF_KERNELS[name]


def with_part(module, name, args, out):
    """``out``, the wrapper's outputs of ``name`` at ``args``, with the per-row
    partial sums of phase 2 (v3, v2, v1) through the C entry of ``module``."""
    from tests.torch_helpers import phase2_part

    out = (out,) if torch.is_tensor(out) else tuple(out)
    if name not in PAIRS_PART:
        return out
    if name == "pbf_phase2_v1" and getattr(module, "counts_first", False):
        return out + (_counts_first_phase2_v1_part(module, args),)
    return out + phase2_part(module, name, args)[-1:]


def _counts_first(mod):
    """``mod``, the pbf wrappers of another checkout, made to take this
    checkout's v1 arguments where its v1 wrappers and C entries take the row
    counts ``cnt`` (C+1,) after the gathered tensors: cnt is then made from
    each gathered row's own count, ncnt[:, 13], and 0 for row C. Its phase 1
    v1 is then the one-block-a-row walk, whatever ``walk`` asks. Such a
    module is marked ``counts_first``; any other is returned as it is."""
    import inspect

    from fluidnexus_torch.sim import pbf_cuda as pc

    if "cnt" not in inspect.signature(mod.phase1_v1_slots).parameters:
        return mod
    p1, p2 = mod.phase1_v1_slots, mod.phase2_v1_slots
    mod.phase1_v1_slots = lambda ncnt, xng, *a, walk=False: p1(ncnt, xng, pc._own_counts(ncnt), *a)
    mod.phase2_v1_slots = lambda ncnt, xng, lng, *a: p2(ncnt, xng, lng, pc._own_counts(ncnt), *a)
    mod.phase1_v1_slots.__name__, mod.phase2_v1_slots.__name__ = "phase1_v1_slots", "phase2_v1_slots"
    mod.counts_first = True
    return mod


def _counts_first_phase2_v1_part(mod, args):
    """The per-row partial sums (C+1, 2) of phase 2 v1 through the C entry of
    a ``_counts_first`` module at this checkout's arguments ``args`` (ncnt,
    xng, lng, x, y, z, lam, k)."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    ncnt, xng, lng, x, y, z, lam, k = args
    cnt = pc._own_counts(ncnt)
    c, m = x.shape[0] - 1, x.shape[1]
    dsum = torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device)
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    err = mod._lib().fnx_pbf_phase2_v1(
        *(t.data_ptr() for t in (cnt, ncnt, xng, lng, x, y, z, lam, dsum, part)), c, m, k.h, k.h2,
        k.eps, k.c6, k.s45, k.k_p, k.e_p, k.int_pow, k.inv_denom, mod._stream(x))
    if err:
        raise RuntimeError(f"pbf_phase2_v1's C entry returned {err}")
    return part


def rigid_inputs_by_train(cfg, scene, bg, dev, tmp):
    """The rigid rollout's first-iteration inputs made as the main run makes
    them: ``train`` A -> B -> C at the smoke widths (``cfg``, phase C's, on
    ``scene`` and ``bg``) with its checkpoints under ``tmp``, then phase C's
    frame-2 checkpoint and the future config's cylinder (``rigid_state``) and
    ``rigid_first_inputs``, its row statistics printed; then
    ``check_rigid_kernels`` there (this checkout's kernels). Returns (inputs,
    what the check saved: lambda, the v1 pre-gathers, the in-radius
    counts)."""
    from fluidnexus_torch.pipelines import train_physical_particle as tp

    cfg.model.model_path = os.path.join(tmp, "recon")
    try:
        tp.train(cfg, scene, bg=bg, log=lambda *a, **k: None, device="cuda")
    finally:
        cfg.model.model_path = ""
    fcfg = future_config(os.path.join(tmp, "recon"), os.path.join(tmp, "future"))
    params, state0, _, _ = rigid_state(fcfg, dev)
    inp = rigid_first_inputs(params, state0)
    return inp, check_rigid_kernels(inp)[1]


def pairs_time(parent=None):
    """``python3 chip_smoke.py pairs [PARENT]``: the pair kernels of rows 4-13
    of PERF.md's kernel table alone: the gas-loss density, its adjoint, the
    splat forward and the splat adjoint at the first phase-C fit
    iteration's inputs, made as ``train`` makes them (phases A and B, frame
    1's simulation; the rasterizer, pbf and splat libraries are built for
    that); phases 1 and 2 of the PBF tick (v3), 1 and 2 v2 and 1 and 2 v1 at
    phase B's first tick (``first_tick_inputs``, lambda and nc from the plain
    versions); and phases 1 and 2 v2 and v1 again at the rigid rollout's
    first-iteration inputs, where they run (``rigid_inputs_by_train``: ``train``
    A -> B -> C as the main run calls it, then the rollout's first grid).
    Prints the grids' live rows, slots and lists (``row_stats`` for phase B's
    and the rigid grid), the splat adjoint's source rows with a query in
    reach, each kernel against its plain version (outputs in NaN-filled
    blocks; phases 1 and 2 v3 as ``check_pbf_kernels`` holds them, phase 2 v2
    and v1 with their per-row partial sums; at the rigid inputs as
    ``check_rigid_kernels`` holds them), and every kernel's time on the card
    beside its bound and its launch floors: the same launch with every count
    0 and, for the splat forward, with every source count 0 and the queries
    live, for the splat adjoint with every query count 0 and the sources
    live. With the root of another checkout as PARENT (a ``git archive`` of
    the parent commit), that checkout's ``csrc/pbf.cu`` and ``csrc/splat.cu``
    are built as well, its kernels are timed alone (phase B's before any
    kernel of this checkout runs) and held against this one's bit for bit at
    each input (phase 2's per-row partial sums too), and both are timed in
    turns (parent, this, this, parent), floors included."""
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    this = {"pbf": pc, "splat": sc}
    with tempfile.TemporaryDirectory(prefix="fnx_pairs_") as tmp:
        pmods, procs = {}, {}
        if parent:
            for lib, module in (("pbf", "fluidnexus_torch/sim/pbf_cuda.py"),
                                ("splat", "fluidnexus_torch/sim/splat_cuda.py")):
                pmods[lib], procs[lib] = _parent_module(parent, tmp, lib, module)
        for name, info in cuda_build.build(["rasterizer", "pbf", "splat"]).items():
            print(f"build {name}: {info['seconds']:.1f} s\n{info['log'].strip()}")
        for lib, proc in procs.items():
            _wait_parent_build(proc, lib)

        plans, runs = {}, {}  # (name, where): (wrapper, plain, args, bytes, ops); (name, where, what): args

        def call(module, name, where, args):
            return getattr(module, plans[(name, where)][0].__name__)(*args)

        def add(where, new_plans):
            for name, plan in new_plans.items():
                plans[(name, where)] = plan
                runs[(name, where, "the kernel")] = plan[2]
                for label, args in launch_floors(name, plan[2]).items():
                    runs[(name, where, f"launch floor, {label}")] = args

        def time_alone(modules, who, where):
            for (name, w, what), args in runs.items():
                if w == where:
                    ms, rec = kernel_device_ms(
                        lambda: call(modules[PAIRS_LIBS[name]], name, w, args), pair_kernel(name))
                    bound = ""
                    if what == "the kernel":
                        b_ms, b_by = bound_ms(*plans[(name, w)][3:])
                        bound = f", bound {b_ms:.5f} ms by {b_by}"
                    print(f"{who}: row {PAIRS_ROWS[name]} {name} at {w}, {what} {ms:.4f} ms on the "
                          f"card ({rec}){bound}")

        # phase B's first tick: no kernel of this checkout runs to make it
        cfg_b, params_b = phase_b_config()
        inp_b = first_tick_inputs(cfg_b, params_b, dev)
        saved_b = pbf_plain_saved(inp_b)
        add(PHASE_B, {**pbf_plans(inp_b, saved_b), **v2_v1_plans(inp_b, saved_b)})
        if pmods:
            time_alone(pmods, "parent alone", PHASE_B)

        cfg = phase_c_config()
        scene = smoke_scene()
        bg = synthetic_background(32768, dev)
        render_ground_truth(cfg, scene, bg, dev)
        inp = first_iteration_inputs(phase_c_start(cfg, scene, bg, dev))
        b = inp["density_bwd"]
        nbr, cnt = b[0], b[1]
        dc = density_counts(b[:5] + b[6:])
        lists = cnt[nbr.long()].sum(1)[cnt[:-1] > 0].float()
        print(f"rows 8 and 9's inputs: C {nbr.shape[0]} M {b[2].shape[1]}, {dc['rows']} live cells, "
              f"{dc['n_src']} live slots (fullest cell {int(cnt.max())}), {dc['cand']} live "
              f"candidate pairs, {dc['in_radius']} in radius (self included); a live cell's "
              f"neighbourhood holds {float(lists.mean()):.1f} live slots on average, at most "
              f"{int(lists.max())}")
        f = inp["splat_fwd"]
        qnbr, qcnt, scnt = f[0], f[2], f[6]
        slists = scnt[qnbr.long()].sum(1)[qcnt[:-1] > 0].float()
        print(f"row 10's inputs: Cq {qnbr.shape[0]}, Nq {f[3].shape[0]}, "
              f"{int((qcnt[:-1] > 0).sum())} live query rows holding {int(qcnt.sum())} queries "
              f"(fullest row {int(qcnt.max())}); their source lists {float(slists.mean()):.1f} "
              f"entries on average, at most {int(slists.max())}; {int((slists == 0).sum())} live "
              f"query rows have no source in reach")
        s = inp["splat_bwd"]
        rows, sources, qlists = splat_bwd_reach(s)
        print(f"row 11's inputs: Cs {s[0].shape[0]} Ms {s[2].shape[1]}, Cq {s[7].numel() - 1}; "
              f"{int((s[1][:-1] > 0).sum())} live source rows holding {int(s[1].sum())} sources, "
              f"{int(s[7].sum())} listed queries; {rows} source rows holding {sources} sources "
              f"have a query in reach, their query lists {float(qlists.mean()):.1f} entries on "
              f"average, at most {int(qlists.max())}")
        add(PHASE_C, phase_c_plans(inp))
        if pmods:
            time_alone(pmods, "parent alone", PHASE_C)

        inp_r, saved_r = rigid_inputs_by_train(cfg, scene, bg, dev, tmp)
        add(RIGID, v2_v1_plans(inp_r, saved_r))
        if pmods:
            time_alone(pmods, "parent alone", RIGID)

        failures = []
        for name in PHASE_C_KERNELS:
            failures += held_in_nan_blocks(name, plans[(name, PHASE_C)][2],
                                           f"row {PAIRS_ROWS[name]}")[1]
        for name in ("pbf_phase1_v2", "pbf_phase1_v1"):
            failures += held_in_nan_blocks(name, plans[(name, PHASE_B)][2],
                                           f"row {PAIRS_ROWS[name]} at {PHASE_B}")[1]
        for name in ("pbf_phase2_v2", "pbf_phase2_v1"):
            failures += held_phase2_raw(name, plans[(name, PHASE_B)][2], inp_b["live"],
                                        f"row {PAIRS_ROWS[name]} at {PHASE_B}")[1]
        if failures:
            _fail(f"the pair kernels disagree with their plain versions: {failures}")
        check_pbf_kernels(inp_b)  # rows 12 and 13, into NaN-filled blocks
        for where in (PHASE_B, PHASE_C, RIGID):
            time_alone(this, "this checkout", where)
        if not pmods:
            return
        for (name, where), plan in plans.items():
            lib = PAIRS_LIBS[name]
            mine, theirs = (with_part(m, name, plan[2], call(m, name, where, plan[2]))
                            for m in (pc if lib == "pbf" else sc,
                                      pmods[lib]))
            if name == "splat_fwd":  # the listed entries and entry Nq: this one writes no other
                from tests.torch_helpers import listed_mask

                listed = listed_mask(plan[2][1], plan[2][2], plan[2][3].shape[0])
                listed[-1] = True
                mine, theirs = (mine[0][listed],), (theirs[0][listed],)
            diff = max(float((a - b).abs().max()) for a, b in zip(mine, theirs))
            same = [bits_equal(a, b) for a, b in zip(mine, theirs)]
            print(f"row {PAIRS_ROWS[name]} {name} at {where} this against the parent: max|diff| "
                  f"{diff:.3e}, bit-identical {all(same)} (per output {same})")
        for (name, where, what), args in runs.items():
            lib = PAIRS_LIBS[name]
            in_turns(f"row {PAIRS_ROWS[name]} {name} at {where}, {what}", pair_kernel(name),
                     lambda m, n=name, w=where, a=args: call(m, n, w, a), pmods[lib], this[lib])


def pbf_variants(parent, *variants):
    """``python3 chip_smoke.py pbf-variants PARENT VARIANT...``: the PBF pair
    kernels of source variants against another checkout, PARENT, at phase
    B's first tick (rows 12, 13, 6, 7, 4 and 5 of PERF.md's kernel table) and
    at the rigid rollout's first-iteration inputs (rows 6, 7, 4 and 5; made
    by ``rigid_inputs_by_train``, which builds this checkout's rasterizer,
    pbf and splat). Each root holds ``fluidnexus_torch/csrc`` and
    ``sim/pbf_cuda.py`` (a copy of the checkout with its sources edited). For
    each variant: whether every output, phase 2's per-row partial sums too,
    is bit-identical to the parent's at both inputs, then rows 6 and 5 and
    their launch floors timed in turns (parent, variant, variant, parent) at
    both inputs."""
    from fluidnexus_torch.ops import cuda_build

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="fnx_variants_") as tmp:
        mods, procs = {}, {}
        for i, root in enumerate((parent,) + variants):
            os.makedirs(os.path.join(tmp, str(i)))
            mods[root], procs[root] = _parent_module(root, os.path.join(tmp, str(i)), "pbf",
                                                     "fluidnexus_torch/sim/pbf_cuda.py")
        cuda_build.build(["rasterizer", "pbf", "splat"])
        for root, proc in procs.items():
            print(f"{root}:", end=" ")
            _wait_parent_build(proc, "pbf")
        cfg, params = phase_b_config()
        inp = first_tick_inputs(cfg, params, dev)
        saved = pbf_plain_saved(inp)
        plans = {PHASE_B: {**pbf_plans(inp, saved), **v2_v1_plans(inp, saved)}}
        cfg_c = phase_c_config()
        scene = smoke_scene()
        bg = synthetic_background(32768, dev)
        render_ground_truth(cfg_c, scene, bg, dev)
        plans[RIGID] = v2_v1_plans(*rigid_inputs_by_train(cfg_c, scene, bg, dev, tmp))
        pm = mods[parent]
        for root in variants:
            vm = mods[root]
            for where, at in plans.items():
                for name, (fn, _, args, _, _) in at.items():
                    outs = [with_part(m, name, args, getattr(m, fn.__name__)(*args))
                            for m in (vm, pm)]
                    same = [bits_equal(a, b) for a, b in zip(*outs)]
                    print(f"{root}: row {PAIRS_ROWS[name]} {name} at {where} against {parent}: "
                          f"bit-identical {all(same)} (per output {same})")
            for where, at in plans.items():
                for name in ("pbf_phase1_v2", "pbf_phase2_v1"):
                    fn, _, args, _, _ = at[name]
                    for label, a in [("the kernel", args)] + list(launch_floors(name, args).items()):
                        in_turns(f"{root}: row {PAIRS_ROWS[name]} {name} at {where}, {label}",
                                 pair_kernel(name),
                                 lambda m, f=fn.__name__, a=a: getattr(m, f)(*a), pm, vm)


def pairs_checks(dev):
    """The gas-loss density, its adjoint, both splat kernels, phase 1 v3 and
    phase 2 (v3 and v2) against their plain versions, every output written
    into NaN-filled blocks: the density pair at M = 32 and M = 128 over seeded points with
    full rows and one isolated point, whose 26 neighbour cells are empty (its
    pi must be the plain version's bit for bit: the self term alone); the
    splat adjoint at source capacities 32 and 128 and with a pile of 1 100
    queries in one cell (SPLAT_EDGES), with full source rows, query lists
    that span several staged chunks, and source rows with no query in
    reach, which must read exactly 0, as must row Cs; the splat forward at
    the same cases with full source rows whose lists span several chunks,
    query rows of two or more 32-query work items (the pile's 36), and over
    1 024 query rows (two tiles of the work items' scan) with no source in
    reach, whose queries must read exactly 0, as must entry Nq; phase 2 at M = 32 and M = 128, at e_p 4 and
    2.5, over the density's grid with two live particles at one position in
    one row (a non-self pair at d2 = 0), whose isolated point must keep its
    coordinates bit for bit (its update is exactly 0), and phase 2 v2 there
    (its dsum and each row's partial sums, the isolated point's dsum exactly
    0); phase 1 v3 at M = 32 and M = 128 over such a grid, nl exact, the
    isolated point's pi_raw and nl bit for bit (its self pair alone); phases
    1 v3, v2 and v1 against phase 1 v1's checking mode, the walk, over 20
    coincident pairs and over graded rows at the default epsilon
    (``tests/torch_helpers.phase1_against_the_walk``: only sums that take the
    self pair by index, in the walk's order, round alike); and
    ``graded_rows_checks``. What a pairs mutant has to get past."""
    from fluidnexus_torch.sim import pbf as tpbf
    from fluidnexus_torch.sim import pbf_cuda as pc
    from fluidnexus_torch.sim import splat_cuda as sc
    from tests.torch_helpers import (
        coincident_pairs_grid, graded_rows_grid, isolated_point_grid, phase1_against_the_walk,
        splat_edge_args, splat_fwd_edge_args,
    )

    failures = []
    k = pc.pair_consts(tpbf.PBFParams(h=1.0))
    for m in (32, 128):
        grid, rng = isolated_point_grid(m, dev, seed=m)
        cnt, *xyz = pc.planes(grid)
        live = grid.bmask
        g = torch.where(live, torch.as_tensor(rng.standard_normal(live.shape).astype(np.float32),
                                              device=dev), 0.0).contiguous()
        for name, args in (("density_fwd", (grid.nbr, cnt, *xyz, k)),
                           ("density_bwd", (grid.nbr, cnt, *xyz, g, k))):
            failures += [f"M {m}: {f}" for f in
                         held_in_nan_blocks(name, args, f"pairs check, M {m}")[1]]
        row, col = int(grid.prow[0]), int(grid.pcol[0])
        alone = int(cnt[grid.nbr[row].long()].sum()) == 1
        pi = pc.density_slots(grid.nbr, cnt, *xyz, k)[row, col]
        want = pc.density_plain(grid.nbr, cnt, *xyz, k)[row, col]
        full = bool((cnt == m).any())
        print(f"pairs check, M {m}: a full row {full}; the isolated point (alone: {alone}) pi "
              f"{float(pi):.9g}, plain {float(want):.9g}, bit for bit {bits_equal(pi, want)}")
        if not (full and alone and bits_equal(pi, want)):
            failures.append(f"M {m}: the full row or the isolated point")
    for ms, pile in SPLAT_EDGES:
        args = splat_edge_args(ms, pile, dev, seed=ms + pile)
        what = f"pairs check, splat adjoint Ms {ms}, pile {pile}"
        failures += [f"({ms}, {pile}): {f}" for f in held_in_nan_blocks("splat_bwd", args, what)[1]]
        scnt, qcnt = args[1], args[7]
        lists = qcnt[args[0].long()].sum(1)
        none = torch.nonzero((lists == 0) & (scnt[:-1] > 0))[:, 0]
        gx, gv = sc.splat_bwd_slots(*args)
        zero = not bool(gx[none].any() or gv[none].any())
        chunked = int(lists.max()) > SPLAT_CHUNK
        print(f"{what}: {len(none)} live source rows with no query in reach, all 0: {zero}; a "
              f"full source row {bool((scnt == ms).any())}; the fullest query row {int(qcnt.max())}; "
              f"the longest query list {int(lists.max())} entries (more than one chunk of "
              f"{SPLAT_CHUNK}: {chunked})")
        if not (len(none) > 0 and zero and chunked and int(qcnt.max()) > pile):
            failures.append(f"({ms}, {pile}): the rows with no query in reach or the lists")
        args = splat_fwd_edge_args(ms, pile, dev, seed=ms + pile + 2)
        what = f"pairs check, splat forward Ms {ms}, pile {pile}"
        failures += [f"fwd ({ms}, {pile}): {f}" for f in held_in_nan_blocks("splat_fwd", args, what)[1]]
        qnbr, qstart, qcnt, scnt = args[0], args[1], args[2], args[6]
        lists = scnt[qnbr.long()].sum(1)
        none = (lists == 0) & (qcnt[:-1] > 0)
        ent, _ = sc.listed_entries(qstart, qcnt, torch.nonzero(none).flatten())
        out = sc.splat_fwd_slots(*args)
        zero = not bool(out[ent].any() or out[-1].any())
        chunked = int(lists.max()) > SPLAT_CHUNK
        rows = int((qcnt > 0).sum())
        print(f"{what}: {len(ent)} listed queries of {int(none.sum())} rows with no source in "
              f"reach and entry Nq, all 0: {zero}; a full source row {bool((scnt == ms).any())}; "
              f"{rows} occupied query rows (past one tile of 1 024 of the work items' scan: "
              f"{rows > 1024}), the fullest {int(qcnt.max())} ({-(-int(qcnt.max()) // 32)} work "
              f"items); the longest source list {int(lists.max())} entries (more than one chunk "
              f"of {SPLAT_CHUNK}: {chunked})")
        if not (len(ent) > 0 and zero and chunked and int(qcnt.max()) > max(32, pile)
                and rows > 1024):
            failures.append(f"fwd ({ms}, {pile}): the rows with no source in reach or the lists")
    for m, e_p in ((32, 4.0), (32, 2.5), (128, 4.0), (128, 2.5)):
        # epsilon 1e-2: a pair at d2 = 0 has cg ~ eps^-1/2, whose terms the
        # update's sums then cancel; at the default 1e-8 the comparison would
        # read the two summation orders' rounding of ~1e4-times larger terms
        k2 = pc.pair_consts(tpbf.PBFParams(h=1.0, e_p=e_p, epsilon=1e-2))
        grid, _ = isolated_point_grid(m, dev, seed=m + 3, coincident=True)
        cnt, *xyz = pc.planes(grid)
        lam, _, nl, _, _ = pc.phase1_plain(grid.nbr, cnt, *xyz, torch.ones_like(xyz[0]), k2)
        args = (grid.nbr, cnt, *xyz, lam.contiguous(), (nl + 3.0).contiguous(), k2)
        what = f"pairs check, phase 2 M {m} e_p {e_p}"
        failures += [f"phase 2 M {m} e_p {e_p}: {f}" for f in
                     held_phase2(args, grid.bmask, what)[1]]
        row, col = int(grid.prow[0]), int(grid.pcol[0])
        new = pc.phase2_slots(*args)[:3]
        kept = all(bits_equal(n[row, col], x[row, col]) for n, x in zip(new, xyz))
        same = bool((xyz[0][grid.prow[1], grid.pcol[1]] == xyz[0][grid.prow[2], grid.pcol[2]]) &
                    (grid.prow[1] == grid.prow[2]))
        longest = int(cnt[grid.nbr.long()].sum(1).max())
        print(f"{what}: the isolated point's coordinates kept bit for bit {kept}; points 1 and 2 "
              f"coincide in one row {same}; the longest list {longest} entries (more than one "
              f"chunk of {P2_CHUNK}: {longest > P2_CHUNK})")
        if not (kept and same and longest > P2_CHUNK):
            failures.append(f"phase 2 M {m} e_p {e_p}: the isolated point or the grid")
        what = f"pairs check, phase 2 v2 M {m} e_p {e_p}"
        failures += [f"phase 2 v2 M {m} e_p {e_p}: {f}" for f in
                     held_phase2_raw("pbf_phase2_v2", args[:6] + (k2,), grid.bmask, what)[1]]
        dsum = pc.phase2_v2_slots(*args[:6], k2)[0]
        alone = not bool(dsum[row, col].any())
        print(f"{what}: the isolated point's dsum 0: {alone}")
        if not alone:
            failures.append(f"phase 2 v2 M {m} e_p {e_p}: the isolated point")
    for m in (32, 128):
        # epsilon 1e-2 as for phase 2: sg cancels the pair at d2 = 0's terms
        k1 = pc.pair_consts(tpbf.PBFParams(h=1.0, epsilon=1e-2))
        grid, rng = isolated_point_grid(m, dev, seed=m + 5, coincident=True)
        cnt, *xyz = pc.planes(grid)
        live = grid.bmask
        im = torch.as_tensor((0.8 + 0.4 * rng.random(tuple(live.shape))).astype(np.float32),
                             device=dev)
        args = (grid.nbr, cnt, *xyz, torch.where(live, im, 1.0).contiguous(), k1)
        what = f"pairs check, phase 1 M {m}"
        _, failed, got = held_phase1(args, live, what)
        failures += [f"phase 1 M {m}: {f}" for f in failed]
        row, col = int(grid.prow[0]), int(grid.pcol[0])
        want = pc.phase1_plain(*args)
        alone = all(bits_equal(g[row, col], w[row, col]) for g, w in zip(got[1:3], want[1:3]))
        same = bool((xyz[0][grid.prow[1], grid.pcol[1]] == xyz[0][grid.prow[2], grid.pcol[2]]) &
                    (grid.prow[1] == grid.prow[2]))
        longest = int(cnt[grid.nbr.long()].sum(1).max())
        print(f"{what}: the isolated point's pi_raw and nl bit for bit {alone}; points 1 and 2 "
              f"coincide in one row {same}; the longest list {longest} entries (more than one "
              f"chunk of {P1_CHUNK}: {longest > P1_CHUNK})")
        if not (alone and same and longest > P1_CHUNK):
            failures.append(f"phase 1 M {m}: the isolated point or the grid")
    for m in (32, 128):
        for kind, (grid, rng) in (("20 coincident pairs", coincident_pairs_grid(m, dev, seed=m + 7)),
                                  ("graded rows", graded_rows_grid(m, dev, seed=m + 13))):
            live = grid.bmask
            im = torch.as_tensor((0.8 + 0.4 * rng.random(tuple(live.shape))).astype(np.float32),
                                 device=dev)
            same_pi, same_nl, rel, raw_same = phase1_against_the_walk(
                grid, torch.where(live, im, 1.0).contiguous(), k)
            ok = same_pi and same_nl and rel <= 1e-6 and all(raw_same)
            print(f"pairs check, phases 1 v3, v2 and v1 against phase 1 v1's walk, M {m}, "
                  f"{kind}: v3 pi_raw bit for bit {same_pi}, nl exact {same_nl}, lambda max rel "
                  f"diff {rel:.3e} [tol 1e-6]; v2 then v1 pi_raw, sg, c2d2, nlen bit for bit "
                  f"{raw_same}" + ("" if ok else " FAILED"))
            if not ok:
                failures.append(f"phase 1 M {m}, {kind}: the walk's sums")
    failures += graded_rows_checks(dev)
    if failures:
        _fail(f"the pair kernels disagree with their plain versions: {failures}")


def graded_rows_checks(dev):
    """Phase 1 v2 (row 6), phase 1 v1 (row 4) and phase 2 v1 (row 5) at M =
    32 and 128 over ``tests/torch_helpers.graded_rows_grid``, whose rows hold
    1-8, 9-16, 17-24 and more live slots (every count of centre slots a lane
    and of passes), d2 = 0 pairs in one row and a lone point: rows 6 and 4
    into NaN-filled blocks against their plain versions at epsilon 1e-2, row
    4's gathered rows followed by guard rows that hold live neighbours
    (``guarded_gather``: row C must read none), row 6's lone point's pi_raw
    and nlen bit for bit, row 4's every output bit for bit row 6's; row 5 at
    e_p 4 and 2.5 with its dsum and
    per-row partial sums in NaN-filled blocks against its plain version, its
    gathered rows followed by guard rows that hold live neighbours
    (``guarded_gather``: row C must read none), its lone point's dsum 0, and
    dsum and partials bit for bit those of phase 2 v2 on the same rows.
    Returns the failures."""
    from fluidnexus_torch.sim import pbf as tpbf
    from fluidnexus_torch.sim import pbf_cuda as pc
    from tests.torch_helpers import GRADED_BANDS, graded_rows_grid, guarded_gather, phase2_part

    failures = []
    for m in (32, 128):
        grid, _ = graded_rows_grid(m, dev, seed=m + 11)
        cnt, *xyz = pc.planes(grid)
        live, occ = grid.bmask, cnt[cnt > 0]
        bands = [int(((occ >= lo) & (occ <= hi)).sum()) for lo, hi in GRADED_BANDS if hi <= m]
        longest = int(cnt[grid.nbr.long()].sum(1).max())
        print(f"graded rows, M {m}: live rows in the bands {GRADED_BANDS[:len(bands)]}: {bands}; "
              f"the longest list {longest} entries")
        if min(bands) == 0 or longest <= P1_CHUNK:
            failures.append(f"graded rows M {m}: the grid")
        row, col = int(grid.prow[-1]), int(grid.pcol[-1])
        k1 = pc.pair_consts(tpbf.PBFParams(h=1.0, epsilon=1e-2))
        args = (grid.nbr, cnt, *xyz, k1)
        what = f"pairs check, row 6, graded rows M {m}"
        failures += [f"row 6 M {m}: {f}" for f in held_in_nan_blocks("pbf_phase1_v2", args, what)[1]]
        got, want = pc.phase1_v2_slots(*args), pc.phase1_v2_plain(*args)
        alone = all(bits_equal(got[i][row, col], want[i][row, col]) for i in (0, 3))
        print(f"{what}: the lone point's pi_raw and nlen bit for bit {alone}")
        if not alone:
            failures.append(f"row 6 M {m}: the lone point")
        args4 = (*guarded_gather(grid.nbr, cnt, *xyz, torch.zeros_like(xyz[0]))[:2], *xyz, k1)
        what = f"pairs check, row 4, graded rows M {m}"
        failures += [f"row 4 M {m}: {f}" for f in held_in_nan_blocks("pbf_phase1_v1", args4, what)[1]]
        same = [bits_equal(a, b) for a, b in zip(pc.phase1_v1_slots(*args4)[:4], got[:4])]
        print(f"{what}: pi_raw, sg, c2d2, nlen bit for bit row 6's: {same}")
        if not all(same):
            failures.append(f"row 4 M {m}: row 6's bits")
        for e_p in (4.0, 2.5):
            k2 = pc.pair_consts(tpbf.PBFParams(h=1.0, e_p=e_p, epsilon=1e-2))
            lam = pc.phase1_plain(grid.nbr, cnt, *xyz, torch.ones_like(xyz[0]), k2)[0].contiguous()
            args1 = (*guarded_gather(grid.nbr, cnt, *xyz, lam), *xyz, lam, k2)
            args2 = (grid.nbr, cnt, *xyz, lam, k2)
            what = f"pairs check, row 5, graded rows M {m} e_p {e_p}"
            failures += [f"row 5 M {m} e_p {e_p}: {f}" for f in
                         held_phase2_raw("pbf_phase2_v1", args1, live, what)[1]]
            v1, v2 = phase2_part(pc, "pbf_phase2_v1", args1), phase2_part(pc, "pbf_phase2_v2", args2)
            alone = not bool(v1[0][row, col].any())
            same = [bits_equal(a, b) for a, b in zip(v1, v2)]
            print(f"{what}: the lone point's dsum 0: {alone}; dsum and partials bit for bit row "
                  f"7's: {same}")
            if not (alone and all(same)):
                failures.append(f"row 5 M {m} e_p {e_p}: the lone point or row 7")
    return failures


def encode_probe():
    """``python3 chip_smoke.py encode-probe``: the 5B VAE's whole-clip encode
    of a batch of two 49 x 480 x 720 clips, and the encode in chunks of
    train_video's default --encode_chunk latents, each with its peak memory
    above what is resident (or the out-of-memory error): why that default is
    not JAX's 0."""
    import time

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the probe runs on an NVIDIA card")
    from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig, chunked_encode, init_vae
    from fluidnexus_torch.pipelines import train_video

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    vae = init_vae(VAE3DConfig(), torch.Generator(device=dev).manual_seed(1))
    x = torch.zeros((2, VIDEO_FRAMES, 480, 720, 3), device=dev)
    for chunk in (0, train_video.build_argparser().get_default("encode_chunk")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                z = vae.encode(x, None)[0] if chunk == 0 else chunked_encode(vae, x, chunk=chunk)
            torch.cuda.synchronize()
            print(f"encode, chunk {chunk} (0: the whole clip): {time.perf_counter() - t0:.2f} s, "
                  f"peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the "
                  f"resident {base / 2**30:.2f} GiB, latents {tuple(z.shape)}")
            del z
        except torch.OutOfMemoryError as e:
            print(f"encode, chunk {chunk} (0: the whole clip): out of memory after "
                  f"{time.perf_counter() - t0:.2f} s: {str(e).splitlines()[0]}")
        torch.cuda.empty_cache()


def tick_flips(trials=120):
    """``python3 chip_smoke.py tick-flips``: how often the grid-reuse ticks
    of ``compare_backends`` part at a pair that crosses d2 = h^2. ``train``
    at the phase-C config writes the rigid rollout's start; then ``trials``
    copies of it (the first as it is, each other with every coordinate moved
    by a seeded uniform draw of up to 1e-3 scaled units) go through the v3,
    v2 and v1 ticks, and v3 once more. Prints, for each pair and for v3
    against itself, the trials whose estimates part by more than 1e-4 scaled
    units, those whose in-radius sums differ, and the largest gap of a trial
    where they do not."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the count runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.sim.pbf import guess_hidden
    from fluidnexus_torch.sim.pbf_dense import project_iterations_dense

    cuda_build.build(["rasterizer", "pbf", "splat"])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="fnx_flips_") as tmp:
        cfg = phase_c_config()
        scene = smoke_scene()
        bg = synthetic_background(32768, dev)
        render_ground_truth(cfg, scene, bg, dev)
        cfg.model.model_path = os.path.join(tmp, "recon")
        tp.train(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
        params, state0, _, _ = rigid_state(future_config(cfg.model.model_path,
                                                         os.path.join(tmp, "run")), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pairs = [(b, ref) for b, ref, _, _ in BACKEND_PAIRS] + [("v3 again", "v3")]
    rows = []
    for trial in range(trials):
        jitter = (torch.rand(state0.xyz.shape, device=dev, generator=gen) * 2.0 - 1.0) * 1e-3
        st = guess_hidden(state0 if trial == 0 else state0._replace(xyz=state0.xyz + jitter),
                          params)
        out = {b: project_iterations_dense(st, params, RIGID_ITERS, counts_step=1.0,
                                           backend=b.split()[0])
               for b in ("v3", "v2", "v1", "v3 again")}
        rows.append({(b, ref): _tick_gap(out[b], out[ref], st.alive) for b, ref in pairs})
    for key in pairs:
        over = [t for t, g in enumerate(rows) if g[key][0] > 1e-4]
        flips = [t for t, g in enumerate(rows) if not g[key][3]]
        clean = max((g[key][0] for g in rows if g[key][3]), default=0.0)
        print(f"tick flips: {key[0]} against {key[1]}: {len(over)} of {trials} trials with "
              f"max|d estimate| over 1e-4 scaled units {over}, in-radius sums differ in "
              f"{len(flips)} {flips}; the largest gap where they do not {clean:.3e}; the largest "
              f"force gap / scale {max(g[key][1] / g[key][2] for g in rows):.3e}")


def attention_time():
    """``python3 chip_smoke.py attention-time``: the attention forward alone
    at the CogVideoX-5B shape (2, 48, 17 776, 64) bf16, q and k contiguous
    and v a view of a (b, s, 3 h d) projection as the DiT passes them, drawn
    from a seed; the Hopper kernel, the mma.sync kernel and
    scaled_dot_product_attention by CUDA events over 20 calls each, in that
    order and then in reverse. Builds ``attention`` only: the quick loop for
    work on the forward kernel."""
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the timing runs on an NVIDIA card")
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.ops import cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(f"build attention: {cuda_build.build(['attention'])['attention']['seconds']:.1f} s")
    b, h, s, d = 2, 48, 17776, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, -1))
    q, k = q.contiguous(), k.contiguous()
    qc, kc, vc = q, k, v.contiguous()
    calls = {"wgmma": lambda: ac.attention_fwd(q, k, v),
             "mma.sync": lambda: ac._attention_fwd_mma_sync(q, k, v),
             "scaled_dot_product_attention": lambda: F.scaled_dot_product_attention(qc, kc, vc)}
    flops = 4 * b * h * s * s * d
    with torch.inference_mode():
        for name in list(calls) + list(calls)[::-1]:
            ms = cuda_ms(calls[name], iters=20)
            print(f"attention forward {name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")


def attention_bwd_time():
    """``python3 chip_smoke.py attention-bwd``: the attention backward alone.
    Builds ``attention`` and ``attention_bwd`` (prints the Hopper kernels'
    -Xptxas -v lines), runs the ragged check (``check_attention_ragged``),
    then at the CogVideoX-5B shape (2, 48, 17 776, 64) bf16 (q and k
    contiguous, v a view of a (b, s, 3 h d) projection, dout drawn from a
    seed, O and the LSE from the forward kernel) times the Hopper backward,
    the mma.sync pair and scaled_dot_product_attention's backward by CUDA
    events over 5 calls each, in that order and then in reverse, and the
    Hopper kernel apart from the torch work around it. The quick loop for
    work on the backward kernel."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the timing runs on an NVIDIA card")
    from fluidnexus_torch.ops import attention_cuda as ac
    from fluidnexus_torch.ops import cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    for name, info in cuda_build.build(["attention", "attention_bwd"]).items():
        lines = info["log"].splitlines()
        hop = [i for i, line in enumerate(lines) if "wgmma_kernel" in line and "Compiling" in line]
        print(f"build {name}: {info['seconds']:.1f} s\n" + "\n".join(
            line for i in hop for line in lines[i:i + 4]))
    dev = torch.device("cuda")
    check_attention_ragged(dev)
    b, h, s, d = 2, 48, 17776, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, -1))
    q, k = q.contiguous(), k.contiguous()
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    flops = 5 * 2 * b * h * s * s * d
    with torch.no_grad():
        out, lse = ac.attention_fwd(q, k, v, lse=True)
        calls = {"wgmma": lambda: ac.attention_bwd(q, k, v, out, lse, dout),
                 "mma.sync pair": lambda: ac._attention_bwd_mma_sync(q, k, v, out, lse, dout)}
        for name in list(calls) + [None] + list(calls)[::-1]:
            ms = sdpa_bwd_ms(q, k, v, dout) if name is None else cuda_ms(calls[name], iters=5)
            print(f"attention backward {name or 'scaled_dot_product_attention'}: {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s in the gradient's 5 products)")
        kernel_ms, prep_ms = bwd_kernel_ms(q, k, v, out, lse, dout, iters=5)
    print(f"attention backward wgmma: the kernel {kernel_ms:.3f} ms, D, the rows, the zeroed "
          f"workspace and the cast {prep_ms:.3f} ms")


PNG_TIME_REPS = 5             # timed reads of the Paeth frame


def png_time():
    """The PNG decode a capture's reads go through, on this machine's CPU (no
    card needed): a 960 x 544 RGB frame with every row Paeth-filtered (the
    slowest filter to undo), read by ``utils/png.read_png`` (the compiled
    unfilter), and its rows unfiltered by the plain Python version."""
    import struct
    import time
    import zlib

    from fluidnexus_torch.utils import png

    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (544, 960, 3)).astype(np.uint8)
    rows = img.reshape(544, -1).astype(np.int64)
    filt = []
    for y in range(544):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        filt.append(b"\x04" + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    raw = b"".join(filt)
    with tempfile.TemporaryDirectory(prefix="fnx_png_") as tmp:
        path = os.path.join(tmp, "paeth.png")
        header = struct.pack(">IIBBBBB", 960, 544, 8, 2, 0, 0, 0)
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", header)
                    + png._chunk(b"IDAT", zlib.compress(raw, 6)) + png._chunk(b"IEND", b""))
        png.read_png(path)   # builds the unfilter at first use
        times = []
        for _ in range(PNG_TIME_REPS):
            t0 = time.perf_counter()
            got = png.read_png(path)
            times.append(time.perf_counter() - t0)
        if not np.array_equal(got, img):
            _fail("read_png gave other pixels than were written")
        t0 = time.perf_counter()
        plain = png._unfilter_plain(raw, 544, 960 * 3, 3)
        plain_s = time.perf_counter() - t0
        if not np.array_equal(plain, img.reshape(544, -1)):
            _fail("the plain unfilter gave other pixels than were written")
    print(f"png-time: read_png of a 960 x 544 RGB PNG, every row Paeth: "
          f"{', '.join(f'{t:.4f}' for t in times)} s (median {statistics.median(times):.4f} s); "
          f"the plain Python unfilter of its rows alone {plain_s:.3f} s; {os.cpu_count()} CPUs")
    return statistics.median(times)


def stages_only():
    """The ``stages`` phase alone: builds the rasterizer, pbf and splat
    kernels, then ``run_stages``, and prints its ``kernels`` entries."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, info in cuda_build.build(["rasterizer", "pbf", "splat"]).items():
        print(f"build {name}: {info['seconds']:.1f} s")
    png_time()
    with tempfile.TemporaryDirectory(prefix="fnx_stages_") as tmp:
        print(json.dumps({"kernels": run_stages(torch.device("cuda"), tmp)}))


# ------------------------------ novel view (Zero123) ------------------------------

NV_ITERS, NV_BATCH = 5, 8        # cut from the reference finetune's 52 000 iterations of batch 96
NV_SAMPLE_STEPS = 10             # --sample_steps of the logged grids (the CLI's 50)
NV_LAST = f"iter_{NV_ITERS:07d}"
NV_PROBE_BATCHES = (96,)         # the reference finetune's batch (16 and 32 fit: PR 20)
NV_INFER_FRAMES, NV_INFER_STEPS = 1, 10   # infer_novel_view's --num_frames, --num_steps (410, 50)
NV_TOL = 1e-4                    # card against the CPU in f64, x max|f64| ...
NV_F32_RATIO = 2.0               # ... or at most this x the CPU's own f32 error there
NV_VIEWS = (0, 1, 3, 4)          # infer_novel_view's default targets from camera 2


class _Tee:
    """stdout kept in a buffer as it is printed."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


def write_nv_capture(root):
    """A capture at the FluidNexus-Smoke geometry for the novel-view phase:
    the stages phase's five cameras (``capture_cameras``: transforms.json)
    and ``train0{c}/{t:03d}.png`` for frames 0-2 at 960 x 544, seeded images
    (a bright column over a gradient, moved with the frame and the camera,
    and noise; no rasterizer is needed)."""
    from fluidnexus_torch.utils.png import write_png

    os.makedirs(root, exist_ok=True)
    capture_cameras(root, STAGE_FRAMES)
    rng = np.random.default_rng(SEED + 30)
    h, w = CAPTURE_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for c in range(5):
        for t in range(STAGE_FRAMES):
            cx = w * (0.3 + 0.1 * c) + 12 * t
            col = np.exp(-((xx - cx) / 60.0) ** 2) * np.clip((h - yy - 30 * t) / h, 0, 1)
            base = 0.15 + 0.2 * xx / w + 0.1 * yy / h
            img = (base + 0.7 * col)[..., None] * np.array([1.0, 0.95, 0.9], np.float32)
            img = img + rng.normal(0, 0.02, (h, w, 3))
            write_png(os.path.join(root, f"train0{c}", f"{t:03d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _nv_held(label, card, cpu32, cpu64):
    """The card's f32 result and the CPU's, each against the CPU in float64
    (the same weights and inputs): the card's error at most NV_F32_RATIO x
    the CPU's own f32 error, or within NV_TOL of scale. Prints card vs CPU
    f32 too."""
    card, cpu32 = card.detach().double().cpu(), cpu32.detach().double()
    scale = float(cpu64.abs().max())
    e_card, e_cpu = (float((x - cpu64).abs().max()) / scale for x in (card, cpu32))
    e_pair = float((card - cpu32).abs().max()) / scale
    ok = bool(torch.isfinite(card).all()) and (e_card <= NV_F32_RATIO * e_cpu
                                               or e_card <= NV_TOL)
    print(f"novel-view card vs CPU {label}: against the CPU in f64 (max|f64| {scale:.3e}) the "
          f"card {e_card:.2e}, the CPU in f32 {e_cpu:.2e} of scale [card <= {NV_F32_RATIO:g} x "
          f"CPU, or <= {NV_TOL:g}]; card vs CPU f32 {e_pair:.2e} {'ok' if ok else 'FAILED'}")
    return ok


def run_novel_view(dev, root, probes=False):
    """The Zero123 stage through its two CLIs at the full geometry (UNet
    320 x (1, 2, 4, 4), CLIP ViT-L/14, KL-VAE 128; 256 px, 32 x 32 latents)
    on seeded weights: a capture of 3 frames x 5 cameras through ``convert
    original_to_zero123`` (512-px PNGs) and ``zero123_cams``;
    ``train_novel_view`` for NV_ITERS steps of batch NV_BATCH (cut from 52 000
    of 96) with the EMA, checkpoints and TensorBoard grids; a probe of the
    reference's batch; ``infer_novel_view`` from its last checkpoint
    (NV_INFER_FRAMES frames x 4 views, NV_INFER_STEPS DDIM steps, CFG 3.0);
    ``convert zero123_to_cogvideox`` on the output; the UNet (batch 2, both
    CFG halves), CLIP and the VAE on the card against the CPU at NV_TOL; component times; a profile of a sampler step
    and a training step. The probe and the profiles are measurements, not
    checks: they run with ``probes`` (``python3 chip_smoke.py novel-view``),
    not in the default run. No hand-written kernel is on this path: the
    launch counts stay 0. Returns no ``kernels`` entry."""
    import copy
    import shutil
    import time

    from fluidnexus_torch.__main__ import main as runner
    from fluidnexus_torch.convert import novel_view_from_numpy
    from fluidnexus_torch.core.checkpoint import load_params
    from fluidnexus_torch.diffusion.ldm.model import NovelViewModel, get_pose_delta
    from fluidnexus_torch.pipelines import train_novel_view as tnv
    from fluidnexus_torch.pipelines.infer_novel_view import load_image
    from fluidnexus_torch.utils.png import read_png
    from fluidnexus_torch.utils.tb import device_memory_stats

    free_gib = shutil.disk_usage(root if os.path.isdir(root) else os.path.dirname(root)).free / 2**30
    print(f"novel-view: {free_gib:.1f} GiB free where the phase writes (two 5 GB checkpoints)")

    # ---- the dataset, through the DataProcessing hand-offs
    t_phase = t0 = time.perf_counter()
    cap, z123 = os.path.join(root, "capture"), os.path.join(root, "zero123")
    write_nv_capture(cap)
    runner(["convert", "original_to_zero123", "--data_root", cap, "--out_root", z123,
            "--camera_prefix", "train"])
    runner(["convert", "zero123_cams", "--transforms_json", os.path.join(cap, "transforms.json"),
            "--out_dir", os.path.join(z123, "camera")])
    frames = sorted(d for d in os.listdir(z123) if d.startswith("frame_"))
    shapes = {read_png(os.path.join(z123, f, n)).shape for f in frames
              for n in os.listdir(os.path.join(z123, f))}
    n_png = sum(len(os.listdir(os.path.join(z123, f))) for f in frames)
    cams = sorted(os.listdir(os.path.join(z123, "camera")))
    print(f"novel-view dataset: {len(frames)} frames, {n_png} PNGs of {sorted(shapes)}, "
          f"{len(cams)} cameras, in {time.perf_counter() - t0:.2f} s")
    if len(frames) != STAGE_FRAMES or n_png != 5 * STAGE_FRAMES or shapes != {(512, 512, 3)} \
            or len(cams) != 5:
        _fail("novel-view: the Zero123 dataset is not 3 frames x 5 cameras of 512 px")

    # ---- training through the CLI, each step and data batch timed on the card
    real_step, real_batch = tnv.NovelViewTrainer.step, tnv.ViewPairDataset.sample_batch
    step_ms, data_ms, counts = [], [], {}

    def timed_step(self, *a):
        if not counts:
            for k in ("unet", "clip", "vae", "cc"):
                counts[k] = sum(p.numel() for n, p in self.model.named_parameters()
                                if n.startswith(k + "."))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_step(self, *a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_batch(self, *a):
        t = time.perf_counter()
        out = real_batch(self, *a)
        data_ms.append((time.perf_counter() - t) * 1e3)
        return out

    save = os.path.join(root, "run")
    argv = ["train_novel_view", "--data_dir", z123, "--save_dir", save, "--image_size", "256",
            "--batch", str(NV_BATCH), "--iterations", str(NV_ITERS), "--log_every", "5",
            "--save_every", str(NV_ITERS), "--sample_every", str(NV_ITERS), "--sample_steps",
            str(NV_SAMPLE_STEPS),
            "--max_log_images", "4"]
    print(f"novel-view: python -m fluidnexus_torch {' '.join(argv)} (full width, EMA 0.9999; "
          f"cut: batch 96 -> {NV_BATCH}, iterations 52 000 -> {NV_ITERS})")
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    tnv.NovelViewTrainer.step, tnv.ViewPairDataset.sample_batch = timed_step, timed_batch
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            runner(argv)
    finally:
        tnv.NovelViewTrainer.step, tnv.ViewPairDataset.sample_batch = real_step, real_batch
    train_s = time.perf_counter() - t0
    mem = device_memory_stats(dev)
    gc_cuda()
    logs = [ln for ln in tee.text().splitlines() if ln.startswith("iter ")]
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in logs]
    print(f"novel-view parameters: " + ", ".join(f"{k} {v:,}" for k, v in counts.items())
          + f"; total {sum(counts.values()):,}")
    print(f"novel-view train: {train_s:.1f} s for {NV_ITERS} iterations; ms per step (the card, "
          f"synchronised) {', '.join(f'{t:.1f}' for t in step_ms)}; median of steps 2-{NV_ITERS} "
          f"{statistics.median(step_ms[1:]):.1f} ms; host data (PNG decode + LANCZOS 512 -> "
          f"256 of {2 * NV_BATCH} images) median {statistics.median(data_ms):.1f} ms a batch; "
          f"device_memory_stats {json.dumps({k: round(v, 1) for k, v in mem.items()})}")
    if len(losses) != NV_ITERS // 5 or not all(math.isfinite(x) for x in losses) \
            or len(step_ms) != NV_ITERS:
        _fail(f"novel-view train: log lines {logs}, {len(step_ms)} steps")
    marks = [time.perf_counter()]

    def mark(what):
        marks.append(time.perf_counter())
        print(f"novel-view: {what} {marks[-1] - marks[-2]:.1f} s")

    trees = {}
    for name in (NV_LAST, NV_LAST + "_ema"):
        tree = load_params(os.path.join(save, name))
        leaves = _leaves(tree)
        finite = all(np.isfinite(x).all() for x in leaves)
        size = sum(x.size for x in leaves)
        gib = os.path.getsize(os.path.join(save, name + ".npz")) / 2**30
        print(f"novel-view checkpoint {name}.npz: {gib:.2f} GiB, {sorted(tree)} {len(leaves)} "
              f"leaves, {size:,} values, finite {finite}")
        if sorted(tree) != ["cc", "clip", "unet", "vae"] or size != sum(counts.values()) \
                or not finite:
            _fail(f"novel-view: {name} did not load back as the full tree")
        trees[name] = tree
    ema_moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(trees[NV_LAST]["unet"]), _leaves(trees[NV_LAST + "_ema"]["unet"])))
    del trees[NV_LAST + "_ema"]
    events = [f for f in os.listdir(save) if f.startswith("events.out.tfevents")]
    blob = b"".join(open(os.path.join(save, f), "rb").read() for f in events)
    grids = {t: blob.count(t.encode()) for t in ("train/conditioning", "train/targets",
                                                 "train/samples_cfg_scale_3.00")}
    print(f"novel-view event file: {len(blob)} bytes, grids {grids} (iterations 1 and "
          f"{NV_ITERS}); the EMA differs from the live UNet by up to {ema_moved:.3e}")
    if any(v != 2 for v in grids.values()) or ema_moved <= 0:
        _fail("novel-view: the event file does not hold the three grids twice, or the EMA "
              "never moved")

    mark("the checkpoints and the event file read back")
    if probes:
        nv_batch_probe(dev)
        mark("the batch probe")

    # ---- sampling through the CLI
    out = os.path.join(root, "novel_views")
    real_sample, view_ms = NovelViewModel.ddim_sample, []

    def timed_sample(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_sample(self, *a, **k)
        torch.cuda.synchronize()
        view_ms.append((time.perf_counter() - t) * 1e3)
        return res

    argv = ["infer_novel_view", "--data_dir", z123, "--out_dir", out, "--ckpt",
            os.path.join(save, NV_LAST), "--num_frames", str(NV_INFER_FRAMES), "--num_steps",
            str(NV_INFER_STEPS)]
    print(f"novel-view: python -m fluidnexus_torch {' '.join(argv)} (source camera 2, targets "
          f"{NV_VIEWS}, CFG 3.0, 256 px, the _ema sibling)")
    NovelViewModel.ddim_sample = timed_sample
    t0 = time.perf_counter()
    try:
        runner(argv)
    finally:
        NovelViewModel.ddim_sample = real_sample
    infer_s = time.perf_counter() - t0
    gc_cuda()
    launches = all_launches()
    print(f"novel-view launches of the hand-written kernels over training and sampling: "
          f"{launches}")
    if any(launches.values()):
        _fail("novel-view: the Zero123 path launched a hand-written kernel")
    stds = []
    for c in NV_VIEWS:
        for i in range(NV_INFER_FRAMES):
            path = os.path.join(out, f"zero123_finetune_52000_cam2to{c}", f"frame_{i:06d}.png")
            if not os.path.exists(path):
                _fail(f"novel-view: {path} was not written")
            img = read_png(path)
            stds.append(float(img.std()))
            if img.shape != (256, 256, 3) or img.std() == 0:
                _fail(f"novel-view: {path} is {img.shape} with std {img.std()}")
    print(f"novel-view infer: {infer_s:.1f} s for {len(stds)} views (load included); ms per "
          f"view ({NV_INFER_STEPS} steps + decode) {', '.join(f'{t:.1f}' for t in view_ms)}; "
          f"PNG std {min(stds):.1f}-{max(stds):.1f}")

    t0 = time.perf_counter()
    cvx = os.path.join(root, "cogvideox")
    runner(["convert", "zero123_to_cogvideox", "--zero123_folder",
            os.path.join(out, "zero123_finetune_52000_cam2to0"), "--out_folder", cvx])
    handed = sorted(os.listdir(cvx))
    hshapes = {read_png(os.path.join(cvx, n)).shape for n in handed}
    print(f"novel-view hand-off zero123_to_cogvideox: {handed} of {sorted(hshapes)} in "
          f"{time.perf_counter() - t0:.2f} s")
    if handed != [f"frame_{i:06d}.png" for i in range(NV_INFER_FRAMES)] \
            or hshapes != {(480, 720, 3)}:
        _fail("novel-view: zero123_to_cogvideox did not write the view's 480 x 720 frames")

    # ---- card against CPU, component times, profiles
    mark("sampling and the hand-off")
    tree = trees.pop(NV_LAST)
    cpu = novel_view_from_numpy(tree, None, "cpu")
    cpu64 = copy.deepcopy(cpu).double()      # one build from the tree: the others copy it
    model = copy.deepcopy(cpu).to(dev)
    del tree
    cond = torch.as_tensor(load_image(os.path.join(z123, "frame_000", "02.png")))[None]
    rts = [np.load(os.path.join(z123, "camera", f"{c:02d}.npy")) for c in (0, 2)]
    dt = torch.as_tensor(get_pose_delta(rts[0], rts[1])[None])
    gen = torch.Generator().manual_seed(SEED + 31)
    lat = 256 // cpu.downsample_factor
    x = torch.randn((1, lat, lat, 4), generator=gen)
    t = torch.tensor([500, 500])
    ok = True
    with torch.no_grad():
        ctx, concat = cpu.conditioning(cond, dt)
        inputs = {"x_in": torch.cat([torch.cat([x, x]), torch.cat([concat, torch.zeros_like(
            concat)])], -1), "ctx2": torch.cat([ctx, torch.zeros_like(ctx)]), "cond": cond, "x": x}
        pairs = (("UNet (batch 2, both CFG halves)",
                  lambda m, i: m.unet(i["x_in"], t.to(i["x"].device), i["ctx2"])),
                 ("CLIP", lambda m, i: m.clip(i["cond"])),
                 ("VAE encode", lambda m, i: m.vae.encode(i["cond"] * 2 - 1)),
                 ("VAE decode", lambda m, i: m.vae.decode(i["x"])))
        on_card = {k: v.to(dev) for k, v in inputs.items()}
        in_f64 = {k: v.double() for k, v in inputs.items()}
        times = {}
        for label, fn in pairs:
            t0 = time.perf_counter()
            ref = fn(cpu, inputs)
            cpu_s = time.perf_counter() - t0
            ok &= _nv_held(f"{label} (CPU {cpu_s:.2f} s)", fn(model, on_card), ref,
                           fn(cpu64, in_f64))
            times[label] = cuda_ms(lambda: fn(model, on_card), iters=10)
    del cpu, cpu64
    print("novel-view card ms: " + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; a view {statistics.median(view_ms):.1f} (the infer run's median)")
    if not ok:
        _fail("novel-view: the card and the CPU disagree")
    mark("card against CPU")
    if probes:
        nv_profiles(model, cond.to(dev), dt.to(dev), statistics.median(step_ms[1:]))
        mark("the profiles")
    del model
    gc_cuda()
    print(f"novel-view phase: {time.perf_counter() - t_phase:.1f} s")
    return []


def _leaves(tree):
    out = []
    for v in tree.values():
        out += _leaves(v) if isinstance(v, dict) else [v]
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def nv_random_batch(b, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    tgt = torch.rand((b, 256, 256, 3), generator=g, device=dev)
    cond = torch.rand((b, 256, 256, 3), generator=g, device=dev)
    return tgt, cond, torch.randn((b, 4), generator=g, device=dev)


def nv_batch_probe(dev):
    """Training steps of a fresh seeded model at each of NV_PROBE_BATCHES in
    turn, until one runs out of memory: the ms of the second step and the
    peak memory, and the first batch that does not fit."""
    import time

    from fluidnexus_torch.diffusion.ldm.model import build_novel_view, init_novel_view
    from fluidnexus_torch.pipelines.train_novel_view import NovelViewTrainer, lambda_linear_schedule

    model = init_novel_view(build_novel_view(dev), torch.Generator(device=dev).manual_seed(SEED))
    trainer = NovelViewTrainer(model, lambda_linear_schedule(1e-4), lambda_linear_schedule(1e-3),
                               0.9999)
    fits, first_oom = [], None
    for b in NV_PROBE_BATCHES:
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        try:
            batch = nv_random_batch(b, dev, SEED + b)
            rng = torch.Generator(device=dev).manual_seed(SEED)
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step(*batch, rng)
                torch.cuda.synchronize()
            fits.append((b, (time.perf_counter() - t0) * 1e3,
                         torch.cuda.max_memory_allocated() / 2**30))
            del batch
        except torch.cuda.OutOfMemoryError:
            first_oom = b
            break
    del trainer, model
    gc_cuda()
    print("novel-view batch probe: " + "; ".join(
        f"batch {b} fits: {ms:.1f} ms a step, peak {gib:.2f} GiB" for b, ms, gib in fits)
          + (f"; batch {first_oom} runs out of memory" if first_oom else
             f"; every batch of {NV_PROBE_BATCHES} fits"))


def nv_profiles(model, cond, dt, train_ms):
    """torch.profiler over 5 DDIM steps (a batch-2 UNet forward and the
    update each) and over 2 training steps of batch NV_BATCH: the card's
    busy ms, its idle share and the top device ops."""
    from fluidnexus_torch.pipelines.train_novel_view import NovelViewTrainer, lambda_linear_schedule
    from fluidnexus_torch.utils.profiling import annotate

    rng = torch.Generator(device=cond.device).manual_seed(SEED)
    with torch.no_grad():
        model_eps, lad, x0 = model._sampler_setup(cond, dt, 50, 1.0, 3.0, 256, rng)

        def steps(n):
            x = x0
            for i in range(n):
                with annotate("fnx.sampler_step"):
                    at, ap = float(lad["a_t"][i]), float(lad["a_prev"][i])
                    eps = model_eps(x, lad["times"][i])
                    pred = (x - math.sqrt(1 - at) * eps) / math.sqrt(at)
                    x = math.sqrt(ap) * pred + float(lad["dir_coef"][i]) * eps \
                        + float(lad["sigma"][i]) * torch.randn(x.shape, generator=rng,
                                                               device=x.device)
            return x

        step_ms = cuda_ms(lambda: steps(1), iters=10)
        print(f"novel-view sampler step: {step_ms:.3f} ms (a batch-2 UNet forward and the update)")
        profile_run("DDIM steps", lambda: steps(5), 5, step_ms)
    trainer = NovelViewTrainer(model, lambda_linear_schedule(1e-4), lambda_linear_schedule(1e-3),
                               0.9999)
    batch = nv_random_batch(NV_BATCH, cond.device, SEED + 1)

    def train_steps(n):
        for _ in range(n):
            with annotate("fnx.train_step"):
                trainer.step(*batch, rng)

    train_steps(1)
    profile_run(f"training steps of batch {NV_BATCH}", lambda: train_steps(2), 2, train_ms)
    del trainer, batch


def novel_view_only():
    """``python3 chip_smoke.py novel-view``: ``run_novel_view`` alone (no
    kernel to build)."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="fnx_novel_view_") as tmp:
        print(json.dumps({"kernels": run_novel_view(torch.device("cuda"), tmp, probes=True)}))


# ------------------------------ text and data ---------------------------------

T5_TOL = 1e-4                 # card against CPU, f32 both (TF32 off), x max|ref|
T5_WORDS = ("<pad> </s> <unk> a smoke plume rises past the cylinder in cold air slowly wind "
            "blows left right over ball bounces thin column white grey dense light").split()
T5_PROMPTS = (" ".join(T5_WORDS[3 + (i * 7) % (len(T5_WORDS) - 3)] for i in range(300)),
              "a thin white smoke plume rises slowly past the cylinder in cold air")
TEXT_TRAIN_ITERS = 1          # --iterations a data layout, cut from the CLI's 10 000
TEXT_TRAIN_FRAMES = 9         # its --num_frames, of the 49-frame clips (the CLI's 49)
TEXT_SAMPLE_STEPS = 2         # --num_steps of sample_video --t5_dir
TEXT_SAMPLE_FRAMES = 9        # its --num_frames (49 before the parallel phase came: 21 s more)


def write_t5_tokenizer(d):
    """A WordLevel tokenizer over T5_WORDS in Hugging Face's format (the
    t5-v1_1-xxl sentencepiece model does not ship with the repository)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    os.makedirs(d, exist_ok=True)
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(T5_WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}, f)


def init_t5(model, generator):
    """transformers' Flax T5 init, drawn from ``generator``: the embedding
    normal(1), q normal((inner d_kv)^-1/2), k, v, o and the bias table
    normal(inner^-1/2), wi normal(d_model^-1/2), wo normal(d_ff^-1/2), the
    norms 1."""
    c = model.cfg
    inner = c.num_heads * c.d_kv
    std = {"q": (inner * c.d_kv) ** -0.5, "k": inner ** -0.5, "v": inner ** -0.5,
           "o": inner ** -0.5, "relative_attention_bias": inner ** -0.5,
           "wi": c.d_model ** -0.5, "wi_0": c.d_model ** -0.5, "wi_1": c.d_model ** -0.5,
           "wo": c.d_ff ** -0.5, "shared": 1.0}
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[-1] == "weight" and "norm" in parts[-2]:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std[parts[-2]], generator=generator)
    return model


def write_flax_msgpack(path, tree):
    """``tree`` (nested dicts of numpy arrays) in flax's msgpack format, as
    ``FlaxPreTrainedModel.save_pretrained`` writes ``flax_model.msgpack``:
    maps of maps, each leaf an ext value of type 1 holding the msgpack array
    (shape, dtype name, raw bytes). Leaves are streamed (no copy of the
    tree in memory); none may exceed flax's 2^30-byte chunk size."""
    import struct

    def head(fix, n, fix_max, wide):
        if n <= fix_max:
            return bytes([fix | n])
        code, fmt = wide
        return bytes([code]) + struct.pack(fmt, n)

    def string(s):
        b = s.encode()
        return head(0xA0, len(b), 31, (0xDA, ">H")) + b

    with open(path, "wb") as f:
        def put(node):
            if isinstance(node, dict):
                f.write(head(0x80, len(node), 15, (0xDE, ">H")))
                for k, v in node.items():
                    f.write(string(str(k)))
                    put(v)
                return
            a = np.ascontiguousarray(node)
            if a.nbytes > 2 ** 30:
                raise ValueError(f"a leaf of {a.nbytes} bytes needs flax's chunked form")
            inner = (b"\x93" + head(0x90, a.ndim, 15, (0xDC, ">H"))
                     + b"".join(b"\xce" + struct.pack(">I", n) for n in a.shape)
                     + string(a.dtype.name) + b"\xc6" + struct.pack(">I", a.nbytes))
            f.write(b"\xc9" + struct.pack(">I", len(inner) + a.nbytes) + b"\x01" + inner)
            f.write(memoryview(a).cast("B"))

        put(tree)


def write_flax_t5(d, model):
    """A Hugging Face Flax T5 directory from a port ``T5Encoder``:
    ``config.json``, ``flax_model.msgpack`` (the flax layout,
    ``convert.flax_params_to_numpy``) and the WordLevel tokenizer."""
    from fluidnexus_torch.convert import flax_params_to_numpy

    c = model.cfg
    write_t5_tokenizer(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["T5EncoderModel"], "model_type": "t5",
                   "vocab_size": c.vocab_size, "d_model": c.d_model, "d_kv": c.d_kv,
                   "d_ff": c.d_ff, "num_layers": c.num_layers, "num_heads": c.num_heads,
                   "relative_attention_num_buckets": c.relative_attention_num_buckets,
                   "relative_attention_max_distance": c.relative_attention_max_distance,
                   "layer_norm_epsilon": c.layer_norm_epsilon,
                   "feed_forward_proj": c.feed_forward_proj, "pad_token_id": 0,
                   "eos_token_id": 1}, f)
    write_flax_msgpack(os.path.join(d, "flax_model.msgpack"),
                       flax_params_to_numpy(dict(model.named_parameters())))


def write_mp4_clip(path, seed, frames=VIDEO_FRAMES, height=480, width=720, fps=8):
    """A seeded clip (blocks of 32 x 32 pixels drifting one pixel a frame)
    through OpenCV's mp4 encoder."""
    import cv2

    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (-(-height // 32) + 1, -(-width // 32) + 2, 3), dtype=np.uint8)
    big = np.kron(low, np.ones((32, 32, 1), np.uint8))
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    if not out.isOpened():
        _fail(f"OpenCV cannot open an mp4 writer for {path}")
    for i in range(frames):
        out.write(np.ascontiguousarray(big[i % 32:i % 32 + height, i:i + width, ::-1]))
    out.release()


def write_video_roots(root):
    """The two reference layouts at 480 x 720, 49 frames at 8 fps: an
    SFTVideoDataset root (videos/*.mp4 + labels/*.txt) and a root of two
    webdataset tar shards (<key>.mp4, <key>.txt, <key>.json: duration, fps).
    Returns (sft root, shard root)."""
    import tarfile

    sft, web, stage = (os.path.join(root, n) for n in ("sft", "web", "stage"))
    for d in (os.path.join(sft, "videos"), os.path.join(sft, "labels"), web, stage):
        os.makedirs(d, exist_ok=True)
    captions = {"clip0": "a thin white smoke plume rises slowly",
                "clip1": "smoke blows left past the cylinder"}
    for i, (key, caption) in enumerate(captions.items()):
        write_mp4_clip(os.path.join(sft, "videos", key + ".mp4"), SEED + 30 + i)
        with open(os.path.join(sft, "labels", key + ".txt"), "w") as f:
            f.write(caption + "\n")
        with tarfile.open(os.path.join(web, f"shard{i}.tar"), "w") as tf:
            for j in range(2):
                name = f"s{i}{j}"
                write_mp4_clip(os.path.join(stage, name + ".mp4"), SEED + 40 + 2 * i + j)
                with open(os.path.join(stage, name + ".txt"), "w") as f:
                    f.write(f"{caption}, take {j}")
                with open(os.path.join(stage, name + ".json"), "w") as f:
                    json.dump({"duration": VIDEO_FRAMES / 8, "fps": 8}, f)
                for ext in ("mp4", "txt", "json"):
                    tf.add(os.path.join(stage, f"{name}.{ext}"), arcname=f"{name}.{ext}")
    return sft, web


def held_rel(what, got, ref, tol):
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    print(f"{what}: max|err| {err:.3e}, max|ref| {scale:.3e} ({err / scale:.3e} of it; "
          f"tol {tol:g})")
    if not err <= tol * scale:
        _fail(f"{what} disagrees beyond {tol:g} of max|ref|")


def run_text_data(dev, root):
    """The video stage's real inputs: (a) the T5-XXL encoder at its full
    geometry (24 blocks, d_model 4096, 64 heads x 64, d_ff 10 240,
    gated-gelu, vocab 32 128, f32) on seeded weights, 2 prompts at 226
    tokens: ms per encode and peak memory, and the first two blocks at full
    width on the card against the CPU; (b) those two blocks written as a
    Hugging Face Flax directory (config.json, flax_model.msgpack, a WordLevel
    tokenizer) and read back by ``T5TextEncoder``; ``sample_video --t5_dir``
    at the 5B geometry, and ``train_video --t5_dir`` on an mp4 root and on
    tar shards (``make_video_dataset``), the full XXL left resident during
    the first training run so that its peak counts the encoder's 19 GB; (c)
    whether tensorstore (the orbax checkpoint reader) imports. Adds no
    kernel: T5 reaches no Pallas kernel. Returns []."""
    import time

    from fluidnexus_torch.diffusion.video import t5 as t5_mod
    from fluidnexus_torch.diffusion.video.conditioner import T5TextEncoder
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.pipelines import sample_video, train_video
    from fluidnexus_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    try:
        import tensorstore
        print(f"text-data: tensorstore imports ({getattr(tensorstore, '__version__', 'version ?')}"
              "): the orbax checkpoints of the JAX package load here")
    except ImportError as e:
        print(f"text-data: tensorstore does not import ({e}): orbax checkpoints cannot load "
              "here, the flat npz can")
    from transformers import AutoTokenizer

    tdir = os.path.join(root, "t5_xxl_depth2")
    write_t5_tokenizer(tdir)
    tok = AutoTokenizer.from_pretrained(tdir)
    batch = tok(list(T5_PROMPTS), truncation=True, max_length=226, padding="max_length",
                return_tensors="np")
    ids = torch.as_tensor(batch["input_ids"], device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    print(f"text-data: {type(tok).__name__} from {tdir}: prompt tokens "
          f"{[int(n) for n in batch['attention_mask'].sum(1)]} of 226")

    # ---- (a) T5-XXL at full geometry
    cfg = t5_mod.T5Config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with torch.device("meta"):
        xxl = t5_mod.T5Encoder(cfg)
    xxl = init_t5(xxl.to_empty(device=dev), torch.Generator(device=dev).manual_seed(SEED + 21))
    n_params = sum(p.numel() for p in xxl.parameters())
    with torch.no_grad():
        out = xxl(ids, mask)
        encode_ms = [cuda_ms(lambda: xxl(ids, mask), iters=1, warmup=0) for _ in range(5)]
    peak = torch.cuda.max_memory_allocated() - base_mem
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"text-data: T5-XXL encoder ({cfg.num_layers} blocks, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.d_kv}, d_ff {cfg.d_ff}, {cfg.feed_forward_proj}, vocab "
          f"{cfg.vocab_size}, f32, TF32 off) {n_params} parameters on seeded weights: ms per "
          f"encode of 2 x 226 tokens {', '.join(f'{t:.2f}' for t in encode_ms)} (median "
          f"{statistics.median(encode_ms):.2f}); peak allocated {peak / 2**30:.2f} GiB above "
          f"the {base_mem / 2**30:.2f} GiB held before (weights {n_params * 4 / 2**30:.2f}) "
          f"[{smi}]")
    if tuple(out.shape) != (2, 226, cfg.d_model) or not torch.isfinite(out).all():
        _fail(f"the XXL encode is not finite (2, 226, {cfg.d_model}): {tuple(out.shape)}")

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    with torch.device("meta"):
        two = t5_mod.T5Encoder(cfg2)
    own = dict(xxl.state_dict())
    two = two.to_empty(device=dev)
    two.load_state_dict({k: own[k] for k in two.state_dict()})
    with torch.device("meta"):
        two_cpu = t5_mod.T5Encoder(cfg2)
    two_cpu = two_cpu.to_empty(device="cpu")
    two_cpu.load_state_dict({k: v.cpu() for k, v in two.state_dict().items()})
    with torch.no_grad():
        ref2 = two_cpu(ids.cpu(), mask.cpu())
        out2 = two(ids, mask)
    held_rel("text-data: T5 at full width, depth 2, card against CPU (2 x 226 tokens)",
             out2.cpu(), ref2, T5_TOL)

    # ---- (b) the Flax directory and the CLIs
    t0 = time.perf_counter()
    write_flax_t5(tdir, two_cpu)
    size = os.path.getsize(os.path.join(tdir, "flax_model.msgpack"))
    del two_cpu, ref2
    t1 = time.perf_counter()
    enc = T5TextEncoder(tdir, 226, dev)
    load_s = time.perf_counter() - t1
    got = enc(list(T5_PROMPTS))
    print(f"text-data: flax_model.msgpack {size / 2**30:.2f} GiB written in "
          f"{t1 - t0:.1f} s, read by T5TextEncoder in {load_s:.1f} s [{smi}]")
    held_rel("text-data: T5TextEncoder from the directory against the module it was written "
             "from", got, out2, T5_TOL)
    del enc, got

    seen = {}
    real_sample = VideoEngine.sample

    def sample(self, params, shape, text_emb, *a, **kw):
        seen["text"] = text_emb
        return real_sample(self, params, shape, text_emb, *a, **kw)

    prompt = T5_PROMPTS[1]
    out_folder = os.path.join(root, "sampled")
    argv = ["--prompt", prompt, "--out_folder", out_folder, "--t5_dir", tdir,
            "--num_steps", str(TEXT_SAMPLE_STEPS), "--num_frames", str(TEXT_SAMPLE_FRAMES)]
    n_layers = sample_video.configs(TEXT_SAMPLE_FRAMES, 480, 720, tiny=False)[0].num_layers
    VideoEngine.sample = sample
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        decoded = sample_video.main(argv, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
    finally:
        VideoEngine.sample = real_sample
    peak = torch.cuda.max_memory_allocated()
    print(f"text-data: sample_video.main({argv}) at the 5B geometry ({TEXT_SAMPLE_FRAMES} x 480 "
          f"x 720): "
          f"launches {launches}; {seconds:.2f} s end to end; peak allocated "
          f"{peak / 2**30:.2f} GiB (the XXL's {n_params * 4 / 2**30:.2f} GiB resident beside "
          f"it) [{smi}]")
    want = {"attention_fwd": n_layers * TEXT_SAMPLE_STEPS,
            "attention_fwd_wgmma": n_layers * TEXT_SAMPLE_STEPS}
    if any(launches[n] != c for n, c in want.items()) or any(
            c for n, c in launches.items() if n not in want):
        _fail(f"sample_video --t5_dir launched {launches}, expected {want} and no other kernel")
    if tuple(decoded.shape) != (1, TEXT_SAMPLE_FRAMES, 480, 720, 3) \
            or not torch.isfinite(decoded).all():
        _fail(f"sample_video --t5_dir decoded {tuple(decoded.shape)}, not a finite clip")
    if len(os.listdir(out_folder)) != TEXT_SAMPLE_FRAMES:
        _fail(f"sample_video --t5_dir wrote {len(os.listdir(out_folder))} PNGs")
    with torch.no_grad():
        ref = two(*(torch.as_tensor(tok([prompt], truncation=True, max_length=226,
                                        padding="max_length", return_tensors="np")[k],
                                    device=dev) for k in ("input_ids", "attention_mask")))
    held_rel("text-data: sample_video's text embedding against the module's", seen["text"], ref,
             T5_TOL)
    del decoded

    sft, web = write_video_roots(os.path.join(root, "data"))
    for label, data_root, keep_xxl in (("mp4 files (SFTVideoDataset)", sft, True),
                                       ("tar shards (WebVideoDataset)", web, False)):
        if not keep_xxl:
            del xxl, own
            gc_cuda()
        argv = ["--data_root", data_root, "--t5_dir", tdir, "--batch", "2", "--lora_rank",
                str(LORA_RANK), "--log_every", "1", "--fixed_frames", "3", "--iterations",
                str(TEXT_TRAIN_ITERS), "--num_frames", str(TEXT_TRAIN_FRAMES)]
        timer = StageTimer()
        result, launches, seconds, peak, tseen = run_train(argv, timer)
        loss = result[1]
        del result   # its EMA tree holds the run's DiT
        ds = train_video.make_video_dataset(data_root, TEXT_TRAIN_FRAMES, 480, 720)
        print(f"text-data: train_video --t5_dir on {label} ({type(ds).__name__}, "
              f"{TEXT_TRAIN_ITERS} LoRA step of batch 2 at the 5B width, {TEXT_TRAIN_FRAMES} "
              f"frames): loss {loss:.5f}; "
              f"launches {launches}; ms per LoRA step "
              f"{', '.join(f'{t:.1f}' for t in timer.ms['train_step'])}, VAE encode "
              f"{', '.join(f'{t:.1f}' for t in timer.ms['vae_encode'])}, data "
              f"{', '.join(f'{t:.1f}' for t in timer.ms['data'])}; "
              f"{seconds:.2f} s end to end; peak allocated "
              f"{peak / 2**30:.2f} GiB"
              + (f" with the full XXL ({n_params * 4 / 2**30:.2f} GiB) resident" if keep_xxl
                 else "") + f" [{smi}]")
        check_train_launches(launches, f"train_video --t5_dir on {label}",
                             2 * n_layers * TEXT_TRAIN_ITERS, n_layers * TEXT_TRAIN_ITERS)
        if not math.isfinite(loss):
            _fail(f"train_video --t5_dir on {label}: loss {loss}")
        # each caption's embedding, or zeros where ucg dropped it
        captions = ds.sample_batch(2, np.random.default_rng(0))[1]
        with torch.no_grad():
            ref = two(*(torch.as_tensor(tok(captions, truncation=True, max_length=226,
                                            padding="max_length", return_tensors="np")[k],
                                        device=dev) for k in ("input_ids", "attention_mask")))
        txt = tseen["text"]
        kept = [bool(txt[i].abs().max() > 0) for i in range(len(captions))]
        print(f"text-data: the step's captions {captions}, kept by ucg {kept}")
        for i, k in enumerate(kept):
            if k:
                held_rel(f"text-data: caption {i}'s embedding in the step", txt[i], ref[i],
                         T5_TOL)
        del tseen, txt, ref, ds
        gc_cuda()
    for m in ("jax", "flax", "fluidnexus_tpu"):
        if m in sys.modules:
            _fail(f"the text-data phase imported {m}")
    print(f"text-data phase: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return []


def text_data_only():
    """``python3 chip_smoke.py text-data``: builds ``attention`` and
    ``attention_bwd``, runs ``run_text_data``."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, info in cuda_build.build(["attention", "attention_bwd"]).items():
        print(f"build {name}: {info['seconds']:.1f} s")
    with tempfile.TemporaryDirectory(prefix="fnx_text_data_") as tmp:
        run_text_data(torch.device("cuda"), tmp)


# ---------------------------- port and evaluate_adm ---------------------------


PE_DIT_LAYERS = 2             # the SAT DiT's depth at the 5B width (port-5b: all 42)
PE_ADM_N = 10_000             # images a set (the reference evaluator's block)
PE_ADM_PX = 256
PE_VGG_PX = 64
PE_FVD_N = 256                # clips a set
PE_FVD_T = 16
PE_PERC_PAIRS = 64
PE_PERC_PX = 256
PE_SUBSET = 500               # images whose features, FID and sFID are held card against CPU
PE_VIEW_STEPS = 10            # the hand-off view's DDIM steps (the CLI's default 50)
PE_SQRTM_DIM = 1792           # scipy's sqrtm timed at this size (port-5b; sFID's finding)

PE_TOL = 1e-4                 # card against CPU, x max|ref| (forwards, features, logits)
PE_METRIC_TOL = 1e-4          # FID / sFID / FVD card against CPU, relative
PE_QUANT_TOL = 1e-2           # the int8 DiT's checksum against the float one, relative
# a sphere test that flips between card and CPU must be borderline in float64:
# |d - r| within 1e-4 of r, plus 4x the f32 rounding of |u|^2 - 2 u.v + |v|^2
# (up to 1.2e-6 of |u|^2 + |v|^2 on 2 000 + 2 000 of the default features)
PE_PR_REL, PE_PR_NORM = 1e-4, 4.8e-6


def pe_held(what, got, ref, tol=PE_TOL):
    got, ref = torch.as_tensor(got).double().cpu(), torch.as_tensor(ref).double().cpu()
    if got.shape != ref.shape:
        _fail(f"{what}: shape {tuple(got.shape)} against {tuple(ref.shape)}")
    held_rel(what, got, ref, tol)


def pe_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(pe_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def pe_same_tree(what, a, b):
    fa, fb = pe_flat(a), pe_flat(b)
    bad = [k for k in fa if k not in fb or fa[k].dtype != fb[k].dtype
           or fa[k].shape != fb[k].shape or not np.array_equal(fa[k], fb[k])]
    if sorted(fa) != sorted(fb) or bad:
        _fail(f"{what}: the saved tree differs from the drill's ({len(fa)} / {len(fb)} leaves; "
              f"first differing {bad[:3]})")
    print(f"port-eval: {what}: {len(fa)} leaves read back bit for bit")


def pe_printed(text):
    """{name: (the printed '<x>M' count, checksum or None)} of [port] lines."""
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 4 and parts[0] == "[port]" and parts[3] == "params":
            rows[parts[1]] = (parts[2], float(parts[-1]) if "checksum" in line else None)
        elif len(parts) >= 2 and parts[:2] == ["[port]", "t5"]:
            rows["t5"] = (None, float(parts[-1]))
    return rows


def pe_count(module):
    return f"{sum(p.numel() for p in module.parameters()) / 1e6:.2f}M"


def pe_checksum(what, got, printed, tol=1e-5):
    """A forward's checksum against the drill's printed one (6 digits)."""
    x = float(got.float().abs().sum())
    print(f"port-eval: {what}: checksum {x:.6g} against the printed {printed:.6g}")
    if not abs(x - printed) <= tol * abs(printed):
        _fail(f"{what}: checksum {x:.6g} is not the printed {printed:.6g} (tol {tol:g})")


def pe_run(fn, *args, **kw):
    """``fn(*args, **kw)`` with its stdout captured (and echoed), every
    launch count set to 0 before, layer 0's attention inputs captured, the
    trees ``port_drill`` reports and saves kept: (result, stdout, info)."""
    import io
    import time

    from fluidnexus_torch.diffusion.video import dit as dit_mod
    from fluidnexus_torch.pipelines import port_drill as pd

    real_attn, real_save, real_report = dit_mod.joint_attention, pd._save, pd._report
    info = {"saved": {}, "reported": {}, "attention_calls": 0}

    def recording_attn(q, k, v):
        info["attention_calls"] += 1
        if "q" not in info:
            info.update(q=q, k=k, v=v)
        return real_attn(q, k, v)

    def save(out_dir, name, tree):
        info["saved"][name] = tree
        return real_save(out_dir, name, tree)

    def report(name, tree, fwd=None):
        # the DiT's float tree at the depth the card-vs-CPU check takes
        info["reported"][name] = {k: v for k, v in tree.items()
                                  if not (k.startswith("block_") and int(k[6:]) >= 2)}
        return real_report(name, tree, fwd)

    buf = io.StringIO()
    dit_mod.joint_attention, pd._save, pd._report = recording_attn, save, report
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        info["seconds"] = time.perf_counter() - t0
        info["launches"] = all_launches()
    finally:
        dit_mod.joint_attention, pd._save, pd._report = real_attn, real_save, real_report
    print(buf.getvalue(), end="")
    return out, buf.getvalue(), info


def write_port_checkpoints(dev, root, dit_layers, t5_dir, only_dit=False):
    """Seeded checkpoints in the reference's layouts: a Zero123 Lightning
    ``.ckpt`` (``{"state_dict": ...}``, the upstream 4-channel input conv),
    a SAT ``{"module": ...}`` of ``dit_layers`` layers at the 5B width in the
    raw SAT-lora2 layout at rank LORA_RANK, a 3D-VAE under
    ``first_stage_model.``, and (unless ``t5_dir`` holds one) a Flax T5
    directory at depth 2 and full width; with ``only_dit`` the SAT file
    alone. All f32. Returns the paths and the DiT's and 3D-VAE's configs."""
    import time

    from fluidnexus_torch.diffusion.ldm.model import build_novel_view
    from fluidnexus_torch.diffusion.video import t5 as t5_mod
    from fluidnexus_torch.diffusion.video.dit import VideoDiTConfig
    from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig, VideoVAE
    from tests.torch_helpers import (
        sat_dit_state_dict, seeded_fill_, video_vae_reference_sd, zero123_reference_sd,
    )

    os.makedirs(root, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    paths, t0 = {}, time.perf_counter()

    def save(name, obj):
        paths[name] = os.path.join(root, name)
        torch.save(obj, paths[name])
        print(f"port-eval: wrote {name}: {os.path.getsize(paths[name]) / 2**30:.2f} GiB "
              f"({time.perf_counter() - t0:.1f} s so far)")

    if not only_dit:
        model = seeded_fill_(build_novel_view(dev), gen)
        sd = {k: v.detach().contiguous().cpu() for k, v in zero123_reference_sd(model).items()}
        del model
        save("last.ckpt", {"state_dict": sd, "global_step": 0, "epoch": 0})
        del sd
    dcfg = VideoDiTConfig(latent_frames=2, latent_height=8, latent_width=8, num_layers=dit_layers)
    sd = {k: v.cpu() for k, v in sat_dit_state_dict(dcfg, gen, lora_rank=LORA_RANK).items()}
    save("mp_rank_00_model_states.pt", {"module": sd, "iteration": 0})
    del sd
    vcfg = VAE3DConfig()
    if only_dit:
        return paths, dcfg, vcfg
    with torch.device(dev):
        vae = seeded_fill_(VideoVAE(vcfg), gen)
    sd = {"first_stage_model." + k: v.detach().contiguous().cpu()
          for k, v in video_vae_reference_sd(dict(vae.named_parameters()), vcfg).items()}
    del vae
    save("3d-vae.pt", {"state_dict": sd})
    del sd
    gc_cuda()
    if not (t5_dir and os.path.isfile(os.path.join(t5_dir, "flax_model.msgpack"))):
        t5_dir = os.path.join(root, "t5_depth2")
        with torch.device("meta"):
            t5 = t5_mod.T5Encoder(dataclasses.replace(t5_mod.T5Config(), num_layers=2))
        t5 = init_t5(t5.to_empty(device=dev), gen)
        write_flax_t5(t5_dir, t5)
        del t5
        print(f"port-eval: wrote the Flax T5 directory {t5_dir}")
    else:
        print(f"port-eval: the Flax T5 directory of the text-data phase: {t5_dir}")
    paths["t5"] = t5_dir
    return paths, dcfg, vcfg


def port_checks(dev, paths, out, printed, info, dcfg, vcfg, quant):
    """The trees read back bit for bit, the modules loaded from them give
    the printed counts and checksums, each forward card against CPU.
    Returns the card's Zero123 (None without one)."""
    from fluidnexus_torch.core.checkpoint import load_params
    from fluidnexus_torch.diffusion.ldm.model import build_novel_view
    from fluidnexus_torch.diffusion.video.dit import VideoDiT
    from fluidnexus_torch.diffusion.video.vae3d import VideoVAE
    from fluidnexus_torch.pipelines import port_drill as pd

    with torch.device("meta"):
        nv = build_novel_view("meta")
        counts = {"video.dit": pe_count(VideoDiT(dcfg))}
        if "zero123" in info["saved"]:
            counts.update({"zero123.unet": pe_count(nv.unet), "zero123.vae": pe_count(nv.vae),
                           "zero123.clip": pe_count(nv.clip), "zero123.cc": pe_count(nv.cc),
                           "video.vae3d": pe_count(VideoVAE(vcfg)), "t5": None})
    if set(printed) != set(counts):
        _fail(f"port printed {sorted(printed)}, expected {sorted(counts)}")
    for name, (n, _) in printed.items():
        if n != counts[name]:
            _fail(f"port: {name} printed {n} params, the module has {counts[name]}")
    print(f"port-eval: printed counts equal the modules' own: {counts} "
          f"(NovelViewModel {sum(p.numel() for p in nv.parameters())} parameters)")
    del nv

    saved = {name: load_params(os.path.join(out, name)) for name in info["saved"]}
    for name, tree in info["saved"].items():
        pe_same_tree(f"{name}.npz", saved[name], tree)

    check_dit(dev, saved, printed, info, dcfg, quant)
    if "zero123" not in saved:
        return None
    check_vae3d(dev, saved, printed, vcfg)
    emb = pd.drill_t5(paths["t5"], device="cpu")
    pe_checksum("t5 on the CPU", emb, printed["t5"][1], tol=PE_TOL)
    return check_zero123(dev, saved, printed, info["saved"]["zero123"])


def check_zero123(dev, saved, printed, tree):
    """The Zero123 module from the saved tree: its checksums, card against
    CPU (the VAE encode by the novel-view phase's rule against float64).
    Returns the card's module, built from the drill's in-memory ``tree``
    (bit for bit the saved one)."""
    from fluidnexus_torch.convert import novel_view_from_numpy

    size = 224                                          # ViT-L/14's input
    models = {"card": novel_view_from_numpy(tree, device=dev),
              "cpu": novel_view_from_numpy(saved["zero123"], device="cpu")}
    results = {}
    for key, m in models.items():
        d = next(m.parameters()).device
        lat = 64 // m.downsample_factor
        with torch.no_grad():
            ctx, concat = m.conditioning(torch.zeros((1, size, size, 3), device=d),
                                         torch.zeros((1, 4), device=d))
            eps = m.unet(torch.zeros((1, lat, lat, m.unet_config.in_channels), device=d),
                         torch.zeros((1,), dtype=torch.int32, device=d), ctx)
        results[key] = (ctx.cpu(), concat.cpu(), eps.cpu())
    vae64 = models.pop("cpu").vae.double()
    with torch.no_grad():
        concat64 = vae64.encode(-torch.ones((1, size, size, 3), dtype=torch.float64))
    del vae64
    for i, (name, label) in enumerate((("zero123.clip", "CLIP + cc"),
                                       ("zero123.vae", "VAE encode"),
                                       ("zero123.unet", "UNet"))):
        pe_checksum(f"{name} from zero123.npz on the card", results["card"][i], printed[name][1])
        if name == "zero123.vae":   # the CPU's f32 encode strays: the novel-view phase's rule
            if not _nv_held(f"(port-eval) {label}", results["card"][i], results["cpu"][i],
                            concat64):
                _fail("port-eval: the Zero123 VAE encode, card against CPU")
        else:
            pe_held(f"port-eval: Zero123 {label} card against CPU", results["card"][i],
                    results["cpu"][i])
    return models["card"]


def check_dit(dev, saved, printed, info, dcfg, quant):
    """The DiT from the saved (int8) tree; the ported tree at depth 2 in f32,
    card against CPU."""
    from fluidnexus_torch.convert import video_dit_from_numpy

    qcfg = dataclasses.replace(dcfg, base_quant=quant)
    dit = video_dit_from_numpy(saved["video_dit"], qcfg, dev)
    zeros = (torch.zeros((1, dcfg.latent_frames, dcfg.in_channels, dcfg.latent_height,
                          dcfg.latent_width), device=dev),
             torch.zeros((1,), dtype=torch.int32, device=dev),
             torch.zeros((1, dcfg.text_length, dcfg.text_hidden_size), device=dev))
    with torch.no_grad():
        out_q = dit(*zeros)
    del dit
    pe_checksum("video.dit from video_dit.npz (int8 base) on the card", out_q,
                printed["video.dit"][1], tol=PE_QUANT_TOL if quant else 1e-5)
    cfg2 = dataclasses.replace(dcfg, num_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED + 23)
    inputs = (torch.randn(zeros[0].shape, generator=g), torch.tensor([500], dtype=torch.int32),
              torch.randn(zeros[2].shape, generator=g))
    outs = {}
    for d in (dev, torch.device("cpu")):
        m = video_dit_from_numpy(info["reported"]["video.dit"], cfg2, d)
        with torch.no_grad():
            outs[d.type] = m(*(x.to(d) for x in inputs)).cpu()
        del m
    pe_held("port-eval: the ported DiT at the 5B width, depth 2, f32, card against CPU",
            outs[dev.type], outs["cpu"])


def check_vae3d(dev, saved, printed, vcfg):
    """The 3D-VAE from its saved tree, card against CPU."""
    from fluidnexus_torch.convert import vae3d_from_numpy

    g = torch.Generator().manual_seed(SEED + 27)
    fac = 2 ** (len(vcfg.ch_mult) - 1)
    x = torch.rand((1, 5, fac * 8, fac * 8, 3), generator=g) * 2 - 1
    zs = {}
    for d in (dev, torch.device("cpu")):
        v = vae3d_from_numpy(saved["video_vae"], vcfg, d)
        with torch.no_grad():
            if d == dev:
                pe_checksum("video.vae3d from video_vae.npz on the card",
                            v.encode(torch.zeros_like(x, device=d))[0], printed["video.vae3d"][1])
            zs[d.type] = v.encode(x.to(d))[0].cpu()
        del v
    pe_held("port-eval: 3D-VAE encode card against CPU", zs[dev.type], zs["cpu"])


def write_view_data(root, size=256):
    """frame_000/02.png (a seeded 256-px image) and camera/{00,02}.npy (W2C
    [R|T]) for one ``infer_novel_view`` view from camera 2 to camera 0."""
    from fluidnexus_torch.utils.png import write_png

    rng = np.random.default_rng(SEED + 24)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([0.2 + 0.6 * np.exp(-((xx - 0.5) / 0.15) ** 2) * (1 - yy)] * 3, -1)
    img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
    write_png(os.path.join(root, "frame_000", "02.png"), (img * 255).astype(np.uint8))
    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    for cam, angle in ((0, -0.6), (2, 0.0)):
        c, s = math.cos(angle), math.sin(angle)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        np.save(os.path.join(root, "camera", f"{cam:02d}.npy"),
                np.concatenate([r, (-r @ np.array([3 * s, 0.2, 3 * c]))[:, None]], 1))


def hand_off_view(dev, root, out, model):
    """``infer_novel_view --ckpt <out>/zero123`` makes one view; the same
    view from ``model`` (the drill's in-memory tree) must equal it bit for
    bit."""
    import time

    from fluidnexus_torch.pipelines import infer_novel_view as inv
    from fluidnexus_torch.utils.png import read_png

    data = os.path.join(root, "view_data")
    write_view_data(data)
    argv = ["--data_dir", data, "--out_dir", os.path.join(root, "view_cli"), "--ckpt",
            os.path.join(out, "zero123"), "--target_cams", "0", "--num_frames", "1",
            "--num_steps", str(PE_VIEW_STEPS)]
    t0 = time.perf_counter()
    inv.main(argv, device=dev.type)
    seconds = time.perf_counter() - t0
    inv.run_inference(model, data, os.path.join(root, "view_tree"), target_cams=(0,),
                      num_frames=1, num_steps=PE_VIEW_STEPS, log=lambda *a: None)
    name = os.path.join("zero123_finetune_52000_cam2to0", "frame_000000.png")
    a, b = (read_png(os.path.join(root, d, name)) for d in ("view_cli", "view_tree"))
    print(f"port-eval: infer_novel_view --ckpt {out}/zero123 ({PE_VIEW_STEPS} DDIM steps, "
          f"{seconds:.1f} s with the load): {a.shape} {a.dtype}, mean {a.mean():.2f}; the view "
          f"from the drill's in-memory tree {'equals it bit for bit' if np.array_equal(a, b) else 'DIFFERS'}")
    if not np.array_equal(a, b):
        _fail("the hand-off view differs from the in-memory tree's")
    gc_cuda()


def _blurred_shift(x, axis, shift):
    """The sample set: x averaged with itself shifted by one along ``axis``,
    plus ``shift`` (float in, float out)."""
    return 0.5 * (x + torch.roll(x, 1, axis)) + shift


def adm_images(n, px, generator):
    """(n, px, px, 3) uint8 images on the generator's device: a gradient of
    its own an image (offset 40-215, slopes up to +-40 levels) plus noise of
    30 levels at 256 px (scaled with the side, so that the mean over a cell
    of the features' 8 x 8 grid keeps ~1 level of it); the sample set is the blurred copy tinted by +3 levels of red
    and -3 of blue, off the references' manifold (a shift of brightness
    would move along it), which at 10 000 images a set leaves P and R
    inside (0, 1)."""
    dev = generator.device
    a, b, c = (torch.rand((n, 1, 1, 1), generator=generator, device=dev) for _ in range(3))
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, px, device=dev),
                            torch.linspace(-1, 1, px, device=dev), indexing="ij")
    x = (40 + 175 * a + 40 * (2 * b - 1) * xx[None, :, :, None]
         + 40 * (2 * c - 1) * yy[None, :, :, None]
         + 30 * px / 256 * torch.randn((n, px, px, 3), generator=generator, device=dev))
    ref = x.clamp(0, 255).to(torch.uint8)
    tint = torch.tensor([3.0, 0.0, -3.0], device=dev)
    smp = _blurred_shift(ref.float(), 2, tint).clamp(0, 255).to(torch.uint8)
    return ref.cpu().numpy(), smp.cpu().numpy()


def pe_pr_points(ref_feats, smp_feats, device):
    """``precision_recall``'s steps on ``device`` (``manifold_radii``, then
    ``evaluate_pr``) and the sphere tests point by point: (P, R, the
    samples inside a reference sphere, the references inside a sample
    sphere)."""
    from fluidnexus_torch.utils import adm_metrics as am

    r1, r2 = (am.manifold_radii(f, device=device) for f in (ref_feats, smp_feats))
    prec, rec = am.evaluate_pr(ref_feats, r1, smp_feats, r2, device=device)
    d = am.pairwise_sq_distances(ref_feats, smp_feats, device)
    r1, r2 = (torch.as_tensor(r[:, 0], device=d.device) for r in (r1, r2))
    return (float(prec[0]), float(rec[0]), (d <= r1[:, None]).any(0).cpu().numpy(),
            (d <= r2[None]).any(1).cpu().numpy())


def pe_pr_held(got, ref_feats, smp_feats, dev):
    """``evaluate_adm``'s P and R (``got``, from the card) against the CPU's
    on the same features, point by point: every point whose sphere test
    differs between card and CPU must have a distance to a sphere's centre
    that lies, in float64, within PE_PR_REL of that sphere's radius plus
    PE_PR_NORM of |u|^2 + |v|^2."""
    pts = {"card": pe_pr_points(ref_feats, smp_feats, dev),
           "cpu": pe_pr_points(ref_feats, smp_feats, "cpu")}
    for key, (p, r, inside_ref, inside_smp) in pts.items():
        if (p, r) != (float(inside_ref.mean()), float(inside_smp.mean())):
            _fail(f"P/R on the {key}: ({p}, {r}) is not the mean of its sphere tests")
    if pts["card"][:2] != (got["Precision"], got["Recall"]):
        _fail(f"P/R: evaluate_adm wrote {got}, its steps on the card give {pts['card'][:2]}")
    cpu_pr = pts["cpu"][:2]
    if not all(0 < x < 1 for x in cpu_pr):
        _fail(f"P/R on the CPU {cpu_pr}: 0 < P, R < 1 expected")
    flip_s = np.flatnonzero(pts["card"][2] != pts["cpu"][2])   # samples
    flip_r = np.flatnonzero(pts["card"][3] != pts["cpu"][3])   # references
    far = 0
    if len(flip_s) or len(flip_r):
        f1, f2 = (torch.as_tensor(np.asarray(f, np.float64), device=dev)
                  for f in (ref_feats, smp_feats))
        n1, n2 = (f1 * f1).sum(1), (f2 * f2).sum(1)
        # radius: the 4th smallest squared distance (the point itself at rank 0)
        r1, r2 = (torch.kthvalue(torch.cdist(f, f) ** 2, 4, 1).values for f in (f1, f2))
        # a flipped sample j against every reference sphere (i, j); a flipped
        # reference i against every sample sphere (i, j)
        s, r = torch.as_tensor(flip_s, device=dev), torch.as_tensor(flip_r, device=dev)
        for d, rad, norms, axis in (
                (torch.cdist(f1, f2[s]) ** 2, r1[:, None], n1[:, None] + n2[s][None], 0),
                (torch.cdist(f1[r], f2) ** 2, r2[None], n1[r][:, None] + n2[None], 1)):
            near = (d - rad).abs() <= PE_PR_REL * rad + PE_PR_NORM * norms
            far += int((~near.any(axis)).sum())
    print(f"port-eval: P/R of {len(ref_feats)} against {len(smp_feats)} (evaluate_adm's features): "
          f"card {pts['card'][:2]}, CPU {cpu_pr}; sphere tests that differ: {len(flip_s)} samples, "
          f"{len(flip_r)} references, {far} of them not borderline")
    if far:
        _fail(f"P/R: {far} sphere tests differ between card and CPU away from a radius")


def write_vgg16(path, g):
    """A seeded torchvision-layout VGG16 state dict (every ``features.*`` and
    ``classifier.*`` key) at ``path``."""
    from fluidnexus_torch.utils import perceptual as per

    dev, sd, cin = g.device, {}, 3
    for idx, cout in zip(per.CONV_IDX, per.CONV_CH):
        sd[f"features.{idx}.weight"] = (torch.randn((cout, cin, 3, 3), generator=g, device=dev)
                                        * math.sqrt(2.0 / (cin * 9))).cpu()
        sd[f"features.{idx}.bias"] = (0.01 * torch.randn(cout, generator=g, device=dev)).cpu()
        cin = cout
    for i, (o, c) in zip((0, 3, 6), ((4096, 25088), (4096, 4096), (1000, 4096))):
        sd[f"classifier.{i}.weight"] = (torch.randn((o, c), generator=g, device=dev)
                                        / math.sqrt(c)).cpu()
        sd[f"classifier.{i}.bias"] = torch.zeros(o)
    torch.save(sd, path)


def run_adm(dev, root, smi):
    """``evaluate_adm`` through the runner on PE_ADM_N against PE_ADM_N seeded
    uint8 images (``adm_images``: the sample set a blurred, shifted copy),
    default features; the features, distance blocks and host sqrtm timed
    apart; the features, FID and sFID of PE_SUBSET images held card against
    CPU, P and R of the whole run against the CPU's on its features. Then
    ``--vgg16`` on the reference's NHWC layout at PE_VGG_PX (raises, as in
    the JAX package) and the VGG features of 16 images as the network reads
    them (N, C, H, W), card against CPU."""
    import time

    import yaml

    from fluidnexus_torch.__main__ import main as runner
    from fluidnexus_torch.utils import adm_metrics as am
    from fluidnexus_torch.utils import perceptual as per

    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    n, px = PE_ADM_N, PE_ADM_PX
    t0 = time.perf_counter()
    ref, smp = adm_images(n, px, g)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    ref_p, smp_p = os.path.join(root, "ref.npz"), os.path.join(root, "samples", "smp.npz")
    np.savez(ref_p, arr_0=ref)
    np.savez(smp_p, arr_0=smp)
    print(f"port-eval: {n} + {n} uint8 images of {px} x {px} x 3 written in "
          f"{time.perf_counter() - t0:.1f} s")

    times = {"features": [], "distances": [], "sqrtm": []}
    feats = []
    real = am.default_feature_fn, am.pairwise_sq_distances, am.ADMStatistics.frechet_distance

    def features(images, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real[0](images, *a, **kw)
        times["features"].append((time.perf_counter() - t) * 1e3)
        feats.append(out)
        return out

    def distances(u, v, device="cuda"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real[1](u, v, device)
        torch.cuda.synchronize()
        times["distances"].append((time.perf_counter() - t) * 1e3)
        return out

    def frechet(self, other, eps=1e-6):
        t = time.perf_counter()
        out = real[2](self, other, eps)
        times["sqrtm"].append((time.perf_counter() - t) * 1e3)
        return out

    am.default_feature_fn, am.pairwise_sq_distances = features, distances
    am.ADMStatistics.frechet_distance = frechet
    try:
        t0 = time.perf_counter()
        runner(["evaluate_adm", "--ref_batch", ref_p, "--sample_batch", smp_p])
        seconds = time.perf_counter() - t0
    finally:
        am.default_feature_fn, am.pairwise_sq_distances = real[:2]
        am.ADMStatistics.frechet_distance = real[2]

    with open(os.path.join(root, "samples", "evaluation_metrics.yaml")) as f:
        got = yaml.safe_load(f)
    print(f"port-eval: evaluate_adm ({n} against {n} at {px} px, default features; pool "
          f"{feats[0][0].shape[1]}, spatial {feats[0][1].shape[1]} dims): {got}; {seconds:.2f} s "
          f"end to end; features ms {', '.join(f'{t:.1f}' for t in times['features'])}; "
          f"distance blocks ({len(times['distances'])} of {n} x {n}) ms "
          f"{', '.join(f'{t:.1f}' for t in times['distances'])}; host FID / sFID (scipy sqrtm, "
          f"float64) ms {', '.join(f'{t:.1f}' for t in times['sqrtm'])} [{smi}]")
    if not (got["FID"] > 0 and got["sFID"] > 0 and 0 < got["Precision"] < 1
            and 0 < got["Recall"] < 1):
        _fail(f"evaluate_adm: {got} (FID, sFID > 0 and 0 < P, R < 1 expected)")
    k = PE_SUBSET
    cpu_s, cpu_r = (am.default_feature_fn(x[:k], device="cpu") for x in (smp, ref))
    for i, what in enumerate(("pool", "spatial")):
        pe_held(f"port-eval: default features ({what}) of {k} images card against CPU",
                feats[0][i][:k], cpu_s[i])
    card_s, card_r = (tuple(f[:k] for f in fs) for fs in feats)
    for i, what in enumerate(("FID", "sFID")):
        a = am.compute_statistics(card_s[i]).frechet_distance(am.compute_statistics(card_r[i]))
        b = am.compute_statistics(cpu_s[i]).frechet_distance(am.compute_statistics(cpu_r[i]))
        print(f"port-eval: {what} of {k} against {k}: card {a!r}, CPU {b!r}")
        if not abs(a - b) <= PE_METRIC_TOL * abs(b):
            _fail(f"{what} of the subset: card {a} against CPU {b}")
    t0 = time.perf_counter()
    pe_pr_held(got, feats[1][0], feats[0][0], dev)
    print(f"port-eval: P/R card against CPU {time.perf_counter() - t0:.1f} s")
    del ref, smp, feats, cpu_s, cpu_r, card_s, card_r
    gc_cuda()

    vp = os.path.join(root, "vgg16.pth")
    write_vgg16(vp, g)
    ref, smp = adm_images(n, PE_VGG_PX, g)
    np.savez(ref_p, arr_0=ref)
    np.savez(smp_p, arr_0=smp)
    try:
        runner(["evaluate_adm", "--ref_batch", ref_p, "--sample_batch", smp_p, "--vgg16", vp])
        _fail("evaluate_adm --vgg16 ran on (N, H, W, 3) images; the JAX package's raises")
    except RuntimeError as e:
        print(f"port-eval: evaluate_adm --vgg16 on the reference's ({n}, {PE_VGG_PX}, "
              f"{PE_VGG_PX}, 3) uint8 npz raises, as the JAX package's does: "
              f"{str(e).splitlines()[0]}")
    x = ref[:16].transpose(0, 3, 1, 2)
    card, cpu = (am.vgg_feature_fn(per.load_torch_vgg16(vp), device=d)(x) for d in (dev, "cpu"))
    for i, what in enumerate(("pool", "spatial")):
        pe_held(f"port-eval: VGG16 features ({what}) of 16 images card against CPU", card[i],
                cpu[i])
    gc_cuda()


def vgg_sfid_finding(dev, root, smi):
    """The sFID finding of ``--vgg16``: VGG16's features of PE_ADM_N +
    PE_ADM_N images at PE_VGG_PX as the network reads them (N, C, H, W),
    their FID, P and R, the spatial features' width and the float64
    covariance it takes, and scipy's sqrtm timed at PE_SQRTM_DIM."""
    import time

    from scipy import linalg

    from fluidnexus_torch.utils import adm_metrics as am
    from fluidnexus_torch.utils import perceptual as per

    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    vp = os.path.join(root, "vgg16.pth")
    write_vgg16(vp, g)
    n = PE_ADM_N
    ref, smp = adm_images(n, PE_VGG_PX, g)
    fn = am.vgg_feature_fn(per.load_torch_vgg16(vp), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vr, vs = fn(ref.transpose(0, 3, 1, 2)), fn(smp.transpose(0, 3, 1, 2))
    torch.cuda.synchronize()
    vgg_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fid = am.compute_statistics(vs[0]).frechet_distance(am.compute_statistics(vr[0]))
    fid_ms = (time.perf_counter() - t0) * 1e3
    prec, rec = am.precision_recall(vr[0], vs[0], device=dev)
    dims = vr[1].shape[1]
    rng = np.random.default_rng(SEED)
    m = PE_SQRTM_DIM
    a, b = rng.normal(size=(m, m)), rng.normal(size=(m, m))
    s1, s2 = a @ a.T / m, b @ b.T / m
    t0 = time.perf_counter()
    linalg.sqrtm(s1.dot(s2))
    sq_s = time.perf_counter() - t0
    print(f"port-5b: VGG16 features of {n} + {n} images at {PE_VGG_PX} px as the network "
          f"reads them ((N, 3, H, W)): {vgg_ms:.1f} ms; pool {vr[0].shape[1]} dims, FID over them "
          f"{fid!r} ({fid_ms:.1f} ms), P {prec}, R {rec}; spatial {dims} dims: its float64 "
          f"covariance {dims ** 2 * 8 / 2**30:.2f} GiB; scipy sqrtm on this host {sq_s:.2f} s "
          f"at {m} dims, so ~{sq_s * (dims / m) ** 3 / 3600:.1f} h at {dims} (n^3): sFID not "
          f"computed [{smi}]")
    if not (np.isfinite(vr[0]).all() and np.isfinite(vs[0]).all() and math.isfinite(fid)):
        _fail(f"VGG16 features or their FID not finite ({fid})")
    gc_cuda()


def run_fvd_perceptual(dev, smi):
    """FVD through ``i3d_feature_fn(random_params(0))`` on PE_FVD_N against
    PE_FVD_N seeded clips of PE_FVD_T x 224 x 224 (the sample set blurred and
    shifted), and ``compute_perceptual_similarity_from_list`` on
    PE_PERC_PAIRS pairs at PE_PERC_PX; each held card against CPU on a few."""
    import time

    from fluidnexus_torch.utils import i3d
    from fluidnexus_torch.utils import perceptual as per
    from fluidnexus_torch.utils import video_metrics as vm

    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    shape = (PE_FVD_N, PE_FVD_T, 224, 224, 3)   # the I3D detector's input
    a = torch.rand(shape, generator=g, device=dev)
    b = _blurred_shift(a, 3, 0.02).clamp(0, 1)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    params = i3d.random_params(0)
    fn = vm.i3d_feature_fn(params, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa, fb = fn(a), fn(b)
    torch.cuda.synchronize()
    feat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fvd = vm.frechet_distance(fa, fb)
    fd_ms = (time.perf_counter() - t0) * 1e3
    print(f"port-eval: FVD (I3D logits, random_params(0)) of {shape[0]} against {shape[0]} clips "
          f"of {shape[1]} x {shape[2]} x {shape[3]}: {fvd!r}; I3D features {feat_ms:.1f} ms "
          f"({feat_ms / (2 * shape[0]):.2f} ms a clip, batch 8), host Frechet (eigh, float64) "
          f"{fd_ms:.1f} ms [{smi}]")
    if not (math.isfinite(fvd) and fvd > 0 and np.isfinite(fa).all()):
        _fail(f"FVD {fvd}")
    cpu = i3d.i3d_logits(params, a[:2], device="cpu")
    pe_held("port-eval: I3D logits of 2 clips card against CPU", fa[:2], cpu)
    del a, b

    vp = per.random_params(0)
    n, px = PE_PERC_PAIRS, PE_PERC_PX
    p = torch.rand((n, 3, px, px), generator=g, device=dev)
    t = _blurred_shift(p, 3, 0.02).clamp(0, 1)
    pred, tgt = list(p.cpu().numpy()), list(t.cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = per.compute_perceptual_similarity_from_list(pred, tgt, vp, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"port-eval: compute_perceptual_similarity_from_list on {n} pairs at {px} x {px}: "
          f"{got}; {ms:.1f} ms [{smi}]")
    a4 = per.compute_perceptual_similarity_from_list(pred[:4], tgt[:4], vp, device=dev)
    c4 = per.compute_perceptual_similarity_from_list(pred[:4], tgt[:4], vp, device="cpu")
    for k in c4:
        print(f"port-eval: {k} of 4 pairs: card {a4[k]!r}, CPU {c4[k]!r}")
        if not abs(a4[k] - c4[k]) <= PE_METRIC_TOL * abs(c4[k]):
            _fail(f"{k} of 4 pairs: card {a4[k]} against CPU {c4[k]}")
    gc_cuda()


def run_port_eval(dev, root, t5_dir=None, full_dit=False):
    """The ``port`` and ``evaluate_adm`` stages. ``python -m fluidnexus_torch
    port --zero123 ... --vae3d ... --t5 ... --out_dir ... --quant_base`` in
    process on seeded checkpoints in the reference's layouts (Zero123 at the
    full UNet / ViT-L/14 / KL-VAE geometry with the upstream 4-channel input
    conv, the 3D-VAE at VAE3DConfig(), T5 at full width and depth 2); the SAT
    DiT at the 5B width in the raw LoRA layout at rank LORA_RANK: with
    ``full_dit`` all 42 layers through the CLI's ``--cogvideox``, else
    ``drill_cogvideox`` on PE_DIT_LAYERS layers (the 42-layer file is 21
    GB and its port takes minutes: ``port-5b``). Row 14 held at the DiT
    forward's layer-0 inputs and counted there; the saved trees read back bit
    for bit, the modules loaded from them give the printed counts and
    checksums, every forward card against CPU; ``infer_novel_view --ckpt`` on
    the saved Zero123 against the in-memory tree; then the metrics (ADM, VGG,
    FVD, perceptual), or with ``full_dit`` the VGG sFID finding. Returns the
    row-14 ``kernels`` entry."""
    import shutil
    import time

    from fluidnexus_torch.__main__ import main as runner
    from fluidnexus_torch.pipelines import port_drill as pd

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs(root, exist_ok=True)
    with open("/proc/meminfo") as f:
        mem = {l.split(":")[0]: int(l.split()[1]) for l in f if l.split(":")[0] in
               ("MemTotal", "MemAvailable")}
    print(f"port-eval: {shutil.disk_usage(root).free / 2**30:.1f} GiB free in {root}; host "
          f"memory {mem['MemAvailable'] / 2**20:.1f} of {mem['MemTotal'] / 2**20:.1f} GiB "
          f"available [{smi}]")
    dit_layers = 42 if full_dit else PE_DIT_LAYERS
    marks = [t_phase]

    def mark(what):
        marks.append(time.perf_counter())
        print(f"port-eval: {what} {marks[-1] - marks[-2]:.1f} s")

    paths, dcfg, vcfg = write_port_checkpoints(dev, os.path.join(root, "ckpt"), dit_layers,
                                               t5_dir, only_dit=full_dit)
    mark("the checkpoints")
    out = os.path.join(root, "ports")
    if full_dit:
        argv = ["--cogvideox", paths["mp_rank_00_model_states.pt"], "--out_dir", out,
                "--quant_base"]
        _, text, info = pe_run(runner, ["port"] + argv)
    else:
        argv = ["--zero123", paths["last.ckpt"], "--vae3d", paths["3d-vae.pt"], "--t5",
                paths["t5"], "--out_dir", out, "--quant_base"]
        _, text, info = pe_run(runner, ["port"] + argv)
        _, dit_text, dit_info = pe_run(pd.drill_cogvideox, paths["mp_rank_00_model_states.pt"],
                                       out, dit_cfg=dcfg, quant=True)
        text += dit_text
        for k in ("saved", "reported"):
            info[k].update(dit_info[k])
        info.update({k: dit_info[k] for k in ("launches", "q", "k", "v", "attention_calls")})
        info["seconds"] += dit_info["seconds"]
    print(f"port-eval: python -m fluidnexus_torch port {' '.join(argv)}"
          + ("" if full_dit else f" and drill_cogvideox at {dit_layers} layers")
          + f": {info['seconds']:.1f} s [{smi}]")
    if "all requested port maps ran OK" not in text:
        _fail("port did not end with its OK line")
    printed = pe_printed(text)
    entry = refine_attention_entry("port", info, 1, dit_layers, pairs=((0, 0), (0, 47)))
    for k in ("q", "k", "v"):
        info.pop(k)
    mark("port")
    model = port_checks(dev, paths, out, printed, info, dcfg, vcfg, quant=True)
    info.clear()
    mark("the checks")
    if model is not None:
        hand_off_view(dev, root, out, model)
        del model
        mark("the hand-off view")
    gc_cuda()
    shutil.rmtree(os.path.join(root, "ckpt"), ignore_errors=True)
    if full_dit:
        vgg_sfid_finding(dev, root, smi)
        mark("the VGG sFID finding")
    else:
        run_adm(dev, root, smi)
        mark("evaluate_adm and VGG")
        run_fvd_perceptual(dev, smi)
        mark("FVD and perceptual")
    for m in ("jax", "flax", "fluidnexus_tpu"):
        if m in sys.modules:
            _fail(f"the port-eval phase imported {m}")
    print(f"port-eval phase: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return [entry]


def port_eval_only(full_dit=False):
    """``python3 chip_smoke.py port-eval`` (``port-5b``: the 42-layer SAT
    DiT through the CLI and the VGG sFID finding, in place of the other
    checkpoints and metrics): builds ``attention``, runs ``run_port_eval``."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    from fluidnexus_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, info in cuda_build.build(["attention"]).items():
        print(f"build {name}: {info['seconds']:.1f} s")
    with tempfile.TemporaryDirectory(prefix="fnx_port_eval_") as tmp:
        print(json.dumps({"kernels": run_port_eval(torch.device("cuda"), tmp,
                                                   full_dit=full_dit)}))


# ------------------------------- parallel -------------------------------------

PAR_LAYERS = 2                # of the 5B DiT's 42 blocks, in the two-rank runs
PAR_STEPS = 2                 # sampler steps of the two-rank sampling runs
PAR_FRAMES = 9                # --num_frames of the two-rank CLIs (3 latents, 4 276 tokens)
PAR_CP = (9, 64, 96)          # frames, height, width of the CP VAE check (the VAE's full channels)
PAR_RECON_BATCH = 5           # cameras of the phase-C iteration at pipe.dp 2 (padded to 6)
# bf16 latents after PAR_STEPS guided steps: a rank's GEMMs split or batch the
# work differently (the row-parallel partial sums meet in a bf16 all_reduce),
# so outputs part by bf16's 2^-8, which the guidance's 1 + 6 (cond - uncond)
# multiplies up to ~7x a step: max|diff| within 5e-2 of max|ref| and the
# mean within 1e-2 of mean|ref| (one rank's runs agree bit for bit)
PAR_TOL, PAR_MEAN_TOL = 5e-2, 1e-2
# train_video --tp 2: the loss is one f32 reduction of bf16 products either
# way (1.76e-6 and 2.00e-6 relative in two card runs), so 1e-4 relative
PAR_LOSS_TOL = 1e-4
PAR_TIMEOUT = 600             # seconds the two ranks get for all their runs
PAR_SHAPE = (2, 24, 17776, 64)   # rows 14 and 15 at 24 heads a rank, the 5B clip


def _depth_configs(real, layers):
    """``sample_video.configs`` with the DiT cut to ``layers`` blocks (the
    ``--tiny`` DiT as it is)."""
    def configs(num_frames, height, width, tiny, run_cfg=None):
        dit_cfg, vae_cfg = real(num_frames, height, width, tiny, run_cfg)
        return (dit_cfg if tiny else dataclasses.replace(dit_cfg, num_layers=layers)), vae_cfg

    return configs


@contextlib.contextmanager
def dit_depth(layers):
    """The video CLIs (``sample_video``, ``train_video``, ``gen_refine_video``,
    ``gen_future_video``) build their DiT with ``layers`` blocks inside."""
    from fluidnexus_torch.pipelines import sample_video, train_video

    real = sample_video.configs
    sample_video.configs = train_video.configs = _depth_configs(real, layers)
    try:
        yield
    finally:
        sample_video.configs = train_video.configs = real


def _par_argv(root):
    """The argv of the two-rank runs' CLIs (run the same on one rank)."""
    return {
        "sample": ["--prompt", "smoke rising past a cylinder", "--num_steps", str(PAR_STEPS),
                   "--num_frames", str(PAR_FRAMES), "--allow_fake_conditioning"],
        "train": ["--data_root", os.path.join(root, "clips"), "--iterations", "1", "--batch", "2",
                  "--num_frames", str(PAR_FRAMES), "--allow_fake_conditioning",
                  "--lora_rank", str(LORA_RANK), "--log_every", "1"],
    }


def _par_run(task, root, out_dir, group_size, recon):
    """One run of the parallel phase on this process (a rank, or the one
    rank): the CLI of ``task`` with the DiT cut to PAR_LAYERS blocks and the
    non-zero init of the training phase (so every block's gates let its
    attention and MLP reach the output), or the phase-C fit iteration.
    Returns what the parent holds the runs to, and the launch counts."""
    from fluidnexus_torch.diffusion.video.dit import gather_dit_state, lora_param_filter
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.pipelines import sample_video, train_video

    argv = _par_argv(root)
    seen = {}
    real = (sample_video.configs, train_video.configs, VideoEngine.init_params,
            VideoEngine.sample)

    def sample(self, *a, **kw):
        lat = real[3](self, *a, **kw)
        seen["lat"] = lat.float().cpu()
        return lat

    init = _train_init(real[2])

    def init_params(self, generator):
        model = init(self, generator)
        seen["lora0"] = {n: p.detach().float().cpu().clone()
                         for n, p in model.named_parameters() if lora_param_filter(n)}
        return model

    sample_video.configs = train_video.configs = _depth_configs(real[0], PAR_LAYERS)
    VideoEngine.init_params, VideoEngine.sample = init_params, sample
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        if task.startswith("sample"):
            flags = {"sample_tp": ["--tp", "2"], "sample_dp": ["--dp", "2"], "sample": []}[task]
            decoded = sample_video.main(argv["sample"] + flags + [
                "--out_folder", os.path.join(out_dir, task)], device="cuda")
            torch.cuda.synchronize()
            res = {"lat": seen["lat"], "frames": tuple(decoded.shape),
                   "finite": bool(torch.isfinite(decoded).all())}
        elif task.startswith("train"):
            flags = ["--tp", "2"] if task == "train_tp" else []
            dit, loss, _ = train_video.main(argv["train"] + flags, device="cuda", log=print)
            lora = {n: p for n, p in dit.named_parameters() if lora_param_filter(n)}
            full = gather_dit_state(dit, lora)
            torch.cuda.synchronize()
            res = {"loss": loss, "lora": {n: x.detach().float().cpu() for n, x in full.items()},
                   "lora0": seen["lora0"], "local_qkv": tuple(dict(dit.named_parameters())[
                       "block_0.attn.qkv.weight"].shape)}
        else:
            res = _par_recon(recon, group_size)
        launches = all_launches()
    finally:
        sample_video.configs, train_video.configs, VideoEngine.init_params, VideoEngine.sample = real
    res["launches"] = launches
    return res


def _par_recon(recon, dp):
    """One phase-C fit iteration on the smoke scene from the reconstruction
    ``recon``'s frame-1 checkpoint, its camera batch of PAR_RECON_BATCH split over the
    ``pipe.dp`` ranks (``train_physical_particle._recon_group``). Returns the
    loss, its terms and the fitted positions."""
    from fluidnexus_torch.data.scene import cameras_by_time
    from fluidnexus_torch.pipelines import train_physical_particle as tp

    dev = torch.device("cuda")
    cfg = phase_c_config()
    cfg.optim.batch, cfg.pipe.dp = PAR_RECON_BATCH, dp
    scene = smoke_scene()
    bg = synthetic_background(32768, dev)
    render_ground_truth(cfg, scene, bg, dev)
    params = tp.pbf_params_from_config(cfg)
    ckpt = os.path.join(recon, "checkpoint")
    state = tp.load_hidden(ckpt, 1, cfg.model.hidden_capacity, params, device=dev)
    visual, attrs = tp.load_visual(ckpt, 1, cfg.model.visual_capacity, channels=1, device=dev)
    cams = cameras_by_time(scene.train_cameras)[2]
    step = tp.make_current_frame_step(bg, tp.raster_config_from(cfg), cams[0].width,
                                      cams[0].height, params, cfg.optim, 3,
                                      group=tp._recon_group(cfg, dev))
    sel, w, inv_w = tp._select_batch(np.random.default_rng(SEED), len(cams), PAR_RECON_BATCH, 2)
    views, projs, fovs = tp._cam_tensors(cams, dev)
    sel_t = torch.as_tensor(sel, device=dev)
    nn = state.estimate_xyz / params.scale_factor
    torch.cuda.synchronize()
    reset_all_launches()
    nn, _, loss, aux = step(nn, tp.adam_init({"nn": nn}), state, visual, attrs,
                            (views[sel_t], projs[sel_t], fovs[sel_t]), tp._gts(cams, 3, dev)[sel_t],
                            1e-4, torch.as_tensor(w, device=dev), torch.as_tensor(inv_w, device=dev))
    torch.cuda.synchronize()
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "nn": nn.cpu(), "alive": state.alive.cpu(), "slots": len(sel)}


def _par_rank(rank, world, rdv, root, out_dir, recon):
    """A rank of the parallel phase: gloo over a ``file://`` rendezvous (NCCL
    refuses two ranks on one card), cuda:0, every two-rank run in turn, each
    result saved for the parent."""
    import datetime

    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for task in ("sample_tp", "sample_dp", "train_tp", "recon_dp"):
            res = _par_run(task, root, out_dir, world, recon)
            torch.save(res, os.path.join(out_dir, f"{task}.rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _par_held(what, got, ref, tol, mean_tol=None):
    """max|got - ref| over max|ref| against ``tol`` (and, with
    ``mean_tol``, mean|got - ref| over mean|ref|); fails past them."""
    diff = (got.float() - ref.float()).abs()
    err, scale = float(diff.max()), float(ref.float().abs().max())
    mean = float(diff.mean()) / float(ref.float().abs().mean())
    print(f"parallel: {what}: max|diff| {err:.3e} of max|ref| {scale:.3e} ({err / scale:.2e}; "
          f"tol {tol:g}); mean|diff| / mean|ref| {mean:.2e}"
          + (f" (tol {mean_tol:g})" if mean_tol else ""))
    if not err <= tol * scale or (mean_tol and not mean <= mean_tol):
        _fail(f"parallel: {what} disagrees with one rank's run")
    return err / scale


def _par_cp_check(dev, tmp):
    """``cp_vae_encode``/``cp_vae_decode`` on the card through a one-rank
    NCCL group (gloo's point-to-point takes no CUDA tensor, so the two ranks
    on one card cannot run the halo ring): the front pad, the masked group-
    norm moments summed over the group, the uniform temporal pool and
    doubling, against the serial pass at 1e-4 of scale."""
    import torch.distributed as dist

    from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig, init_vae
    from fluidnexus_torch.parallel.cp import cp_vae_decode, cp_vae_encode
    from fluidnexus_torch.parallel.mesh import make_mesh

    t, hh, ww = PAR_CP
    vae = init_vae(VAE3DConfig(), torch.Generator(device=dev).manual_seed(SEED))
    x = torch.as_tensor(np.random.default_rng(SEED + 8).uniform(-1, 1, (1, t, hh, ww, 3)),
                        dtype=torch.float32, device=dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, dp=1, tp=1, time=1, device_type="cuda")
        with torch.no_grad():
            z_ser = vae.encode(x, sample=False)[0]
            z_cp = cp_vae_encode(vae, x, mesh)
            d_ser = vae.decode(z_ser)[0]
            d_cp = cp_vae_decode(vae, z_ser, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    e = _par_held(f"cp_vae_encode at n = 1 under NCCL, {tuple(x.shape)} (3 front pads) against "
                  f"the serial encode", z_cp, z_ser, 1e-4)
    d = _par_held(f"cp_vae_decode at n = 1 under NCCL, latents {tuple(z_ser.shape)} (1 front "
                  f"pad) against the serial decode", d_cp, d_ser, 1e-4)
    return max(e, d)


def _par_kernel_entries(launches_fwd, launches_bwd):
    """Rows 14 and 15 at PAR_SHAPE (24 heads, a rank's share of the 5B's 48
    under --tp 2) on seeded bf16 inputs: against the plain versions on two
    (b, h) pairs, their CUDA-event times beside the bound, the plain
    versions' and the library's. Returns their ``kernels`` entries."""
    import torch.nn.functional as F

    from fluidnexus_torch.ops import attention_cuda as ac

    b, h, s, d = PAR_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    q, k, v, dout = (torch.randn(PAR_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    dout = dout.transpose(1, 2).contiguous()     # (b, s, h, d), the layout the DiT hands back
    pairs = ((0, 0), (1, 23))
    with torch.no_grad():
        out, lse = ac.attention_fwd(q, k, v, lse=True)
        grads = ac.attention_bwd(q, k, v, out, lse, dout)
        f_err = b_err = 0.0
        for bi, hi in pairs:
            sl = (slice(bi, bi + 1), slice(hi, hi + 1))
            e = attention_errors(out[bi:bi + 1, :, hi:hi + 1], ac.attention_plain(q[sl], k[sl], v[sl]))
            eb = bwd_errors([g[sl] for g in grads],
                            ac.attention_bwd_plain(q[sl], k[sl], v[sl], dout[bi:bi + 1, :, hi:hi + 1]))
            if not (attention_ok(torch.bfloat16, *e) and bwd_ok(torch.bfloat16, eb)):
                _fail(f"rows 14/15 at {PAR_SHAPE} disagree with their plain versions at {(bi, hi)}")
            f_err, b_err = max(f_err, e[0]), max(b_err, *(x[0] for x in eb))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: ac.attention_fwd(q, k, v), iters=10)
        bwd_ms = cuda_ms(lambda: ac.attention_bwd(q, k, v, out, lse, dout), iters=5)
        sl = (slice(0, 1), slice(0, 1))
        plain = cuda_ms(lambda: ac.attention_plain(q[sl], k[sl], v[sl]), iters=2, warmup=1) * b * h
        plain_bwd = cuda_ms(lambda: ac.attention_bwd_plain(q[sl], k[sl], v[sl], dout[:1, :, :1]),
                            iters=2, warmup=1) * b * h
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10)
    lib_bwd = sdpa_bwd_ms(q, k, v, dout)
    prod = 2 * b * h * s * s * d
    io = b * h * s * d * 2
    fb = bound_ms(4 * io, 2 * prod, peak=H100_BF16_TC_FLOPS)
    bb = bound_ms(8 * io + 4 * b * h * s, 5 * prod, peak=H100_BF16_TC_FLOPS)
    print(f"parallel: row 14 (attention_fwd_wgmma) at {PAR_SHAPE} bf16: {ms:.3f} ms (bound "
          f"{fb[0]:.3f} by {fb[1]}, plain {plain:.1f}, scaled_dot_product_attention {lib:.3f}); "
          f"row 15 (attention_bwd_wgmma): {bwd_ms:.3f} ms (bound {bb[0]:.3f} by {bb[1]}, plain "
          f"{plain_bwd:.1f}, the library's backward {lib_bwd:.3f}); max|err| {f_err:.3e} / "
          f"{b_err:.3e}; launches at 24 heads on rank 0: {launches_fwd} forward, {launches_bwd} "
          f"backward")
    common = {"route": "cuda", "heads": h}
    return [dict(common, name="attention_fwd_wgmma_tp2", source="fluidnexus_torch/csrc/attention.cu",
                 replaces="fluidnexus_tpu/diffusion/video/dit.py:213", launches=launches_fwd,
                 max_abs_err=f_err, ms=ms, plain_ms=plain, bound_ms=fb[0], bound_by=fb[1],
                 library_ms=lib),
            dict(common, name="attention_bwd_wgmma_tp2",
                 source="fluidnexus_torch/csrc/attention_bwd.cu",
                 replaces="fluidnexus_tpu/diffusion/video/dit.py:256", launches=launches_bwd,
                 max_abs_err=b_err, ms=bwd_ms, plain_ms=plain_bwd, bound_ms=bb[0],
                 bound_by=bb[1], library_ms=lib_bwd)]


def run_parallel(dev, root, recon):
    """Item 16 on the card: two ranks on cuda:0 under gloo (NCCL refuses two
    ranks on one device) run ``sample_video --tp 2`` and ``--dp 2`` at the 5B
    width (48 heads, 24 a rank under --tp) with PAR_LAYERS blocks and
    PAR_STEPS sampler steps, one ``train_video --tp 2`` LoRA step, and one
    phase-C fit iteration at ``pipe.dp`` 2 from the reconstruction
    ``recon``; this process runs each on one rank and holds the ranks
    to it. Then the VAE's time-sharded encode and decode at n = 1 under NCCL
    (``_par_cp_check``) and rows 14 and 15 at 24 heads. Returns their
    ``kernels`` entries."""
    import time

    t0 = time.perf_counter()
    gc_cuda()    # the ranks share the card with this process
    out_dir = os.path.join(root, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    write_train_clip(os.path.join(root, "clips"), frames=PAR_FRAMES)
    print(f"parallel: two gloo ranks on cuda:0; the 5B DiT cut to {PAR_LAYERS} of 42 blocks "
          f"(hidden 3072, 48 heads), the non-zero init; sample_video --num_steps {PAR_STEPS} "
          f"({PAR_FRAMES} x 480 x 720, 4 276 tokens) at --tp 2 and at --dp 2; train_video --tp 2 "
          f"one LoRA step (rank {LORA_RANK}, batch 2, {PAR_FRAMES} frames); one phase-C fit "
          f"iteration at pipe.dp 2 (batch {PAR_RECON_BATCH}, padded to 6)")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_par_rank, args=(r, 2, os.path.join(root, "rendezvous"), root,
                                                 out_dir, recon)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + PAR_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 1.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if [p.exitcode for p in procs] != [0, 0]:
        _fail(f"parallel: the ranks exited {[p.exitcode for p in procs]}")
    t_ranks = time.perf_counter() - t0

    def ranks(task):
        return [torch.load(os.path.join(out_dir, f"{task}.rank{r}.pt"), weights_only=False)
                for r in range(2)]

    one = {t: _par_run(t, root, out_dir, 1, recon) for t in ("sample", "train", "recon")}
    worst = {}
    for task in ("sample_tp", "sample_dp"):
        got = ranks(task)
        for r, res in enumerate(got):
            if not res["finite"] or res["frames"] != (1, PAR_FRAMES, 480, 720, 3):
                _fail(f"parallel: {task} rank {r} decoded {res['frames']} (finite {res['finite']})")
            worst[task] = _par_held(f"{task} rank {r}'s latents after {PAR_STEPS} steps",
                                    res["lat"], one["sample"]["lat"], PAR_TOL, PAR_MEAN_TOL)
        heads = 24 if task == "sample_tp" else 48
        want = PAR_LAYERS * PAR_STEPS
        for r, res in enumerate(got):
            lc = res["launches"]
            print(f"parallel: {task} rank {r} launches {lc}")
            if lc["attention_fwd_wgmma"] != want:
                _fail(f"parallel: {task} rank {r} launched the Hopper forward "
                      f"{lc['attention_fwd_wgmma']} times, expected {want} ({heads} heads)")
        pngs = [sorted(os.listdir(os.path.join(out_dir, task)))]
        if len(pngs[0]) != PAR_FRAMES:
            _fail(f"parallel: {task} wrote {len(pngs[0])} PNGs, expected {PAR_FRAMES}")
    train = ranks("train_tp")
    lr = 1e-3

    def median_step(res):
        """The median |change| of the LoRA leaves over the step, over lr."""
        return float(torch.cat([(res["lora"][n] - x).abs().flatten()
                                for n, x in res["lora0"].items()]).median()) / lr

    # Adam's first update is lr * g / (|g| + eps) plus the decay, so the
    # step moves about every LoRA element by lr: the median change is held
    # within 10 % of lr on one rank and on each of the two
    one_step = median_step(one["train"])
    for r, res in enumerate(train):
        if res["local_qkv"] != (3 * 3072 // 2, 3072):
            _fail(f"parallel: train_tp rank {r} holds qkv {res['local_qkv']}, not half the heads")
        rel = abs(res["loss"] - one["train"]["loss"]) / abs(one["train"]["loss"])
        print(f"parallel: train_tp rank {r} loss {res['loss']:.6f}, one rank "
              f"{one['train']['loss']:.6f} ({rel:.2e}; tol {PAR_LOSS_TOL:g}); launches "
              f"{res['launches']}")
        if not rel <= PAR_LOSS_TOL:
            _fail("parallel: train_video --tp 2's loss disagrees with one rank's")
        if any(not torch.equal(res["lora0"][n], x) for n, x in one["train"]["lora0"].items()):
            _fail(f"parallel: train_tp rank {r} started from other LoRA leaves than one rank")
        # leaves whose gradient is bf16 noise may take the other sign, the
        # rest agree
        diffs = torch.cat([(res["lora"][n] - x).abs().flatten()
                           for n, x in one["train"]["lora"].items()])
        step = median_step(res)
        print(f"parallel: train_tp rank {r}'s LoRA leaves after the step against one rank's: max "
              f"|diff| {float(diffs.max()):.3e}, mean {float(diffs.mean()):.3e} (lr {lr:g}; tol "
              f"max 2 lr, mean 0.05 lr); median |step| {step:.4f} lr, one rank's {one_step:.4f} "
              f"lr (tol 0.9-1.1 lr)")
        if not (float(diffs.max()) <= 2 * lr and float(diffs.mean()) <= 0.05 * lr
                and 0.9 <= step <= 1.1 and 0.9 <= one_step <= 1.1):
            _fail("parallel: train_video --tp 2's LoRA step disagrees with one rank's")
        check_train_launches(res["launches"], f"train_tp rank {r}", 2 * PAR_LAYERS, PAR_LAYERS)
    recon = ranks("recon_dp")
    ref = one["recon"]
    for r, res in enumerate(recon):
        rel = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
        dnn = (res["nn"] - ref["nn"])[ref["alive"]].abs()
        print(f"parallel: recon_dp rank {r}: loss {res['loss']:.6f} against one rank's "
              f"{ref['loss']:.6f} ({rel:.2e}), terms {res['aux']} / {ref['aux']}; nn max|diff| "
              f"{float(dnn.max()):.3e}, mean {float(dnn.mean()):.3e} (lr 1e-4); launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }")
        if not (rel <= 1e-4 and float(dnn.max()) <= 2e-4 and float(dnn.mean()) <= 5e-6):
            _fail("parallel: the phase-C iteration at pipe.dp 2 disagrees with one rank's")
        if res["launches"]["composite_bwd"] != 3:
            _fail(f"parallel: recon_dp rank {r} rendered {res['launches']['composite_bwd']} "
                  f"cameras, expected 3 of the 6 padded slots")
    cp_err = _par_cp_check(dev, root)
    entries = _par_kernel_entries(
        train[0]["launches"]["attention_fwd_wgmma"]
        + ranks("sample_tp")[0]["launches"]["attention_fwd_wgmma"],
        train[0]["launches"]["attention_bwd_wgmma"])
    print(f"parallel: rank vs one-rank errors (max|diff| / max|ref|) sample_tp "
          f"{worst['sample_tp']:.2e}, sample_dp {worst['sample_dp']:.2e}, cp {cp_err:.2e}; the "
          f"ranks {t_ranks:.1f} s; the phase {time.perf_counter() - t0:.1f} s")
    return entries


def parallel_only():
    """``python3 chip_smoke.py parallel``: builds the kernels, makes a
    reconstruction (phases A -> B -> C at the smoke config, cut to 5 and 3
    fit iterations), then ``run_parallel``."""
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.pipelines import train_physical_particle as tp

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_build.build(["rasterizer", "pbf", "splat", "attention", "attention_bwd"])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="fnx_parallel_") as tmp:
        cfg = phase_c_config()
        cfg.optim.iterations_per_time_first = 5
        cfg.optim.iterations_per_time_current = cfg.optim.iterations_per_time_current_max = 3
        scene = smoke_scene()
        bg = synthetic_background(32768, dev)
        render_ground_truth(cfg, scene, bg, dev)
        cfg.model.model_path = os.path.join(tmp, "recon")
        tp.train(cfg, scene, bg=bg, log=lambda *a: None, device="cuda")
        print(json.dumps({"kernels": run_parallel(dev, os.path.join(tmp, "parallel"),
                                                  cfg.model.model_path)}))



# ------------------------------ ScalarFlow -----------------------------------

SCALAR_HW = (1062, 600)       # a ScalarFlow camera frame, H x W (Eckert et al. 2019)
SCALAR_STACKS = 6             # raw stacks: frame 0 smoke-free, frames 1-5 the plume
SCALAR_FRAMES = 3             # duration of stages 2 and 4: frames 20-22 (cut from 120 / 141)
SCALAR_FIRST_ITERS = 10       # iterations_per_time_first, cut from the default 1000
SCALAR_ITERS = 5              # iterations_per_time_current and _max, cut from 250
SCALAR_FUTURE = 3             # future_pred_frames, cut from 60
SCALAR_RISE = 0.01            # the plume moves up this much a frame
SCALAR_NOISE = 0.02           # the raw frames' noise, of the [0, 1] range (~5 levels)
SCALAR_EDGE_SHAPES = ((16, 12), (7, 5), (1, 1))   # the reflected border wraps again
NLMEANS_TIMED = 4             # timed launches a camera frame (20 over the 5)
NLMEANS_PLAIN_TIMED = 3
# int32 operations an offset and pixel of the least work, the sliding-sum
# form: a column sum's new squared difference and its update (sub, mul, add,
# sub of the row that leaves), the window's (add, sub), the two weighted sums
NLMEANS_OPS = 8
H100_INT32_OPS = 132 * 64 * 1.98e9   # 64 INT32 lanes an SM x 132 SMs x the 1.98 GHz boost
# (Hopper white paper: 16 INT32 units in each of an SM's four partitions)

_CV2_SCRIPT = """
import json, sys, time
import numpy as np
try:
    import cv2
except ImportError as e:
    print(json.dumps({"cv2": None, "why": str(e)}))
    sys.exit(0)
frames = np.load(sys.argv[1])
outs, times = [], []
for rep in range(2):
    for f in frames:
        t0 = time.perf_counter()
        o = cv2.fastNlMeansDenoising(f, None, 3, 7, 21)
        times.append(time.perf_counter() - t0)
        if rep == 0:
            outs.append(o)
np.save(sys.argv[2], np.stack(outs))
print(json.dumps({"cv2": cv2.__version__, "threads": cv2.getNumThreads(),
                  "ms": [t * 1e3 for t in times]}))
"""


def scalar_stacks(sim, cams, dev):
    """ScalarFlow's raw capture as ``scalar_flow_preprocess`` reads it:
    SCALAR_STACKS files ``cam/imgsUnproc_{t:06d}.npz`` holding "data", a (5,
    H, W) float32 stack in [0, 1] with the cameras in SCALARFLOW_CAMERA_IDS
    order, each frame upside down. A camera's frame is a seeded smooth static
    background with noise; frames 1 on add the port's gray render (no
    background splats, C = 1) of configs/scalar_dynamics.json's seeded
    visual column through that camera, moved up SCALAR_RISE a frame.
    Returns the seconds it took."""
    import time

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.data.dataset_builders import SCALARFLOW_CAMERA_IDS
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.sim.state import make_visual_state
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs, create_visual_points
    from fluidnexus_torch.splat.render import render_particles_with_background

    t0 = time.perf_counter()
    cfg = load_config("configs/scalar_dynamics.json")
    m, rc = cfg.model, raster_config_from(cfg)
    pts = create_visual_points(m, np.random.default_rng(SEED + 2))
    attrs = constant_visual_attrs(m.visual_capacity, 1, device=dev)
    by_name = {c.image_name[-1]: c for c in cams}
    rng = np.random.default_rng(SEED + 3)
    h, w = SCALAR_HW
    y, x = np.mgrid[:h, :w].astype(np.float32) / max(h, w)
    backgrounds = {}
    for cam_id in SCALARFLOW_CAMERA_IDS:
        ph = rng.uniform(0, 2 * np.pi, 3)
        backgrounds[cam_id] = (0.10 + 0.04 * np.sin(7 * x + ph[0]) * np.cos(5 * y + ph[1])
                               + 0.03 * np.sin(13 * (x + y) + ph[2]) + 0.05 * y)
    os.makedirs(os.path.join(sim, "cam"))
    for t in range(SCALAR_STACKS):
        stack = np.empty((5, h, w), np.float32)
        moved = pts + np.array([0.0, 0.02 + SCALAR_RISE * t, 0.0], np.float32)
        vis = make_visual_state(m.visual_capacity, moved, device=dev)
        for idx, cam_id in enumerate(SCALARFLOW_CAMERA_IDS):
            img = backgrounds[cam_id] + rng.normal(0, SCALAR_NOISE, (h, w))
            if t > 0:
                cam = by_name[str(cam_id)]
                with torch.no_grad():
                    out = render_particles_with_background(
                        vis.xyz, vis.alive, attrs, None,
                        view_matrix=torch.as_tensor(cam.world_view, device=dev),
                        proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=w, height=h,
                        bg_color=torch.zeros(1, device=dev), config=rc)
                img = img + out.color.mean(0).clamp(0, 1).cpu().numpy()
            stack[idx] = np.flipud(np.clip(img, 0, 1))
        np.savez(os.path.join(sim, "cam", f"imgsUnproc_{t:06d}.npz"), data=stack)
    return time.perf_counter() - t0


def nlmeans_cases(sim, dev):
    """The kernel's inputs held against the plain version, uint8 on the
    card: stack 1's five camera frames cast as the preprocess casts them,
    uniform noise and 0 / 255 halves at SCALAR_HW (the table's far end), and
    noise at SCALAR_EDGE_SHAPES. Returns (name, image) pairs, the cameras
    first."""
    from fluidnexus_torch.data.dataset_builders import SCALARFLOW_CAMERA_IDS

    with np.load(os.path.join(sim, "cam", "imgsUnproc_000001.npz")) as npz:
        stack = torch.as_tensor(npz["data"], device=dev)
    cases = [(f"camera {c}, frame 1", torch.flip(torch.clamp(stack[i] * 255, 0, 255)
                                                 .to(torch.uint8), (0,)))
             for i, c in enumerate(SCALARFLOW_CAMERA_IDS)]
    rng = np.random.default_rng(SEED + 4)
    h, w = SCALAR_HW
    halves = np.zeros((h, w), np.uint8)
    halves[:, w // 2:] = 255
    cases += [("uniform noise", rng.integers(0, 256, (h, w), dtype=np.uint8)),
              ("0 / 255 halves", halves)]
    cases += [(f"noise {eh}x{ew}", rng.integers(0, 256, (eh, ew), dtype=np.uint8))
              for eh, ew in SCALAR_EDGE_SHAPES]
    return [(n, torch.as_tensor(img, device=dev).contiguous()) for n, img in cases]


def check_nlmeans(cases):
    """Each case through the kernel and ``denoise_plain`` on the card: fails
    on any differing pixel. Returns the kernel's outputs and the largest
    |difference| (0)."""
    from fluidnexus_torch.ops import nlmeans_cuda as nc
    from fluidnexus_torch.utils.nlmeans import denoise_plain

    outs, worst = [], 0
    for name, img in cases:
        got = nc.nlmeans_cuda(img)
        ref = denoise_plain(img)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        err = int((got.int() - ref.int()).abs().max())
        print(f"nlmeans {name} ({img.shape[0]}x{img.shape[1]}): {diff} pixels differ from "
              f"denoise_plain (max |diff| {err})")
        if diff:
            _fail(f"the nlmeans kernel differs from denoise_plain on {name}")
        outs.append(got)
        worst = max(worst, err)
    return outs, worst


def time_nlmeans(frames):
    """ms a frame of the kernel (CUDA events around each launch, median over
    NLMEANS_TIMED launches a frame) and of ``denoise_plain`` on the card
    (median of NLMEANS_PLAIN_TIMED, the first frame)."""
    from fluidnexus_torch.ops import nlmeans_cuda as nc
    from fluidnexus_torch.utils.nlmeans import denoise_plain

    def event_ms(fn, img, n):
        times = []
        for _ in range(n):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(img)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return times

    for img in frames:
        nc.nlmeans_cuda(img)
    kernel = [t for img in frames for t in event_ms(nc.nlmeans_cuda, img, NLMEANS_TIMED)]
    plain = event_ms(denoise_plain, frames[0], NLMEANS_PLAIN_TIMED)
    return statistics.median(kernel), kernel, statistics.median(plain)


def opencv_beside(frames, outs, tmp):
    """OpenCV's fastNlMeansDenoising(., None, 3, 7, 21) on the same frames in a
    subprocess (this process loads no cv2), where the machine has it: its
    host ms a frame and how many pixels differ from the kernel. Printed, not
    checked."""
    src, dst = os.path.join(tmp, "cv2_in.npy"), os.path.join(tmp, "cv2_out.npy")
    np.save(src, np.stack([f.cpu().numpy() for f in frames]))
    res = subprocess.run([sys.executable, "-c", _CV2_SCRIPT, src, dst], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        print(f"nlmeans: the OpenCV subprocess exited {res.returncode}: {res.stderr[-2000:]}")
        return None
    info = json.loads(res.stdout.strip().splitlines()[-1])
    if info["cv2"] is None:
        print(f"nlmeans: no OpenCV on this machine ({info['why']})")
        return None
    ref = np.load(dst)
    diff = int(sum(int((o.cpu().numpy() != r).sum()) for o, r in zip(outs, ref)))
    ms = statistics.median(info["ms"])
    print(f"nlmeans: OpenCV {info['cv2']} ({info['threads']} threads) on the host: {ms:.3f} ms a "
          f"frame (median of {len(info['ms'])}: {', '.join(f'{t:.1f}' for t in info['ms'])}); "
          f"{diff} of {len(outs) * outs[0].numel()} pixels differ from the kernel")
    return ms


def check_preprocess_outputs(sim, dev):
    """The preprocess's PNGs of the last stack, by the port's own means: each
    camera's raw frame is the npz cast and flipped, its denoise is
    ``denoise_plain`` of that, and its no_bg is ``separate_background`` of
    the denoise against frame 0's."""
    from fluidnexus_torch.data.dataset_builders import SCALARFLOW_CAMERA_IDS, separate_background
    from fluidnexus_torch.utils.nlmeans import denoise_plain
    from fluidnexus_torch.utils.png import read_png

    t = SCALAR_STACKS - 1
    with np.load(os.path.join(sim, "cam", f"imgsUnproc_{t:06d}.npz")) as npz:
        stack = npz["data"]

    def png(tree, k):
        return read_png(os.path.join(sim, tree, f"imgs_{k:06d}.png"))[..., 0]

    for idx, cam in enumerate(SCALARFLOW_CAMERA_IDS):
        raw = png(f"cam{cam}_raw", t)
        want_raw = np.flip(np.clip(stack[idx] * 255, 0, 255).astype(np.uint8), axis=0)
        den = denoise_plain(torch.as_tensor(raw, device=dev)).cpu().numpy()
        no_bg = separate_background(torch.as_tensor(den), torch.as_tensor(png(f"cam{cam}_denoise",
                                                                               0))).numpy()
        for what, a, b in (("raw", raw, want_raw), ("denoise", png(f"cam{cam}_denoise", t), den),
                           ("no_bg", png(f"cam{cam}_no_bg", t), no_bg)):
            if not np.array_equal(a, b):
                _fail(f"scalar_flow_preprocess: cam{cam}_{what} of frame {t} is not what the "
                      f"plain path gives ({int((a != b).sum())} pixels)")
    shares = [float((png(f"cam{cam}_no_bg", t) > 0).mean()) for cam in SCALARFLOW_CAMERA_IDS]
    print(f"scalar_flow_preprocess: frame {t}'s raw, denoise and no_bg PNGs of every camera equal "
          f"the plain path's; the plume (no_bg > 0) covers "
          f"{', '.join(f'{100 * v:.2f}' for v in shares)} % of cameras "
          f"{', '.join(map(str, SCALARFLOW_CAMERA_IDS))}")


def write_scalar_capture(cap, sim, n_stacks):
    """The ScalarReal layout ``read_scene(loader scalar_real)`` reads, from
    the preprocess's ``cam{j}_no_bg`` frames (stacks 1 on, as frames
    start_time on): ``colmap_frames/colmap_{t}/train0{j}.png`` and, for the
    config's fake views, the refined-view folders' ``frame_{k:06d}.png``.
    Returns the count of files written."""
    import shutil

    from fluidnexus_torch.core.config import load_config
    from fluidnexus_torch.data.readers import fake_view_folder

    m = load_config("configs/scalar_dynamics.json").model
    n = 0
    for k in range(n_stacks - 1):
        for cam in "01234":
            src = os.path.join(sim, f"cam{cam}_no_bg", f"imgs_{k + 1:06d}.png")
            dsts = [os.path.join(cap, "colmap_frames", f"colmap_{m.start_time + k}",
                                 f"train0{cam}.png")]
            if cam in m.train_views_fake:
                dsts.append(os.path.join(cap, fake_view_folder("scalar", m.train_views[:1], cam,
                                                               m.refined_strength),
                                         f"frame_{k:06d}.png"))
            for dst in dsts:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(src, dst)
                n += 1
    return n


def _rasterizer_channels(tc, seen):
    """Wrap the rasterizer's two kernel wrappers to count their launches by
    colour channels C; returns a function that puts them back."""
    real = tc.composite_fwd, tc.composite_bwd

    def fwd(packed, *a, **kw):
        seen[("composite_fwd", packed.shape[2] - 7)] += 1
        return real[0](packed, *a, **kw)

    def bwd(packed, *a, **kw):
        seen[("composite_bwd", packed.shape[2] - 7)] += 1
        return real[1](packed, *a, **kw)

    tc.composite_fwd, tc.composite_bwd = fwd, bwd

    def restore():
        tc.composite_fwd, tc.composite_bwd = real
    return restore


def scalar_raster_check(res, cam, cfg, dev):
    """The rasterizer's three kernels against their plain versions
    (``check_kernels``, its limits) at this path's own tiles: the last
    frame's fitted visual particles of stage 2 (``gm_fluid``: no background,
    C = 1) through ``cam`` at the configuration's tile settings."""
    from fluidnexus_torch.ops.rasterizer import tile_packed
    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.splat.render import compose_splats

    rc = raster_config_from(cfg)
    vis, params = res["visual"], res["params"]
    with torch.no_grad():
        splats = compose_splats(vis.xyz / params.scale_factor, vis.alive, res["attrs"], None)
        tl = tile_packed(*splats, view_matrix=torch.as_tensor(cam.world_view, device=dev),
                         proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                         tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                         height=cam.height, config=rc)
    packed_t = tl.packed.contiguous()
    print(f"scalar stage 2 camera {cam.image_name} tiles ({cam.width} x {cam.height}, the last "
          f"frame's {int(vis.alive.sum())} visual particles, no background): T "
          f"{packed_t.shape[0]} K {packed_t.shape[1]} F {packed_t.shape[2]} live slots "
          f"{int(tl.counts.sum())} max count {int(tl.counts.max())}; tiles {rc.tile_x}x{rc.tile_y} "
          f"dup {rc.dup_x}x{rc.dup_y}")
    print(count_distribution(tl.counts, rc.tile_capacity))
    if packed_t.shape[2] != 8 or not int(tl.counts.sum()):
        _fail(f"scalar stage 2's tiles are {tuple(packed_t.shape)} with "
              f"{int(tl.counts.sum())} live slots: expected C = 1 and some splat drawn")
    check_kernels(packed_t, tl.gauss, tl.counts, tl.tiles_x, splats[0].shape[0], rc)


def run_scalar(dev, root):
    """The ScalarFlow capture on the card: raw stacks (``scalar_stacks``)
    through ``dataset_builders scalar_flow_preprocess``'s CLI (the main path
    of the nlmeans kernel: 5 launches a stack, 1 a camera), the kernel held
    bit for bit against ``denoise_plain`` and timed, OpenCV beside it where
    the machine has it, then the ScalarReal capture written from the no_bg
    frames and the reconstruction (``train_physical_particle --loader
    scalar_real --config configs/scalar_dynamics.json``, phases A -> B -> C
    over frames 20-22) and the future (``future_simulation --config
    configs/scalar_future_simulation.json``, SCALAR_FUTURE frames) through
    their CLIs: ``gm_fluid``, no background, gray images, emit ratios 1.61,
    alpha -3, buoyancy_max_y 0.8. Checks the launches exactly (every
    rasterizer launch at C = 1), the rasterizer kernels against their plain
    versions at this path's tiles (``scalar_raster_check``), that no PLY was read and that no jax, JAX
    package, PIL or cv2 is loaded. Returns the nlmeans entry of the
    ``kernels`` line."""
    import collections
    import time

    from fluidnexus_torch.core.config import parse_cli
    from fluidnexus_torch.data import dataset_builders as db
    from fluidnexus_torch.data.scene import cameras_by_time
    from fluidnexus_torch.ops import rasterizer_cuda as tc
    from fluidnexus_torch.pipelines import future_simulation as tf
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.splat.dynamics import BackgroundSplats

    t_phase = time.perf_counter()
    h, w = SCALAR_HW
    sim, cap = os.path.join(root, "sim", "input"), os.path.join(root, "capture")
    recon, future = os.path.join(root, "recon"), os.path.join(root, "future")
    os.makedirs(cap, exist_ok=True)
    cams = capture_cameras(cap, 1, width=w, height=h, dataset_style="scalar", start_time=20)
    secs = scalar_stacks(sim, cams, dev)
    print(f"scalar: wrote {SCALAR_STACKS} raw stacks of 5 x {h} x {w} float32 (frame 0 "
          f"smoke-free, noise {SCALAR_NOISE}) in {secs:.2f} s")

    # ---- the main path of the kernel: the preprocess CLI
    host = {"s": 0.0, "n": 0, "bytes": 0}
    real_imwrite = db.imwrite

    def timed_imwrite(path, arr):
        t0 = time.perf_counter()
        real_imwrite(path, arr)
        host["s"] += time.perf_counter() - t0
        host["n"] += 1
        host["bytes"] += os.path.getsize(path)

    db.imwrite = timed_imwrite
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        n = db.main(["scalar_flow_preprocess", "--sim_input_path", sim])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        db.imwrite = real_imwrite
    launches = all_launches()
    want = {"nlmeans": 5 * SCALAR_STACKS}
    print(f"scalar_flow_preprocess: {n} frames x 5 cameras in {wall:.3f} s; {host['n']} PNGs, "
          f"{host['bytes']} bytes; the PNG encodes and writes {host['s']:.3f} s "
          f"({100 * host['s'] / wall:.1f} % of the CLI, on the host); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if n != SCALAR_STACKS or host["n"] != 5 * (2 * SCALAR_STACKS + 3 * (SCALAR_STACKS - 1)):
        _fail(f"scalar_flow_preprocess processed {n} frames and wrote {host['n']} PNGs")
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        _fail(f"scalar_flow_preprocess launched {launches}, expected {want} and no other kernel")
    check_preprocess_outputs(sim, dev)

    # ---- the kernel against the plain version, its time and bound, OpenCV
    cases = nlmeans_cases(sim, dev)
    outs, err = check_nlmeans(cases)
    frames = [img for _, img in cases[:5]]
    ms, all_ms, plain_ms = time_nlmeans(frames)
    b = bound_ms(2 * h * w, NLMEANS_OPS * 21 * 21 * h * w, peak=H100_INT32_OPS)
    print(f"nlmeans kernel at {h} x {w}: {ms:.4f} ms a frame (median of {len(all_ms)}: "
          f"{min(all_ms):.4f}-{max(all_ms):.4f}), 5 launches a stack; bound {b[0]:.4f} ms by "
          f"{b[1]} ({NLMEANS_OPS} int32 operations an offset and pixel at "
          f"{H100_INT32_OPS / 1e12:.2f} T/s; {2 * h * w} bytes at 3.35 TB/s); the direct form "
          f"does 49 x 2 an offset and pixel; denoise_plain on the card {plain_ms:.3f} ms")
    cv_ms = opencv_beside(frames, outs[:5], root)

    # ---- stages 2 and 4 on the ScalarReal capture
    n_files = write_scalar_capture(cap, sim, SCALAR_STACKS)
    print(f"scalar: the ScalarReal capture holds {n_files} frames from the no_bg trees (frames "
          f"20-{20 + SCALAR_STACKS - 2}, the fake views 0134 too)")
    plys, channels = [], collections.Counter()
    real_ply = BackgroundSplats.from_ply.__func__

    def from_ply(cls, *a, **kw):
        plys.append(a)
        return real_ply(cls, *a, **kw)

    fits, ticks, scenes = [], [], []
    real = dict(fit=tp.fit_frame, tick2=tp.solver_tick, tick4=tf.solver_tick, read=tp.read_scene)

    def events_around(fn, log, n_of=None):
        def run(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            log.append((s, e, n_of(a) if n_of else 1))
            return out
        return run

    def read(cfg, *a, **kw):
        scenes.append(real["read"](cfg, *a, **kw))
        return scenes[-1]

    print("scalar stage 2 config (configs/scalar_dynamics.json, cut):")
    cut = dict(duration=SCALAR_FRAMES)
    cfg2 = derived_config("configs/scalar_dynamics.json", os.path.join(root, "scalar2.json"),
                          dict(cut, iterations_per_time_first=SCALAR_FIRST_ITERS,
                               iterations_per_time_current=SCALAR_ITERS,
                               iterations_per_time_current_max=SCALAR_ITERS))
    BackgroundSplats.from_ply = classmethod(from_ply)
    restore = _rasterizer_channels(tc, channels)
    tp.fit_frame = events_around(real["fit"], fits, n_of=lambda a: a[7])
    tp.solver_tick = events_around(real["tick2"], ticks, n_of=lambda a: a[2])
    tp.read_scene = read
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        res = tp.main(["--config", cfg2, "--data_path", cap, "--model_path", recon, "--loader",
                       "scalar_real", "--seed", str(SEED)], device="cuda")
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        tp.fit_frame, tp.solver_tick, tp.read_scene = real["fit"], real["tick2"], real["read"]
        BackgroundSplats.from_ply = classmethod(real_ply)
        restore()
    launches2, seen2 = all_launches(), dict(channels)
    cfg_s = scenes[-1]
    o = parse_cli(["--config", cfg2]).optim
    metrics = res["metrics"]
    for mm in metrics:
        print(f"scalar stage 2 frame {mm['frame']}: loss {mm['loss']:.6f} hidden {mm['hidden']} "
              f"visual {mm['visual']} held-out l1 {mm.get('l1', float('nan')):.4f} psnr "
              f"{mm.get('psnr', float('nan')):.3f}; the splat's query list dropped "
              f"{mm['query_drops']} visual particles")
    if [mm["frame"] for mm in metrics] != list(range(1, SCALAR_FRAMES)) or not all(
            np.isfinite(mm["loss"]) for mm in metrics):
        _fail("scalar stage 2 did not give a finite loss for each frame")
    train_by_t = cameras_by_time(cfg_s.train_cameras)
    test_by_t = cameras_by_time(cfg_s.test_cameras)
    if not all(c.image.ndim == 2 for c in cfg_s.train_cameras) or not any(
            c.is_fake_view for c in cfg_s.train_cameras):
        _fail("scalar stage 2 did not read gray frames and fake views")
    fit_iters = (SCALAR_FRAMES - 1) * SCALAR_ITERS
    evals = sum(len(test_by_t.get(t, [])) for t in range(1, SCALAR_FRAMES))
    steps = o.batch * (SCALAR_FIRST_ITERS + fit_iters)
    tick_iters = sum(k for _, _, k in ticks)
    want = {"composite_fwd": steps + evals, "composite_bwd": steps, "combine_rows": steps,
            "density_fwd": 2 * fit_iters, "density_bwd": 2 * fit_iters,
            "splat_fwd": fit_iters + SCALAR_FRAMES - 1, "splat_bwd": fit_iters,
            "pbf_phase1": tick_iters, "pbf_phase2": tick_iters}
    print(f"scalar stage 2: main in {wall2:.2f} s; {len(train_by_t[0])} training cameras a frame "
          f"({sum(c.is_fake_view for c in train_by_t[0])} fake views), {evals} test renders; "
          f"launches {launches2}; rasterizer launches by C {seen2}")
    if any(launches2[k] != v for k, v in want.items()) or any(
            v for k, v in launches2.items() if k not in want):
        _fail(f"scalar stage 2 launched {launches2}, expected {want} and no other kernel")
    if set(c for _, c in seen2) != {1} or sum(v for (k, _), v in seen2.items()
                                              if k == "composite_fwd") != want["composite_fwd"]:
        _fail(f"scalar stage 2's rasterizer launches by C are {seen2}: expected every one at C = 1")
    scalar_raster_check(res, train_by_t[SCALAR_FRAMES - 1][0], parse_cli(["--config", cfg2]), dev)
    from fluidnexus_torch.ops.neighbors import build_dense_grid

    st, pr = res["state"], res["params"]
    splat_list_check(f"scalar stage 2 frame {20 + SCALAR_FRAMES - 1}", build_dense_grid(
        st.estimate_xyz, pr.h, st.alive, pr.dense_max_cells, pr.dense_cell_capacity),
        st.velocity, res["visual"].xyz, res["visual"].alive, pr)
    fit_ms = [s.elapsed_time(e) / k for s, e, k in fits]
    tick_ms = [s.elapsed_time(e) for s, e, _ in ticks]
    print(f"scalar stage 2: ms a fit iteration a frame {', '.join(f'{v:.3f}' for v in fit_ms)} "
          f"({SCALAR_ITERS} iterations, 1 camera at {w} x {h}); ms a tick (phase B's "
          f"{len(ticks) - (SCALAR_FRAMES - 1)} stable ticks, then the frames') median "
          f"{statistics.median(tick_ms):.3f} ({min(tick_ms):.3f}-{max(tick_ms):.3f}, "
          f"{o.solver_iterations} Jacobi iterations each)")

    print("scalar stage 4 config (configs/scalar_future_simulation.json, cut):")
    cfg4 = derived_config("configs/scalar_future_simulation.json",
                          os.path.join(root, "scalar4.json"),
                          dict(cut, future_pred_frames=SCALAR_FUTURE))
    argv4 = ["--config", cfg4, "--data_path", cap, "--load_path", recon, "--loader",
             "scalar_real", "--seed", str(SEED)]
    ticks4 = []
    read_s = {}

    def timed_read(stage, real_read):
        def rd(cfg, *a, **kw):
            t0 = time.perf_counter()
            out = real_read(cfg, *a, **kw)
            read_s[stage] = time.perf_counter() - t0
            return out
        return rd

    tf.solver_tick = events_around(real["tick4"], ticks4)
    BackgroundSplats.from_ply = classmethod(from_ply)
    restore = _rasterizer_channels(tc, channels)
    channels.clear()
    try:
        y = run_stage4(argv4, future, timed_read, "scalar 4", n_frames=SCALAR_FUTURE)
        torch.cuda.synchronize()
    finally:
        tf.solver_tick = real["tick4"]
        BackgroundSplats.from_ply = classmethod(real_ply)
        restore()
    seen4 = dict(channels)
    ms4 = [s.elapsed_time(e) for s, e, _ in ticks4]
    print(f"scalar stage 4: the first future frame's visual y (min, median, max) "
          f"{', '.join(f'{v:.6f}' for v in y)}; ms a future tick {', '.join(f'{v:.3f}' for v in ms4)} "
          f"({parse_cli(argv4).optim.solver_iterations_future} Jacobi iterations each); rasterizer "
          f"launches by C {seen4}; read {read_s.get('scalar 4', 0.0):.3f} s")
    if set(c for _, c in seen4) != {1}:
        _fail(f"scalar stage 4's rasterizer launches by C are {seen4}: expected C = 1")
    if plys:
        _fail(f"the ScalarReal stages read background PLYs {plys}")
    print("scalar: no background PLY was read (gm_fluid renders its particles alone)")
    if PROFILES:
        cfg4p = derived_config("configs/scalar_future_simulation.json",
                               os.path.join(root, "scalar4p.json"),
                               dict(cut, future_pred_frames=1))
        argv4p = ["--config", cfg4p, "--data_path", cap, "--load_path", recon, "--loader",
                  "scalar_real", "--seed", str(SEED), "--model_path",
                  os.path.join(root, "future_profile")]

        def one_future_frame():
            tf.main(argv4p, device="cuda")

        one_future_frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_future_frame()
        torch.cuda.synchronize()
        profile_run("scalar stage-4 run of 1 future frame (read, set-up and save included)",
                    one_future_frame, 1, (time.perf_counter() - t0) * 1e3)
    imported = [m for m in ("jax", "fluidnexus_tpu", "PIL", "cv2") if m in sys.modules] + [
        m for m in sys.modules if m.startswith(("fluidnexus_tpu.", "jax.", "PIL.", "cv2."))]
    if imported:
        _fail(f"the scalar phase imported {imported}")
    cv_text = "not measured" if cv_ms is None else f"{cv_ms:.3f}"
    print(f"scalar: no jax, fluidnexus_tpu, PIL or cv2 in the process; the phase "
          f"{time.perf_counter() - t_phase:.1f} s (OpenCV's host ms a frame: {cv_text})")
    return [dict(name="nlmeans", route="cuda", source="fluidnexus_torch/csrc/nlmeans.cu",
                 replaces="fluidnexus_tpu/data/dataset_builders.py:52", launches=launches["nlmeans"],
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                 library_ms=None)]


def scalar_only():
    """``python3 chip_smoke.py scalar``: builds the rasterizer, pair and
    nlmeans kernels and runs ``run_scalar``."""
    from fluidnexus_torch.ops import cuda_build

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, info in cuda_build.build(["rasterizer", "pbf", "splat", "nlmeans"]).items():
        print(f"build {name}: {info['seconds']:.1f} s")
        if name == "nlmeans":
            print(info["log"].strip())
    with tempfile.TemporaryDirectory(prefix="fnx_scalar_") as tmp:
        print(json.dumps({"kernels": run_scalar(torch.device("cuda"), tmp)}))


# ------------- the reference-scale run, the camera paths and the examples -------------

FULL_SCALE_CUT = ["--frames", "2", "--iters", "30", "--first_iters", "30"]   # of 120, 1 000, 1 000
FULL_SCALE_FRAMES = 10        # ``full-scale``'s default: of the reference's 120
FULL_SCALE_OUT = "runs/full_scale_torch"
ORBIT_FRAMES = 12             # render_orbit's --frames, cut from its 60
ORBIT_SPLATS = 32768
DEMO_FIT_STEPS = 201
SPLAT_PILE = 1100             # queries piled in one cell of h by ``pile_queries``
SPLAT_SPREAD = 600            # and spread over the three cells past it


def splat_args_at(grid, vel, points, alive, params):
    """The two splat kernels' arguments as ``sim/pbf._splat_delta`` makes
    them, the queries ``points`` as a ``sort_queries`` list over the source
    ``grid``; the adjoint's p and q from a seeded cotangent (the pairs, not
    the values, set its time). Returns (the query list, forward args,
    adjoint args)."""
    from fluidnexus_torch.ops.neighbors import slot_gather, sort_queries
    from fluidnexus_torch.sim import pbf_cuda as pc

    ql = sort_queries(grid, params.h, points, alive, params.dense_max_cells)
    planes = pc.planes(grid)
    vel_s = slot_gather(grid, vel).contiguous()
    gen = torch.Generator(device=points.device).manual_seed(SEED)
    pq = (torch.randn((points.shape[0], 4), generator=gen, device=points.device)
          * alive[:, None])[ql.order]
    lst = (ql.start, ql.cnt, ql.x, ql.y, ql.z)
    return (ql, (ql.nbr, *lst, *planes, vel_s, params.h),
            (ql.rnbr, *planes, vel_s, *lst, pq[:, :3].contiguous(), pq[:, 3].contiguous(),
             params.h))


def pile_queries(state, visual, params, n_pile=SPLAT_PILE, n_spread=SPLAT_SPREAD):
    """``visual``'s live points and two seeded piles inside the hidden cloud
    of ``state`` (its estimates): ``n_pile`` queries in one cell of h, the
    cell of the live hidden particle nearest their mean, and ``n_spread``
    over the three cells past it along x. Returns (points, alive)."""
    est = state.estimate_xyz[state.alive]
    h = params.h
    near = est[torch.argmin(((est - est.mean(0)) ** 2).sum(1))]
    cell = torch.floor(near / h)
    gen = torch.Generator(device=est.device).manual_seed(SEED + 1)
    u = lambda n: torch.rand((n, 3), generator=gen, device=est.device)  # noqa: E731
    pile = (cell + 0.1 + 0.8 * u(n_pile)) * h
    spread = cell + 0.1 + 0.8 * u(n_spread)
    spread[:, 0] = cell[0] + 1.0 + 2.9 * u(n_spread)[:, 0]
    pts = torch.cat([visual.xyz[visual.alive], pile, spread * h])
    return pts, torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)


def splat_list_check(what, grid, vel, points, alive, params):
    """Rows 10 and 11 at ``what``'s inputs (the queries ``points`` over the
    source ``grid``, ``splat_args_at``): the query list's rows, fullest row
    and drops (cells past ``dense_max_cells``), the adjoint's longest query
    list; both kernels held against their plain versions in NaN-filled
    blocks (``held_in_nan_blocks``), their device times (``entry_device_ms``:
    a call's kernels, the forward's chunk scan included) and bounds. Returns
    {forward ms, adjoint ms, fullest, dropped}."""
    from fluidnexus_torch.sim import splat_cuda as sc

    ql, fwd, bwd = splat_args_at(grid, vel, points, alive, params)
    lists = ql.cnt[ql.rnbr.long()].sum(1)
    n_live = int(alive.sum())
    out = dict(fullest=int(ql.cnt.max()), dropped=int(ql.overflow))
    print(f"{what}: the query list: {int((ql.cnt > 0).sum())} occupied rows, fullest "
          f"{out['fullest']} ({-(-out['fullest'] // sc.FWD_QUERIES)} forward work items), "
          f"{int(ql.start[-1])} of {n_live} live queries listed, {out['dropped']} dropped "
          f"(cells past {params.dense_max_cells}); the adjoint's longest query list "
          f"{int(lists.max())} entries")
    failures = []
    for name, args in (("splat_fwd", fwd), ("splat_bwd", bwd)):
        failures += held_in_nan_blocks(name, args, what)[1]
    if failures:
        _fail(f"{what}: the splat kernels disagree with their plain versions: {failures}")
    (fb, fo), (bb, bo), _ = splat_work(fwd, bwd)
    for name, args, nbytes, ops in (("splat_fwd", fwd, fb, fo), ("splat_bwd", bwd, bb, bo)):
        ms, rec = entry_device_ms(lambda: phase_c_calls()[name][0](*args), name)
        b_ms, b_by = bound_ms(nbytes, ops)
        out[name] = ms
        print(f"{what}: {name} {ms:.4f} ms a call on the card ({rec}), bound {b_ms:.6f} ms "
              f"by {b_by}")
    return out


def check_launches(what, launches, want):
    """Fails unless ``launches`` are exactly ``want`` and no other kernel ran."""
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        _fail(f"{what} launched {launches}, expected {want} and no other kernel")
    print(f"{what}: launches as expected, {want}")


def run_full_scale_cut(dev, root):
    """``python -m fluidnexus_torch.tools.run_full_scale_recon`` at full width
    (960 x 544, 5 + 1 cameras, ~27 720 hidden particles, 32 x 32 tiles of
    384, dup 3 x 3) with a cut depth (FULL_SCALE_CUT: 2 frames, 30 + 30 fit
    iterations): its report, finite losses, every file under --out, exactly
    its launches, then the rasterizer's three kernels against their plain
    versions at the tool's tiles (its first fit iteration: the initial
    column at camera 0). No kernel entry."""
    import time

    from fluidnexus_torch.pipelines.train_physical_particle import raster_config_from
    from fluidnexus_torch.tools import run_full_scale_recon as fs

    out = os.path.join(root, "out")
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = fs.main(FULL_SCALE_CUT + ["--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg, o = res["config"], res["config"].optim
    metrics = res["metrics"]
    if [mm["frame"] for mm in metrics] != [1] or not all(np.isfinite(mm["loss"]) for mm in metrics):
        _fail(f"the full-scale tool's cut gave frames {metrics}")
    if not {"RUN.md", "run.log", "metrics.npy", "recon"} <= set(os.listdir(out)):
        _fail(f"the full-scale tool wrote {sorted(os.listdir(out))} under --out")
    ticks = 2 * o.stable_iterations + 2   # the truth's and the reconstruction's, and a frame's each
    fit = o.iterations_per_time_first + o.iterations_per_time_current
    check_launches(f"full-scale tool cut ({wall:.1f} s)", all_launches(), {
        "composite_fwd": 6 * 2 + fit + 1, "composite_bwd": fit, "combine_rows": fit,
        "pbf_phase1": 10 * ticks, "pbf_phase2": 10 * ticks,
        "density_fwd": 2 * o.iterations_per_time_current,
        "density_bwd": 2 * o.iterations_per_time_current,
        "splat_fwd": o.iterations_per_time_current + 1, "splat_bwd": o.iterations_per_time_current})
    rc = raster_config_from(cfg)
    packed_t, tile_gauss, counts, tiles_x, n = main_path_tiles(cfg, res["scene"], None, dev)
    print(f"full-scale tool tiles (camera 0, frame 0, the initial {cfg.model.init_visual_num_pts} "
          f"+ {cfg.model.init_thick_visual_num_pts} visual particles): T {packed_t.shape[0]} K "
          f"{packed_t.shape[1]} live slots {int(counts.sum())} max count {int(counts.max())}; "
          f"tiles {rc.tile_x}x{rc.tile_y} capacity {rc.tile_capacity} dup {rc.dup_x}x{rc.dup_y}")
    print(count_distribution(counts, rc.tile_capacity))
    check_kernels(packed_t, tile_gauss, counts, tiles_x, n, rc)
    return []


def run_orbit(dev, root):
    """``python -m fluidnexus_torch.examples.render_orbit`` on a seeded
    32 768-splat PLY, ORBIT_FRAMES frames at 960 x 544: exactly one
    composite forward a frame and no other kernel, the AVI read back, and a
    2-frame orbit at 160 x 96 card against the CPU (within one level of the
    8-bit video: 32 768 overlapping splats sum in another order on the
    card). No kernel entry."""
    import time

    from fluidnexus_torch.core.ply import save_background_ply
    from fluidnexus_torch.examples import render_orbit as ro
    from fluidnexus_torch.utils.video_io import read_video

    rng = np.random.default_rng(SEED + 25)
    n = ORBIT_SPLATS
    ply = os.path.join(root, "splat.ply")
    os.makedirs(root, exist_ok=True)
    save_background_ply(ply, rng.normal(0.0, 0.35, (n, 3)), rng.uniform(0.05, 0.95, (n, 3)),
                        rng.normal(0.0, 1.5, (n, 1)), rng.uniform(-5.0, -3.5, (n, 3)),
                        rng.normal(size=(n, 4)))
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    path = ro.main(["--ply", ply, "--out", os.path.join(root, "orbit.avi"), "--frames",
                    str(ORBIT_FRAMES)], device="cuda")
    wall = time.perf_counter() - t0
    check_launches(f"render_orbit ({ORBIT_FRAMES} frames at 960 x 544, {n} splats, {wall:.2f} s "
                   f"with the PLY read and the AVI write)", all_launches(),
                   {"composite_fwd": ORBIT_FRAMES})
    frames = read_video(path)
    if frames.shape != (ORBIT_FRAMES, 544, 960, 3) or frames.max() < 64:
        _fail(f"render_orbit wrote {frames.shape} frames, max {frames.max()}")
    print(f"render_orbit: {path}, {os.path.getsize(path)} bytes, mean level "
          f"{frames.mean():.2f}")
    card = ro.render_frames(ply, 2, 2.5, 0.3, 160, 96, device="cuda")
    cpu = ro.render_frames(ply, 2, 2.5, 0.3, 160, 96, device="cpu")
    diff = np.abs(card - cpu)
    err = float(diff.max())
    print(f"render_orbit card against CPU at 160 x 96: max|err| {err:.3e} [tol 1/255, a level "
          f"of the 8-bit video], {int((diff > 1e-4).sum())} of {diff.size} values past 1e-4")
    if not err <= 1.0 / 255.0:
        _fail(f"render_orbit's card frames part from the CPU's by {err}")
    return []


def run_demo(dev):
    """``python -m fluidnexus_torch.examples.fit_gaussians_demo`` in full: the
    201-step fit (PSNR must rise by 5 dB), the 5 ticks, exactly their
    launches; then 2 ticks card against the CPU (1e-3: chained f32 Jacobi
    iterations, as in the CPU test against JAX). No kernel entry."""
    import time

    from fluidnexus_torch.examples import fit_gaussians_demo as demo

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = demo.main(device="cuda")
    wall = time.perf_counter() - t0
    ticks = len(res["ticks"])
    check_launches(f"fit_gaussians_demo ({wall:.2f} s)", all_launches(), {
        "composite_fwd": DEMO_FIT_STEPS + 2, "composite_bwd": DEMO_FIT_STEPS,
        "combine_rows": DEMO_FIT_STEPS, "pbf_phase1": 10 * ticks, "pbf_phase2": 10 * ticks,
        "splat_fwd": ticks})
    psnrs = res["psnrs"]
    if not psnrs[-1] > psnrs[0] + 5.0 or not all(np.isfinite([r["p_ratio"] for r in res["ticks"]])):
        _fail(f"the demo's fit went {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, ticks {res['ticks']}")
    st_c, vis_c, _ = demo.rollout(dev, 2)
    st_h, vis_h, _ = demo.rollout(torch.device("cpu"), 2)
    err = max(float((st_c.xyz.cpu() - st_h.xyz).abs().max()),
              float((vis_c.xyz.cpu() - vis_h.xyz).abs().max()))
    print(f"fit_gaussians_demo: PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB; 2 ticks card against "
          f"CPU max|err| {err:.3e} scaled units [tol 1e-3]")
    if not err <= 1e-3:
        _fail(f"the demo's ticks on the card part from the CPU's by {err}")
    return []


def run_profile_raster(dev, root):
    """``python -m fluidnexus_torch.examples.profile_raster``: its step time,
    the trace it writes and its kernel table, which must hold the three
    rasterizer kernels; exactly its launches. No kernel entry."""
    from fluidnexus_torch.examples import profile_raster as pr

    torch.cuda.synchronize()
    reset_all_launches()
    ms, table = pr.main([root])
    steps = 1 + 2 * pr.STEPS   # its warm-up, the timed steps and the traced ones
    check_launches("profile_raster", all_launches(), {
        k: steps for k in ("composite_fwd", "composite_bwd", "combine_rows")})
    names = " ".join(name for _, name in table)
    missing = [k for k in ("composite_fwd_kernel", "composite_bwd_kernel", "combine_kernel")
               if k not in names]
    if missing or not os.path.exists(os.path.join(root, "trace.json")) or not np.isfinite(ms):
        _fail(f"profile_raster: {ms} ms a step, kernels missing from its table {missing}")
    return []


def full_scale_only(frames=FULL_SCALE_FRAMES):
    """``python3 chip_smoke.py full-scale [FRAMES]``: the reference-scale
    tool on the card at the reference's counts (1 000 + 1 000 fit iterations
    at 960 x 544, --hidden_delta 0.01), FRAMES frames of its 120, into
    FULL_SCALE_OUT; prints its log and its RUN.md and, at each frame's
    commit, the fullest query cell, the live queries past the 128th of their
    cell (the slots a cell the query grid had before the query list) and how
    many of those have a hidden source in reach (ws >= eps: they move now);
    fails unless every frame gave a finite loss, or if any query was dropped
    or any capacity overflow was reported."""
    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.ops.neighbors import build_dense_grid
    from fluidnexus_torch.pipelines import train_physical_particle as tp
    from fluidnexus_torch.sim import pbf as tpbf
    from fluidnexus_torch.tools import run_full_scale_recon as fs

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script runs on an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_build.build(["rasterizer", "pbf", "splat"])
    commit, seen = tp.commit_frame, []

    def reporting_commit(params, state, visual, exyz_nn):
        with torch.no_grad():
            est = exyz_nn * params.scale_factor
            grid = build_dense_grid(est, params.h, state.alive, params.dense_max_cells,
                                    params.dense_cell_capacity)
            _, ws, dropped, (_, ql, _, _) = tpbf._splat_delta(
                grid, (est - state.xyz) / params.secs, visual.xyz, visual.alive, params)
            listed = ql.pos < ql.pos.shape[0]
            rank = ql.pos - ql.start[ql.prow.clamp(max=ql.max_cells - 1).long()]
            past = listed & (rank >= 128)
            moved = past & (ws >= params.epsilon)
            row = [len(seen) + 1, int(ql.cnt.max()), int(past.sum()), int(moved.sum()),
                   int(dropped), int(visual.alive.sum())]
        seen.append(row)
        print(f"full-scale frame {row[0]} commit: fullest query cell {row[1]}; {row[2]} live "
              f"queries past the 128th of their cell, {row[3]} of them with a hidden source in "
              f"reach (ws >= eps: moved now, left still at 128 slots a cell); {row[4]} dropped "
              f"of {row[5]} live", flush=True)
        return commit(params, state, visual, exyz_nn)

    tp.commit_frame = reporting_commit
    try:
        res = fs.main(["--frames", str(frames), "--out", FULL_SCALE_OUT])
    finally:
        tp.commit_frame = commit
    metrics = res["metrics"]
    if len(metrics) != frames - 1 or not all(np.isfinite(mm["loss"]) for mm in metrics):
        _fail(f"the full-scale run completed {len(metrics)} of {frames - 1} frames")
    for mm in metrics:
        print(f"full-scale frame {mm['frame']}: loss {mm['loss']:.6f} held-out psnr "
              f"{mm.get('psnr', float('nan')):.3f} visual {mm['visual']} hidden {mm['hidden']} "
              f"query drops {mm['query_drops']}")
    print(f"full-scale frames past 128 in a cell: {sum(1 for r in seen if r[2])} of {len(seen)}; "
          f"queries past the 128th, summed over the frames {sum(r[2] for r in seen)}, with a "
          f"source in reach {sum(r[3] for r in seen)}; the last frame {seen[-1] if seen else None}")
    drops = [mm["query_drops"] for mm in metrics]
    if any(drops) or any(r[4] for r in seen) or res["overflow_lines"]:
        _fail(f"the full-scale run dropped queries ({drops}) or reported "
              f"{res['overflow_lines']} capacity overflows")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["png-time"]:
        png_time()
    elif sys.argv[1:] == ["stages"]:
        stages_only()
    elif sys.argv[1:2] == ["mutants"] and set(sys.argv[2:]) <= set(MUTANT_GROUPS):
        run_mutants(tuple(sys.argv[2:]) or tuple(MUTANT_GROUPS))
    elif sys.argv[1:] == ["encode-probe"]:
        encode_probe()
    elif sys.argv[1:] == ["refine"]:
        refine_only()
    elif sys.argv[1:] == ["novel-view"]:
        novel_view_only()
    elif sys.argv[1:] == ["text-data"]:
        text_data_only()
    elif sys.argv[1:] == ["port-eval"]:
        port_eval_only()
    elif sys.argv[1:] == ["port-5b"]:
        port_eval_only(full_dit=True)
    elif sys.argv[1:] == ["refine-encode-probe"]:
        refine_encode_probe()
    elif sys.argv[1:] == ["attention-time"]:
        attention_time()
    elif sys.argv[1:] == ["attention-bwd"]:
        attention_bwd_time()
    elif sys.argv[1:] == ["parallel"]:
        parallel_only()
    elif sys.argv[1:] == ["scalar"]:
        scalar_only()
    elif sys.argv[1:2] == ["full-scale"] and len(sys.argv) <= 3:
        full_scale_only(*map(int, sys.argv[2:]))
    elif sys.argv[1:] == ["profiles"]:
        main(profiles=True)
    elif sys.argv[1:] == ["tick-flips"]:
        tick_flips()
    elif sys.argv[1:2] == ["raster"] and len(sys.argv) <= 3:
        raster_time(*sys.argv[2:])
    elif sys.argv[1:2] == ["pairs"] and len(sys.argv) <= 3:
        pairs_time(*sys.argv[2:])
    elif sys.argv[1:2] == ["pbf-variants"] and len(sys.argv) >= 4:
        pbf_variants(*sys.argv[2:])
    else:
        main()
