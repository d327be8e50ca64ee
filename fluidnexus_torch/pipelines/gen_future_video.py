"""Generative refinement of simulated future and wind rollouts (counterpart
of ``fluidnexus_tpu/pipelines/gen_future_video.py``).

The machinery of ``gen_refine_video`` in one window: the body frames are the
physics simulation's renders (``future_simulation`` writes
``render_frame{idx:03d}_{cam}_0000.png``), the prefix is the tail of the
reconstruction's frames, and the refined frames go into the folder that
``data/readers.future_view_folder`` names, so the reconstruction picks them
up directly.

    python -m fluidnexus_torch gen_future_video --preset future_smoke \
        --sim_render_folder future/renders --recon_frames_folder capture/train00 \
        --out_root capture --allow_fake_conditioning

Weights, text and draws as in ``gen_refine_video``. Not ported:
``--tp``/``--dp``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.data.readers import future_view_folder
from fluidnexus_torch.pipelines.gen_refine_video import (
    RefineConfig, apply_preset, load_frames, load_models, refine_window, save_frames,
)


def refine_future(engine, dit, vae, text_emb, uc_text_emb, sim_render_folder: str,
                  recon_frames_folder: str, out_root: str, camera_name: str, capture_part: str,
                  gen_future_since: int, strength: float, cfg: RefineConfig,
                  rng: torch.Generator, is_wind: bool = False, log=print):
    """One camera's future refinement; writes the frames after the prefix
    into the reader's folder under ``out_root`` and returns that folder."""
    strength_str = str(strength).replace(".", "d")  # 0.75 -> "0d75", the reader's convention
    out_folder = os.path.join(out_root, future_view_folder(
        capture_part, camera_name[-1], strength_str, gen_future_since, is_wind))

    win, pre, step = cfg.window_frames, cfg.prefix_frames, cfg.frame_step
    prefix = load_frames(recon_frames_folder, [gen_future_since - pre + i for i in range(pre)],
                         "%03d.png", cfg.height, cfg.width)
    # the simulation's renders, read every frame_step-th frame
    body = load_frames(sim_render_folder, [gen_future_since + step * i for i in range(win - pre)],
                       f"render_frame%03d_{camera_name}_0000.png", cfg.height, cfg.width)
    frames = np.concatenate([prefix, body], 0)
    out_frames = refine_window(engine, dit, vae, text_emb, uc_text_emb, frames, cfg, strength,
                               rng)[pre:]
    save_frames(out_folder, out_frames, start_index=gen_future_since)
    log(f"{camera_name}: wrote {len(out_frames)} refined future frames to {out_folder}")
    return out_folder


def build_argparser():
    ap = argparse.ArgumentParser(description="refine simulated future/wind rollouts")
    ap.add_argument("--preset", default="",
                    help="shipped configs_gen pin set (configs/gen_*.json): future_smoke | "
                         "future_ball | future_scalar | wind_smoke, or a JSON path; explicit "
                         "flags override")
    ap.add_argument("--sim_render_folder", required=True)
    ap.add_argument("--recon_frames_folder", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--camera_name", default="train00")
    ap.add_argument("--capture_part", default="smoke")
    ap.add_argument("--gen_future_since", type=int, default=90)
    ap.add_argument("--strength", type=float, default=0.75)
    ap.add_argument("--is_wind", action="store_true")
    ap.add_argument("--prompt", default="a smoke plume")
    ap.add_argument("--dit_ckpt", default="")
    ap.add_argument("--vae_ckpt", default="")
    ap.add_argument("--t5_dir", default="", help="T5-XXL weights (not ported yet: raises)")
    ap.add_argument("--window_frames", type=int, default=49)
    ap.add_argument("--prefix_frames", type=int, default=9)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--allow_fake_conditioning", action="store_true",
                    help="run with hash pseudo-embeddings (test/smoke only; implied by --tiny)")
    ap.add_argument("--pack_video", action="store_true",
                    help="also pack the refined frames into a video file")
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--frame_step", type=int, default=1,
                    help="read every Nth simulation render (sdedit_frame_step)")
    return ap


def main(argv=None, device="cuda"):
    """Returns (the folder written, the packed video's path or None)."""
    from fluidnexus_torch.pipelines.sample_video import configs

    args = apply_preset(build_argparser(), argv)
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dit_cfg, vae_cfg = configs(args.window_frames, args.height, args.width, args.tiny)
    engine, dit, vae, text_emb = load_models(args, dev, dit_cfg, vae_cfg)
    cfg = RefineConfig(window_frames=args.window_frames, prefix_frames=args.prefix_frames,
                       num_steps=args.num_steps, height=args.height, width=args.width,
                       frame_step=args.frame_step)
    out = refine_future(engine, dit, vae, text_emb, torch.zeros_like(text_emb),
                        args.sim_render_folder, args.recon_frames_folder, args.out_root,
                        args.camera_name, args.capture_part, args.gen_future_since,
                        args.strength, cfg, torch.Generator(device=dev).manual_seed(2),
                        args.is_wind)
    video = None
    if args.pack_video:
        from fluidnexus_torch.utils.video_io import frames_folder_to_video

        video = frames_folder_to_video(out, fps=args.fps)
        print("video:", video)
    return out, video


if __name__ == "__main__":
    main()
