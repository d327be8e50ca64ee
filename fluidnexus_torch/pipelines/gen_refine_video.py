"""Long-video generative refinement: chained SDEdit windows over the video
diffusion model, the CogVideoX stage (counterpart of
``fluidnexus_tpu/pipelines/gen_refine_video.py``).

It turns the Zero123 per-frame views into temporally coherent fake views,
which the reconstruction reads through ``data/readers.fake_view_folder``:
  - ``num_windows`` chained windows of ``window_frames`` frames; window k's
    first ``prefix_frames`` frames are the last frames of window k-1's
    decoded output (the capture's GT frames for window 1);
  - the rest come from the input folder, SDEdit-noised at the strength;
  - the prefix's clean latents are pasted back at every sampler step;
  - the VAE encode and decode run in chunks that carry the conv cache
    (the JAX package encodes a window whole: ``ENCODE_CHUNK``).

    python -m fluidnexus_torch gen_refine_video --preset refine_smoke \
        --input_folder zero123_out --gt_prefix_folder capture/train02 \
        --out_folder refined --allow_fake_conditioning --pack_video

The DiT and the VAE stay on the card. Without ``--dit_ckpt``/``--vae_ckpt``
(the JAX package's flat npz) the weights are drawn from seeds 0 and 1, as the
JAX CLI draws them; text goes through the hash pseudo-encoder
(``--allow_fake_conditioning``, implied by ``--tiny``), and a ``--t5_dir``
raises until the T5 encoder is ported. Every draw (each window's VAE
posterior, then its sampler noise) comes from one ``torch.Generator`` seeded
with 2, where the JAX CLI splits ``PRNGKey(2)`` into an encode and a sampler
key per window. Not ported: ``--tp``/``--dp``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import vae3d_from_numpy, video_dit_from_numpy
from fluidnexus_torch.core.checkpoint import load_params, load_params_prefer_ema
from fluidnexus_torch.data.video_dataset import read_frames
from fluidnexus_torch.diffusion.video.conditioner import make_text_encoder
from fluidnexus_torch.diffusion.video.engine import VideoEngine
from fluidnexus_torch.pipelines.train_background import save_image

# latent frames a chunk of the windows' VAE encode (cache-carried, as
# train_video's default --encode_chunk). The JAX package encodes a window
# whole; beside the resident 5B DiT on an 80 GB H100 a whole 73-frame window
# runs out of memory and a 65-frame one peaks at 56 GiB, after which cuBLAS
# could not allocate its handle (``python3 chip_smoke.py refine-encode-probe``).
# A window of at most 2 + (latents % 2) latents is one chunk: the whole window.
ENCODE_CHUNK = 2


@dataclasses.dataclass
class RefineConfig:
    window_frames: int = 49          # 4k+1 for the causal VAE
    prefix_frames: int = 9           # "prefix9"
    num_windows: int = 3
    sdedit_strength: float = 0.5
    num_steps: int = 50
    cfg_scale: float = 6.0
    height: int = 480
    width: int = 720
    # source frames are read every `frame_step`-th frame, window w's body
    # starts at window_start_indices[w] of the input folder (default: the
    # windows chain contiguously), and window 1's GT prefix starts at
    # gt_prefix_start
    frame_step: int = 1
    window_start_indices: Optional[Sequence[int]] = None
    gt_prefix_start: int = 0
    decode_chunk: int = 2


def load_frames(folder: str, indices: Sequence[int], pattern: str, height: int, width: int):
    """The frames ``folder/(pattern % i)`` as ``video_dataset.read_frames``
    gives them: (T, H, W, 3) in [-1, 1], at (height, width)."""
    return read_frames([os.path.join(folder, pattern % i) for i in indices], height, width)


def save_frames(folder: str, frames, start_index: int, pattern="frame_%06d.png"):
    """(T, H, W, 3) frames in [-1, 1] as 8-bit PNGs: the pixels of the JAX
    package's ``clip((f + 1) 127.5, 0, 255).astype(uint8)``."""
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(np.asarray(frames, np.float32)):
        arr = np.clip((f + 1) * 127.5, 0, 255).astype(np.uint8)
        # save_image multiplies by 255 and truncates: k / 255 gives back k
        save_image(os.path.join(folder, pattern % (start_index + i)),
                   arr.transpose(2, 0, 1).astype(np.float32) / 255.0)


def latent_prefix_len(prefix_frames: int) -> int:
    """frames -> causal-VAE latent frames: (n-1)/4 + 1."""
    return (prefix_frames - 1) // 4 + 1


def refine_window(engine: VideoEngine, dit, vae, text_emb, uc_text_emb, frames, cfg: RefineConfig,
                  strength: float, rng: torch.Generator):
    """One SDEdit window: encode ``frames`` ((T, H, W, 3) in [-1, 1]), sample
    from them at ``strength`` with the prefix's clean latents pasted back,
    decode. Returns the (T, H, W, 3) decoded frames as f32 numpy."""
    dev = rng.device
    z = engine.encode_first_stage(vae, torch.as_tensor(frames, dtype=torch.float32,
                                                       device=dev)[None], rng,
                                  chunk=ENCODE_CHUNK)
    z = z.permute(0, 1, 4, 2, 3)                   # (B, T, C, H, W) for the DiT
    out = engine.sample(dit, tuple(z.shape), text_emb, uc_text_emb, rng=rng,
                        num_steps=cfg.num_steps, frames_z=z, sdedit_strength=strength,
                        prefix_clean_frames=z[:, :latent_prefix_len(cfg.prefix_frames)],
                        cfg_scale=cfg.cfg_scale)
    decoded = engine.decode_first_stage(vae, out.permute(0, 1, 3, 4, 2), chunk=cfg.decode_chunk)
    return decoded[0].float().cpu().numpy()


def refine_long_video(engine: VideoEngine, dit, vae, text_emb, uc_text_emb, input_folder: str,
                      gt_prefix_folder: str, out_folder: str, cfg: RefineConfig,
                      rng: torch.Generator, input_pattern: str = "frame_%06d.png",
                      gt_pattern: str = "%03d.png", log=print):
    """Refine the input frames (Zero123 outputs) into a temporally coherent
    long video in ``out_folder``. Returns the frame counts written per
    window."""
    win, pre, step = cfg.window_frames, cfg.prefix_frames, cfg.frame_step
    written, prev_output, start = [], None, 0
    for w in range(cfg.num_windows):
        if w == 0:
            # window 1's GT prefix, read at frame_step
            gt_idx = [cfg.gt_prefix_start + step * i for i in range(pre)]
            prefix = load_frames(gt_prefix_folder, gt_idx, gt_pattern, cfg.height, cfg.width)
        else:
            # the tail of the previous window's output
            prefix = prev_output[-pre:]
        if cfg.window_start_indices is not None:
            s0 = int(cfg.window_start_indices[w])
            body_idx = [s0 + step * i for i in range(win - pre)]
        else:
            body_idx = [start + pre + step * i for i in range(win - pre)]
        body = load_frames(input_folder, body_idx, input_pattern, cfg.height, cfg.width)
        frames = np.concatenate([prefix, body], 0)
        assert frames.shape[0] == win, (frames.shape, win)

        out_frames = refine_window(engine, dit, vae, text_emb, uc_text_emb, frames, cfg,
                                   cfg.sdedit_strength, rng)
        # window 1 writes all frames; later windows skip the re-decoded prefix
        emit = out_frames if w == 0 else out_frames[pre:]
        save_frames(out_folder, emit, start_index=start if w == 0 else start + pre)
        written.append(len(emit))
        prev_output = out_frames
        start += win - pre
        log(f"window {w}: wrote {len(emit)} frames (total start now {start})")
    return written


def load_models(args, dev, dit_cfg, vae_cfg, cfg_scale: float = 6.0):
    """The engine, the DiT and the VAE (from ``args.dit_ckpt``/``vae_ckpt``,
    the flat npz, the DiT's ``_ema`` sibling preferred; else drawn from
    seeds 0 and 1) and the embedding of ``args.prompt``, all on ``dev``. A
    ``args.t5_dir`` raises before any weight is made."""
    enc = make_text_encoder(args.t5_dir or None, max_length=dit_cfg.text_length,
                            hidden=dit_cfg.text_hidden_size,
                            allow_fake=args.allow_fake_conditioning or args.tiny)
    engine = VideoEngine(dit_cfg, vae_cfg, cfg_scale=cfg_scale)
    if args.dit_ckpt:
        dit = video_dit_from_numpy(load_params_prefer_ema(args.dit_ckpt), dit_cfg, dev)
    else:
        dit = engine.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.vae_ckpt:
        vae = vae3d_from_numpy(load_params(args.vae_ckpt), vae_cfg, dev)
    else:
        vae = engine.init_vae_params(torch.Generator(device=dev).manual_seed(1))
    return engine, dit, vae, enc([args.prompt], device=dev)


def apply_preset(ap, argv):
    """The two-pass parse of the refinement CLIs: a --preset's values
    become the parser's defaults, explicit flags win."""
    pre, _ = ap.parse_known_args(argv)
    if pre.preset:
        from fluidnexus_torch.core.gen_presets import apply_preset_defaults, load_gen_preset

        apply_preset_defaults(ap, load_gen_preset(pre.preset))
    return ap.parse_args(argv)


def build_argparser():
    ap = argparse.ArgumentParser(description="long-video generative refinement")
    ap.add_argument("--preset", default="",
                    help="shipped configs_gen pin set (configs/gen_*.json): refine_smoke | "
                         "refine_ball | refine_scalar, or a JSON path; explicit flags override "
                         "preset values")
    ap.add_argument("--input_folder", required=True, help="Zero123 frame folder")
    ap.add_argument("--gt_prefix_folder", required=True, help="real capture frames for window 1")
    ap.add_argument("--out_folder", required=True)
    ap.add_argument("--prompt", default="a smoke plume")
    ap.add_argument("--dit_ckpt", default="")
    ap.add_argument("--vae_ckpt", default="")
    ap.add_argument("--t5_dir", default="", help="T5-XXL weights (not ported yet: raises)")
    ap.add_argument("--strength", type=float, default=0.5)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--num_windows", type=int, default=3)
    ap.add_argument("--window_frames", type=int, default=49)
    ap.add_argument("--prefix_frames", type=int, default=9)
    ap.add_argument("--frame_step", type=int, default=1,
                    help="read every Nth source frame (sdedit_frame_step)")
    ap.add_argument("--window_start_indices", type=int, nargs="*", default=None,
                    help="per-window body start frame in input_folder "
                         "(sdedit_start_idx_one/two/three)")
    ap.add_argument("--gt_prefix_start", type=int, default=0,
                    help="window 1's GT prefix start frame (sdedit_prefix_start_idx_one)")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--tiny", action="store_true", help="tiny random model (smoke test)")
    ap.add_argument("--allow_fake_conditioning", action="store_true",
                    help="run with hash pseudo-embeddings (test/smoke only; implied by --tiny)")
    ap.add_argument("--pack_video", action="store_true",
                    help="also pack the refined frames into a video file")
    ap.add_argument("--fps", type=int, default=8)
    return ap


def main(argv=None, device="cuda"):
    """Returns (the frame counts written per window, the packed video's
    path or None)."""
    from fluidnexus_torch.pipelines.sample_video import configs

    args = apply_preset(build_argparser(), argv)
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dit_cfg, vae_cfg = configs(args.window_frames, args.height, args.width, args.tiny)
    engine, dit, vae, text_emb = load_models(args, dev, dit_cfg, vae_cfg)
    cfg = RefineConfig(window_frames=args.window_frames, prefix_frames=args.prefix_frames,
                       num_windows=args.num_windows, sdedit_strength=args.strength,
                       num_steps=args.num_steps, height=args.height, width=args.width,
                       frame_step=args.frame_step,
                       window_start_indices=args.window_start_indices,
                       gt_prefix_start=args.gt_prefix_start)
    written = refine_long_video(engine, dit, vae, text_emb, torch.zeros_like(text_emb),
                                args.input_folder, args.gt_prefix_folder, args.out_folder, cfg,
                                torch.Generator(device=dev).manual_seed(2))
    video = None
    if args.pack_video:
        from fluidnexus_torch.utils.video_io import frames_folder_to_video

        video = frames_folder_to_video(args.out_folder, fps=args.fps)
        print("video:", video)
    return written, video


if __name__ == "__main__":
    main()
