"""Video sampling CLI (t2v, and i2v from prefix frames) (counterpart of
``fluidnexus_tpu/pipelines/sample_video.py``): sample a clip from a text
prompt with the video DiT and decode it with the causal VAE into PNG frames.
``--prefix_folder``/``--prefix_frames``/``--prefix_pattern`` read PNG frames
(``gen_refine_video.load_frames``), encode them and keep their latents clean
during sampling.

    python -m fluidnexus_torch.pipelines.sample_video --prompt "smoke rising" \
        --out_folder out --allow_fake_conditioning

Without ``--dit_ckpt``/``--vae_ckpt`` the weights are drawn from a seed, as
the JAX CLI's are. Text goes through the hash pseudo-encoder only
(``--allow_fake_conditioning``, implied by ``--tiny``); a ``--t5_dir`` raises
until the T5 encoder is ported. ``--base`` merges the reference's CogVideoX
YAML configs (``diffusion/video/config_yaml``, which needs PyYAML) into the
defaults of the clip geometry, the sampler and the T5 directory, and gives
the DiT and VAE geometry; ``--t5_dir ""`` overrides a YAML's T5 directory.
``--pack_video`` packs the PNGs into a video (``utils/video_io``). Not
ported: ``--tp``/``--dp``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.diffusion.video.dit import VideoDiTConfig
from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig
from fluidnexus_torch.pipelines.gen_refine_video import (
    latent_prefix_len, load_frames, load_models, save_frames,
)


def configs(num_frames, height, width, tiny, run_cfg=None):
    """The DiT and VAE configs of a run: the JAX CLI's ``--tiny`` one (hidden
    64, 2 layers, 4 heads, f32), else a ``--base`` run config's model (the
    merged YAMLs' geometry), else the CogVideoX-5B geometry; the latent grid
    is the clip's."""
    lat_t = (num_frames - 1) // 4 + 1
    if tiny:
        return (VideoDiTConfig(hidden_size=64, num_layers=2, num_heads=4, text_hidden_size=64,
                               text_length=8, latent_frames=lat_t, latent_height=height // 8,
                               latent_width=width // 8, dtype=torch.float32),
                VAE3DConfig(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1))
    if run_cfg is not None:
        return (dataclasses.replace(run_cfg.dit, latent_frames=lat_t, latent_height=height // 8,
                                    latent_width=width // 8), run_cfg.vae)
    return (VideoDiTConfig(latent_frames=lat_t, latent_height=height // 8,
                           latent_width=width // 8), VAE3DConfig())


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description="sample a video clip (t2v)")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--out_folder", required=True)
    ap.add_argument("--prefix_folder", default="", help="i2v prefix frames (optional)")
    ap.add_argument("--prefix_frames", type=int, default=0)
    ap.add_argument("--prefix_pattern", default="%03d.png")
    ap.add_argument("--num_frames", type=int, default=49)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--cfg_scale", type=float, default=6.0)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--dit_ckpt", default="")
    ap.add_argument("--vae_ckpt", default="")
    ap.add_argument("--t5_dir", default="", help="T5-XXL weights (not ported yet: raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--allow_fake_conditioning", action="store_true",
                    help="run with hash pseudo-embeddings (test/smoke only; implied by --tiny)")
    ap.add_argument("--pack_video", action="store_true",
                    help="also pack the frames into a video file (mp4, or an uncompressed AVI)")
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--base", nargs="+", default=[],
                    help="reference CogVideoX YAML config(s), merged in order: the sampler's "
                         "and the model's geometry defaults come from them (needs PyYAML)")
    pre, _ = ap.parse_known_args(argv)
    run_cfg = None
    if pre.base:
        from fluidnexus_torch.diffusion.video.config_yaml import load_cogvideox_yaml

        run_cfg = load_cogvideox_yaml(pre.base)
        ap.set_defaults(num_frames=run_cfg.train.max_num_frames,
                        num_steps=run_cfg.sampler.num_steps, cfg_scale=run_cfg.sampler.scale,
                        height=run_cfg.train.video_size[0], width=run_cfg.train.video_size[1],
                        t5_dir=run_cfg.t5_dir)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dit_cfg, vae_cfg = configs(args.num_frames, args.height, args.width, args.tiny, run_cfg)
    engine, params, vae, text_emb = load_models(args, dev, dit_cfg, vae_cfg, args.cfg_scale)
    uc = torch.zeros_like(text_emb)

    shape = (1, dit_cfg.latent_frames, dit_cfg.in_channels, dit_cfg.latent_height,
             dit_cfg.latent_width)
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    prefix_lat = None
    if args.prefix_folder and args.prefix_frames > 0:
        frames = load_frames(args.prefix_folder, range(args.prefix_frames), args.prefix_pattern,
                             args.height, args.width)
        z = engine.encode_first_stage(vae, torch.as_tensor(frames, dtype=torch.float32,
                                                           device=dev)[None], rng)
        prefix_lat = z.permute(0, 1, 4, 2, 3)[:, :latent_prefix_len(args.prefix_frames)].clone()
    lat = engine.sample(params, shape, text_emb, uc, rng=rng, num_steps=args.num_steps,
                        prefix_clean_frames=prefix_lat)
    decoded = engine.decode_first_stage(vae, lat.permute(0, 1, 3, 4, 2))
    save_frames(args.out_folder, decoded[0].cpu().numpy(), 0)
    if args.pack_video:
        from fluidnexus_torch.utils.video_io import frames_folder_to_video

        print("video:", frames_folder_to_video(args.out_folder, fps=args.fps))
    print(f"wrote {decoded.shape[1]} frames to {args.out_folder}")
    return decoded


if __name__ == "__main__":
    main()
