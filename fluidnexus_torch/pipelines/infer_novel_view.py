"""Per-frame novel-view synthesis (the Zero123 stage; counterpart of
``fluidnexus_tpu/pipelines/infer_novel_view.py``) on one card.

    python -m fluidnexus_torch infer_novel_view --data_dir zero123 --out_dir out \
        --ckpt runs/zero123/iter_0052000

For each frame, condition on the source camera's image, take the spherical
pose delta to each target camera (``camera/{i:02d}.npy`` W2C matrices), run
a 50-step CFG-3.0 DDIM sample, and write
``<out>/zero123_finetune_<steps>_cam{s}to{c}/frame_{i:06d}.png``. Images are
read by ``utils/png`` and resized by PIL's 8-bit LANCZOS (``utils/lanczos``),
with no imaging library. ``--ckpt`` is the JAX package's flat npz; its
``_ema`` sibling is preferred when there is one. Without it the weights are
drawn from a seed (``init_novel_view``). The draws come from one
``torch.Generator`` seeded with ``seed``, one sample after the other.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import novel_view_from_numpy
from fluidnexus_torch.core.checkpoint import load_params_prefer_ema
from fluidnexus_torch.diffusion.ldm.model import (
    NovelViewModel, build_novel_view, get_pose_delta, init_novel_view,
)
from fluidnexus_torch.utils.lanczos import resize_u8
from fluidnexus_torch.utils.png import read_png, to_rgb, write_png


def load_image(path, size=256):
    """The PNG at ``path`` as (size, size, 3) f32 in [0, 1]: PIL's
    ``convert("RGB")`` (alpha dropped) and LANCZOS resize."""
    img = resize_u8(to_rgb(read_png(path)), size, size)
    return img.astype(np.float32) / 255.0


def save_image(path, arr):
    """(H, W, 3) in [0, 1] -> an 8-bit PNG, the values truncated as
    ``(clip(x) * 255).astype(uint8)`` truncates them."""
    write_png(path, (np.clip(arr, 0, 1) * 255).astype(np.uint8))


def run_inference(
    model: NovelViewModel,
    data_dir: str,
    out_dir: str,
    source_cam: int = 2,
    target_cams=(0, 1, 3, 4),
    num_frames: int = 410,
    num_steps: int = 50,
    cfg_scale: float = 3.0,
    image_size: int = 256,
    finetune_steps: int = 52000,
    seed: int = 0,
    log=print,
):
    """data_dir layout (DataProcessing/fluid_nexus_real/create_zero123_dataset):
    frame_%03d/{cam:02d}.png + camera/{cam:02d}.npy W2C matrices. The model
    runs on the device its weights are on."""
    dev = next(model.parameters()).device
    cams = {i: np.load(os.path.join(data_dir, "camera", f"{i:02d}.npy"))
            for i in set(list(target_cams) + [source_cam])}
    deltas = {c: torch.as_tensor(get_pose_delta(cams[c], cams[source_cam])[None], device=dev)
              for c in target_cams}
    rng = torch.Generator(device=dev).manual_seed(seed)
    for i in range(num_frames):
        cond_path = os.path.join(data_dir, f"frame_{i:03d}", f"{source_cam:02d}.png")
        if not os.path.exists(cond_path):
            log(f"stopping at frame {i}: {cond_path} missing")
            break
        cond = torch.as_tensor(load_image(cond_path, image_size), device=dev)[None]
        for c in target_cams:
            out = model.ddim_sample(cond, deltas[c], rng, num_steps=num_steps,
                                    cfg_scale=cfg_scale, image_size=image_size)
            folder = f"zero123_finetune_{finetune_steps}_cam{source_cam}to{c}"
            save_image(os.path.join(out_dir, folder, f"frame_{i:06d}.png"),
                       out[0].cpu().numpy())
        if i % 20 == 0:
            log(f"frame {i}/{num_frames}")


def build_argparser():
    ap = argparse.ArgumentParser(description="novel-view inference")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--ckpt", default="", help="flat-npz checkpoint of model params")
    ap.add_argument("--source_cam", type=int, default=2)
    ap.add_argument("--target_cams", type=int, nargs="+", default=[0, 1, 3, 4])
    ap.add_argument("--num_frames", type=int, default=410)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--cfg_scale", type=float, default=3.0)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--finetune_steps", type=int, default=52000)
    return ap


def main(argv=None, device="cuda", configs=None, log=print):
    """``configs``: ``NovelViewModel``'s config keywords (the full geometry
    when None)."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ckpt:
        # prefer the LitEma shadow when the finetune saved one (the reference
        # samples with model_ema scopes active, ddpm.py:151-162)
        model = novel_view_from_numpy(load_params_prefer_ema(args.ckpt), configs, dev)
    else:
        log("WARNING: no --ckpt given; using random init (smoke-test mode)")
        model = init_novel_view(build_novel_view(dev, **(configs or {})),
                                torch.Generator(device=dev).manual_seed(0))
    run_inference(model, args.data_dir, args.out_dir, args.source_cam, tuple(args.target_cams),
                  args.num_frames, args.num_steps, args.cfg_scale, args.image_size,
                  args.finetune_steps, log=log)
    return model


if __name__ == "__main__":
    main()
