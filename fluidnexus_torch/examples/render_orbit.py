"""Turntable video of a trained background splat, or any PLY (counterpart of
the repository's ``examples/render_orbit.py``).

Usage (on the card):
  python -m fluidnexus_torch.examples.render_orbit \\
      --ply out/bg/point_cloud/iteration_30000/point_cloud.ply --out orbit.avi \\
      [--frames 60 --radius 2.5 --width 960 --height 544]

Loads the PLY with ``core/ply``, orbits a camera around the splat centroid
(``data/camera_paths``), renders each view through ``ops/rasterizer`` (the
card's kernels) and packs the frames with ``utils/video_io``: an
uncompressed AVI for ``.avi`` (an mp4 through OpenCV for ``.mp4``)."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.core.ply import load_background_ply
from fluidnexus_torch.data.camera_paths import orbit_cameras
from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize
from fluidnexus_torch.utils.video_io import write_video


def render_frames(ply: str, frames: int, radius: float, elevation: float, width: int,
                  height: int, white_background: bool = False, device="cuda"):
    """The orbit's renders of ``ply``: (frames, H, W, 3) float32 in [0, 1]."""
    dev = resolve_device(device)
    d = load_background_ply(ply)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    rot = d["rotation"] / (np.linalg.norm(d["rotation"], axis=-1, keepdims=True) + 1e-12)
    splats = (t(d["xyz"]), t(d["color"]), t(1.0 / (1.0 + np.exp(-d["opacity"]))).reshape(-1),
              t(np.exp(d["scaling"])), t(rot))
    center = d["xyz"].mean(0)
    spread = float(np.percentile(np.linalg.norm(d["xyz"] - center, axis=1), 90))
    cams = orbit_cameras(center, radius=max(radius, 1.5 * spread), n_frames=frames,
                         height=elevation, width=width, image_height=height)
    bg = torch.ones(3, device=dev) if white_background else torch.zeros(3, device=dev)
    out = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            img = rasterize(*splats, view_matrix=torch.as_tensor(cam.world_view, device=dev),
                            proj_matrix=torch.as_tensor(cam.full_proj, device=dev),
                            tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
                            height=cam.height, bg_color=bg, config=RasterizerConfig()).color
            out.append(torch.clamp(img, 0, 1).permute(1, 2, 0).cpu().numpy())
            if (i + 1) % 10 == 0:
                print(f"{i + 1}/{len(cams)} frames")
    return np.stack(out)


def main(argv=None, device="cuda"):
    """The CLI; returns the path written."""
    ap = argparse.ArgumentParser(description="orbit-render a splat PLY to video")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", default="orbit.avi")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--radius", type=float, default=2.5)
    ap.add_argument("--elevation", type=float, default=0.3)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--white_background", action="store_true")
    args = ap.parse_args(argv)
    frames = render_frames(args.ply, args.frames, args.radius, args.elevation, args.width,
                           args.height, args.white_background, device=device)
    path = write_video(args.out, frames, fps=args.fps)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
