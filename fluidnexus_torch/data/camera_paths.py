"""Synthetic camera paths for turntable renders (counterpart of
``fluidnexus_tpu/data/camera_paths.py``).

The reference renders the fixed capture views; for inspection videos it
relies on external tooling. ``orbit_cameras`` makes a list of ``Camera``s on
a circle (or a spiral) around a point, so that any trained splat or particle
state can be turned into a turntable video with the port's rasterizer and
video writer (``fluidnexus_torch.examples.render_orbit``).
"""
from __future__ import annotations

import numpy as np

from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.utils.maths import focal2fov, fov2focal


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)):
    """c2w rotation in the 3DGS convention (camera +z looks at the target,
    +y down, as the capture rigs' OpenCV-style matrices)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    # columns: x = right, y = down (OpenCV), z = forward
    return np.stack([right, down, fwd], axis=1)


def orbit_cameras(center, radius: float, n_frames: int, height: float = 0.0,
                  fovx: float = 0.7, width: int = 960, image_height: int = 544,
                  start_angle: float = 0.0, sweep: float = 2.0 * np.pi,
                  elevation_wobble: float = 0.0):
    """Cameras on a horizontal circle around ``center``, all looking at it.
    ``elevation_wobble`` adds one sine period of vertical spiral."""
    center = np.asarray(center, np.float64)
    cams = []
    fovy = focal2fov(fov2focal(fovx, width), image_height)
    for i in range(n_frames):
        ang = start_angle + sweep * i / max(n_frames, 1)
        wob = elevation_wobble * np.sin(2.0 * np.pi * i / max(n_frames, 1))
        eye = center + np.array([radius * np.cos(ang), height + wob, radius * np.sin(ang)])
        R = look_at(eye, center)
        cams.append(Camera(uid=i, R=R, T=-R.T @ eye, fovx=fovx, fovy=fovy,
                           width=width, height=image_height,
                           time_idx=i, timestamp=i / max(n_frames, 1)))
    return cams
