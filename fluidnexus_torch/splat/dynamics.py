"""Dynamics Gaussian model (counterpart of ``fluidnexus_tpu/splat/dynamics.py``):
visual render particles + frozen background Gaussians.

So far: constant-appearance attrs (prepare_*_for_rendering:1643-1699: color
0.7, log-scale -5.9, opacity 0.1), the first-frame visual column
(create_particles_visual:510) and the per-frame visual npy checkpoint
(save_visual:1901, load_visual:2067) in the reference format. The hidden
particles and the emitters come with the phase-B and phase-C slices.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from fluidnexus_torch.sim.state import VisualState, make_visual_state
from fluidnexus_torch.utils.maths import inv_sigmoid

CONSTANT_COLOR = 0.7      # ref gm_dynamics.py:178-180
CONSTANT_SCALE = -5.9
CONSTANT_OPACITY = 0.1


class VisualAttrs(NamedTuple):
    """Appearance of visual particles (level-two fit targets); capacity-sized."""

    color: torch.Tensor     # (V,C) raw
    scales: torch.Tensor    # (V,3) log
    rotation: torch.Tensor  # (V,4)
    opacity: torch.Tensor   # (V,1) pre-sigmoid


def constant_visual_attrs(capacity: int, channels: int = 1, device="cuda") -> VisualAttrs:
    f32 = dict(dtype=torch.float32, device=device)
    rot = torch.zeros((capacity, 4), **f32)
    rot[:, 0] = 1.0
    op = float(inv_sigmoid(torch.tensor(CONSTANT_OPACITY, dtype=torch.float32)))
    return VisualAttrs(
        color=torch.full((capacity, channels), CONSTANT_COLOR, **f32),
        scales=torch.full((capacity, 3), CONSTANT_SCALE, **f32),
        rotation=rot,
        opacity=torch.full((capacity, 1), op, **f32),
    )


@dataclasses.dataclass
class BackgroundSplats:
    """Frozen background Gaussians loaded from the stage-1 PLY."""

    xyz: torch.Tensor
    color: torch.Tensor
    scaling: torch.Tensor   # log
    rotation: torch.Tensor
    opacity: torch.Tensor   # pre-sigmoid

    @classmethod
    def from_ply(cls, path: str, device="cuda"):
        from fluidnexus_torch.core.ply import load_background_ply

        d = load_background_ply(path)
        return cls(**{k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
                      for k in ("xyz", "color", "scaling", "rotation", "opacity")})

    @property
    def n(self):
        return self.xyz.shape[0]


def create_visual_points(m, rng: np.random.Generator) -> np.ndarray:
    """Random cylinder-ish column of visual particles (create_particles_visual,
    gm_dynamics.py:510-556). m is a ModelConfig. WORLD units. Draws from
    ``rng`` in the JAX package's order, so both packages pick the same points."""
    n, nt = m.init_visual_num_pts, max(m.init_thick_visual_num_pts, 0)
    y = rng.uniform(m.init_visual_y_min, m.init_visual_y_max, (n, 1))
    r = rng.random((n, 1)) * m.init_visual_radius_small_max
    if nt > 0:
        y = np.concatenate([y, rng.uniform(m.init_visual_y_thick_min, m.init_visual_y_max, (nt, 1))], 0)
        r = np.concatenate([r, rng.random((nt, 1)) * m.init_visual_radius_max], 0)
    th = rng.random((n + nt, 1)) * 2 * np.pi
    x = r * np.cos(th) + m.init_x_mid
    z = r * np.sin(th) + m.init_z_mid
    return np.concatenate([x, y, z], 1).astype(np.float32)


def save_visual(visual: VisualState, attrs: VisualAttrs, path: str, frame_idx: int,
                scale_factor: float = 100.0, scale: bool = True):
    """(save_visual, :1901-1924): alive rows only, positions down-scaled."""
    os.makedirs(path, exist_ok=True)
    a = visual.alive.cpu().numpy()
    pre = os.path.join(path, f"frame_{frame_idx:03d}_")
    xyz = visual.xyz.detach().cpu().numpy()[a]
    np.save(pre + "visual_xyz.npy", xyz / scale_factor if scale else xyz)
    for name, t in (("color", attrs.color), ("scales", attrs.scales),
                    ("rotation", attrs.rotation), ("opacity", attrs.opacity)):
        np.save(pre + f"visual_{name}.npy", t.detach().cpu().numpy()[a])


def load_visual(path: str, frame_idx: int, capacity: int, channels: int = 1,
                scale_factor: float = 100.0, scale: bool = True, device="cuda"):
    """(load_visual :2067). With scale=False positions are loaded as saved,
    i.e. world units. The smoothed-attribute variant comes with the level-two
    stage."""
    pre = os.path.join(path, f"frame_{frame_idx:03d}_")
    xyz = np.load(pre + "visual_xyz.npy")
    if scale:
        xyz = xyz * scale_factor
    n = len(xyz)
    vis = make_visual_state(capacity, xyz.astype(np.float32), device=device)

    def attr(name):
        return torch.as_tensor(np.load(pre + f"visual_{name}.npy"), dtype=torch.float32,
                               device=device)

    attrs = constant_visual_attrs(capacity, channels, device=device)
    color = attr("color")
    if color.shape[1] == 1 and channels == 3:  # level_two_color_3ch
        color = color.repeat(1, 3)
    attrs.color[:n] = color
    attrs.scales[:n] = attr("scales")
    attrs.rotation[:n] = attr("rotation")
    attrs.opacity[:n] = attr("opacity")
    return vis, attrs
