"""Dynamics Gaussian model (counterpart of ``fluidnexus_tpu/splat/dynamics.py``):
visual render particles + frozen background Gaussians.

So far: constant-appearance attrs (prepare_*_for_rendering:1643-1699: color
0.7, log-scale -5.9, opacity 0.1), the first-frame visual column
(create_particles_visual:510), the hidden PBF pillar
(create_particles_hidden:557) and the per-frame visual and hidden npy
checkpoints (save_visual:1901, load_visual:2067, save_hidden:1834,
load_hidden:1991) in the reference format. The emitters come with phase C.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from fluidnexus_torch.sim.pbf import GRAVITY, PBFParams
from fluidnexus_torch.sim.state import (
    ParticleState, VisualState, make_particle_state, make_visual_state,
)
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


def create_hidden_points(m) -> np.ndarray:
    """Uniform lattice pillar (create_particles_hidden, gm_dynamics.py:557-610).
    Returns SCALED (x100) coordinates like the reference."""
    d = m.init_hidden_delta
    xr = np.arange(m.init_x_mid - m.init_hidden_radius_max, m.init_x_mid + m.init_hidden_radius_max + d, d)
    yr = np.arange(m.init_hidden_y_min, m.init_hidden_y_max, d)
    zr = np.arange(m.init_z_mid - m.init_hidden_radius_max, m.init_z_mid + m.init_hidden_radius_max + d, d)
    X, Y, Z = np.meshgrid(xr, yr, zr, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    keep = (pts[:, 0] - m.init_x_mid) ** 2 + (pts[:, 2] - m.init_z_mid) ** 2 <= m.init_hidden_radius_max**2
    return (pts[keep] * 100.0).astype(np.float32)


def save_hidden(state: ParticleState, params: PBFParams, path: str, frame_idx: int):
    """Per-frame npy checkpoint in the reference format (save_hidden,
    :1834-1898): alive rows only, xyz/estimate_xyz down-scaled, the
    solver constants in ``scalar_values.json``."""
    os.makedirs(path, exist_ok=True)
    a = state.alive.cpu().numpy()
    pre = os.path.join(path, f"frame_{frame_idx:03d}_")

    def rows(t):
        return t.detach().cpu().numpy()[a]

    np.save(pre + "xyz.npy", rows(state.xyz) / params.scale_factor)
    np.save(pre + "estimate_xyz.npy", rows(state.estimate_xyz) / params.scale_factor)
    np.save(pre + "buoyancy.npy", rows(state.buoyancy))
    np.save(pre + "force.npy", rows(state.force))
    np.save(pre + "velocity.npy", rows(state.velocity))
    np.save(pre + "imass.npy", rows(state.imass)[:, None])
    np.save(pre + "counts.npy", rows(state.counts)[:, None])
    np.save(pre + "gravity.npy", GRAVITY.reshape(1, 3))
    np.save(pre + "particle_id.npy", rows(state.particle_id)[:, None])
    scalars = {
        "scale_factor": params.scale_factor, "secs": params.secs, "alpha": params.alpha,
        "k": params.k, "p0": params.p0, "buoyancy_decay_rate": params.buoyancy_decay_rate,
        "buoyancy_max_y": params.buoyancy_max_y, "min_neighbors": params.min_neighbors,
        "particle_id_max": int(state.next_id),
    }
    with open(pre + "scalar_values.json", "w") as f:
        json.dump(scalars, f)


def load_hidden(path: str, frame_idx: int, capacity: int, params: PBFParams,
                device="cuda") -> ParticleState:
    """(load_hidden, gm_dynamics.py:1991-2064): the saved rows fill the
    first slots of a capacity-sized state."""
    pre = os.path.join(path, f"frame_{frame_idx:03d}_")

    def load(name, scale=1.0):
        arr = np.load(pre + name + ".npy")
        return torch.as_tensor(arr * scale if scale != 1.0 else arr, device=device)

    xyz = load("xyz", params.scale_factor)
    n = len(xyz)
    st = make_particle_state(capacity, device=device)
    st.xyz[:n] = xyz
    st.estimate_xyz[:n] = load("estimate_xyz", params.scale_factor)
    st.buoyancy[:n] = load("buoyancy")
    st.force[:n] = load("force")
    st.velocity[:n] = load("velocity")
    st.imass[:n] = load("imass").reshape(-1)
    st.counts[:n] = load("counts").reshape(-1)
    st.particle_id[:n] = load("particle_id").reshape(-1).to(torch.int32)
    st.alive[:n] = True
    with open(pre + "scalar_values.json") as f:
        scalars = json.load(f)
    st.next_id.fill_(scalars.get("particle_id_max", n))
    return st


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
