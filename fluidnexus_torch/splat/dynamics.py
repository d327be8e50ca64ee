"""Dynamics Gaussian model (counterpart of ``fluidnexus_tpu/splat/dynamics.py``):
visual render particles + frozen background Gaussians.

So far: constant-appearance attrs (prepare_*_for_rendering:1643-1699: color
0.7, log-scale -5.9, opacity 0.1), the first-frame visual column
(create_particles_visual:510), the hidden PBF pillar
(create_particles_hidden:557) and the per-frame visual and hidden npy
checkpoints (save_visual:1901, load_visual:2067 with its smoothed variant,
save_hidden:1834, load_hidden:1991) in the reference format, the emitters
of phase C and of the future stage (prepare_emitter_points:674-790,
emit_new_particles:844) under static capacities: the plans are host-side
numpy drawn from the caller's generator in the JAX package's order, the
writes go into dead slots; and the bottom cut of the visual particles.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from fluidnexus_torch.sim.pbf import GRAVITY, PBFParams
from fluidnexus_torch.sim.state import (
    ParticleState, VisualState, emit_into_dead_slots, make_particle_state, make_visual_state,
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


def _disk_lattice(center_x, center_z, y_values, radius, delta) -> np.ndarray:
    xr = np.arange(center_x - radius, center_x + radius + delta, delta)
    zr = np.arange(center_z - radius, center_z + radius + delta, delta)
    pts = []
    for x in xr:
        for y in np.atleast_1d(y_values):
            for z in zr:
                if (x - center_x) ** 2 + (z - center_z) ** 2 <= radius**2:
                    pts.append([x, y, z])
    return np.asarray(pts, np.float32)


@dataclasses.dataclass
class EmitterPoints:
    """Precomputed emitter lattices (prepare_emitter_points, :674-745, and
    the future-first variant :747-790). WORLD units; scaled at emit time.
    ``hidden_first``/``visual_first`` stack the disk over 2 r of height; the
    future stage sizes its emission caps by them."""

    hidden: np.ndarray
    visual: np.ndarray
    hidden_first: np.ndarray
    visual_first: np.ndarray

    @classmethod
    def from_config(cls, m, is_future: bool = False):
        """The lattices of ``m`` (a ModelConfig); with ``is_future`` the
        visual disk sits vr / 2 lower, as the future stage emits it."""
        vr = m.emitter_visual_delta * m.emitter_visual_radius_ratio
        hr = m.emitter_hidden_delta * m.emitter_hidden_radius_ratio
        vy = m.emitter_center_y_visual - vr / 2 if is_future else m.emitter_center_y_visual
        visual = _disk_lattice(m.init_x_mid, m.init_z_mid, [vy], vr, m.emitter_visual_delta)
        hidden = _disk_lattice(m.init_x_mid, m.init_z_mid, [m.emitter_center_y_hidden], hr,
                               m.emitter_hidden_delta)
        vy_first = np.arange(m.emitter_center_y_visual,
                             m.emitter_center_y_visual + vr * 2 + m.emitter_visual_delta,
                             m.emitter_visual_delta)
        hy_first = np.arange(m.emitter_center_y_hidden,
                             m.emitter_center_y_hidden + hr * 2 + m.emitter_hidden_delta,
                             m.emitter_hidden_delta)
        return cls(hidden=hidden, visual=visual,
                   hidden_first=_disk_lattice(m.init_x_mid, m.init_z_mid, hy_first, hr,
                                              m.emitter_hidden_delta),
                   visual_first=_disk_lattice(m.init_x_mid, m.init_z_mid, vy_first, vr,
                                              m.emitter_visual_delta))


def plan_emission(points: np.ndarray, ratio: float, rng: np.random.Generator,
                  scale_factor: float = 100.0):
    """int+fractional emission of an emitter lattice (emit_new_particles,
    gm_dynamics.py:862-889): floor(ratio) full copies + a random subset of
    size int(frac*E). Host-side; returns (M,3) scaled positions."""
    full = int(ratio)
    frac = ratio - full
    out = [points] * full
    if frac > 0:
        sel = rng.permutation(len(points))[: int(frac * len(points))]
        out.append(points[sel])
    if not out:
        return np.zeros((0, 3), np.float32)
    return (np.concatenate(out, 0) * scale_factor).astype(np.float32)


def plan_extra_visual(visual_xyz: np.ndarray, alive: np.ndarray, extra_ratio: float,
                      extra_num: int, y_min: float, min_num: int, visual_delta: float,
                      rng: np.random.Generator, scale_factor: float = 100.0) -> np.ndarray:
    """Resample high visual particles with jitter (emit_new_particles
    :891-931). Host-side numpy."""
    out = []
    high = visual_xyz[alive]
    high = high[high[:, 1] > y_min * scale_factor]
    if extra_ratio > 0 and len(high) > 0:
        num = max(int(len(high) * extra_ratio), min_num)
        sel = rng.permutation(len(high))[:num]
        base = high[sel] / scale_factor
        off = (rng.random(base.shape).astype(np.float32) - 0.5) * visual_delta * 0.05
        out.append((base + off) * scale_factor)
    if extra_num > 0 and len(high) > 0:
        sel = rng.permutation(len(high))[:extra_num]
        base = high[sel] / scale_factor
        off = (rng.random(base.shape).astype(np.float32) - 0.5) * visual_delta * 0.05
        out.append((base + off) * scale_factor)
    if not out:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(out, 0).astype(np.float32)


def pad_emission(arr: np.ndarray, cap: int):
    """A host-side (M,3) emission plan cut or padded to the static capacity
    ``cap``, with its mask. Candidates past ``cap`` are dropped, so the caps
    change results."""
    m = min(arr.shape[0], cap)
    out = np.zeros((cap, 3), np.float32)
    out[:m] = arr[:m]
    mask = np.zeros((cap,), bool)
    mask[:m] = True
    return out, mask


def emit_hidden(state: ParticleState, new_xyz: np.ndarray, init_velocity_y: float,
                gravity_alpha: float, mask: Optional[np.ndarray] = None) -> ParticleState:
    """New hidden particles into dead slots with fresh ids, velocity
    (0, init_velocity_y, 0) and buoyancy GRAVITY * gravity_alpha
    (emit_new_particles :933-975). Zeroes ALL counts, as the reference does
    (gm_dynamics.py:961)."""
    mcount = new_xyz.shape[0]
    if mcount == 0:
        return state
    dev = state.xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    mask = (torch.ones((mcount,), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev))
    vel = torch.zeros((mcount, 3), **f32)
    vel[:, 1] = init_velocity_y
    buoy = (torch.as_tensor(GRAVITY, device=dev) * gravity_alpha).expand(mcount, 3)
    ids = state.next_id + torch.cumsum(mask.to(torch.int32), 0) - 1
    st, _ = emit_into_dead_slots(
        state, torch.as_tensor(new_xyz, **f32), mask,
        extra_updates=dict(velocity=vel, buoyancy=buoy, force=torch.zeros((mcount, 3), **f32),
                           imass=torch.ones((mcount,), **f32),
                           counts=torch.zeros((mcount,), **f32), particle_id=ids.to(torch.int32)))
    return st._replace(counts=torch.zeros_like(st.counts),
                       next_id=(st.next_id + mask.sum()).to(torch.int32))


def emit_visual(visual: VisualState, new_xyz: np.ndarray,
                mask: Optional[np.ndarray] = None) -> VisualState:
    """New visual particles into dead slots (emit_new_particles :933-975)."""
    if new_xyz.shape[0] == 0:
        return visual
    dev = visual.xyz.device
    mask = (torch.ones((new_xyz.shape[0],), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev))
    st, _ = emit_into_dead_slots(visual, torch.as_tensor(new_xyz, dtype=torch.float32, device=dev),
                                 mask)
    return st


def remove_bottom_visual(visual: VisualState, scale_factor: float = 100.0) -> VisualState:
    """Kill the visual particles under y = -0.017 world units
    (remove_invisible_bottom_visual_particles, gm_dynamics.py:1062-1072)."""
    return visual._replace(alive=visual.alive & (visual.xyz[:, 1] >= -0.017 * scale_factor))


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
                scale_factor: float = 100.0, smoothed_window: Optional[int] = None,
                use_smoothed=None, scale: bool = True, device="cuda"):
    """(load_visual :2067 / load_visual_smoothed :2095). With
    ``smoothed_window`` and ``use_smoothed`` ({attr: bool}) an attribute
    reads ``visual_{attr}_smoothed_ws{window}.npy`` where that file exists.
    With scale=False positions are loaded as saved, i.e. world units."""
    pre = os.path.join(path, f"frame_{frame_idx:03d}_")
    xyz = np.load(pre + "visual_xyz.npy")
    if scale:
        xyz = xyz * scale_factor
    n = len(xyz)
    vis = make_visual_state(capacity, xyz.astype(np.float32), device=device)

    def attr(name):
        p = pre + f"visual_{name}.npy"
        if smoothed_window and use_smoothed and use_smoothed.get(name, False):
            ps = pre + f"visual_{name}_smoothed_ws{smoothed_window}.npy"
            if os.path.exists(ps):
                p = ps
        return torch.as_tensor(np.load(p), dtype=torch.float32, device=device)

    attrs = constant_visual_attrs(capacity, channels, device=device)
    color = attr("color")
    if color.shape[1] == 1 and channels == 3:  # level_two_color_3ch
        color = color.repeat(1, 3)
    attrs.color[:n] = color
    attrs.scales[:n] = attr("scales")
    attrs.rotation[:n] = attr("rotation")
    attrs.opacity[:n] = attr("opacity")
    return vis, attrs
