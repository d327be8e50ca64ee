"""Particle states (counterpart of ``fluidnexus_tpu/sim/state.py``).

The hidden PBF particles and the visual particles. Buffers keep the JAX
package's static ``capacity`` with an ``alive`` mask, so checkpoints, indices
and the parity tests line up slot for slot. Emission into dead slots and
``compact`` come with phase C.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ParticleState(NamedTuple):
    """Hidden PBF particles (scaled space, i.e. world * scale_factor)."""

    xyz: torch.Tensor            # (N,3)
    estimate_xyz: torch.Tensor   # (N,3)
    velocity: torch.Tensor       # (N,3)
    force: torch.Tensor          # (N,3)
    buoyancy: torch.Tensor       # (N,3)
    imass: torch.Tensor          # (N,) inverse mass (1 for fluid)
    counts: torch.Tensor         # (N,) solver-iteration counter (PBF delta averaging)
    particle_id: torch.Tensor    # (N,) int32 stable ids
    alive: torch.Tensor          # (N,) bool
    next_id: torch.Tensor        # () int32, the next id to assign

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self):
        return self.alive.sum()


def make_particle_state(capacity: int, init_xyz=None, init_velocity_y: float = 0.0,
                        gravity_alpha_buoyancy=None, device="cuda") -> ParticleState:
    """A capacity-N state; the first rows optionally seeded from ``init_xyz``
    with velocity (0, init_velocity_y, 0) (create_particles_hidden,
    gm_dynamics.py:557-610). Raises ``ValueError`` over capacity."""
    f32 = dict(dtype=torch.float32, device=device)
    if gravity_alpha_buoyancy is None:
        buoy = torch.zeros((capacity, 3), **f32)
    else:
        g = torch.as_tensor(np.asarray(gravity_alpha_buoyancy, np.float32), **f32)
        buoy = g.expand(capacity, 3).clone()
    st = ParticleState(
        xyz=torch.zeros((capacity, 3), **f32), estimate_xyz=torch.zeros((capacity, 3), **f32),
        velocity=torch.zeros((capacity, 3), **f32), force=torch.zeros((capacity, 3), **f32),
        buoyancy=buoy, imass=torch.ones((capacity,), **f32),
        counts=torch.zeros((capacity,), **f32),
        particle_id=torch.zeros((capacity,), dtype=torch.int32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
    )
    if init_xyz is not None:
        n = init_xyz.shape[0]
        if n > capacity:
            raise ValueError(f"init {n} > capacity {capacity}")
        xyz = torch.as_tensor(init_xyz, **f32)
        st.xyz[:n] = xyz
        st.estimate_xyz[:n] = xyz
        st.velocity[:n, 1] = init_velocity_y
        st.particle_id[:n] = torch.arange(n, dtype=torch.int32, device=device)
        st.alive[:n] = True
        st.next_id.fill_(n)
    return st


class VisualState(NamedTuple):
    """Visual (rendering) particles; appearance attrs live in the splat model."""

    xyz: torch.Tensor    # (V,3)
    alive: torch.Tensor  # (V,) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self):
        return self.alive.sum()


def make_visual_state(capacity: int, init_xyz=None, device="cuda") -> VisualState:
    st = VisualState(xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
                     alive=torch.zeros((capacity,), dtype=torch.bool, device=device))
    if init_xyz is not None:
        n = init_xyz.shape[0]
        if n > capacity:
            raise ValueError(f"init {n} > capacity {capacity}")
        st.xyz[:n] = torch.as_tensor(init_xyz, dtype=torch.float32, device=device)
        st.alive[:n] = True
    return st
