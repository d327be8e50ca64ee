"""Particle states (counterpart of ``fluidnexus_tpu/sim/state.py``).

The hidden PBF particles and the visual particles. Buffers keep the JAX
package's static ``capacity`` with an ``alive`` mask, so checkpoints, indices
and the parity tests line up slot for slot. Emission writes into dead slots
(``emit_into_dead_slots``); ``compact`` is not ported yet.
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


def emit_into_dead_slots(state, new_xyz, new_mask, extra_updates=None):
    """Write up to M new particles into dead slots, the lowest indices first
    (the JAX package's ``emit_into_dead_slots``, sim/state.py:96-130).

    ``state`` is a ParticleState or a VisualState; ``new_xyz`` (M, 3) and
    ``new_mask`` (M,) mark which of the M candidates are real, in order;
    ``extra_updates`` maps a field name to (M, ...) values written alongside.
    The real candidates keep their order and go to the dead slots in index
    order; those that do not fit are dropped. Returns (new_state, dropped).
    The input state is left as it was."""
    cap = state.capacity
    m = new_xyz.shape[0]
    if m > cap:
        raise ValueError(f"{m} candidates for a capacity of {cap}")
    slot = torch.argsort(state.alive.to(torch.int32), stable=True)[:m]   # dead slots first
    num_dead = cap - state.alive.sum()
    fits = new_mask & (torch.cumsum(new_mask.to(torch.int64), 0) - 1 < num_dead)
    order = torch.argsort((~fits).to(torch.int32), stable=True)          # fitting ones first
    src_mask = fits[order]

    def scatter(field, values):
        out = field.clone()
        keep = src_mask.reshape((-1,) + (1,) * (values.ndim - 1))
        out[slot] = torch.where(keep, values[order].to(field.dtype), field[slot])
        return out

    updates = {"xyz": scatter(state.xyz, new_xyz)}
    if isinstance(state, ParticleState):
        updates["estimate_xyz"] = scatter(state.estimate_xyz, new_xyz)
    for name, values in (extra_updates or {}).items():
        updates[name] = scatter(getattr(state, name), values)
    alive = state.alive.clone()
    alive[slot] = src_mask | state.alive[slot]
    updates["alive"] = alive
    return state._replace(**updates), new_mask.sum() - fits.sum()
