"""Particle states (counterpart of ``fluidnexus_tpu/sim/state.py``).

So far the visual particles; the hidden PBF state comes with phase B. Buffers
keep the JAX package's static ``capacity`` with an ``alive`` mask, so
checkpoints, indices and the parity tests line up slot for slot.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
