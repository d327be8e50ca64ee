"""State carried across from the JAX package.

``*_from_numpy`` turn the JAX package's states, given as numpy arrays
(``jax.tree.map(np.asarray, x)``), into the port's tensors on a device;
``*_to_numpy`` go the other way. Field names and order are the same in both
packages, so a state converts field by field.
"""
from __future__ import annotations

import numpy as np
import torch

from fluidnexus_torch.core.optim import AdamState
from fluidnexus_torch.ops.neighbors import DenseGrid
from fluidnexus_torch.sim.state import ParticleState, VisualState
from fluidnexus_torch.splat.dynamics import BackgroundSplats, VisualAttrs


def _t(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _n(x):
    return x.detach().cpu().numpy()


def visual_state_from_numpy(v, device="cuda") -> VisualState:
    return VisualState(xyz=_t(v.xyz, device).to(torch.float32), alive=_t(v.alive, device).bool())


def visual_state_to_numpy(v: VisualState):
    return VisualState(xyz=_n(v.xyz), alive=_n(v.alive))


_INT_FIELDS = ("particle_id", "next_id")


def particle_state_from_numpy(s, device="cuda") -> ParticleState:
    def field(name):
        t = _t(getattr(s, name), device)
        if name == "alive":
            return t.bool()
        return t.to(torch.int32 if name in _INT_FIELDS else torch.float32)

    return ParticleState(**{name: field(name) for name in ParticleState._fields})


def particle_state_to_numpy(s: ParticleState) -> ParticleState:
    return ParticleState(*(_n(x) for x in s))


def dense_grid_from_numpy(g, device="cuda") -> DenseGrid:
    """The JAX package's ``DenseGrid`` (numpy fields) as the port's, so its
    tables can feed the port's pair passes."""
    def field(name):
        t = _t(getattr(g, name), device)
        if name == "bxyz":
            return t.to(torch.float32)
        return t.bool() if name == "bmask" else t.to(torch.int32)

    return DenseGrid(**{name: field(name) for name in DenseGrid._fields})


def visual_attrs_from_numpy(a, device="cuda") -> VisualAttrs:
    return VisualAttrs(*(_t(x, device).to(torch.float32) for x in a))


def visual_attrs_to_numpy(a: VisualAttrs):
    return VisualAttrs(*(_n(x) for x in a))


def background_from_numpy(b, device="cuda") -> BackgroundSplats:
    return BackgroundSplats(**{k: _t(getattr(b, k), device).to(torch.float32)
                               for k in ("xyz", "color", "scaling", "rotation", "opacity")})


def background_to_numpy(b: BackgroundSplats) -> dict:
    return {k: _n(getattr(b, k)) for k in ("xyz", "color", "scaling", "rotation", "opacity")}


def adam_state_from_numpy(s, device="cuda") -> AdamState:
    return AdamState(mu={k: _t(v, device) for k, v in s.mu.items()},
                     nu={k: _t(v, device) for k, v in s.nu.items()},
                     count=_t(s.count, device).to(torch.int32))


def adam_state_to_numpy(s: AdamState) -> AdamState:
    return AdamState(mu={k: _n(v) for k, v in s.mu.items()},
                     nu={k: _n(v) for k, v in s.nu.items()}, count=_n(s.count))
