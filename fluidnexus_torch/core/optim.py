"""Per-field Adam with external learning rates — the reference trains every
model with ``torch.optim.Adam(param_groups, lr=0.0, eps=1e-15)`` and
per-group lrs updated by schedules (gm_background.training_setup:155-180,
gm_dynamics.training_setup_current:372-398).

Counterpart of ``fluidnexus_tpu/core/optim.py``: a functional transform over
a dict of tensors, with the lrs passed in per call so the schedules stay on
the host. Moments are exposed for the densification "optimizer surgery".

``ClipAdamW`` is the video trainer's ``optax.chain(clip_by_global_norm,
adamw)`` with optax's defaults (eps 1e-8, weight decay 1e-4; torch's AdamW
defaults to 1e-2): the updates scaled by max_norm / |g| only when |g| >=
max_norm (``clip_grad_norm_`` scales by max_norm / (|g| + 1e-6) always)."""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

import torch


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor  # () int32


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=torch.zeros((), dtype=torch.int32, device=some.device))


@torch.no_grad()
def adam_step(params, grads, state: AdamState, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam update with bias correction. ``lrs`` maps field -> scalar lr.
    Returns new tensors; the inputs are left as they were."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    new_mu, new_nu, new_params = {}, {}, {}
    for k in params:
        g = grads[k]
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        mhat = mu / bc1
        nhat = nu / bc2
        new_params[k] = params[k] - lrs[k] * mhat / (torch.sqrt(nhat) + eps)
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def sorted_names(params):
    """Dotted parameter names in a flax tree's flattening order."""
    return sorted(params, key=lambda n: tuple(n.split(".")))


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay))`` over a dict of f32 tensors, updated in place (the
    trainables are the only copy kept); the defaults are optax's.
    ``count``, ``mu`` and ``nu`` are the optax state's leaves, in its order
    for a name-sorted tree."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params, self.lr = params, lr
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def state_leaves(self):
        """[count, mu leaves, nu leaves], each name-sorted."""
        names = sorted_names(self.params)
        return ([torch.tensor(self.count, dtype=torch.int32)] + [self.mu[n] for n in names]
                + [self.nu[n] for n in names])

    def load_state_leaves(self, leaves):
        names = sorted_names(self.params)
        if len(leaves) != 1 + 2 * len(names):
            raise ValueError(f"{len(leaves)} optimizer leaves for {len(names)} parameters")
        self.count = int(leaves[0])
        with torch.no_grad():
            for i, n in enumerate(names):
                self.mu[n].copy_(torch.as_tensor(np.asarray(leaves[1 + i])))
                self.nu[n].copy_(torch.as_tensor(np.asarray(leaves[1 + len(names) + i])))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        b1, b2 = self.b1, self.b2
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_norm
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for k, p in self.params.items():
            g = torch.where(keep, grads[k], (grads[k] / g_norm) * self.max_norm)
            mu = self.mu[k].mul_(b1).add_((1 - b1) * g)
            nu = self.nu[k].mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * p
            p.add_(-self.lr * u)
