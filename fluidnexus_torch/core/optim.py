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
max_norm (``clip_grad_norm_`` scales by max_norm / (|g| + 1e-6) always).
Across ranks (``ClipAdamW.shard``) the moments are ZeRO-sharded over the
mesh's 'data' axis and the clip's norm is taken over the whole gradient."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

import torch
import torch.distributed as dist

from fluidnexus_torch.parallel.mesh import chunk, gather, group


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
    ``max_norm=None`` is ``adamw`` alone. ``lr`` is a number or a schedule,
    a function of the update count before this update (optax's
    ``scale_by_schedule``). ``count``, ``mu`` and ``nu`` are the optax
    state's leaves, in its order for a name-sorted tree."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, max_norm: Optional[float] = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params, self.lr = params, lr
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        # set by ``shard``: the mesh, each moment's ZeRO dim and the
        # tensor-parallel leaves
        self.mesh, self.zero, self.tp_sharded = None, {}, frozenset()

    def shard(self, zero_dims, mesh, tp_sharded=()):
        """ZeRO over the mesh's 'data' axis: each moment keeps this rank's
        chunk along ``zero_dims[name]`` (None: whole), each step updates
        that chunk of its parameter and all-gathers the parameter back.
        ``tp_sharded`` names the parameters split over 'model' (their
        squares are summed over it for the clip)."""
        self.mesh, self.zero, self.tp_sharded = mesh, dict(zero_dims), frozenset(tp_sharded)
        dg = group(mesh, "data")
        for k in self.params:
            if self.zero.get(k) is not None:
                self.mu[k] = chunk(self.mu[k], self.zero[k], dg).clone()
                self.nu[k] = chunk(self.nu[k], self.zero[k], dg).clone()

    def _full(self, name, x):
        """A moment whole over 'data' from this rank's chunk of it."""
        if self.zero.get(name) is not None:
            x = gather(x, self.zero[name], group(self.mesh, "data"))
        return x

    def _local(self, name, x):
        if self.zero.get(name) is not None:
            x = chunk(x, self.zero[name], group(self.mesh, "data"))
        return x

    def state_leaves(self):
        """[count, mu leaves, nu leaves], each name-sorted and whole over
        'data' (the moments of a parameter split over 'model' stay this
        rank's shard, as the parameter does)."""
        names = sorted_names(self.params)
        return ([torch.tensor(self.count, dtype=torch.int32)]
                + [self._full(n, self.mu[n]) for n in names]
                + [self._full(n, self.nu[n]) for n in names])

    def load_state_leaves(self, leaves):
        names = sorted_names(self.params)
        if len(leaves) != 1 + 2 * len(names):
            raise ValueError(f"{len(leaves)} optimizer leaves for {len(names)} parameters")
        self.count = int(leaves[0])
        with torch.no_grad():
            for i, n in enumerate(names):
                for dst, leaf in ((self.mu, leaves[1 + i]), (self.nu, leaves[1 + len(names) + i])):
                    leaf = leaf if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
                    dst[n].copy_(self._local(n, leaf))

    def _global_norm(self, grads):
        """|g| over the whole gradient: the tensor-parallel leaves' squares
        summed over 'model', the replicated ones counted once."""
        sq = [torch.sum(g * g) for k, g in grads.items() if k not in self.tp_sharded]
        total = sum(sq) if sq else 0.0
        if self.tp_sharded:
            part = sum(torch.sum(grads[k] * grads[k]) for k in sorted(self.tp_sharded))
            dist.all_reduce(part, group=group(self.mesh, "model"))
            total = total + part
        return torch.sqrt(total)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        b1, b2 = self.b1, self.b2
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        if self.max_norm is not None:
            g_norm = self._global_norm(grads)
            keep = g_norm < self.max_norm
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        dg = group(self.mesh, "data")
        for k, p in self.params.items():
            g = grads[k]
            if self.max_norm is not None:
                g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            d = self.zero.get(k)
            pk = p if d is None else chunk(p, d, dg)
            if d is not None:
                g = chunk(g, d, dg)
            mu = self.mu[k].mul_(b1).add_((1 - b1) * g)
            nu = self.nu[k].mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * pk
            if d is None:
                p.add_(-lr * u)
            else:
                p.copy_(gather(pk + (-lr * u), d, dg))
