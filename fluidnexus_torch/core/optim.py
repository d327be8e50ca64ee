"""Per-field Adam with external learning rates — the reference trains every
model with ``torch.optim.Adam(param_groups, lr=0.0, eps=1e-15)`` and
per-group lrs updated by schedules (gm_background.training_setup:155-180,
gm_dynamics.training_setup_current:372-398).

Counterpart of ``fluidnexus_tpu/core/optim.py``: a functional transform over
a dict of tensors, with the lrs passed in per call so the schedules stay on
the host. Moments are exposed for the densification "optimizer surgery"."""
from __future__ import annotations

from typing import Dict, NamedTuple

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
