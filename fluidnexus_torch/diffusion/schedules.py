"""Diffusion noise schedules and prediction parameterizations (counterpart of
``fluidnexus_tpu/diffusion/schedules.py``).

- Zero123's DDPM linear-beta schedule, eps-parameterization (linear beta
  0.00085 -> 0.012, 1000 steps).
- CogVideoX's ZeroSNR DDPM discretization and v-prediction.

Schedules are numpy; the parameterizations take tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str = "linear", n_timestep: int = 1000,
                       linear_start: float = 0.00085, linear_end: float = 0.012):
    """'linear' is the scaled-linear sqrt schedule used by SD/Zero123."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        s = 0.008
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
        alphas_bar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
        alphas_bar = alphas_bar / alphas_bar[0]
        betas = np.clip(1 - alphas_bar[1:] / alphas_bar[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    else:
        raise ValueError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed alphas for a discrete schedule."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @classmethod
    def create(cls, n_timestep=1000, linear_start=0.00085, linear_end=0.012,
               schedule="linear", zero_snr=False):
        betas = make_beta_schedule(schedule, n_timestep, linear_start, linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, 0)
        if zero_snr:
            alphas_cumprod = _shift_to_zero_snr(alphas_cumprod)
        return cls(betas=betas, alphas_cumprod=alphas_cumprod)

    @property
    def num_timesteps(self):
        return len(self.betas)

    def sqrt_alphas_cumprod(self):
        return np.sqrt(self.alphas_cumprod)

    def sqrt_one_minus_alphas_cumprod(self):
        return np.sqrt(1.0 - self.alphas_cumprod)

    def sigmas_eps(self):
        """EDM-style sigma per step: sigma_t = sqrt((1-abar)/abar)."""
        return np.sqrt((1 - self.alphas_cumprod) / self.alphas_cumprod)


def _shift_to_zero_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift sqrt(abar) so sqrt(abar_T) = 0 while keeping sqrt(abar_1)."""
    sqrt_ac = np.sqrt(alphas_cumprod)
    a0, aT = sqrt_ac[0], sqrt_ac[-1]
    sqrt_ac = sqrt_ac - aT
    sqrt_ac = sqrt_ac * a0 / (a0 - aT)
    return sqrt_ac**2


def q_sample(x0, noise, sqrt_ac_t, sqrt_1mac_t):
    """Forward diffusion: x_t = sqrt(abar_t) x0 + sqrt(1-abar_t) eps."""
    return sqrt_ac_t * x0 + sqrt_1mac_t * noise


def v_from_eps_x0(x0, noise, sqrt_ac_t, sqrt_1mac_t):
    """v-parameterization target: v = sqrt(abar) eps - sqrt(1-abar) x0."""
    return sqrt_ac_t * noise - sqrt_1mac_t * x0


def x0_from_v(x_t, v, sqrt_ac_t, sqrt_1mac_t):
    return sqrt_ac_t * x_t - sqrt_1mac_t * v


def eps_from_v(x_t, v, sqrt_ac_t, sqrt_1mac_t):
    return sqrt_ac_t * v + sqrt_1mac_t * x_t


def x0_from_eps(x_t, eps, sqrt_ac_t, sqrt_1mac_t):
    return (x_t - sqrt_1mac_t * eps) / torch.clamp(torch.as_tensor(sqrt_ac_t), min=1e-8)


def append_dims(x, target_ndim):
    return x.reshape(tuple(x.shape) + (1,) * (target_ndim - x.dim()))
