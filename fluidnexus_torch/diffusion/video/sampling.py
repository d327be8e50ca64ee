"""Video diffusion sampling: ZeroSNR discretization, v-pred denoiser,
VP-SDE DPM-Solver++(2M) with SDEdit entry and prefix clamping, DynamicCFG
guidance (counterpart of ``fluidnexus_tpu/diffusion/video/sampling.py``).

Noise comes from an explicit ``torch.Generator``, drawn in the JAX sampler's
order: per step the SDEdit noise (only at ``sdedit_index``), then the step
noise (every step but the last). A test can therefore replay the same draws
into the JAX sampler.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from fluidnexus_torch.diffusion.schedules import DiffusionSchedule, append_dims


def zero_snr_alphas_sqrt(num_steps: int, num_timesteps: int = 1000,
                         linear_start: float = 0.00085, linear_end: float = 0.012,
                         shift_scale: float = 1.0):
    """sqrt(alpha_cumprod) for ``num_steps`` sampling steps, SNR-shifted and
    rescaled to zero terminal SNR, index 0 the noisiest, with 1.0 appended;
    and the matching timestep ids, with -1 appended."""
    sched = DiffusionSchedule.create(num_timesteps, linear_start, linear_end)
    ac = sched.alphas_cumprod
    ac = ac / (shift_scale + (1 - shift_scale) * ac)  # SNR shift
    if num_steps < num_timesteps:
        timesteps = np.linspace(num_timesteps - 1, 0, num_steps, endpoint=False).astype(int)[::-1]
        ac = ac[timesteps]
    else:
        timesteps = np.arange(num_timesteps)
    s = np.sqrt(ac)
    s0, sT = s[0], s[-1]
    s = (s - sT) * s0 / (s0 - sT)
    alpha_sqrt = s[::-1].copy()
    t_ids = timesteps[::-1].copy()
    return np.concatenate([alpha_sqrt, [1.0]]), np.concatenate([t_ids, [-1]]).astype(np.int32)


@dataclasses.dataclass
class VDenoiser:
    """v-prediction -> x0: the network sees x_t and the discrete timestep;
    denoised = sqrt(abar) x_t - sqrt(1-abar) v, the coefficients in f32."""

    apply_fn: Callable  # (latents, t, cond) -> v

    def __call__(self, x, alpha_sqrt, t_idx, cond):
        a = torch.as_tensor(alpha_sqrt, dtype=torch.float32, device=x.device)
        sigma = torch.sqrt(1.0 - a**2)
        t = torch.as_tensor(t_idx, dtype=torch.int32, device=x.device).reshape(-1).expand(x.shape[0])
        v = self.apply_fn(x, t, cond)
        return append_dims(a, x.dim()) * x - append_dims(sigma, x.dim()) * v


@dataclasses.dataclass
class DynamicCFG:
    """Guidance scale ramped as 1 + scale (1 - cos(pi (step/num)^exp)) / 2."""

    scale: float = 6.0
    exp: float = 5.0
    num_steps: int = 50

    def __call__(self, x_uncond, x_cond, step_index):
        s = 1 + self.scale * (1 - math.cos(math.pi * (float(step_index) / self.num_steps) ** self.exp)) / 2
        return x_uncond + s * (x_cond - x_uncond)


def _denoise_cfg(denoiser, guider, x, alpha_sqrt, t_idx, cond, uc, step_index,
                 data_group=None):
    if uc is None:
        return denoiser(x, alpha_sqrt, t_idx, cond)
    if data_group is not None and dist.get_world_size(data_group) == 2:
        # the CFG pair split over 'data': rank 0 runs the cond half, rank 1
        # the uncond half, then both halves are gathered on both
        d = denoiser(x, alpha_sqrt, t_idx, uc if dist.get_rank(data_group) else cond)
        dc, du = torch.empty_like(d), torch.empty_like(d)
        dist.all_gather([dc, du], d.contiguous(), group=data_group)
        return guider(du, dc, step_index)
    # one batch-2 forward for cond and uncond; the DiT has no cross-batch ops
    d = denoiser(torch.cat([x, x], 0), alpha_sqrt, t_idx, torch.cat([cond, uc], 0))
    dc, du = torch.chunk(d, 2, 0)
    return guider(du, dc, step_index)


def _normal(shape, generator, device):
    """One draw of standard normal noise (the sampler's only source of it)."""
    return torch.randn(tuple(shape), generator=generator, device=device)


def _lam(a_sq):
    """lambda = log(alpha / sigma), clamped where alpha = 0 (zero SNR)."""
    return math.log(max(math.sqrt(a_sq**2 / max(1 - a_sq**2, 1e-12)), 1e-20))


def sample_dpmpp2m_sde(
    denoiser,
    x,
    cond,
    uc=None,
    num_steps=50,
    guider=None,
    rng: Optional[torch.Generator] = None,
    num_timesteps=1000,
    frames_z=None,
    sdedit_strength: Optional[float] = None,
    prefix_clean_frames=None,
    fixed_frames: int = 0,
    data_group=None,
):
    """VP-SDE DPM-Solver++(2M). ``frames_z`` + ``sdedit_strength``: start
    from noised input latents at sdedit_index = round(steps (1 - strength)).
    ``prefix_clean_frames``: re-pasted over the first frames at every step.
    ``fixed_frames``: the first latents of ``x`` pasted back at every step
    (the engine's prefix-i2v frames).
    ``rng`` is the torch.Generator every draw comes from. ``data_group``, a
    group of 2 ranks, splits each CFG pair's forward over them."""
    if rng is None:
        raise ValueError("the stochastic sampler needs a torch.Generator (rng)")
    alpha_sqrt, t_ids = zero_snr_alphas_sqrt(num_steps, num_timesteps)
    guider = guider or DynamicCFG(num_steps=num_steps)
    num_sigmas = num_steps + 1

    sdedit_index = 0
    if frames_z is not None and sdedit_strength is not None and 0.0 <= sdedit_strength <= 1.0:
        sdedit_index = max(round((num_sigmas - 1) * (1.0 - sdedit_strength)), 0)

    prefix_frames = x[:, :fixed_frames] if fixed_frames > 0 else None
    cur_fix = prefix_clean_frames.shape[1] if prefix_clean_frames is not None else 0

    old_denoised = None
    for i in range(num_steps):
        if i < sdedit_index:
            continue
        a = float(alpha_sqrt[i])
        a_next = float(alpha_sqrt[i + 1])

        if prefix_frames is not None:
            x = torch.cat([prefix_frames, x[:, fixed_frames:]], 1)

        if sdedit_index > 0 and i == sdedit_index:
            noise = _normal(frames_z.shape, rng, x.device)
            x = a * frames_z + noise * math.sqrt(1 - a**2)

        if prefix_clean_frames is not None:
            x = torch.cat([prefix_clean_frames, x[:, cur_fix:]], 1)

        denoised = _denoise_cfg(denoiser, guider, x, a, t_ids[i], cond, uc, num_steps - i,
                                data_group)
        if num_steps - i == 1:
            x, old_denoised = denoised, denoised
            continue

        # DPM-Solver++(2M) SDE in lambda = log(alpha/sigma) space
        h = _lam(a_next) - _lam(a)
        mult1 = math.sqrt((1 - a_next**2) / max(1 - a**2, 1e-12)) * math.exp(-h)
        mult2 = math.expm1(-2 * h) * a_next
        mult_noise = math.sqrt(1 - a_next**2) * math.sqrt(max(1 - math.exp(-2 * h), 0.0))
        noise = _normal(x.shape, rng, x.device)

        if old_denoised is None or a_next < 1e-14:
            x = mult1 * x - mult2 * denoised + mult_noise * noise
        else:
            r = (_lam(a) - _lam(float(alpha_sqrt[i - 1]))) / h
            denoised_d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
            x = mult1 * x - mult2 * denoised_d + mult_noise * noise
        old_denoised = denoised

    if prefix_frames is not None:
        x = torch.cat([prefix_frames, x[:, fixed_frames:]], 1)
    if prefix_clean_frames is not None:
        x = torch.cat([prefix_clean_frames, x[:, cur_fix:]], 1)
    return x
