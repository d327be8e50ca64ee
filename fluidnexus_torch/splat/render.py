"""Render pipes (counterpart of ``fluidnexus_tpu/splat/render.py``): camera +
model -> image, composing fluid particles with the frozen background splats
(render_dynamics, pipe_dynamics.py:8-180). Gray particle colours are repeated
to 3 channels when composited with the RGB background (pipe_dynamics.py:139-148).
"""
from __future__ import annotations

from typing import Optional

import torch

from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize
from fluidnexus_torch.splat.dynamics import BackgroundSplats, VisualAttrs
from fluidnexus_torch.utils.maths import normalize


def _opacity(pre_sigmoid):
    return torch.clamp(torch.reciprocal(1 + torch.exp(-pre_sigmoid)), 0, 1)[:, 0]


def compose_splats(positions, alive, attrs: VisualAttrs, background: Optional[BackgroundSplats]):
    """Fluid + background splats as one set of rasterizer inputs (means,
    colors, activated opacities, scales, unit rotations, alive)."""
    color = attrs.color
    means, ops = positions, _opacity(attrs.opacity)
    scales, rots = torch.exp(attrs.scales), normalize(attrs.rotation)
    if background is not None:
        if color.shape[-1] == 1:
            color = color.repeat(1, 3)
        means = torch.cat([means, background.xyz], 0)
        color = torch.cat([color, background.color], 0)
        ops = torch.cat([ops, _opacity(background.opacity)], 0)
        scales = torch.cat([scales, torch.exp(background.scaling)], 0)
        rots = torch.cat([rots, normalize(background.rotation)], 0)
        alive = torch.cat([alive, torch.ones((background.n,), dtype=torch.bool,
                                             device=alive.device)], 0)
    return means, color, ops, scales, rots, alive


def render_particles_with_background(
    positions,                  # (N,3) fluid particle positions (world units)
    alive,                      # (N,)
    attrs: VisualAttrs,         # appearance (color (N,1) or (N,3))
    background: Optional[BackgroundSplats],
    *,
    view_matrix, proj_matrix, tan_fovx, tan_fovy, width: int, height: int,
    bg_color, config: RasterizerConfig,
):
    """The render_dynamics compose path: concat fluid + background splats into
    one rasterize call (pipe_dynamics.py:51-57,139-154)."""
    means, color, ops, scales, rots, alive = compose_splats(positions, alive, attrs, background)
    return rasterize(
        means, color, ops, scales, rots, alive=alive,
        view_matrix=view_matrix, proj_matrix=proj_matrix,
        tan_fovx=tan_fovx, tan_fovy=tan_fovy, width=width, height=height,
        bg_color=bg_color, config=config,
    )


def to_gray(img):
    """Channel mean, kept single-channel: L1/SSIM of two ``to_gray3`` images
    equal those of the 1-channel means, at a third of the cost."""
    return img.mean(dim=0, keepdim=True)


def to_gray3(img):
    """Channel mean repeated x3 — the smoke losses compare gray images
    (train_physical_particle.py:127-133)."""
    return to_gray(img).repeat(3, 1, 1)
