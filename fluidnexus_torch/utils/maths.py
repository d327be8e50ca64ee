"""Math utilities (counterpart of ``fluidnexus_tpu/utils/maths.py``).

Reference: FluidDynamics/utils/general_utils.py, graphics_utils.py. The camera
matrices and the lr schedule are host-side numpy, exactly as in the JAX
package, so both packages build bit-identical camera matrices.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def inv_sigmoid(x):
    """Inverse of the logistic sigmoid (ref: general_utils.py:9)."""
    return torch.log(x / (1.0 - x))


def normalize(v, dim=-1, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True), min=eps)


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1000000):
    """Log-linearly interpolated LR schedule (ref: general_utils.py:63).

    Returns 0 when both lrs are 0. Works on python ints or arrays.
    """
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = np.clip(np.asarray(step, np.float64) / max_steps, 0.0, 1.0)
    log_lerp = np.exp(np.log(max(lr_init, 1e-32)) * (1 - t) + np.log(max(lr_final, 1e-32)) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(np.asarray(step, np.float64) / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = 1.0
    out = delay_rate * log_lerp
    return float(out) if np.ndim(out) == 0 else out


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def get_world_to_view(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """World->camera 4x4 (ref: graphics_utils.py:101 get_world_2_view2).

    R is cam->world rotation (stored transposed by convention), t is w2c
    translation. Returns the classic 3DGS Rt with optional recentering.
    """
    Rt = np.zeros((4, 4), dtype=np.float32)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def get_projection_matrix(znear, zfar, fovx, fovy):
    """OpenGL-style perspective matrix used by 3DGS (ref: graphics_utils.py:38)."""
    return get_projection_matrix_cv(znear, zfar, fovx, fovy)


def get_projection_matrix_cv(znear, zfar, fovx, fovy, cx=0.0, cy=0.0):
    """Perspective matrix with principal-point offset (ref: graphics_utils.py:66);
    with cx = cy = 0 it is the plain 3DGS matrix."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    # principal-point shift moves the frustum window
    cx_shift = cx * (right - left) / 2
    cy_shift = cy * (top - bottom) / 2
    left += cx_shift
    right += cx_shift
    top += cy_shift
    bottom += cy_shift
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P
