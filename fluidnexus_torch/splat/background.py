"""Static background 3D-Gaussian model with the densify/clone/split/prune
lifecycle (counterpart of ``fluidnexus_tpu/splat/background.py``; reference
``gm_background.py``, GaussianModel :1-476).

As in the JAX package, and unlike the reference:
- a static ``capacity`` with an ``alive`` mask instead of torch.cat growth
  and boolean-index shrinking (reference densification_postfix:349,
  prune_points:286): new rows are masked writes into dead slots, so the
  slots, and every later step, match the JAX package's, and the rasterizer's
  launches keep their shapes from step to step;
- the reference's "optimizer surgery" (zeroing the Adam moments of new
  rows, :271-347) is a masked write into the moments of the written slots;
- a raw RGB ``color`` (no SH): constant 0.7 at init, log-scale -5.9,
  opacity 0.1 (create_from_pcd:115-134).

``densify_and_prune`` takes its two normal draws as an argument
(``densify_noise`` draws them from a ``torch.Generator``), so a test can
hand it the JAX package's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from fluidnexus_torch.utils.maths import inv_sigmoid, normalize

TRAINABLE = ("xyz", "color", "scaling", "rotation", "opacity")
MAX_NEW = 4096   # clones + splits one densify writes at most; the rest count as dropped


class BackgroundModel(NamedTuple):
    xyz: torch.Tensor        # (C,3)
    color: torch.Tensor      # (C,3) raw RGB (no activation)
    scaling: torch.Tensor    # (C,3) log-scale
    rotation: torch.Tensor   # (C,4) unnormalized quaternion
    opacity: torch.Tensor    # (C,1) pre-sigmoid
    alive: torch.Tensor      # (C,) bool
    max_radii2d: torch.Tensor         # (C,)
    xyz_gradient_accum: torch.Tensor  # (C,)
    denom: torch.Tensor               # (C,)

    @property
    def capacity(self):
        return self.xyz.shape[0]

    @property
    def num_alive(self):
        return self.alive.sum()

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        return normalize(self.rotation)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.opacity)


@dataclasses.dataclass(frozen=True)
class BackgroundParams:
    """Optimization constants (ref arguments/__init__.py OptimizationParams
    background fields + gm_background defaults)."""

    capacity: int = 120_000
    percent_dense: float = 0.01
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    color_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    init_color: float = 0.7
    init_scaling: float = -5.9
    init_opacity: float = 0.1


def _f32(x, device):
    """A float32 0-d tensor: the JAX package's jitted arithmetic on python
    and numpy scalars runs in float32."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def create_from_points(points, params: BackgroundParams, device="cuda") -> BackgroundModel:
    """Initialize from a point cloud (create_from_pcd, gm_background.py:115-143:
    constant color 0.7, log-scale -5.9, opacity 0.1, identity rotation)."""
    n, cap = points.shape[0], params.capacity
    if n > cap:
        raise ValueError(f"{n} initial points do not fit the background capacity {cap}")
    f = torch.float32

    def padded(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=f, device=device)
        out[:n] = x
        return out

    rotation = torch.zeros((cap, 4), dtype=f, device=device)
    rotation[:, 0] = 1.0
    op0 = float(inv_sigmoid(_f32(params.init_opacity, "cpu")))
    return BackgroundModel(
        xyz=padded(torch.as_tensor(np.asarray(points, np.float32), device=device)),
        color=padded(torch.full((n, 3), params.init_color, dtype=f, device=device)),
        scaling=padded(torch.full((n, 3), params.init_scaling, dtype=f, device=device)),
        rotation=rotation,
        opacity=padded(torch.full((n, 1), op0, dtype=f, device=device)),
        alive=torch.arange(cap, device=device) < n,
        max_radii2d=torch.zeros((cap,), dtype=f, device=device),
        xyz_gradient_accum=torch.zeros((cap,), dtype=f, device=device),
        denom=torch.zeros((cap,), dtype=f, device=device),
    )


def add_densification_stats(model: BackgroundModel, xy_grad, radii) -> BackgroundModel:
    """Accumulate screen-space mean-grad norms for visible Gaussians
    (add_densification_stats, gm_background.py:472-476 + max_radii2D update
    in train_background.py)."""
    visible = (radii > 0) & model.alive
    gnorm = torch.linalg.vector_norm(xy_grad, dim=-1)
    return model._replace(
        xyz_gradient_accum=torch.where(visible, model.xyz_gradient_accum + gnorm,
                                       model.xyz_gradient_accum),
        denom=torch.where(visible, model.denom + 1.0, model.denom),
        max_radii2d=torch.where(visible, torch.maximum(model.max_radii2d, radii.to(torch.float32)),
                                model.max_radii2d),
    )


def _write_rows(model: BackgroundModel, rows: dict, slots, mask) -> BackgroundModel:
    """Masked scatter of per-field rows into the given slots."""
    upd = {}
    for k, v in rows.items():
        field = getattr(model, k)
        sel = mask.reshape((-1,) + (1,) * (v.ndim - 1))
        out = field.clone()
        out[slots] = torch.where(sel, v, field[slots])
        upd[k] = out
    for k, fill in (("alive", None), ("max_radii2d", 0.0), ("xyz_gradient_accum", 0.0),
                    ("denom", 0.0)):
        field = getattr(model, k)
        out = field.clone()
        out[slots] = (mask | field[slots]) if fill is None else torch.where(
            mask, torch.zeros_like(field[slots]), field[slots])
        upd[k] = out
    return model._replace(**upd)


def densify_noise(generator: torch.Generator, max_new: int, device) -> torch.Tensor:
    """The (2, max_new, 3) standard normals one ``densify_and_prune`` call
    takes: the split children's offsets, then the resampled parents'."""
    return torch.randn((2, max_new, 3), generator=generator, device=device)


def _quat_to_rotmat(q):
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


@torch.no_grad()
def densify_and_prune(model: BackgroundModel, opt_mu: dict, opt_nu: dict, noise,
                      grad_threshold, min_opacity, extent, max_screen_size, percent_dense,
                      max_new: int = MAX_NEW):
    """One densification step (densify_and_prune, gm_background.py:418-447):
    clone small high-grad Gaussians, split large high-grad ones (N=2, sampled
    inside the parent, scale/1.6), then prune transparent/huge ones.

    At most ``max_new`` clones + splits a call, the highest grads first
    (a stable sort: ties keep slot order); candidates that find no dead slot
    count as ``dropped``. ``noise`` is ``densify_noise``'s (2, max_new', 3),
    max_new' = min(max_new, capacity). The Adam moments ``opt_mu``/``opt_nu``
    (dicts over ``TRAINABLE``) are zeroed in the written slots only, as the
    JAX package's code does (its comment also names the split parents, which
    it leaves alone). Returns (model, opt_mu, opt_nu, stats)."""
    dev = model.xyz.device
    max_new = min(max_new, model.capacity)
    if tuple(noise.shape) != (2, max_new, 3):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected (2, {max_new}, 3)")
    grads = torch.where(model.denom > 0, model.xyz_gradient_accum / model.denom,
                        torch.zeros_like(model.denom))
    scal = model.get_scaling
    max_scale = scal.max(-1).values
    dense_limit = _f32(percent_dense, dev) * _f32(extent, dev)

    high = (grads >= _f32(grad_threshold, dev)) & model.alive
    clone_mask = high & (max_scale <= dense_limit)
    split_mask = high & (max_scale > dense_limit)

    # rank candidates by grad so the cap keeps the most-demanding ones
    cand_mask = clone_mask | split_mask
    score = torch.where(cand_mask, grads, torch.full_like(grads, -1.0))
    src = torch.argsort(-score, stable=True)[:max_new]
    sel = cand_mask[src]
    is_split = split_mask[src]

    # clone: copy row as-is; split: a child sampled inside the parent with
    # its scale / 1.6, and the parent resampled and shrunk in place
    rot = _quat_to_rotmat(normalize(model.rotation[src]))
    offset = torch.einsum("nij,nj->ni", rot, noise[0] * scal[src])
    child_scaling = torch.log(torch.clamp(scal[src] / 1.6, min=1e-12))
    split_col = is_split[:, None]
    new_rows = dict(
        xyz=torch.where(split_col, model.xyz[src] + offset, model.xyz[src]),
        color=model.color[src],
        scaling=torch.where(split_col, child_scaling, model.scaling[src]),
        rotation=model.rotation[src],
        opacity=model.opacity[src],
    )
    parent_xyz = model.xyz[src] + torch.einsum("nij,nj->ni", rot, noise[1] * scal[src])
    moved = (is_split & sel)[:, None]
    xyz, scaling = model.xyz.clone(), model.scaling.clone()
    xyz[src] = torch.where(moved, parent_xyz, model.xyz[src])
    scaling[src] = torch.where(moved, child_scaling, model.scaling[src])
    model = model._replace(xyz=xyz, scaling=scaling)

    slots = torch.argsort(model.alive.to(torch.int32), stable=True)[:max_new]
    num_dead = model.capacity - model.alive.sum()
    rank = torch.cumsum(sel.to(torch.int32), 0) - 1
    fits = sel & (rank < num_dead)
    model = _write_rows(model, new_rows, slots, fits)

    def zero_rows(tree):
        out = {}
        for k, leaf in tree.items():
            leaf = leaf.clone()
            sel_k = fits.reshape((-1,) + (1,) * (leaf.ndim - 1))
            leaf[slots] = torch.where(sel_k, torch.zeros_like(leaf[slots]), leaf[slots])
            out[k] = leaf
        return out

    opt_mu, opt_nu = zero_rows(opt_mu), zero_rows(opt_nu)

    # prune (gm_background.py:425-431)
    prune = (model.get_opacity[:, 0] < _f32(min_opacity, dev)) & model.alive
    if max_screen_size > 0:
        big_vs = model.max_radii2d > _f32(max_screen_size, dev)
        big_ws = model.get_scaling.max(-1).values > _f32(0.1, dev) * _f32(extent, dev)
        prune = prune | big_vs | big_ws
    zeros = torch.zeros_like(model.denom)
    model = model._replace(alive=model.alive & ~prune, xyz_gradient_accum=zeros,
                           denom=zeros.clone(), max_radii2d=zeros.clone())
    stats = dict(cloned=(fits & ~is_split).sum(), split=(fits & is_split).sum(),
                 pruned=prune.sum(), dropped=sel.sum() - fits.sum())
    return model, opt_mu, opt_nu, stats


@torch.no_grad()
def reset_opacity(model: BackgroundModel) -> BackgroundModel:
    """Clamp opacity to <= 0.01 (reset_opacity, gm_background.py:231-234)."""
    return model._replace(opacity=inv_sigmoid(torch.clamp(model.get_opacity, max=0.01)))


@torch.no_grad()
def prune_near_points(model: BackgroundModel, valid_min_y, valid_max_z,
                      object_center=None, object_radius=None) -> BackgroundModel:
    """Domain prune (prune_near_points, gm_background.py:449-458)."""
    dev = model.xyz.device
    prune = (model.xyz[:, 2] > _f32(valid_max_z, dev)) & (model.xyz[:, 1] > _f32(valid_min_y, dev))
    if object_center is not None:
        center = torch.as_tensor(object_center, dtype=torch.float32, device=dev)
        outside = torch.sum((model.xyz - center) ** 2, -1) > _f32(object_radius, dev) ** 2
        prune = prune & outside
    return model._replace(alive=model.alive & ~prune)


@torch.no_grad()
def prune_near_cam_points(model: BackgroundModel, cam_locations, smoke_location) -> BackgroundModel:
    """Prune Gaussians nearer to any camera than the smoke is
    (prune_near_cam_points, gm_background.py:460-465)."""
    dev = model.xyz.device
    cams = torch.as_tensor(np.asarray(cam_locations), dtype=torch.float32, device=dev)
    smoke = torch.as_tensor(np.asarray(smoke_location), dtype=torch.float32,
                            device=dev).reshape(1, 3)
    smoke_d = torch.linalg.vector_norm(smoke[:, None] - cams[None], dim=-1)   # (1,M)
    d = torch.linalg.vector_norm(model.xyz[:, None] - cams[None], dim=-1)     # (C,M)
    near = torch.any(d < smoke_d, dim=1)
    return model._replace(alive=model.alive & ~near)


@torch.no_grad()
def prune_large_points(model: BackgroundModel, threshold=0.03) -> BackgroundModel:
    """(prune_large_points, gm_background.py:467-470)"""
    large = model.get_scaling.max(-1).values > _f32(threshold, model.xyz.device)
    return model._replace(alive=model.alive & ~large)
