"""Differentiable tile-based 3D Gaussian rasterizer (counterpart of
``fluidnexus_tpu/ops/rasterizer.py``).

Replaces the reference CUDA extensions ``gaussian_rasterization_ch3`` /
``gaussian_rasterization_ch1`` (forward.cu / backward.cu /
rasterizer_impl.cu), with the JAX package's static-capacity semantics:

- ``project_gaussians``: EWA 2D covariance with the 1.3*tan_fov frustum clamp
  and the +0.3 low-pass, radius = ceil(3*sqrt(max eigenvalue));
- ``_build_tile_lists``: each Gaussian is duplicated into at most
  dup_x*dup_y tiles, slots are sorted by (tile, depth) and each tile keeps
  its front-most ``tile_capacity`` slots as a live prefix;
- compositing (``rasterizer_cuda``): alpha = min(.99, op*exp(power)),
  skipped when power > 0 or alpha < 1/255; contributions are masked once
  T < 1e-4 while T keeps falling; median depth starts at 15 and is set where
  T crosses 0.5; out = accum + T*bg.

Projection, tile lists and sorting are plain torch ops. The compositor and
the gradient combine are the hand-written kernels of ``rasterizer_cuda`` on
the card and their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from fluidnexus_torch.ops.rasterizer_cuda import composite, gather_rows


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    tile_x: int = 16
    tile_y: int = 16
    dup_x: int = 4            # max tiles a Gaussian may span horizontally
    dup_y: int = 4            # ... vertically (D = dup_x * dup_y dup slots)
    tile_capacity: int = 256  # max Gaussians composited per tile (front-most K)
    chunk: int = 32           # slots per step of the plain compositor
    near: float = 0.2         # frustum near-cull plane (auxiliary.h in_frustum)


class Projected(NamedTuple):
    xy: torch.Tensor        # (N,2) pixel-space means
    conic: torch.Tensor     # (N,3) inverse 2D covariance (a,b,c)
    depth: torch.Tensor     # (N,) view-space z
    radius: torch.Tensor    # (N,) screen-space radius in pixels (0 = culled)
    valid: torch.Tensor     # (N,) bool


class RasterOutput(NamedTuple):
    color: torch.Tensor     # (C,H,W)
    depth: torch.Tensor     # (H,W) median depth
    final_t: torch.Tensor   # (H,W) final transmittance
    radii: torch.Tensor     # (N,) int32 screen radii


def project_gaussians(means3d, scales, rotations, view_matrix, proj_matrix, tan_fovx, tan_fovy,
                      width, height, near=0.2, alive=None, xy_offset=None):
    """World -> screen, per Gaussian (preprocessCUDA, forward.cu:149-248).
    ``view_matrix``/``proj_matrix`` are (4,4) in the row-vector convention;
    ``tan_fovx``/``tan_fovy`` are floats or 0-d tensors. ``xy_offset``, an
    (N, 2) zero tensor, is added to the pixel-space means: its gradient is
    the screen-space mean gradient that densification accumulates (the
    reference's dummy means2D tensor, pipe_dynamics.py:60-66)."""
    f32 = torch.float32
    mt = means3d.to(f32).T
    mx, my, mz = mt[0], mt[1], mt[2]
    vm = view_matrix.to(f32)
    pvx = mx * vm[0, 0] + my * vm[1, 0] + mz * vm[2, 0] + vm[3, 0]
    pvy = mx * vm[0, 1] + my * vm[1, 1] + mz * vm[2, 1] + vm[3, 1]
    tz = mx * vm[0, 2] + my * vm[1, 2] + mz * vm[2, 2] + vm[3, 2]
    in_front = tz > near

    pm = proj_matrix.to(f32)
    hx = mx * pm[0, 0] + my * pm[1, 0] + mz * pm[2, 0] + pm[3, 0]
    hy = mx * pm[0, 1] + my * pm[1, 1] + mz * pm[2, 1] + pm[3, 1]
    hw = mx * pm[0, 3] + my * pm[1, 3] + mz * pm[2, 3] + pm[3, 3]
    p_w = 1.0 / (hw + 1e-7)

    # world-space covariance Sigma = R diag(s^2) R^T (computeCov3D,
    # forward.cu:116-149; quat convention general_utils.py:113)
    st = scales.to(f32).T
    s0, s1, s2 = st[0] ** 2, st[1] ** 2, st[2] ** 2
    qt = rotations.to(f32).T
    qr, qx, qy, qz = qt[0], qt[1], qt[2], qt[3]
    qn = torch.rsqrt(torch.clamp(qr * qr + qx * qx + qy * qy + qz * qz, min=1e-24))
    qr, qx, qy, qz = qr * qn, qx * qn, qy * qn, qz * qn
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qr * qz)
    r02 = 2 * (qx * qz + qr * qy)
    r10 = 2 * (qx * qy + qr * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qr * qx)
    r20 = 2 * (qx * qz - qr * qy)
    r21 = 2 * (qy * qz + qr * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    c00 = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    c01 = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    c02 = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    c11 = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    c12 = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    c22 = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22

    # EWA: cov2d = J R Sigma R^T J^T with the perspective Jacobian at the
    # frustum-clamped view point (computeCov2D, forward.cu:71-112)
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(pvx / tz_safe, -limx, limx) * tz
    ty = torch.clamp(pvy / tz_safe, -limy, limy) * tz

    z2 = tz_safe * tz_safe
    j00 = focal_x / tz_safe
    j02 = -(focal_x * tx) / z2
    j11 = focal_y / tz_safe
    j12 = -(focal_y * ty) / z2
    w00, w01, w02 = vm[0, 0], vm[1, 0], vm[2, 0]   # world->cam rotation, row 0
    w10, w11, w12 = vm[0, 1], vm[1, 1], vm[2, 1]
    w20, w21, w22 = vm[0, 2], vm[1, 2], vm[2, 2]
    a0 = j00 * w00 + j02 * w20
    a1 = j00 * w01 + j02 * w21
    a2 = j00 * w02 + j02 * w22
    b0 = j11 * w10 + j12 * w20
    b1 = j11 * w11 + j12 * w21
    b2 = j11 * w12 + j12 * w22
    sa0 = c00 * a0 + c01 * a1 + c02 * a2
    sa1 = c01 * a0 + c11 * a1 + c12 * a2
    sa2 = c02 * a0 + c12 * a1 + c22 * a2
    cxx = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3
    cxy = b0 * sa0 + b1 * sa1 + b2 * sa2
    cyy = (b0 * (c00 * b0 + c01 * b1 + c02 * b2)
           + b1 * (c01 * b0 + c11 * b1 + c12 * b2)
           + b2 * (c02 * b0 + c12 * b1 + c22 * b2) + 0.3)

    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    det_inv = 1.0 / det_safe
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)

    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    px = ((hx * p_w + 1.0) * width - 1.0) * 0.5
    py = ((hy * p_w + 1.0) * height - 1.0) * 0.5
    xy = torch.stack([px, py], -1)
    if xy_offset is not None:
        xy = xy + xy_offset

    valid = in_front & (torch.abs(det) > 0.0) & (radius > 0.0)
    if alive is not None:
        valid = valid & alive
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(xy=xy, conic=conic, depth=tz, radius=radius, valid=valid)


def _tile_rects(proj: Projected, cfg: RasterizerConfig, tiles_x, tiles_y):
    """Tile bounding rects per Gaussian, clamped to dup_x x dup_y around the
    center tile (getRect, auxiliary.h:43-50 + static-capacity clamp)."""
    px, py, r = proj.xy[:, 0], proj.xy[:, 1], proj.radius
    i32 = torch.int32
    xmin = torch.clamp(torch.floor((px - r) / cfg.tile_x), 0, tiles_x).to(i32)
    xmax = torch.clamp(torch.floor((px + r + cfg.tile_x - 1) / cfg.tile_x), 0, tiles_x).to(i32)
    ymin = torch.clamp(torch.floor((py - r) / cfg.tile_y), 0, tiles_y).to(i32)
    ymax = torch.clamp(torch.floor((py + r + cfg.tile_y - 1) / cfg.tile_y), 0, tiles_y).to(i32)
    cx = torch.clamp((px / cfg.tile_x).to(i32), 0, tiles_x - 1)
    cy = torch.clamp((py / cfg.tile_y).to(i32), 0, tiles_y - 1)
    w = xmax - xmin
    h = ymax - ymin
    # clamp(v, lo, hi) as jnp.clip does it: min(max(v, lo), hi)
    xmin = torch.where(w > cfg.dup_x,
                       torch.minimum(torch.maximum(cx - cfg.dup_x // 2, xmin), xmax - cfg.dup_x), xmin)
    ymin = torch.where(h > cfg.dup_y,
                       torch.minimum(torch.maximum(cy - cfg.dup_y // 2, ymin), ymax - cfg.dup_y), ymin)
    w = torch.clamp(w, max=cfg.dup_x)
    h = torch.clamp(h, max=cfg.dup_y)
    return xmin, ymin, w, h


def _build_tile_lists(proj: Projected, cfg: RasterizerConfig, tiles_x: int, tiles_y: int,
                      opacities):
    """Duplicate Gaussians into tile slots, sort by (tile, depth), and cut the
    per-tile front-most K lists (duplicateWithKeys + radix sort +
    identifyTileRanges, rasterizer_impl.cu:67-133).

    Tight culling (the JAX package's default ``tight_cull=True``) drops a
    (gaussian, tile) slot when even the largest alpha over the tile stays
    below 1/255 (power <= -d^2 / (2*lam1), d the distance to the tile rect),
    which the per-pixel test would skip anyway. ``opacities`` is the
    activated opacity, (N,).

    Returns ``tile_gauss`` (T, K) int64 Gaussian ids and ``counts`` (T,) int32:
    slot k of tile t is live iff k < counts[t]. Dead slots hold valid but
    meaningless ids."""
    n = proj.xy.shape[0]
    d = cfg.dup_x * cfg.dup_y
    num_tiles = tiles_x * tiles_y
    dev = proj.xy.device

    xmin, ymin, w, h = _tile_rects(proj, cfg, tiles_x, tiles_y)
    slot = torch.arange(d, dtype=torch.int32, device=dev)
    dx = slot % cfg.dup_x
    dy = slot // cfg.dup_x
    in_rect = (dx[None, :] < w[:, None]) & (dy[None, :] < h[:, None]) & proj.valid[:, None]
    tx0 = (xmin[:, None] + dx[None, :]).to(torch.float32) * cfg.tile_x
    ty0 = (ymin[:, None] + dy[None, :]).to(torch.float32) * cfg.tile_y
    px = proj.xy[:, 0:1]
    py = proj.xy[:, 1:2]
    zero = torch.zeros((), device=dev)
    ddx = torch.maximum(torch.maximum(tx0 - px, px - (tx0 + cfg.tile_x)), zero)
    ddy = torch.maximum(torch.maximum(ty0 - py, py - (ty0 + cfg.tile_y)), zero)
    lam1 = (proj.radius[:, None] / 3.0) ** 2
    thresh = 2.0 * torch.clamp(torch.log(255.0 * opacities[:, None]), min=0.0) * lam1
    in_rect = in_rect & (ddx * ddx + ddy * ddy <= thresh)
    tile = (ymin[:, None] + dy[None, :]).to(torch.int64) * tiles_x + (xmin[:, None] + dx[None, :])
    tile = torch.where(in_rect, tile, torch.full_like(tile, num_tiles))

    # one int64 key (tile, depth rank): keys are unique, so the sort order is
    # the JAX package's stable (tile, depth) lexsort
    n_pow2 = 1 << max(1, (n - 1).bit_length())
    depth_rank = torch.empty((n,), dtype=torch.int64, device=dev)
    depth_rank[torch.argsort(proj.depth, stable=True)] = torch.arange(n, device=dev)
    key = (tile * n_pow2 + depth_rank[:, None]).reshape(-1)
    sorted_key, perm = torch.sort(key)
    sorted_gidx = perm // d

    queries = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) * n_pow2
    bounds = torch.searchsorted(sorted_key, queries, side="left")
    starts, ends = bounds[:-1], bounds[1:]
    k = cfg.tile_capacity
    pos = starts[:, None] + torch.arange(k, device=dev)[None, :]
    tile_gauss = sorted_gidx[torch.clamp(pos, max=n * d - 1)]
    counts = torch.clamp(ends - starts, max=k).to(torch.int32)
    return tile_gauss, counts


class Tiles(NamedTuple):
    proj: Projected
    packed: torch.Tensor    # (T,K,7+C) per-slot rows [xy|conic|opacity|color|depth]
    gauss: torch.Tensor     # (T,K) int64 Gaussian id of each slot
    counts: torch.Tensor    # (T,) int32 live prefix of each tile
    tiles_x: int
    tiles_y: int


def tile_packed(means3d, colors, opacities, scales, rotations, alive=None, *,
                view_matrix, proj_matrix, tan_fovx, tan_fovy, width: int, height: int,
                config: RasterizerConfig = RasterizerConfig(), xy_offset=None) -> Tiles:
    """Project, build the tile lists and gather one packed row per tile slot:
    the inputs of the compositor's kernels. ``opacities`` is the activated
    opacity, (N,) or (N,1)."""
    cfg = config
    opacities = opacities.reshape(-1)
    tiles_x = -(-width // cfg.tile_x)
    tiles_y = -(-height // cfg.tile_y)

    with record_function("fnx.project"):
        proj = project_gaussians(means3d, scales, rotations, view_matrix, proj_matrix,
                                 tan_fovx, tan_fovy, width, height, cfg.near, alive, xy_offset)
    with torch.no_grad(), record_function("fnx.tile_lists"):
        tile_gauss, counts = _build_tile_lists(
            Projected(*(t.detach() for t in proj)), cfg, tiles_x, tiles_y,
            opacities=opacities.detach())

    # one packed row per Gaussian, gathered once per tile slot; its gradient
    # comes back as one packed row too
    with record_function("fnx.gather"):
        packed = torch.cat([proj.xy, proj.conic, opacities[:, None], colors.to(torch.float32),
                            proj.depth.detach()[:, None]], 1)
        rows = gather_rows(packed, tile_gauss, counts)
    return Tiles(proj, rows, tile_gauss, counts, tiles_x, tiles_y)


def rasterize(means3d, colors, opacities, scales, rotations, alive=None, *,
              view_matrix, proj_matrix, tan_fovx, tan_fovy, width: int, height: int,
              bg_color, config: RasterizerConfig = RasterizerConfig(), xy_offset=None):
    """Render Gaussians to an image: RasterOutput(color (C,H,W), depth,
    final_t, radii). Differentiable w.r.t. means3d / colors / opacities /
    scales / rotations; the tile ordering and depth are constants, as in the
    reference backward. ``opacities`` is the activated opacity, (N,) or (N,1);
    ``alive`` masks padding rows of static-capacity buffers; ``xy_offset``
    (``project_gaussians``) exposes the screen-space mean gradient."""
    cfg = config
    tl = tile_packed(means3d, colors, opacities, scales, rotations, alive,
                     view_matrix=view_matrix, proj_matrix=proj_matrix, tan_fovx=tan_fovx,
                     tan_fovy=tan_fovy, width=width, height=height, config=cfg,
                     xy_offset=xy_offset)
    tiles_x, tiles_y = tl.tiles_x, tl.tiles_y
    with record_function("fnx.composite"):
        accum, t_run, med = composite(tl.packed, tl.counts, tiles_x, cfg.tile_x, cfg.tile_y,
                                      chunk=cfg.chunk)

    h_pad, w_pad = tiles_y * cfg.tile_y, tiles_x * cfg.tile_x

    def untile(img_tcp):  # (T,C,P) -> (C,H,W)
        c = img_tcp.shape[1]
        img = img_tcp.reshape(tiles_y, tiles_x, c, cfg.tile_y, cfg.tile_x)
        img = img.permute(2, 0, 3, 1, 4).reshape(c, h_pad, w_pad)
        return img[:, :height, :width]

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device).reshape(-1, 1, 1)
    final_t = untile(t_run)
    return RasterOutput(
        color=untile(accum) + final_t * bg,
        depth=untile(med)[0],
        final_t=final_t[0],
        radii=tl.proj.radius.to(torch.int32),
    )
