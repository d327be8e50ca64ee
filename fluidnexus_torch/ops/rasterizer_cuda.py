"""The tile rasterizer's three kernels: wrappers, plain versions, autograd
Functions and launch counts (counterpart of
``fluidnexus_tpu/ops/rasterizer_pallas.py``; kernels in ``csrc/rasterizer.cu``).

Interface, as in the JAX package: ONE packed per-tile tensor ``(T, K, F)``,
F = 7 + C, rows ``[xy | conic | opacity | color | depth]`` depth-sorted per
tile, with ``counts`` (T,) int32: slot k of tile t is live iff k < counts[t].

- ``composite`` — forward kernel ``composite_fwd`` and backward kernel
  ``composite_bwd`` behind ``_CompositeFn``; plain version
  ``composite_plain`` (its gradient: autograd through it).
- ``gather_rows`` — ``packed[idx]`` whose backward is the kernel
  ``combine_rows`` (``out[gid] += g`` over live slots); plain version
  ``combine_plain``.

On a CPU tensor the wrappers take the plain versions. On a CUDA tensor they
launch the kernel or raise; no CUDA tensor reaches a plain version through
them. Each kernel launch adds one to its entry in ``LAUNCHES``.

Tiles the card takes (``check_tile``): every tile of at least one pixel, any
number of them, as on the CPU. A tile of more than ``BLOCK_P`` pixels runs
as chunks of ``BLOCK_P``, a block each; the backward then sums each slot's
chunks in a small second pass (``chunk_sum_kernel``), in chunk order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fluidnexus_torch.ops import cuda_build

CKPT = 32  # slots between the forward's saved transmittances (csrc/rasterizer.cu)
BLOCK_P = 1024  # most pixels one block of the forward or the backward takes
BWD_PPT = 2  # adjacent pixels a thread of the backward kernel owns

LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "combine_rows": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("rasterizer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fnx_ckpt_interval.argtypes = []
    lib.fnx_ckpt_interval.restype = i
    lib.fnx_composite_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.fnx_composite_fwd.restype = i
    lib.fnx_composite_bwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.fnx_composite_bwd.restype = i
    lib.fnx_combine_rows.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.fnx_combine_rows.restype = i
    lib.fnx_raster_limits.argtypes = [p]
    lib.fnx_raster_limits.restype = None
    lib.fnx_raster_occupancy.argtypes = [i, i, i, p]
    lib.fnx_raster_occupancy.restype = i
    limits = (ctypes.c_int * 2)()
    lib.fnx_raster_limits(limits)
    if lib.fnx_ckpt_interval() != CKPT or tuple(limits) != (BLOCK_P, BWD_PPT):
        raise RuntimeError("csrc/rasterizer.cu and rasterizer_cuda's constants disagree")
    return lib


def check_tile(tile_x, tile_y, device):
    """Raise ValueError, naming the tile, where no rasterizer can render
    ``tile_x`` x ``tile_y`` tiles: a side of 0 or less. The card's kernels
    take every other tile, forward and backward, as the JAX package and the
    plain versions do; on the CPU nothing is checked."""
    if torch.device(device).type == "cuda" and (tile_x <= 0 or tile_y <= 0):
        raise ValueError(f"the card's rasterizer takes tiles of at least 1 x 1 pixels: got "
                         f"{tile_x} x {tile_y}")


def chunks(p):
    """Blocks a tile of ``p`` pixels runs as in either kernel: chunks of at
    most BLOCK_P pixels."""
    return -(-p // BLOCK_P)


def _tile_shape(packed, tile_x, tile_y):
    t, k, f = packed.shape
    c = f - 7
    if c not in (1, 3):
        raise ValueError(f"the kernels take C = 1 or 3 colour channels, got {c}")
    return t, k, c, tile_x * tile_y


# ------------------------------ plain versions ------------------------------


def composite_plain(packed, counts, tiles_x, tile_x, tile_y, chunk=32):
    """Front-to-back compositing in plain torch: the arithmetic of the JAX
    package's ``_composite_tiles`` over the packed input, a chunked cumprod
    over K with power taken directly from dx, dy. Returns accum (T,C,P),
    final T (T,1,P) and median depth (T,1,P); differentiable by autograd."""
    num_tiles, k, f = packed.shape
    c = f - 7
    p = tile_x * tile_y
    dev = packed.device
    tid = torch.arange(num_tiles, device=dev)
    pix = torch.arange(p, device=dev)
    px = ((tid % tiles_x) * tile_x)[:, None] + (pix % tile_x)[None, :]
    py = ((tid // tiles_x) * tile_y)[:, None] + (pix // tile_x)[None, :]
    px, py = px.to(torch.float32)[:, None, :], py.to(torch.float32)[:, None, :]

    t_run = torch.ones((num_tiles, p), device=dev)
    accum = torch.zeros((num_tiles, c, p), device=dev)
    med = torch.full((num_tiles, p), 15.0, device=dev)
    med_set = torch.zeros((num_tiles, p), dtype=torch.bool, device=dev)
    kmax = int(counts.max()) if num_tiles else 0
    for s in range(0, kmax, chunk):
        rows = packed[:, s:s + chunk]                                  # (T,CK,F)
        lv = (torch.arange(s, s + rows.shape[1], device=dev)[None, :] < counts[:, None])[..., None]
        dx = rows[..., 0:1] - px                                       # (T,CK,P)
        dy = rows[..., 1:2] - py
        power = -0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy) \
            - rows[..., 3:4] * dx * dy
        alpha = torch.clamp(rows[..., 5:6] * torch.exp(power), max=0.99)
        skip = (power > 0.0) | (alpha < 1.0 / 255.0) | ~lv
        a_eff = torch.where(skip, torch.zeros_like(alpha), alpha)
        one_minus = 1.0 - a_eff
        t_incl = torch.cumprod(one_minus, dim=1)
        t_before = t_run[:, None, :] * torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
        t_after = t_before * one_minus
        alive_px = t_before >= 1e-4
        wgt = a_eff * t_before * alive_px
        accum = accum + (wgt[:, :, None, :] * rows[..., 6:6 + c, None]).sum(1)
        cross = (t_before > 0.5) & (t_after < 0.5) & ~skip & alive_px
        any_cross = cross.any(1)
        med_new = (cross * rows[..., 6 + c:7 + c]).sum(1)
        med = torch.where(med_set | ~any_cross, med, med_new.detach())
        med_set = med_set | any_cross
        t_run = t_run * t_incl[:, -1, :]
    return accum, t_run[:, None, :], med[:, None, :].detach()


def combine_plain(g, gid, counts, n):
    """``out[gid] += g`` over each tile's live slots, by ``index_add_``."""
    num_tiles, k, f = g.shape
    live = (torch.arange(k, device=g.device)[None, :] < counts[:, None]).reshape(-1)
    out = torch.zeros((n, f), dtype=g.dtype, device=g.device)
    return out.index_add_(0, gid.reshape(-1)[live], g.reshape(-1, f)[live])


# --------------------------------- kernels ----------------------------------


def composite_fwd(packed, counts, tiles_x, tile_x, tile_y, box_skip=True):
    """Kernel 1: returns accum (T,C,P), final T (T,1,P), median (T,1,P) and
    the transmittance checkpoints (T, ceil(K/CKPT), P) the backward reads.
    ``box_skip=False`` walks every live slot at every pixel, which must give
    the same bits: a check of the skip."""
    cuda_build.require_cuda(packed, "composite_fwd")
    t, k, c, p = _tile_shape(packed, tile_x, tile_y)
    dev = packed.device
    cuda_build.check(packed, "packed", torch.float32, (t, k, 7 + c), dev)
    cuda_build.check(counts, "counts", torch.int32, (t,), dev)
    check_tile(tile_x, tile_y, dev)
    order = torch.empty((t,), dtype=torch.int32, device=dev)  # the tile order's workspace
    accum = torch.empty((t, c, p), dtype=torch.float32, device=dev)
    final_t = torch.empty((t, 1, p), dtype=torch.float32, device=dev)
    med = torch.empty((t, 1, p), dtype=torch.float32, device=dev)
    ckpt = torch.empty((t, -(-k // CKPT), p), dtype=torch.float32, device=dev)
    err = _lib().fnx_composite_fwd(
        order.data_ptr(), packed.data_ptr(), counts.data_ptr(), accum.data_ptr(), final_t.data_ptr(),
        med.data_ptr(), ckpt.data_ptr(), t, k, c, tiles_x, tile_x, tile_y, int(box_skip),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "composite_fwd launch")
    LAUNCHES["composite_fwd"] += 1
    return accum, final_t, med, ckpt


def composite_bwd(packed, counts, gacc, gft, final_t, ckpt, tiles_x, tile_x, tile_y,
                  resweep=False):
    """Kernel 2: the per-slot packed gradient (T,K,F) of kernel 1's accum and
    final T; the depth column and dead slots are zero. With ``resweep``, also
    the T its re-sweep reaches at the end of each live window, (T,
    ceil(K/CKPT), P), NaN past the live windows: it equals the forward's next
    checkpoint, or its final T after the last window, bit for bit."""
    cuda_build.require_cuda(packed, "composite_bwd")
    t, k, c, p = _tile_shape(packed, tile_x, tile_y)
    dev = packed.device
    cuda_build.check(packed, "packed", torch.float32, (t, k, 7 + c), dev)
    cuda_build.check(counts, "counts", torch.int32, (t,), dev)
    cuda_build.check(gacc, "gacc", torch.float32, (t, c, p), dev)
    cuda_build.check(gft, "gft", torch.float32, (t, 1, p), dev)
    cuda_build.check(final_t, "final_t", torch.float32, (t, 1, p), dev)
    cuda_build.check(ckpt, "ckpt", torch.float32, (t, -(-k // CKPT), p), dev)
    check_tile(tile_x, tile_y, dev)
    order = torch.empty((t,), dtype=torch.int32, device=dev)  # the tile order's workspace
    # each chunk's pixel sums of each slot, where a tile runs as more than one
    nch = chunks(p)
    sums = torch.empty((t, nch, k, 6 + c), dtype=torch.float32, device=dev) if nch > 1 else None
    dpacked = torch.empty((t, k, 7 + c), dtype=torch.float32, device=dev)  # the kernel writes all
    t_end = torch.full(ckpt.shape, float("nan"), device=dev) if resweep else None
    err = _lib().fnx_composite_bwd(
        order.data_ptr(), packed.data_ptr(), counts.data_ptr(), gacc.data_ptr(), gft.data_ptr(),
        final_t.data_ptr(), ckpt.data_ptr(), dpacked.data_ptr(),
        None if t_end is None else t_end.data_ptr(), None if sums is None else sums.data_ptr(),
        t, k, c, tiles_x, tile_x, tile_y, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "composite_bwd launch")
    LAUNCHES["composite_bwd"] += 1
    return (dpacked, t_end) if resweep else dpacked


def occupancy(c, tile_x, tile_y):
    """{kernel: (registers a thread, dynamic shared bytes a block, threads a
    block, resident blocks an SM)} at C channels and the tile size, as the
    card reports them for the instantiations the wrappers' launches take."""
    out = {}
    for which, name in enumerate(("composite_fwd_kernel", "composite_bwd_kernel", "combine_kernel")):
        vals = (ctypes.c_int * 4)()
        cuda_build.raise_on(_lib().fnx_raster_occupancy(which, c, tile_x * tile_y, vals),
                            f"{name} occupancy")
        out[name] = tuple(vals)
    return out


def combine_rows(g, gid, counts, n):
    """Kernel 3: ``out[gid] += g`` over each tile's live prefix, (n, F)."""
    cuda_build.require_cuda(g, "combine_rows")
    t, k, f = g.shape
    dev = g.device
    cuda_build.check(g, "g", torch.float32, (t, k, f), dev)
    cuda_build.check(gid, "gid", torch.int64, (t, k), dev)
    cuda_build.check(counts, "counts", torch.int32, (t,), dev)
    out = torch.zeros((n, f), dtype=torch.float32, device=dev)
    err = _lib().fnx_combine_rows(g.data_ptr(), gid.data_ptr(), counts.data_ptr(),
                                  out.data_ptr(), t, k, f,
                                  torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "combine_rows launch")
    LAUNCHES["combine_rows"] += 1
    return out


# --------------------------- autograd + dispatch ----------------------------


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, counts, tiles_x, tile_x, tile_y):
        accum, final_t, med, ckpt = composite_fwd(packed, counts, tiles_x, tile_x, tile_y)
        ctx.save_for_backward(packed, counts, final_t, ckpt)
        ctx.geom = (tiles_x, tile_x, tile_y)
        ctx.mark_non_differentiable(med)
        return accum, final_t, med

    @staticmethod
    def backward(ctx, gacc, gft, _gmed):
        packed, counts, final_t, ckpt = ctx.saved_tensors
        if gacc is None:
            t, _, p = final_t.shape
            gacc = final_t.new_zeros((t, packed.shape[2] - 7, p))
        gacc = gacc.contiguous()
        gft = torch.zeros_like(final_t) if gft is None else gft.contiguous()
        dpacked = composite_bwd(packed, counts, gacc, gft, final_t, ckpt, *ctx.geom)
        return dpacked, None, None, None, None


def composite(packed, counts, tiles_x, tile_x, tile_y, chunk=32):
    """Composite the packed tiles: (accum (T,C,P), final T (T,1,P), median
    (T,1,P)). CPU tensors take ``composite_plain``; CUDA tensors the kernels."""
    if packed.device.type == "cpu":
        return composite_plain(packed, counts, tiles_x, tile_x, tile_y, chunk)
    cuda_build.require_cuda(packed, "composite")
    return _CompositeFn.apply(packed.contiguous(), counts.to(torch.int32).contiguous(),
                              tiles_x, tile_x, tile_y)


def combine(g, gid, counts, n):
    """``out[gid] += g`` over live slots: ``combine_plain`` on the CPU, the
    kernel on CUDA."""
    if g.device.type == "cpu":
        return combine_plain(g, gid, counts, n)
    return combine_rows(g, gid, counts, n)


class _GatherRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, idx, counts):
        ctx.save_for_backward(idx, counts)
        ctx.n = packed.shape[0]
        return packed[idx]

    @staticmethod
    def backward(ctx, g):
        idx, counts = ctx.saved_tensors
        return combine(g.contiguous(), idx, counts, ctx.n), None, None


def gather_rows(packed, idx, counts):
    """``packed[idx]`` (T,K,F) whose backward combines only the live slots
    (``counts``) back into (N, F) rows."""
    return _GatherRowsFn.apply(packed, idx, counts)
