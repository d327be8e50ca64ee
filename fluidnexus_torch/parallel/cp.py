"""Context parallelism for the causal 3D VAE's time axis (counterpart of
``fluidnexus_tpu/parallel/cp.py``).

Each rank of the mesh's ``time`` group holds one contiguous shard of the
frames. A causal temporal conv takes its k_t - 1 frames of history from the
previous rank: ``halo_exchange_time`` is a ring of point-to-point sends over
the group (``dist.batch_isend_irecv``; NCCL on the card), where JAX runs one
``ppermute``. ``cp_vae_encode``/``cp_vae_decode`` front-pad the sequence
with copies of frame 0 so that every shard is the same length, run the VAE
with a ``CPState`` and gather the result: the pass equals the serial one.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from fluidnexus_torch.parallel.mesh import axis_rank, axis_size, gather, group


def halo_exchange_time(x_local: torch.Tensor, kernel_t: int, grp, dim: int = 1):
    """Prepend the previous rank's last (kernel_t - 1) frames along ``dim``;
    rank 0 gets a replicate of its own first frame (the causal first-frame
    pad). x_local: (B, T_local, H, W, C) with the default ``dim``."""
    pad = kernel_t - 1
    if pad == 0:
        return x_local
    n, r = dist.get_world_size(grp), dist.get_rank(grp)
    first_pad = x_local.narrow(dim, 0, 1).expand(
        *[pad if i == dim else -1 for i in range(x_local.dim())])
    if n == 1:
        return torch.cat([first_pad, x_local], dim)
    tail = x_local.narrow(dim, x_local.shape[dim] - pad, pad).contiguous()
    prev_tail = torch.empty_like(tail)
    # send my tail to the next rank, take the previous rank's
    ops = [dist.P2POp(dist.isend, tail, dist.get_global_rank(grp, (r + 1) % n), grp),
           dist.P2POp(dist.irecv, prev_tail, dist.get_global_rank(grp, (r - 1) % n), grp)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    front = first_pad if r == 0 else prev_tail
    return torch.cat([front, x_local], dim)


def cp_causal_conv_time(conv_fn: Callable, mesh, kernel_t: int = 3):
    """A per-shard temporal conv as a time-sharded op. conv_fn: (B, T_local +
    kernel_t - 1, H, W, C) -> (B, T_local, H, W, C') (VALID in time, after
    the halo is attached). Returns a function of this rank's (B, T_local,
    H, W, C) shard."""
    grp = group(mesh, "time")

    def shard_fn(x_local):
        return conv_fn(halo_exchange_time(x_local, kernel_t, grp))

    return shard_fn


def _front_pad(x, pad: int):
    """Prepend ``pad`` replicated copies of frame 0 along the time axis."""
    if pad == 0:
        return x
    return torch.cat([x[:, :1].expand(-1, pad, *x.shape[2:]), x], 1)


def cp_vae_encode(vae, x, mesh, axis: str = "time", sample: bool = False,
                  rng: Optional[torch.Generator] = None):
    """Time-sharded (context-parallel) VideoVAE encode, equal to the serial
    pass: the video is front-padded with P copies of frame 0, P odd and T +
    P divisible by n 2^levels, so pooling pairs stay aligned (the pad block
    keeps collapsing onto frame 0), the halos carry the neighbours' frames
    and the group norms sum their moments over the shards with the pads
    masked. x: (B, T, H, W, C) on every rank, T = 1 + k
    temporal_compress_times. Returns the whole latent on every rank."""
    from fluidnexus_torch.diffusion.video.vae3d import CPState

    n = axis_size(mesh, axis)
    grp = group(mesh, axis)
    lv = vae.cfg.temporal_compress_level
    t = x.shape[1]
    if t % 2 != 1:
        raise ValueError(f"causal VAE expects odd frame count, got {t}")
    mult = max(n << lv, 2)
    pad = (-t) % mult  # odd: t odd, mult even
    xl = cp_split_time(_front_pad(x, pad), mesh, axis)
    z, _ = vae.encode(xl, rng, sample=sample, cp=CPState(grp, pad, n))
    pad_z = (pad + 1) // (1 << lv) - 1
    return cp_gather_time(z, mesh, axis)[:, pad_z:]


def cp_vae_decode(vae, z, mesh, axis: str = "time"):
    """Time-sharded VideoVAE decode, equal to the serial pass (see
    ``cp_vae_encode``; decode only needs T_z + P divisible by n, P odd)."""
    from fluidnexus_torch.diffusion.video.vae3d import CPState

    n = axis_size(mesh, axis)
    lv = vae.cfg.temporal_compress_level
    t = z.shape[1]
    if t % 2 != 1:
        raise ValueError(f"causal VAE expects odd latent count, got {t}")
    # the smallest odd pad with (t + pad) % n == 0 (odd t makes one exist)
    pad = next(p for p in range(1, 2 * n + 2, 2) if (t + p) % n == 0)
    zl = cp_split_time(_front_pad(z, pad), mesh, axis)
    out, _ = vae.decode(zl, cp=CPState(group(mesh, axis), pad, n))
    pad_out = (pad + 1) * (1 << lv) - 1
    return cp_gather_time(out, mesh, axis)[:, pad_out:]


def cp_split_time(x, mesh, axis: str = "time"):
    """This rank's shard of the time axis (dim 1) of a tensor every rank
    holds whole (the reference's ``_conv_split``)."""
    n = axis_size(mesh, axis)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} frames do not divide over {n} '{axis}' ranks")
    t = x.shape[1] // n
    r = axis_rank(mesh, axis)
    return x[:, r * t:(r + 1) * t]


def cp_gather_time(x_local, mesh, axis: str = "time"):
    """The whole sequence on every rank (``_conv_gather``)."""
    if axis_size(mesh, axis) == 1:
        return x_local
    return gather(x_local, 1, group(mesh, axis))
