"""Process mesh, tensor-parallel layouts and ZeRO optimizer sharding on
``torch.distributed`` (counterpart of ``fluidnexus_tpu/parallel/mesh.py``).

One process per device, as torch runs it (``torchrun --nproc_per_node N``):
rank r computes on ``cuda:LOCAL_RANK`` (NCCL), or on the CPU under gloo when
the caller passes ``device="cpu"``. The mesh is a ``DeviceMesh`` of shape
(dp, tp, time) named
    data   data parallel (the batch, and the ZeRO grouping of moments)
    model  tensor parallel (Megatron column / row splits of the DiT)
    time   context parallel over the VAE's time axis (``parallel/cp.py``)
Where JAX's GSPMD inserts the collectives, the port calls them itself: the
DiT's row-parallel products end in one ``all_reduce`` over ``model``
(``diffusion/video/dit.py``), the trainers mean their gradients over
``data`` and gather their ZeRO shards back after each step.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# the JAX package's flax logical axis -> mesh axis rules, kept as data: the
# DiT's kernels carry ('embed', 'heads') / ('embed', 'mlp') and their
# transposes; 'heads' and 'mlp' split over 'model'
LOGICAL_RULES = (
    ("embed", None),
    ("heads", "model"),
    ("mlp", "model"),
    ("batch", "data"),
    ("time", "time"),
)

AXES = ("data", "model", "time")


def world_size() -> int:
    """Ranks in the default group: 1 when none is made and ``WORLD_SIZE``
    is unset."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main() -> bool:
    """True on global rank 0 (and in a run without a process group): the
    rank that writes files and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _default_group(device_type: str):
    """The default process group, made from ``env://`` (torchrun's
    variables) when none exists yet: NCCL for the card, gloo on the CPU."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")


def require_ranks(n: int, what: str):
    """Raise, in the JAX package's words, when fewer than ``n`` ranks run."""
    have = world_size()
    if have < n:
        raise ValueError(f"{what} but only {have} devices visible")
    if have != n:
        raise ValueError(f"{what} uses {n} ranks but {have} were started")


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              time: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (dp, tp, time) named ("data", "model",
    "time") over the default group (made from ``env://`` when ``WORLD_SIZE``
    is set and none exists). ``dp`` defaults to n // (tp time)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_devices or world_size()
    dp = dp or (n // (tp * time))
    assert dp * tp * time == n, f"{dp}x{tp}x{time} != {n}"
    require_ranks(n, f"--dp {dp} --tp {tp} --time {time}")
    _default_group(device_type)
    return init_device_mesh(device_type, (dp, tp, time), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def group(mesh, axis: str):
    """The process group of this rank's ``axis`` (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


# --------------------------- tensor-parallel layout ---------------------------

# the DiT's tensor-parallel projections: Megatron column splits (JAX kernel
# axes ('embed', 'heads'|'mlp')) and row splits (('heads'|'mlp', 'embed'))
COLUMN = ("attn.qkv", "mlp.fc1")
ROW = ("attn.out", "mlp.fc2")

# which dim of each LoRADense leaf a column / row split cuts, in the port's
# layout: ``weight`` (out, in), ``kernel_q``/``lora_a``/``lora_b`` the flax
# (in, out); a row split's bias and kernel_scale, a column split's lora_a
# and a row split's lora_b are replicated
_COLUMN_DIMS = {"weight": 0, "bias": 0, "kernel_q": 1, "kernel_scale": 0, "lora_b": 1}
_ROW_DIMS = {"weight": 1, "kernel_q": 0, "lora_a": 0}


def param_shardings(names) -> Dict[str, Optional[Tuple[int, str]]]:
    """{parameter name: (dim, "model") or None (replicated)} for the port's
    DiT, read from the logical axes the JAX DiT puts on each kernel. The
    int8 adaLN projection, which the JAX package splits over 'model' (its
    ('embed', 'mlp')), stays replicated here: 0.8 GiB int8 (3.2 GiB f32 in
    the float DiT, which JAX leaves unannotated) per rank at 5B."""
    out = {}
    for n in names:
        mod, _, leaf = n.rpartition(".")
        dims = (_COLUMN_DIMS if mod.endswith(COLUMN) else
                _ROW_DIMS if mod.endswith(ROW) else {})
        out[n] = (dims[leaf], "model") if leaf in dims else None
    return out


def spec_of(sharding, ndim: int) -> Tuple[Optional[str], ...]:
    """A (dim, axis) sharding as a per-dim tuple of axis names."""
    parts = [None] * ndim
    if sharding is not None:
        parts[sharding[0]] = sharding[1]
    return tuple(parts)


def _zero_extend(spec, shape, dp: int):
    """ZeRO: additionally shard the largest still-unsharded, dp-divisible dim
    along 'data' (DeepSpeed's optimizer-state partitioning over the DP
    group); the first such dim on a tie. ``spec`` is a tuple of axis names
    (or None) per dim, as a JAX PartitionSpec lists them."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in parts or not shape:
        return tuple(parts)
    best = None
    for axis, size in enumerate(shape):
        if parts[axis] is None and size % dp == 0 and size >= dp:
            if best is None or size > shape[best]:
                best = axis
    if best is not None:
        parts[best] = "data"
    return tuple(parts)


def zero_dims(shapes: Dict[str, tuple], shardings: Dict[str, Optional[tuple]], dp: int):
    """{name: the dim ZeRO shards along 'data', or None} for full
    (unsharded) ``shapes``: each moment follows its parameter's tensor-
    parallel layout, then ``_zero_extend``'s choice."""
    out = {}
    for n, shape in shapes.items():
        spec = _zero_extend(spec_of(shardings.get(n), len(shape)), tuple(shape), dp)
        out[n] = spec.index("data") if "data" in spec else None
    return out


def zero_shard_opt_state(opt, mesh, shardings=None):
    """Shard the moments of ``opt`` (a ``core/optim.ClipAdamW``) over
    'data' as ZeRO does: each keeps the chunk this rank's data coordinate
    owns along ``zero_dims``' choice. ``shardings`` gives the parameters'
    tensor-parallel layout ({name: (dim, "model") or None}); the choice is
    made on their full shapes. Returns ``opt``."""
    shardings = shardings or {}
    tp = axis_size(mesh, "model")
    full = {}
    for n, p in opt.params.items():
        shape = list(p.shape)
        if shardings.get(n) is not None:
            shape[shardings[n][0]] *= tp
        full[n] = tuple(shape)
    opt.shard(zero_dims(full, shardings, axis_size(mesh, "data")), mesh,
              tp_sharded=[n for n, s in shardings.items() if s is not None and n in opt.params])
    return opt


def shard_params_logical(params, mesh, shardings):
    """{name: this rank's shard} of a {name: full tensor}: each leaf cut
    along its (dim, axis) layout of ``shardings`` over that mesh axis, the
    others whole."""
    return {n: x if shardings.get(n) is None else
            chunk(x, shardings[n][0], group(mesh, shardings[n][1])) for n, x in params.items()}


# ------------------------------ data placement -------------------------------

def data_shard(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a batch-leading tensor that every rank holds
    whole (the JAX package's ``data_sharding``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} '{axis}' ranks")
    b = x.shape[0] // n
    r = axis_rank(mesh, axis)
    return x[r * b:(r + 1) * b]


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` as rank 0 holds it, on every rank (broadcast in place; the
    JAX package's ``replicated`` placement)."""
    if dist.is_initialized():
        dist.broadcast(x, src=0)
    return x


def gather(x: torch.Tensor, dim: int, grp) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in group
    rank order."""
    n = dist.get_world_size(grp)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=grp)
    return torch.cat(parts, dim)


def chunk(x: torch.Tensor, dim: int, grp) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over the group."""
    n = dist.get_world_size(grp)
    if n == 1:
        return x
    return x.chunk(n, dim)[dist.get_rank(grp)]

