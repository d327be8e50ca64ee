"""The video DiT's joint attention: the flash-attention kernels (forward in
``csrc/attention.cu``, backward in ``csrc/attention_bwd.cu``), the autograd
Function around them, their plain versions and their launch counts
(counterpart of ``fluidnexus_tpu/diffusion/video/dit.py:_joint_attention``,
whose TPU path calls the library Pallas flash attention and its ``dkv`` and
``dq`` backward kernels).

``joint_attention(q, k, v)`` takes ``(b, h, s, d)`` and returns
``softmax(q k^T / sqrt(d)) v`` as ``(b, s, h, d)``, non-causal, over all s
tokens. On a CPU tensor it takes ``attention_plain`` (autograd differentiates
it); on a CUDA tensor it launches ``attention_fwd``, or, when a gradient is
wanted, ``JointAttentionFn``, whose backward launches ``attention_bwd``; a
CUDA tensor never falls back to the plain version. The kernels take bf16 or
f32 with a head_dim of 16, 32, 64 or 128. bf16 at head_dim 64 (the 5B and 2B
DiTs' heads) takes the Hopper kernels on TMA and wgmma: the forward
``attention_wgmma_kernel``, the backward ``attention_bwd_wgmma_kernel``.
Every other case takes the mma.sync kernels: the forward
``attention_bf16_kernel`` / ``attention_f32_kernel``, the backward the
``dq`` and ``dkv`` pair. Each forward launch adds one to
``LAUNCHES["attention_fwd"]``, and one of the Hopper kernel also to
``LAUNCHES["attention_fwd_wgmma"]``; each backward launch adds one to its
kernel's own count.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from fluidnexus_torch.ops import cuda_build

LAUNCHES = {"attention_fwd": 0, "attention_fwd_wgmma": 0, "attention_bwd_wgmma": 0,
            "attention_dq": 0, "attention_dkv": 0}
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64,)   # the head_dims of the bf16 Hopper kernels
BWD_TILE = 128            # query rows of a tile of the Hopper backward
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fnx_attention_fwd.argtypes = [p] * 5 + [i] * 5 + [ll] * 9 + [ctypes.c_float, p]
    lib.fnx_attention_fwd.restype = i
    lib.fnx_attention_fwd_wgmma.argtypes = [p] * 5 + [i] * 3 + [ll] * 9 + [ctypes.c_float, p]
    lib.fnx_attention_fwd_wgmma.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = cuda_build.load("attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fnx_attention_bwd.argtypes = ([i] + [p] * 10 + [i] * 5
                                      + [ctypes.POINTER(ctypes.c_longlong)]
                                      + [ctypes.c_float] * 2 + [p])
    lib.fnx_attention_bwd.restype = i
    lib.fnx_attention_bwd_wgmma.argtypes = ([p] * 8 + [i] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                                            + [ctypes.c_float] * 2 + [p])
    lib.fnx_attention_bwd_wgmma.restype = i
    return lib


def attention_plain(q, k, v, rows=None):
    """``softmax(q k^T / sqrt(d)) v`` in f32 (f64 for f64 inputs), returned
    in q's dtype as ``(b, s, h, d)``. The queries go in chunks of ``rows`` (by
    default as many as keep a chunk's scores under 2^28 elements); softmax is
    per row, so the chunking changes no value."""
    b, h, s, d = q.shape
    if rows is None:
        rows = max(1, (1 << 28) // max(b * h * s, 1))
    ct = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(ct), v.to(ct)
    scale = 1.0 / math.sqrt(d)
    out = []
    for i in range(0, s, rows):
        logits = torch.matmul(q[:, :, i:i + rows].to(ct), kf.transpose(-1, -2)) * scale
        out.append(torch.matmul(torch.softmax(logits, dim=-1), vf))
    return torch.cat(out, 2).to(q.dtype).transpose(1, 2)


def attention_lse_plain(q, k):
    """Each row's log-sum-exp of the scaled logits, ``(b, h, s)`` in f32 (f64
    for f64 inputs): what ``attention_fwd(..., lse=True)`` writes beside O,
    query-chunked as ``attention_plain``."""
    b, h, s, d = q.shape
    rows = max(1, (1 << 28) // max(b * h * s, 1))
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct)
    return torch.cat([torch.logsumexp(torch.matmul(q[:, :, i:i + rows].to(ct), kf.transpose(-1, -2))
                                      / math.sqrt(d), -1) for i in range(0, s, rows)], 2)


def attention_bwd_plain(q, k, v, dout, dtype=torch.float32):
    """dq, dk, dv ``(b, h, s, d)`` of ``attention_plain`` for the upstream
    gradient ``dout`` ``(b, s, h, d)``, by autograd, with every input cast to
    ``dtype`` first (f32, or f64 to measure the f32 kernels' own error)."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().to(dtype).requires_grad_() for x in (q, k, v))
        out = attention_plain(qq, kk, vv)
        return torch.autograd.grad(out, (qq, kk, vv), dout.to(dtype))


def takes_wgmma(dtype, d):
    """Whether ``attention_fwd`` and ``attention_bwd`` run the Hopper kernels
    (TMA, wgmma) for inputs of ``dtype`` and head_dim ``d``; the mma.sync
    kernels otherwise."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def _kernel_layout(x):
    """``x`` as the kernels read it, in place where it already is so, else a
    contiguous copy in a new allocation: d contiguous, a 16-byte-aligned base
    and b, h, s strides that are positive multiples of 16 bytes (every row
    16-byte aligned for cp.async; what a TMA tensor map needs). A contiguous
    view at an unaligned offset is copied too, which ``contiguous()`` would
    not do."""
    step = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st > 0 and st % step == 0 for st in x.stride()[:3]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _check_qkv(q, k, v, what):
    cuda_build.require_cuda(q, what)
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bfloat16 or float32, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} takes (b, h, s, d) with d in {HEAD_DIMS}, got "
                         f"{tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on {x.device}, expected "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{what} takes at most 65535 (b, h) pairs, got {q.shape[0] * q.shape[1]}")


def attention_fwd(q, k, v, lse=False):
    """The forward kernel: ``(b, h, s, d)`` bf16 or f32 inputs of one shape on
    one card, any strides over b, h and s; returns a contiguous ``(b, s, h,
    d)``, and with ``lse=True`` also each row's log-sum-exp of the scaled
    logits, f32 ``(b, h, s)``, for the backward. bf16 at head_dim 64 runs the
    Hopper kernel (``takes_wgmma``), or raises; it never takes the other."""
    _check_qkv(q, k, v, "attention_fwd")
    return _forward(q, k, v, lse, takes_wgmma(q.dtype, q.shape[-1]))


def _attention_fwd_mma_sync(q, k, v, lse=False):
    """``attention_fwd`` through the mma.sync kernel whatever the dtype and
    head_dim: the yardstick that ``chip_smoke.py`` times and checks beside the
    Hopper kernel at bf16 and head_dim 64. No pipeline calls it."""
    _check_qkv(q, k, v, "attention_fwd")
    return _forward(q, k, v, lse, False)


def _forward(q, k, v, lse, wgmma):
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
    if s > 0:
        q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_t.data_ptr() if lse else None)
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale_log2 = _LOG2E / math.sqrt(d)
        if wgmma:
            err = _lib().fnx_attention_fwd_wgmma(*ptrs, b, h, s, *strides, scale_log2, stream)
            if err >= 1000:
                raise RuntimeError(f"attention_fwd: the TMA tensor map of q, k or v could not be "
                                   f"encoded (CUresult {err - 1000})")
        else:
            err = _lib().fnx_attention_fwd(*ptrs, _DTYPES[q.dtype], b, h, s, d, *strides,
                                           scale_log2, stream)
        cuda_build.raise_on(err, "attention_fwd launch")
        LAUNCHES["attention_fwd"] += 1
        LAUNCHES["attention_fwd_wgmma"] += int(wgmma)
    return (out, lse_t) if lse else out


def attention_bwd(q, k, v, out, lse, dout):
    """The backward kernels: ``q``, ``k``, ``v`` as given to ``attention_fwd``,
    its ``out`` ``(b, s, h, d)`` and ``lse``, and the upstream gradient
    ``dout`` ``(b, s, h, d)``; returns dq, dk, dv as ``(b, h, s, d)`` views of
    contiguous ``(b, s, h, d)`` tensors, the layout the qkv projection's
    gradient is assembled in. bf16 at head_dim 64 runs the Hopper kernel
    (``takes_wgmma``; one launch, dq summed in f32 across key blocks, so its
    last bits change from run to run), or raises; it never takes the
    mma.sync pair. Every other case launches ``dq`` (which also writes D =
    rowsum(dout * out)) and then ``dkv``."""
    grads = _bwd_grads(q, k, v, out, lse, dout)
    if q.shape[2]:
        if takes_wgmma(q.dtype, q.shape[-1]):
            _backward_wgmma(q, k, v, out, lse, dout, grads)
        else:
            _backward_pair(q, k, v, out, lse, dout, grads)
    return tuple(grads)


def _attention_bwd_mma_sync(q, k, v, out, lse, dout):
    """``attention_bwd`` through the mma.sync pair whatever the dtype and
    head_dim: the yardstick that ``chip_smoke.py`` times and checks beside the
    Hopper kernel at bf16 and head_dim 64. No pipeline calls it."""
    grads = _bwd_grads(q, k, v, out, lse, dout)
    if q.shape[2]:
        _backward_pair(q, k, v, out, lse, dout, grads)
    return tuple(grads)


def _bwd_grads(q, k, v, out, lse, dout):
    """Checks the backward's inputs; returns the empty dq, dk, dv."""
    _check_qkv(q, k, v, "attention_bwd")
    b, h, s, d = q.shape
    for name, x, shape, dtype in (("out", out, (b, s, h, d), q.dtype),
                                  ("dout", dout, (b, s, h, d), q.dtype),
                                  ("lse", lse, (b, h, s), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on {x.device}, expected "
                             f"{dtype} {shape} on {q.device}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    return [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
            for _ in range(3)]


def _backward_pair(q, k, v, out, lse, dout, grads):
    """The mma.sync ``dq`` kernel (it also writes D) and then ``dkv``, into
    ``grads``."""
    b, h, s, d = q.shape
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ins = [_kernel_layout(x) for x in (q, k, v, out.transpose(1, 2), dout.transpose(1, 2))]
    strides = (ctypes.c_longlong * 24)(*[st for x in ins + grads for st in x.stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for which, name in ((0, "attention_dq"), (1, "attention_dkv")):
        err = _bwd_lib().fnx_attention_bwd(
            which, *(x.data_ptr() for x in ins), lse.data_ptr(), dsum.data_ptr(),
            *(g.data_ptr() for g in grads), _DTYPES[q.dtype], b, h, s, d, strides,
            _LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), stream)
        cuda_build.raise_on(err, f"{name} launch")
        LAUNCHES[name] += 1


def bwd_rows(lse, dsum):
    """What the Hopper backward reads of each 128-query tile, f32 ``(b, h,
    nq, 2, 128)`` with nq = ceil(s / 128): the tile's lse times log2(e)
    (+inf past s, so a pad query's P is 0), then its D (0 past s). Padded to
    whole tiles so that each tile's rows are one 16-byte-aligned bulk copy."""
    b, h, s = lse.shape
    nq = -(-s // BWD_TILE)
    pad = nq * BWD_TILE - s
    lse2 = torch.nn.functional.pad(lse * _LOG2E, (0, pad), value=math.inf)
    dd = torch.nn.functional.pad(dsum, (0, pad))
    return torch.stack((lse2.reshape(b, h, nq, BWD_TILE), dd.reshape(b, h, nq, BWD_TILE)), 3)


def _launch_bwd_wgmma(q, k, v, dout, rows, dq_acc, dk, dv):
    """One launch of the Hopper backward: dk and dv into their ``(b, h, s,
    64)`` views, and s dS K summed into ``dq_acc``, an f32 ``(b, h, s, 64)``
    view of zeros."""
    b, h, s, d = q.shape
    ins = [_kernel_layout(x) for x in (q, k, v, dout.transpose(1, 2))]
    strides = (ctypes.c_longlong * 21)(*[st for x in ins + [dq_acc, dk, dv]
                                         for st in x.stride()[:3]])
    err = _bwd_lib().fnx_attention_bwd_wgmma(
        *(x.data_ptr() for x in ins), rows.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, s, strides, _LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err >= 1000:
        raise RuntimeError(f"attention_bwd: the TMA tensor map of q, k, v, dout or the dq "
                           f"workspace could not be encoded (CUresult {err - 1000})")
    cuda_build.raise_on(err, "attention_bwd_wgmma launch")
    LAUNCHES["attention_bwd_wgmma"] += 1


def _bwd_wgmma_scratch(out, lse, dout):
    """What the Hopper kernel reads and sums into besides its inputs: the rows
    (``bwd_rows``) with D = rowsum(dout * out) in f32 by torch (the TPU
    library computes it outside its kernels too), and the dq workspace, f32
    zeros ``(b, s, h, d)`` seen as ``(b, h, s, d)``."""
    b, s, h, d = out.shape
    dsum = dout.float().mul_(out).sum(-1).transpose(1, 2)
    dq_acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=out.device)
    return bwd_rows(lse, dsum), dq_acc.transpose(1, 2)


def _backward_wgmma(q, k, v, out, lse, dout, grads):
    """bf16 at head_dim 64: the Hopper kernel writes dk and dv and sums dq in
    f32 across the key blocks into the workspace, cast to bf16 into dq
    afterwards."""
    rows, dq_acc = _bwd_wgmma_scratch(out, lse, dout)
    _launch_bwd_wgmma(q, k, v, dout, rows, dq_acc, grads[1], grads[2])
    grads[0].copy_(dq_acc)


class JointAttentionFn(torch.autograd.Function):
    """The attention with its gradient on the card: the forward kernel saves
    q, k, v, O and the row log-sum-exp; the backward kernels run on them
    (``attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = attention_fwd(q, k, v, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return attention_bwd(*ctx.saved_tensors, dout)


def joint_attention(q, k, v):
    """Full self-attention over the joint sequence: ``(b, h, s, d)`` in,
    ``(b, s, h, d)`` out. CPU tensors take ``attention_plain``; CUDA tensors
    the forward kernel, through ``JointAttentionFn`` when a gradient is
    wanted."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return JointAttentionFn.apply(q, k, v)
    return attention_fwd(q, k, v)
