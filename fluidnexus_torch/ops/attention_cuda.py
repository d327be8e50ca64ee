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
wanted, ``JointAttentionFn``, whose backward launches the two backward
kernels; a CUDA tensor never falls back to the plain version. The kernels
take bf16 or f32 with a head_dim of 16, 32, 64 or 128; each launch adds one
to its count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from fluidnexus_torch.ops import cuda_build

LAUNCHES = {"attention_fwd": 0, "attention_dq": 0, "attention_dkv": 0}
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fnx_attention_fwd.argtypes = [p] * 5 + [i] * 5 + [ll] * 9 + [ctypes.c_float, p]
    lib.fnx_attention_fwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = cuda_build.load("attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fnx_attention_bwd.argtypes = ([i] + [p] * 10 + [i] * 5
                                      + [ctypes.POINTER(ctypes.c_longlong)]
                                      + [ctypes.c_float] * 2 + [p])
    lib.fnx_attention_bwd.restype = i
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


def _kernel_layout(x):
    """``x`` as the kernels read it: d contiguous, every row 16-byte aligned."""
    step = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % step == 0 for st in x.stride()[:3]))
    return x if ok else x.contiguous()


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
    logits, f32 ``(b, h, s)``, for the backward."""
    _check_qkv(q, k, v, "attention_fwd")
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
    if s > 0:
        q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
        err = _lib().fnx_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_t.data_ptr() if lse else None, _DTYPES[q.dtype], b, h, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], math.log2(math.e) / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
        cuda_build.raise_on(err, "attention_fwd launch")
        LAUNCHES["attention_fwd"] += 1
    return (out, lse_t) if lse else out


def attention_bwd(q, k, v, out, lse, dout):
    """The two backward kernels: ``q``, ``k``, ``v`` as given to
    ``attention_fwd``, its ``out`` ``(b, s, h, d)`` and ``lse``, and the
    upstream gradient ``dout`` ``(b, s, h, d)``. Launches ``dq`` (which also
    writes D = rowsum(dout * out)) and then ``dkv``; returns dq, dk, dv as
    ``(b, h, s, d)`` views of contiguous ``(b, s, h, d)`` tensors, the layout
    the qkv projection's gradient is assembled in."""
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
    grads = [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
             for _ in range(3)]
    if s == 0:
        return tuple(grads)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ins = [_kernel_layout(x) for x in (q, k, v, out.transpose(1, 2), dout.transpose(1, 2))]
    strides = (ctypes.c_longlong * 24)(*[st for x in ins + grads for st in x.stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for which, name in ((0, "attention_dq"), (1, "attention_dkv")):
        err = _bwd_lib().fnx_attention_bwd(
            which, *(x.data_ptr() for x in ins), lse.data_ptr(), dsum.data_ptr(),
            *(g.data_ptr() for g in grads), _DTYPES[q.dtype], b, h, s, d, strides,
            math.log2(math.e) / math.sqrt(d), 1.0 / math.sqrt(d), stream)
        cuda_build.raise_on(err, f"{name} launch")
        LAUNCHES[name] += 1
    return tuple(grads)


class JointAttentionFn(torch.autograd.Function):
    """The attention with its gradient on the card: the forward kernel saves
    q, k, v, O and the row log-sum-exp; the backward runs the ``dq`` and
    ``dkv`` kernels on them."""

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
