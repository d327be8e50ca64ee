"""The video DiT's joint attention: the flash-attention forward kernel, its
plain version and its launch count (counterpart of
``fluidnexus_tpu/diffusion/video/dit.py:_joint_attention``; kernel in
``csrc/attention.cu``).

``joint_attention(q, k, v)`` takes ``(b, h, s, d)`` and returns
``softmax(q k^T / sqrt(d)) v`` as ``(b, s, h, d)``, non-causal, over all s
tokens. On a CPU tensor it takes ``attention_plain``; on a CUDA tensor it
launches ``attention_fwd`` or raises. The kernel takes bf16 or f32 with a
head_dim of 16, 32, 64 or 128; each launch adds one to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from fluidnexus_torch.ops import cuda_build

LAUNCHES = {"attention_fwd": 0}
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fnx_attention_fwd.argtypes = [p] * 4 + [i] * 5 + [ll] * 9 + [ctypes.c_float, p]
    lib.fnx_attention_fwd.restype = i
    return lib


def attention_plain(q, k, v, rows=None):
    """``softmax(q k^T / sqrt(d)) v`` in f32, returned in q's dtype as
    ``(b, s, h, d)``. The queries go in chunks of ``rows`` (by default as many
    as keep a chunk's scores under 2^28 elements); softmax is per row, so the
    chunking changes no value."""
    b, h, s, d = q.shape
    if rows is None:
        rows = max(1, (1 << 28) // max(b * h * s, 1))
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    out = []
    for i in range(0, s, rows):
        logits = torch.matmul(q[:, :, i:i + rows].float(), kf.transpose(-1, -2)) * scale
        out.append(torch.matmul(torch.softmax(logits, dim=-1), vf))
    return torch.cat(out, 2).to(q.dtype).transpose(1, 2)


def _kernel_layout(x):
    """``x`` as the kernel reads it: d contiguous, every row 16-byte aligned."""
    step = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % step == 0 for st in x.stride()[:3]))
    return x if ok else x.contiguous()


def attention_fwd(q, k, v):
    """The kernel: ``(b, h, s, d)`` bf16 or f32 inputs of one shape on one
    card, any strides over b, h and s; returns a contiguous ``(b, s, h, d)``."""
    cuda_build.require_cuda(q, "attention_fwd")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention_fwd takes bfloat16 or float32, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"attention_fwd takes (b, h, s, d) with d in {HEAD_DIMS}, got "
                         f"{tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on {x.device}, expected "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    b, h, s, d = q.shape
    if b * h > 65535:
        raise ValueError(f"attention_fwd takes at most 65535 (b, h) pairs, got {b * h}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if s == 0:
        return out
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    err = _lib().fnx_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], math.log2(math.e) / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.raise_on(err, "attention_fwd launch")
    LAUNCHES["attention_fwd"] += 1
    return out


def joint_attention(q, k, v):
    """Full self-attention over the joint sequence: ``(b, h, s, d)`` in,
    ``(b, s, h, d)`` out. CPU tensors take ``attention_plain``; CUDA tensors
    the kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_fwd(q, k, v)
