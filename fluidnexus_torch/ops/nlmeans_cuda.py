"""The non-local-means denoise's kernel (``csrc/nlmeans.cu``): wrapper and
launch count. It replaces no Pallas kernel: the JAX package's
``data/dataset_builders.denoise_image`` is OpenCV's
``fastNlMeansDenoising`` on the host, and the port's plain version of it is
``utils/nlmeans.denoise_plain``, which the kernel equals bit for bit.

- ``nlmeans_cuda(gray, h)``: the kernel on a uint8 (H, W) CUDA tensor, at
  OpenCV's 7 x 7 patches and 21 x 21 search window (the sizes the ScalarFlow
  preprocess uses, compiled into the kernel). Each launch adds one to
  ``LAUNCHES["nlmeans"]``; it raises where the library does not build or
  the launch fails (there is no fall back).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fluidnexus_torch.ops import cuda_build
from fluidnexus_torch.utils.nlmeans import nlmeans_weight_table, weight_head

TEMPLATE, SEARCH = 7, 21   # csrc/nlmeans.cu's TS and SS

LAUNCHES = {"nlmeans": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("nlmeans")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fnx_nlmeans_max_head.argtypes = []
    lib.fnx_nlmeans_max_head.restype = i
    lib.fnx_nlmeans.argtypes = [p, p, i, i, p, i, i, p]
    lib.fnx_nlmeans.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _head(h: float, device: torch.device) -> torch.Tensor:
    """The weight table's non-zero head as int32 on ``device``."""
    return torch.tensor(weight_head(h, TEMPLATE, SEARCH), dtype=torch.int32, device=device)


def nlmeans_cuda(gray: torch.Tensor, h: float = 3.0) -> torch.Tensor:
    """The kernel: the denoised uint8 (H, W) of a uint8 (H, W) CUDA tensor."""
    cuda_build.require_cuda(gray, "nlmeans_cuda")
    if gray.dim() != 2:
        raise ValueError(f"nlmeans_cuda takes one (H, W) image, got shape {tuple(gray.shape)}")
    H, W = gray.shape
    dev = gray.device
    cuda_build.check(gray, "gray", torch.uint8, (H, W), dev)
    head = _head(float(h), dev)
    if head.numel() < 1 or head.numel() > _lib().fnx_nlmeans_max_head():
        raise ValueError(f"h = {h} gives {head.numel()} non-zero weights; the kernel stages "
                         f"1 to {_lib().fnx_nlmeans_max_head()}")
    out = torch.empty_like(gray)
    err = _lib().fnx_nlmeans(gray.data_ptr(), out.data_ptr(), H, W, head.data_ptr(),
                             head.numel(), nlmeans_weight_table(float(h), TEMPLATE, SEARCH)[1],
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.raise_on(err, "nlmeans launch")
    LAUNCHES["nlmeans"] += 1
    return out

