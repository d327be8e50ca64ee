"""OpenCV's non-local-means denoise of one 8-bit gray image
(``cv2.fastNlMeansDenoising(gray, None, h, template, search)``), which the
JAX package's ``data/dataset_builders.denoise_image`` calls on the host, as
integer arithmetic in plain PyTorch.

OpenCV's ``FastNlMeansDenoisingInvoker<uchar, int, unsigned, DistSquared,
int>`` (photo/src/fast_nlmeans_denoising_invoker.hpp) computes, for every
pixel and every offset of the ``search`` x ``search`` window around it:

- the sum of squared differences (``ssd``) between the ``template`` x
  ``template`` patches at the pixel and at the offset, over the image padded
  by ``search // 2 + template // 2`` with ``BORDER_REFLECT_101`` (applied
  repeatedly where the border is wider than the image: ``border_index``);
  its incremental column sums are exact integers, so the direct sum equals
  them;
- the weight ``table[ssd >> shift]``, where ``1 << shift`` is the power of
  two at or above ``template ** 2`` and entry ``a`` of the table is
  ``cvRound(mult exp(-(a 2^shift / template^2) / h^2))``, 0 below
  ``0.001 mult``, with ``mult = INT_MAX // (search^2 255)`` (19 096 at
  search 21);
- the output ``(sum w p + sum w / 2) / sum w`` in unsigned 32-bit integers,
  where ``p`` is the pixel at the offset (``sum w p`` stays under
  ``INT_MAX`` by the choice of ``mult``).

So the result is exact, and the card's kernel (``csrc/nlmeans.cu``, wrapper
``ops/nlmeans_cuda.py``) equals ``denoise_plain`` bit for bit. This module
is what the CPU runs; on the card nothing on the main path calls it.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

INT_MAX = 2 ** 31 - 1
WEIGHT_THRESHOLD = 0.001


@functools.lru_cache(maxsize=None)
def nlmeans_weight_table(h: float = 3.0, template: int = 7,
                         search: int = 21) -> Tuple[np.ndarray, int, int]:
    """(table, shift, mult): OpenCV's ``almost_dist2weight_`` as int64, the
    shift of ``ssd`` into its index and the fixed-point multiplier, built in
    float64 as OpenCV builds them (``h * h`` in float32, ``std::exp``, which
    ``math.exp`` is on the same C library, and ``cvRound``, half to even).
    The array is shared between callers: do not write to it."""
    mult = min(INT_MAX // (search * search * 255), INT_MAX)
    shift = 0
    while (1 << shift) < template * template:
        shift += 1
    to_dist = float(1 << shift) / (template * template)
    n = int(255 * 255 / to_dist + 1)
    hh = float(np.float32(h) * np.float32(h))
    table = np.zeros(n, np.int64)
    for a in range(n):
        w = math.exp(-(a * to_dist) / hh)
        if math.isnan(w):           # h = 0
            w = 1.0
        v = int(np.rint(mult * w))
        table[a] = 0 if v < WEIGHT_THRESHOLD * mult else v
    table.setflags(write=False)
    return table, shift, mult


def weight_head(h: float = 3.0, template: int = 7, search: int = 21) -> np.ndarray:
    """The table up to its last non-zero entry (indices 0-47 at h 3): every
    later index weighs 0, and the weights fall with the index."""
    table = nlmeans_weight_table(h, template, search)[0]
    nz = np.flatnonzero(table)
    return table[:int(nz[-1]) + 1 if nz.size else 0]


def border_index(n: int, pad: int) -> torch.Tensor:
    """Source index of each of the ``n + 2 pad`` positions of an axis of
    ``n`` padded by ``pad`` on both sides with OpenCV's
    ``BORDER_REFLECT_101`` (``borderInterpolate``'s loop, which reflects
    again where ``pad`` exceeds the axis)."""
    out = []
    for p in range(-pad, n + pad):
        if n == 1:
            p = 0
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * n - 2 - p
        out.append(p)
    return torch.tensor(out, dtype=torch.long)


def _box_sum(d: torch.Tensor, k: int) -> torch.Tensor:
    """Sums of every k x k window over the last two axes, by a summed-area
    table in the input's integer type: (..., H + k - 1, W + k - 1) ->
    (..., H, W)."""
    s = torch.nn.functional.pad(d.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    return s[..., k:, k:] - s[..., :-k, k:] - s[..., k:, :-k] + s[..., :-k, :-k]


def denoise_plain(gray_u8: torch.Tensor, h: float = 3.0, template: int = 7,
                  search: int = 21) -> torch.Tensor:
    """``cv2.fastNlMeansDenoising(gray, None, h, template, search)`` of a
    uint8 (H, W) tensor, on its device, in int64: one search row (``search``
    offsets) at a time. Returns uint8 (H, W)."""
    if gray_u8.dtype != torch.uint8 or gray_u8.dim() != 2:
        raise ValueError(f"denoise_plain takes a uint8 (H, W) tensor, got {gray_u8.dtype} "
                         f"{tuple(gray_u8.shape)}")
    if template % 2 == 0 or search % 2 == 0:
        raise ValueError(f"template ({template}) and search ({search}) must be odd")
    H, W = gray_u8.shape
    dev = gray_u8.device
    table, shift, _ = nlmeans_weight_table(h, template, search)
    table = torch.tensor(table, device=dev)
    tw, sw = template // 2, search // 2
    b = tw + sw
    rows, cols = border_index(H, b).to(dev), border_index(W, b).to(dev)
    pad = gray_u8.long()[rows][:, cols]                     # (H + 2b, W + 2b)
    a = pad[sw:sw + H + 2 * tw, sw:sw + W + 2 * tw]         # the pixels' own patches
    est = torch.zeros((H, W), dtype=torch.long, device=dev)
    wsum = torch.zeros_like(est)
    for dy in range(search):
        band = pad[dy:dy + H + 2 * tw]
        other = torch.stack([band[:, dx:dx + W + 2 * tw] for dx in range(search)])
        ssd = _box_sum((a - other) ** 2, template)          # (search, H, W)
        w = table[ssd >> shift]
        p = torch.stack([band[tw:tw + H, tw + dx:tw + dx + W] for dx in range(search)])
        est += (w * p).sum(0)
        wsum += w.sum(0)
    return ((est + wsum // 2) // wsum).to(torch.uint8)
