"""PIL's LANCZOS resample, arithmetic for arithmetic, on the host with numpy:
the JAX package resizes through Pillow (``Image.resize(..., Image.LANCZOS)``)
and the card's machine has no Pillow.

This is Pillow's ``libImaging/Resample.c`` for a whole-image box:

- an axis whose size changes gets one pass, the horizontal pass first;
- for output index ``xx``: ``scale = in / out``, ``fs = max(scale, 1)``,
  ``support = 3 fs``, ``center = (xx + 0.5) scale``; the taps run from
  ``xmin = max(int(center - support + 0.5), 0)`` to
  ``min(int(center + support + 0.5), in)``, each weighing
  ``lanczos((x + xmin - center + 0.5) / fs)`` (``sinc(t) sinc(t / 3)`` on
  [-3, 3), in double), and the weights are divided by their sum;
- 8 bits (``resize_u8``): each weight becomes ``int(w 2^22 +- 0.5)``, the
  integer sum starts at 2^21, is shifted right by 22 and clipped to 0-255
  after each pass;
- mode "F" (``resize_f32``): a double sum over the taps in order with the
  weights as they are, stored as float32 after each pass.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for LANCZOS over the whole axis:
    (xmin (out,), taps (out,), weights (out, ksize) float64, zero past each
    output's taps)."""
    scale = float(in_size) / out_size
    fs = max(scale, 1.0)
    support = 3.0 * fs
    ss = 1.0 / fs
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            w = _lanczos((x + xmin - center + 0.5) * ss)
            kk[xx, x] = w
            ww += w
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        xmins[xx], taps[xx] = xmin, xmax
    return xmins, taps, kk


def _pass(a: np.ndarray, axis: int, out_size: int, eight_bit: bool) -> np.ndarray:
    in_size = a.shape[axis]
    xmin, _, kk = coefficients(in_size, out_size)
    ksize = kk.shape[1]
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    bshape = [1] * a.ndim
    bshape[axis] = out_size
    if eight_bit:
        q = np.trunc(np.where(kk < 0, kk * (1 << PRECISION_BITS) - 0.5,
                              kk * (1 << PRECISION_BITS) + 0.5)).astype(np.int64)
        acc = np.full([out_size if d == axis else s for d, s in enumerate(a.shape)],
                      1 << (PRECISION_BITS - 1), np.int64)
        for x in range(ksize):
            acc += np.take(a, idx[:, x], axis=axis).astype(np.int64) * q[:, x].reshape(bshape)
        return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    acc = np.zeros([out_size if d == axis else s for d, s in enumerate(a.shape)], np.float64)
    for x in range(ksize):  # the taps in order, as Pillow's loop adds them
        acc += np.take(a, idx[:, x], axis=axis).astype(np.float64) * kk[:, x].reshape(bshape)
    return acc.astype(np.float32)


def _resize(a: np.ndarray, width: int, height: int, eight_bit: bool) -> np.ndarray:
    if width <= 0 or height <= 0:
        raise ValueError(f"a LANCZOS resample to {width} x {height}")
    if a.shape[1] != width:
        a = _pass(a, 1, width, eight_bit)
    if a.shape[0] != height:
        a = _pass(a, 0, height, eight_bit)
    return a


def resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (height, width[, C]) uint8, as
    ``Image.fromarray(img).resize((width, height), Image.LANCZOS)`` for
    modes "L" and "RGB"."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_u8 takes uint8 images, got {img.dtype}")
    return _resize(img, width, height, True)


def resize_f32(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W) float32 -> (height, width) float32, as PIL's mode "F" resample
    (unclipped)."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"resize_f32 takes (H, W) float32 images, got {img.dtype} {img.shape}")
    return _resize(img, width, height, False)
