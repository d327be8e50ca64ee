"""The background stage (counterpart of
``fluidnexus_tpu/pipelines/train_background.py``). Ported so far:
``save_image``, which the future stage writes its renders with. The stage's
fit comes with its own slice.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_image(path, img_chw):
    """A (C, H, W) image in [0, 1] as an 8-bit PNG, gray for one channel and
    RGB for three: the pixels the JAX package's PIL writer stores
    (clip to [0, 1], times 255, truncated to uint8), written by a small
    zlib + struct encoder (filter 0 on every row), so no imaging library is
    needed."""
    arr = (torch.clamp(torch.as_tensor(img_chw), 0, 1) * 255).detach().cpu().numpy()
    arr = arr.astype(np.uint8).transpose(1, 2, 0)
    h, w, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"save_image writes 1 or 3 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
