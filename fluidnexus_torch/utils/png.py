"""A PNG reader with no imaging library (zlib + struct), the inverse of
``pipelines/train_background.save_image``: the card's machine has no Pillow.

``read_png`` decodes non-interlaced 8-bit gray, gray + alpha, RGB and RGBA
images with any of the five row filters; ``to_rgb`` gives what PIL's
``convert("RGB")`` gives for them (gray repeated, alpha dropped).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # color type -> channels


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:                        # sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(stride) & 0xFF
        elif ftype == 2:                        # up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                   # average, Paeth: left to right
            cur_l, ln, up = [0] * stride, line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur_l[x - c] if x >= c else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                cur_l[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The image at ``path`` as uint8 (H, W, C), C = 1, 2, 3 or 4."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit gray, gray + alpha, RGB and RGBA "
                         f"are read (bit depth {depth}, color type {ctype}, interlace "
                         f"{interlace})")
    c = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): gray repeated, alpha dropped."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]
