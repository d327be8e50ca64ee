"""A PNG reader with no imaging library (zlib + struct), the inverse of
``pipelines/train_background.save_image``: the card's machine has no Pillow.

``read_png`` decodes every PNG that the JAX package's native loader
(``runtime/image_loader.cpp``, libpng) reads: gray at 1, 2, 4, 8 and 16
bits, gray + alpha, RGB and RGBA at 8 and 16 bits, palette images at 1-8
bits, any of the five row filters, plain or Adam7-interlaced. It returns 8
bits a sample as libpng's transforms give them: 16 bits stripped to their
high byte, gray under 8 bits scaled to 8 (x 255, 85 or 17), the palette
expanded to RGB, and a tRNS chunk turned into an alpha channel. ``to_rgb``
then gives what the native loader hands on (gray repeated, alpha dropped),
which is also what PIL's ``convert("RGB")`` gives for 8-bit files.

The rows are unfiltered by compiled host code (``csrc/png_unfilter.cpp``,
built at first use); ``_unfilter_plain`` is its plain Python version.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # color type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter_plain(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The five row filters undone in Python: (h, rowbytes) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:                        # sub: a running sum per byte of a pixel
            cur_l, ln = [0] * rowbytes, line.tolist()
            for x in range(rowbytes):
                cur_l[x] = (ln[x] + (cur_l[x - bpp] if x >= bpp else 0)) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        elif ftype == 2:                        # up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                   # average, Paeth: left to right
            cur_l, ln, up = [0] * rowbytes, line.tolist(), prev.tolist()
            for x in range(rowbytes):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[x - bpp] if x >= bpp else 0
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


def _lib():
    from fluidnexus_torch.ops.cuda_build import load_host

    lib = load_host("png_unfilter")
    if not getattr(lib, "_fnx_typed", False):
        lib.fnx_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
        lib.fnx_png_unfilter.restype = ctypes.c_int
        lib._fnx_typed = True
    return lib


def unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """``_unfilter_plain`` in compiled host code: (h, rowbytes) uint8."""
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {h} rows need {h * (rowbytes + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, rowbytes), np.uint8)
    if h:
        err = _lib().fnx_png_unfilter(src.ctypes.data, out.ctypes.data, h, rowbytes, bpp)
        if err:
            y = -err - 1
            raise ValueError(f"PNG row {y} has filter type {src[y * (rowbytes + 1)]}")
    return out


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, w, c) samples: 16 bits as uint16, else uint8
    values at their own depth (not yet scaled)."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows[:, :2 * w * c].reshape(h, w, c, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)                          # (h, rowbytes * 8), MSB first
    bits = bits[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]  # c == 1 below 8 bits


def _decode_rows(data: bytes, w: int, h: int, c: int, depth: int, interlace: int) -> np.ndarray:
    bits_pp = c * depth
    bpp = max(1, bits_pp // 8)
    if not interlace:
        rowbytes = (w * bits_pp + 7) // 8
        return _samples(unfilter(data, h, rowbytes, bpp), w, c, depth)
    out = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * bits_pp + 7) // 8
        n = ph * (rowbytes + 1)
        out[y0::dy, x0::dx] = _samples(unfilter(data[pos:pos + n], ph, rowbytes, bpp), pw, c,
                                       depth)
        pos += n
    return out


def read_png(path: str) -> np.ndarray:
    """The image at ``path`` as uint8 (H, W, C): C = 1 (gray), 2 (gray +
    alpha), 3 (RGB) or 4 (RGBA), 8 bits a sample as libpng's transforms give
    them (module docstring). Raises ValueError, naming the file and its
    format, for a file that is not a PNG or holds a format the PNG standard
    does not define."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, header, idat, plte, trns = len(_SIGNATURE), None, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or comp != 0 or filt != 0 \
            or interlace not in (0, 1):
        raise ValueError(f"{path}: not a format of the PNG standard (bit depth {depth}, "
                         f"color type {ctype}, compression {comp}, filter {filt}, interlace "
                         f"{interlace})")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: a palette image (color type 3) with no PLTE chunk")
    c = _CHANNELS[ctype]
    s = _decode_rows(zlib.decompress(b"".join(idat)), w, h, c, depth, interlace)

    alpha = None
    if ctype == 3:
        idx = s[..., 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError(f"{path}: a palette index past the {len(plte)} PLTE entries")
        if trns is not None:
            table = np.full(len(plte), 255, np.uint8)
            n = min(len(trns), len(plte))
            table[:n] = np.frombuffer(trns[:n], np.uint8)
            alpha = table[idx]
        s = plte[idx]
    elif trns is not None and ctype in (0, 2):
        # the transparent colour, compared at the file's own depth
        key = np.array(struct.unpack(f">{c}H", trns[:2 * c]), np.uint16)
        alpha = np.where((s == key.astype(s.dtype)).all(-1), 0, 255).astype(np.uint8)
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    elif depth < 8 and ctype == 0:
        s = s * np.uint8(255 // ((1 << depth) - 1))
    s = np.ascontiguousarray(s, np.uint8)
    if alpha is not None:
        s = np.concatenate([s, alpha[..., None]], -1)
    return s


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): gray repeated, alpha dropped."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]
