"""Writing clips without an ffmpeg binary or an imaging library (counterpart
of ``fluidnexus_tpu/utils/video_io.py``, its ``write_video``).

The JAX package's chain: an mp4 through OpenCV's built-in encoder, else
imageio-ffmpeg, else an AVI. Its AVI holds JPEG frames encoded by PIL; the
port has no JPEG encoder (no imaging library may be needed on the card's
machine), so its last resort holds the frames uncompressed (24-bit 'DIB '
frames in a RIFF AVI, which ffmpeg and VLC play).
"""
from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np


def _to_uint8(frames) -> np.ndarray:
    arr = np.asarray(frames)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3:  # (T, H, W) gray -> RGB
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3) or (T, H, W), got {arr.shape}")
    return arr


def write_avi_raw(path: str, frames, fps: int = 8) -> str:
    """RIFF AVI with one uncompressed 'vids' stream (bottom-up BGR rows, each
    padded to 4 bytes); returns the written path."""
    arr = _to_uint8(frames)
    t, h, w = arr.shape[:3]
    row = (w * 3 + 3) // 4 * 4
    size = row * h

    def frame_bytes(f):
        out = np.zeros((h, row), np.uint8)
        out[:, :w * 3] = f[::-1, :, ::-1].reshape(h, w * 3)
        return out.tobytes()

    avih = struct.pack("<IIIIIIIIIIIIII", int(1e6 / max(fps, 1)), size * fps, 0, 0x10, t, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4H", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, t, size,
                       -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"\0\0\0\0", size, 0, 0, 0, 0)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index = b"", b""
    for f in arr:
        data = frame_bytes(f)
        index += struct.pack("<4sIII", b"00db", 0x10, 4 + len(movi), len(data))
        movi += chunk(b"00db", data)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", index)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _cv2_write_mp4(path: str, arr: np.ndarray, fps: int) -> Optional[str]:
    try:
        import cv2
    except ImportError:
        return None
    t, h, w = arr.shape[:3]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not out.isOpened():
        return None
    for frame in arr:
        out.write(frame[..., ::-1].copy())
    out.release()
    return path if os.path.exists(path) and os.path.getsize(path) > 0 else None


def write_video(path: str, frames, fps: int = 8) -> str:
    """Write (T, H, W, 3) frames (uint8, or float in [0, 1]) to ``path``: an
    mp4 through OpenCV, then imageio-ffmpeg; else an uncompressed AVI (the
    extension switched to .avi). Returns the path written."""
    arr = _to_uint8(frames)
    if path.endswith(".mp4"):
        out = _cv2_write_mp4(path, arr, fps)
        if out:
            return out
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(path, list(arr), fps=fps, quality=8, macro_block_size=1)
            return path
        except (ImportError, ValueError, RuntimeError):
            path = path[:-4] + ".avi"
    if not path.endswith(".avi"):
        path = path + ".avi"
    return write_avi_raw(path, arr, fps=fps)
