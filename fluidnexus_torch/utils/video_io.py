"""Video files without an ffmpeg binary or an imaging library (counterpart
of ``fluidnexus_tpu/utils/video_io.py``).

Writing, the JAX package's chain: an mp4 through OpenCV's built-in encoder,
else imageio-ffmpeg, else an AVI. Its AVI holds JPEG frames encoded by PIL;
the port has no JPEG encoder (no imaging library may be needed on the card's
machine), so its last resort holds the frames uncompressed (24-bit 'DIB '
frames in a RIFF AVI, which ffmpeg and VLC play).

Reading (``read_video_with_fps``, ``read_video``): an AVI of uncompressed
frames, the port's own, is read by ``read_avi_raw`` (OpenCV 5.0.0's FFmpeg
backend corrupts its heap decoding one); any other file through OpenCV when
it imports, else an AVI through ``read_avi_raw`` (which raises on an MJPEG
frame: the port has no JPEG decoder) and the rest through imageio, as in
the JAX package.

``frames_folder_to_video`` packs a folder of PNG frames (read by
``utils/png.read_png``) into a video.
"""
from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from fluidnexus_torch.utils.png import read_png, to_rgb


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


def _avi_chunks(data: bytes, path: str):
    """(fourcc, payload) of every chunk of a RIFF AVI, LIST chunks
    descended into."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI")
    pos, ends = 12, [len(data)]
    while pos + 8 <= ends[-1]:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if fourcc == b"LIST":
            ends.append(pos + 8 + size)
            pos += 12  # past the list type
            continue
        yield fourcc, data[pos + 8:pos + 8 + size]
        pos += 8 + size + size % 2
        while len(ends) > 1 and pos >= ends[-1]:
            ends.pop()


def _avi_format(data: bytes, path: str):
    """(width, height, bit count, compression fourcc, fps) of the AVI's
    first video stream."""
    video, fps = False, 0.0
    for fourcc, body in _avi_chunks(data, path):
        if fourcc == b"strh":
            video = body[:4] == b"vids"
            if video:
                scale, rate = struct.unpack("<II", body[20:28])
                fps = rate / scale if scale else 0.0
        elif fourcc == b"strf" and video:
            _, w, h, _, bits, comp = struct.unpack("<IiiHH4s", body[:20])
            return w, h, bits, comp, fps
    raise ValueError(f"{path}: an AVI with no video stream format")


def _is_raw_avi(path: str) -> bool:
    if not path.endswith(".avi"):
        return False
    with open(path, "rb") as f:
        data = f.read()
    return _avi_format(data, path)[3] == b"\0\0\0\0"


def read_avi_raw(path: str):
    """(frames (T, H, W, 3) uint8 RGB, fps) of an AVI of uncompressed 24-bit
    frames ('00db' chunks of BGR rows, bottom-up for a positive height, each
    row padded to 4 bytes): the format ``write_avi_raw`` writes. A JPEG
    frame ('00dc' or an MJPG stream) raises NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, bits, comp, fps = _avi_format(data, path)
    if comp != b"\0\0\0\0" or bits != 24:
        raise NotImplementedError(
            f"{path}: frames of compression {comp!r} at {bits} bits; the port reads only "
            "uncompressed 24-bit AVIs, and an MJPEG AVI waits for a JPEG decoder (the JAX "
            "package decodes it with PIL or OpenCV)")
    row, hh = (w * 3 + 3) // 4 * 4, abs(h)
    frames: List[np.ndarray] = []
    for fourcc, body in _avi_chunks(data, path):
        if fourcc[2:] == b"dc":
            raise NotImplementedError(f"{path}: a compressed frame chunk {fourcc!r} waits for "
                                      "a JPEG decoder")
        if fourcc[2:] == b"db" and body:
            img = np.frombuffer(body[:row * hh], np.uint8).reshape(hh, row)[:, :w * 3]
            img = img.reshape(hh, w, 3)[..., ::-1]
            frames.append(img[::-1] if h > 0 else img)
    if not frames:
        raise ValueError(f"{path}: no video chunks")
    return np.ascontiguousarray(np.stack(frames)), fps


def _cv2_read(path: str):
    """(frames uint8 RGB, fps) through OpenCV, or None where it does not
    import or cannot open the file."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
    frames: List[np.ndarray] = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1].copy())
    cap.release()
    if not frames:
        return None
    return np.stack(frames), fps


def read_video_with_fps(path: str):
    """(frames (T, H, W, 3) uint8, fps); fps is 0.0 where the container
    lacks it (module docstring for the decoders tried)."""
    if _is_raw_avi(path):
        return read_avi_raw(path)
    got = _cv2_read(path)
    if got is not None:
        return got
    if path.endswith(".avi"):
        return read_avi_raw(path)
    import imageio.v2 as imageio

    reader = imageio.get_reader(path)
    fps = float(reader.get_meta_data().get("fps", 0.0) or 0.0)
    return np.stack([np.asarray(f) for f in reader]), fps


def read_video(path: str) -> np.ndarray:
    return read_video_with_fps(path)[0]


def frames_folder_to_video(folder: str, out_path: Optional[str] = None, fps: int = 8,
                           pattern: str = ".png") -> str:
    """Pack the folder's frames (file names ending in ``pattern``, in name
    order, as RGB) into a video at ``out_path`` (default: the folder's name
    + .mp4) through ``write_video``; returns the path written."""
    names = sorted(f for f in os.listdir(folder) if f.endswith(pattern))
    if not names:
        raise FileNotFoundError(f"no {pattern} frames in {folder}")
    frames = np.stack([to_rgb(read_png(os.path.join(folder, n))) for n in names])
    return write_video(out_path or folder.rstrip("/") + ".mp4", frames, fps=fps)
