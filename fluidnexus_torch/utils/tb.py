"""TensorBoard logging for the training pipelines (counterpart of
``fluidnexus_tpu/utils/tb.py``, what the port's pipelines use of it): an
event file rooted at the run's folder, written here with no tensorboard,
TensorFlow or imaging package, so a stage's process imports none of them.
Images are (H, W), (H, W, C) or (C, H, W) float arrays in [0, 1].

The file is what ``torch.utils.tensorboard.SummaryWriter`` writes:
``events.out.tfevents.*`` records (a little-endian length, its masked
CRC-32C, the serialized ``Event``, its masked CRC-32C), the first holding
the file version, then one ``Event`` (wall time, step, a ``Summary`` of one
value) for each scalar or image; an image value holds its PNG, 8-bit RGB
(gray repeated), as ``SummaryWriter.add_image`` encodes it. Each record is
flushed as it is written.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from fluidnexus_torch.utils.png import encode_png


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: Optional[int] = None, file_version: Optional[str] = None,
           value: Optional[bytes] = None) -> bytes:
    """A serialized ``Event``: wall_time = 1 (double), step = 2 (int64),
    file_version = 3, summary = 5 (a ``Summary`` of the one ``value``)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step is not None:
        out += b"\x10" + _varint(step)
    if file_version is not None:
        out += _field(3, file_version.encode())
    if value is not None:
        out += _field(5, _field(1, value))
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """``Summary.Value``: tag = 1, simple_value = 2 (float)."""
    return _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)


def _image_value(tag: str, hwc: np.ndarray) -> bytes:
    """``Summary.Value`` with image = 4: ``Summary.Image`` height = 1,
    width = 2, colorspace = 3, encoded_image_string = 4."""
    h, w, c = hwc.shape
    image = (b"\x08" + _varint(h) + b"\x10" + _varint(w) + b"\x18" + _varint(c)
             + _field(4, encode_png(hwc)))
    return _field(1, tag.encode()) + _field(4, image)


class TrainLogger:
    """An event-file writer rooted at ``model_path``; every method is a
    no-op without one."""

    _files = 0

    def __init__(self, model_path: Optional[str]):
        self._path = None
        if not model_path:
            return
        os.makedirs(model_path, exist_ok=True)
        TrainLogger._files += 1
        self._path = os.path.join(
            model_path, f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                        f"{os.getpid()}.{TrainLogger._files}")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes):
        header = struct.pack("<Q", len(event))
        with open(self._path, "ab") as f:
            f.write(header + struct.pack("<I", _masked_crc(header)) + event
                    + struct.pack("<I", _masked_crc(event)))

    @property
    def enabled(self) -> bool:
        return self._path is not None

    def add_scalar(self, tag: str, value, step: int):
        if self._path is not None:
            self._write(_event(time.time(), int(step), value=_scalar_value(tag, float(value))))

    scalar = add_scalar

    def scalars(self, prefix: str, values: dict, step: int):
        """``prefix/key`` scalars of a dict; a value that is not one number
        is skipped."""
        for k, v in values.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(np.asarray(v)), step)
            except (TypeError, ValueError):
                pass

    def add_image(self, tag: str, img, step: int):
        """(H, W) / (H, W, C) / (C, H, W) float in [0, 1] -> a TB image."""
        if self._path is None:
            return
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        elif not (arr.shape[-1] in (1, 3) and arr.shape[0] not in (1, 3)):
            arr = arr.transpose(1, 2, 0)   # (C, H, W)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        u8 = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        self._write(_event(time.time(), int(step), value=_image_value(tag, u8)))

    def image_grid(self, tag: str, imgs, step: int, ncol: int = 8):
        """(N, H, W), (N, H, W, C) or (N, C, H, W) floats in [0, 1] as one
        tiled grid."""
        if self._path is None:
            return
        arr = np.asarray(imgs, np.float32)
        if arr.ndim == 3:
            arr = arr[..., None]
        elif arr.ndim == 4 and arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = arr.transpose(0, 2, 3, 1)
        n, h, w, c = arr.shape
        ncol = min(ncol, n)
        nrow = -(-n // ncol)
        pad = nrow * ncol - n
        if pad:
            arr = np.concatenate([arr, np.zeros((pad, h, w, c), np.float32)])
        grid = (arr.reshape(nrow, ncol, h, w, c).transpose(0, 2, 1, 3, 4)
                .reshape(nrow * h, ncol * w, c))
        self.add_image(tag, grid, step)


def device_memory_stats(device=None) -> dict:
    """Peak, in-use and total memory of a CUDA device in MiB, from the CUDA
    caching allocator: ``peak_mib`` (``max_memory_allocated``), ``in_use_mib``
    (``memory_allocated``) and ``limit_mib`` (the card's total memory). An
    empty dict for a CPU device, or with no device given and no card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"peak_mib": torch.cuda.max_memory_allocated(device) / 2**20,
            "in_use_mib": torch.cuda.memory_allocated(device) / 2**20,
            "limit_mib": torch.cuda.get_device_properties(device).total_memory / 2**20}
