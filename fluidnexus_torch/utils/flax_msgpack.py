"""Flax parameter files as ``FlaxPreTrainedModel.from_pretrained`` reads them
(``flax_model.msgpack``, or ``flax_model.msgpack.index.json`` with its
shards), decoded without flax, JAX or the ``msgpack`` package.

The format is flax's ``msgpack_serialize``: maps of maps whose leaves are
msgpack ext values of type 1, each itself a msgpack array ``(shape, dtype
name, raw C-order bytes)``; a leaf over 2^30 bytes is a map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat part, ...}}``. A sharded checkpoint (transformers'
``flax_model-0000k-of-0000n.msgpack`` files) holds one such tree a shard;
the trees are merged, as transformers merges them.

Leaves come back as numpy arrays viewing the file's bytes (one buffer a
file, no copy). A bfloat16 leaf, which numpy has no type for, comes back
widened to float32, exactly (a bf16 value is the top half of an f32); Flax's
``Dense`` promotes such a kernel to the f32 it computes in the same way.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

WEIGHTS_NAME = "flax_model.msgpack"
INDEX_NAME = "flax_model.msgpack.index.json"
_CHUNKED = "__msgpack_chunked_array__"


class _Ext:
    __slots__ = ("code", "data")

    def __init__(self, code, data):
        self.code, self.data = code, data


class _Reader:
    """A msgpack decoder over one buffer: every type of the format but
    timestamps (an ext like any other here). Bin and ext payloads are
    memoryview slices of the buffer."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack data ends inside a value")
        self.pos += n
        return out

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self._unpack(">b")
            return _Ext(code, self._take(n))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return _Ext(code, self._take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")

    def _str(self, n):
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(buf):
    """The one msgpack value in ``buf`` (bytes, bytearray or memoryview);
    maps as dicts, arrays as lists, bin as memoryviews, ext as ``_Ext``."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes left after the msgpack value")
    return out


def _ndarray(data):
    """A flax ndarray ext payload: msgpack ``(shape, dtype name, bytes)``."""
    shape, name, raw = unpackb(data)
    name = name if isinstance(name, str) else bytes(name).decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _leaves(node):
    """Ext leaves decoded (type 1 ndarrays, type 3 numpy scalars) and
    chunked leaves joined, through maps and arrays."""
    if isinstance(node, _Ext):
        if node.code == 1:
            return _ndarray(node.data)
        if node.code == 3:
            return _ndarray(node.data)[()]
        raise ValueError(f"msgpack ext type {node.code} is not one flax writes")
    if isinstance(node, list):
        return [_leaves(v) for v in node]
    if isinstance(node, dict):
        if node.get(_CHUNKED) is True:
            shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
            chunks = [_leaves(node["chunks"][str(i)]) for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _leaves(v) for k, v in node.items()}
    return node


def _read_buffer(path):
    """The file's bytes in one writable buffer (arrays viewing it are
    writable, so torch takes them without a copy or a warning)."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise OSError(f"{path}: short read")
    return buf


def load_msgpack(path):
    """The tree of one flax msgpack file: nested dicts of numpy arrays."""
    return _leaves(unpackb(_read_buffer(path)))


def _merge(into, tree, where):
    for k, v in tree.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v, f"{where}/{k}")
        elif k in into:
            raise ValueError(f"{where}/{k} is in two shards")
        else:
            into[k] = v


def load_flax_checkpoint(model_dir: str):
    """The parameter tree ``FlaxPreTrainedModel.from_pretrained(model_dir)``
    reads: ``flax_model.msgpack``, else the shards that
    ``flax_model.msgpack.index.json`` names, merged. Raises
    FileNotFoundError naming both when the directory holds neither."""
    single = os.path.join(model_dir, WEIGHTS_NAME)
    index = os.path.join(model_dir, INDEX_NAME)
    if os.path.isfile(single):
        return load_msgpack(single)
    if not os.path.isfile(index):
        raise FileNotFoundError(f"{model_dir!r} holds neither {WEIGHTS_NAME} nor {INDEX_NAME} "
                                "(a Hugging Face Flax checkpoint directory)")
    with open(index) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    tree: dict = {}
    for name in shards:
        _merge(tree, load_msgpack(os.path.join(model_dir, name)), "")
    return tree
