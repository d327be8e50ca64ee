"""Network-parameter checkpoints in the JAX package's flat-npz format
(counterpart of ``fluidnexus_tpu/core/checkpoint.py``, its npz branch): one
array per leaf under its /-joined path. Orbax directories are neither written
nor read here.
"""
from __future__ import annotations

import os

import numpy as np


def save_params(path: str, params):
    """Write a nested dict of numpy arrays as ``<path>.npz`` (``.npz`` not
    repeated), keys /-joined; returns ``path``."""
    flat = {}

    def add(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                add(key, v)
            else:
                flat[key] = np.asarray(v)

    add("", params)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    return path


def load_params_prefer_ema(path: str):
    """Load ``<path>_ema`` when it exists, else ``<path>``: sampling reads the
    EMA weights that training saves beside the plain ones."""
    base = path.rstrip("/")
    if base.endswith(".npz"):
        base = base[:-4]
    ema = base + "_ema"
    if os.path.isdir(ema) or os.path.exists(ema) or os.path.exists(ema + ".npz"):
        return load_params(ema)
    return load_params(path)


def load_params(path: str):
    """The nested dict of numpy arrays saved at ``path`` (``.npz`` optional)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is an orbax checkpoint directory; only the flat-npz format is read "
            "here (save with the JAX package's npz fallback)")
    out: dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            parts = key.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = data[key]
    return out
