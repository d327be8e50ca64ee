"""Network-parameter checkpoints (counterpart of
``fluidnexus_tpu/core/checkpoint.py``). Written in the JAX package's
flat-npz format: one array per leaf under its /-joined path. Read in that
format and in the orbax directory format that the JAX package's
``save_params`` writes where ``orbax.checkpoint`` imports (its default).

An orbax directory (``StandardCheckpointer``, OCDBT) is read with
``tensorstore`` alone, imported when one is read: ``_METADATA`` lists the
tree's leaves by key path, and each leaf is a zarr array (zarr v2, or v3
where newer orbax wrote ``zarr.json``) in the directory's OCDBT key-value
store under its dotted path (``unet.conv.kernel``).
"""
from __future__ import annotations

import json
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


def _load_orbax(path: str):
    """The tree of an orbax ``StandardCheckpointer`` directory, as numpy."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path!r} is a directory without _METADATA: not an orbax "
                                "checkpoint (nor the flat-npz format)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{path!r} is an orbax checkpoint directory, which is read with the tensorstore "
            "package, and tensorstore does not import here; install it, or save the "
            "checkpoint in the flat-npz format (the JAX package's save_params writes .npz "
            "where orbax does not import)") from e
    with open(meta_path) as f:
        meta = json.load(f)
    kvstore = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}
    keys = {k.decode() for k in ts.KvStore.open(kvstore).result().list().result()}
    out: dict = {}
    for entry in meta["tree_metadata"].values():
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        names = [str(k["key"]) for k in entry["key_metadata"]]
        leaf = ".".join(names)
        zarr = "zarr3" if f"{leaf}/zarr.json" in keys else "zarr"
        if zarr == "zarr" and f"{leaf}/.zarray" not in keys:
            raise FileNotFoundError(f"{path!r}: no array stored for the leaf {leaf!r}")
        arr = ts.open({"driver": zarr, "kvstore": kvstore, "path": leaf},
                      open=True, read=True).result().read().result()
        node = out
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = np.asarray(arr)
    return out


def load_params(path: str):
    """The nested dict of numpy arrays saved at ``path``: an orbax directory
    (bf16 leaves as ``ml_dtypes.bfloat16``, which tensorstore needs anyway),
    or the flat npz (``.npz`` optional)."""
    if os.path.isdir(path):
        return _load_orbax(path)
    out: dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            parts = key.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = data[key]
    return out
