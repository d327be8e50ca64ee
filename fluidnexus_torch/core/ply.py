"""Minimal binary PLY I/O (no plyfile dependency).

Writes/reads the reference background-Gaussian attribute layout
(gm_background.construct_list_of_attributes:203-231: x,y,z,nx,ny,nz,
f_dc_*, f_rest_*, opacity, scale_*, rot_*, color_*), including the x/y sign
flip the reference applies for supersplat compatibility (save_ply:208-210)
and undoes on load (gm_dynamics.load_ply:1702-1708).
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

SH_C0 = 0.28209479177387814


def write_ply(path: str, fields: Dict[str, np.ndarray]):
    """fields: name -> (N,) float32 column, written in insertion order."""
    n = len(next(iter(fields.values())))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in fields]
    header += ["end_header"]
    data = np.empty((n, len(fields)), np.float32)
    for i, (name, col) in enumerate(fields.items()):
        data[:, i] = np.asarray(col, np.float32).reshape(-1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        names: List[str] = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line.startswith("property"):
                raise ValueError(f"unsupported property type: {line}")
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(names) * 4), np.float32).reshape(n, len(names))
    return {name: data[:, i].copy() for i, name in enumerate(names)}


def save_background_ply(path: str, xyz, color, opacity, scaling, rotation):
    """Reference save_ply layout with the supersplat x/y flip
    (gm_background.py:203-230). color is raw RGB; f_dc holds rgb2sh(color)."""
    xyz = np.asarray(xyz, np.float32).copy()
    xyz[:, 0] *= -1.0
    xyz[:, 1] *= -1.0
    color = np.asarray(color, np.float32)
    shs = (color - 0.5) / SH_C0
    fields: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        fields[ax] = xyz[:, i]
    for i, ax in enumerate("xyz"):
        fields["n" + ax] = np.zeros(len(xyz), np.float32)
    for i in range(color.shape[1]):
        fields[f"f_dc_{i}"] = shs[:, i]
    for i in range(color.shape[1]):
        fields[f"f_rest_{i}"] = np.zeros(len(xyz), np.float32)
    fields["opacity"] = np.asarray(opacity, np.float32).reshape(-1)
    scaling = np.asarray(scaling, np.float32)
    for i in range(scaling.shape[1]):
        fields[f"scale_{i}"] = scaling[:, i]
    rotation = np.asarray(rotation, np.float32)
    for i in range(rotation.shape[1]):
        fields[f"rot_{i}"] = rotation[:, i]
    for i in range(color.shape[1]):
        fields[f"color_{i}"] = color[:, i]
    write_ply(path, fields)


def load_background_ply(path: str) -> Dict[str, np.ndarray]:
    """Load a background PLY, un-flipping x/y (gm_dynamics.load_ply:1702-1708
    reads color_* columns and flips the sign of x,y). Returns dict with
    xyz, color, opacity, scaling, rotation."""
    fields = read_ply(path)
    n = len(fields["x"])
    xyz = np.stack([-fields["x"], -fields["y"], fields["z"]], 1)
    color_names = sorted((k for k in fields if k.startswith("color_")), key=lambda s: int(s.split("_")[-1]))
    if color_names:
        color = np.stack([fields[k] for k in color_names], 1)
    else:  # fall back to f_dc (standard 3DGS ply)
        dc = sorted((k for k in fields if k.startswith("f_dc_")), key=lambda s: int(s.split("_")[-1]))
        color = np.stack([fields[k] for k in dc], 1) * SH_C0 + 0.5
    scale_names = sorted((k for k in fields if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((k for k in fields if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1]))
    return dict(
        xyz=xyz.astype(np.float32),
        color=color.astype(np.float32),
        opacity=fields["opacity"].reshape(-1, 1),
        scaling=np.stack([fields[k] for k in scale_names], 1),
        rotation=np.stack([fields[k] for k in rot_names], 1),
    )
