"""Builds the port's CUDA sources (``fluidnexus_torch/csrc/*.cu``) with ``nvcc``
for Hopper (``sm_90a``) into shared libraries with a plain C interface, and
loads them with ``ctypes``.

A library is built at first use into ``fluidnexus_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused. ``build`` starts one ``nvcc`` per
source, all at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
                       "kernels of fluidnexus_torch are built on the machine with the card")


def library_path(name: str) -> Path:
    """The library of ``name``, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: {"seconds", "log", "path"}}
    where ``log`` is nvcc's output (its ``-Xptxas -v`` register and
    shared-memory report) or "cached". Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": "cached", "path": str(path)}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log, "path": str(path)}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiling it first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))


HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_HOST_LOCK = threading.Lock()


def load_host(name: str) -> ctypes.CDLL:
    """The host library built from ``csrc/{name}.cpp``, compiling it first
    if it is not built yet. Raises if the compiler is missing or fails.
    Thread-safe: the readers decode on a thread pool, and the first calls
    must not build it twice."""
    with _HOST_LOCK:
        return _load_host(name)


@functools.lru_cache(maxsize=None)
def _load_host(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cpp"
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(f"no host C++ compiler ($CXX, g++ or c++) to build {src}")
    digest = hashlib.sha1(src.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed ({cxx} exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


# ------------------------- checks shared by the wrappers ---------------------


def check(x, name, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err, what):
    """Raise on a non-zero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only, got {x.device}")
