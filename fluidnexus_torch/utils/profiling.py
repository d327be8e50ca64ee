"""Tracing and stage timing for the pipelines (counterpart of
``fluidnexus_tpu/utils/profiling.py``): ``trace`` is a ``torch.profiler``
trace (CPU, and CUDA when there is a card) written for TensorBoard,
``annotate`` a named span on its timeline, and ``StageTimer`` a timer of
named stages that, for a stage whose ``block_on`` holds a CUDA tensor, waits
for the card and takes the stage's time from CUDA events.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the enclosed block into ``log_dir``
    (TensorBoard's profiler plugin reads it); nothing when log_dir is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named span on the profiler's timeline (free when no trace runs)."""
    return torch.profiler.record_function(name)


class _StageHandle:
    __slots__ = ("block_on",)

    def __init__(self, block_on=None):
        self.block_on = block_on


def _cuda_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x] if x.is_cuda else []
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _cuda_tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _cuda_tensors(y)]
    return []


class StageTimer:
    """Accumulating timer of named pipeline stages. Set ``holder.block_on``
    to the stage's outputs inside the block: when they are CUDA tensors the
    timer waits for the card and the stage's time is the CUDA events' time
    from the block's start to its end on the current stream; otherwise it is
    the host's. ``ms[name]`` keeps every call's ms."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.ms: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        holder = _StageHandle(block_on)
        start = None
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            dt = None
            if start is not None and _cuda_tensors(holder.block_on):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            if dt is None:
                dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.ms.setdefault(name, []).append(dt * 1e3)

    def report(self) -> str:
        parts = [f"{k} {self.totals[k]:.3f}s/{self.counts[k]}x"
                 for k in sorted(self.totals, key=self.totals.get, reverse=True)]
        return " | ".join(parts)
