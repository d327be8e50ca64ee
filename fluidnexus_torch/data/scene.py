"""Scene assembly (counterpart of ``fluidnexus_tpu/data/scene.py``); only the
per-frame camera grouping so far — ``read_scene`` comes with the file readers."""
from __future__ import annotations

from typing import Dict, List

from fluidnexus_torch.data.cameras import Camera


def cameras_by_time(cameras: List[Camera]) -> Dict[int, List[Camera]]:
    """Group cameras by frame index (the per-frame training loops iterate
    time-major — train_physical_particle.py:244)."""
    out: Dict[int, List[Camera]] = {}
    for c in cameras:
        out.setdefault(c.time_idx, []).append(c)
    return out
