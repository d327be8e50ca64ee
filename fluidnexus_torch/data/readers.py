"""Scene containers (counterpart of ``fluidnexus_tpu/data/readers.py``).

Only ``SceneInfo`` and ``nerf_pp_norm`` so far; the transforms/PNG readers
come with the slice that reads real FluidNexus captures.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from fluidnexus_torch.data.cameras import Camera


def nerf_pp_norm(cameras: List[Camera]):
    """Scene extent from camera centers (functions.py:get_nerf_pp_norm)."""
    centers = np.stack([c.camera_center for c in cameras], 0)
    center = centers.mean(0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=1))
    return {"translate": -center, "radius": diagonal * 1.1}


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[np.ndarray]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    nerf_normalization: dict
    point_colors: Optional[np.ndarray] = None
