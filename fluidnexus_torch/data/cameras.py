"""Camera model (counterpart of ``fluidnexus_tpu/data/cameras.py``).

Matches the reference convention (FluidDynamics/scene/camera.py:14-143):
``world_view`` is the world->camera matrix stored TRANSPOSED so points
transform as row-vectors ``p @ M``; ``full_proj = world_view @ projection``;
``camera_center = inv(world_view)[3, :3]``. znear=0.01, zfar=100. The matrices
are numpy; the pipelines move them to the device in one stack per frame.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from fluidnexus_torch.utils.maths import get_projection_matrix_cv, get_world_to_view


@dataclasses.dataclass
class Camera:
    """A single view."""

    uid: int
    R: np.ndarray            # (3,3) cam->world rotation (3DGS convention)
    T: np.ndarray            # (3,)  w2c translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: Optional[np.ndarray] = None        # (H,W,C) float32 in [0,1]; supervision target
    image_real: Optional[np.ndarray] = None   # real capture when image is a generated fake view
    image_name: str = ""
    time_idx: int = 0
    timestamp: float = 0.0
    is_fake_view: bool = False
    cxr: float = 0.0
    cyr: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0

    def __post_init__(self):
        w2v = get_world_to_view(self.R, self.T)
        self.world_view = w2v.T.astype(np.float32)  # row-vector convention
        # the principal-point offset applies only when cyr is set, as in the
        # JAX package (cxr alone is ignored there too)
        cx, cy = (self.cxr, self.cyr) if self.cyr != 0.0 else (0.0, 0.0)
        proj = get_projection_matrix_cv(self.znear, self.zfar, self.fovx, self.fovy, cx, cy).T
        self.projection = proj.astype(np.float32)
        self.full_proj = (self.world_view @ self.projection).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[3, :3].astype(np.float32)

    @property
    def tan_fovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tan_fovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))
