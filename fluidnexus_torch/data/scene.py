"""Scene assembly (counterpart of ``fluidnexus_tpu/data/scene.py``): config ->
camera lists + init point cloud.

Parity with FluidDynamics/scene/__init__.py (Scene:10-54), dataset_readers.py
(loader registry :8-13) and fluid_nexus_real.py (read_scene_fluid_nexus_real
:10-248: transforms-file selection by train_views, random init pcds).
ScalarReal scenes use the same reader with gray_image=True.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from fluidnexus_torch.core.config import Config
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.data.readers import (
    SceneInfo,
    large_smoke_points,
    nerf_pp_norm,
    object_sphere_points,
    random_background_points,
    read_cameras_real_capture,
)


def _train_transforms_file(model) -> str:
    """(fluid_nexus_real.py:46-57)"""
    train_views = model.train_views
    if (
        set(train_views) != set("0134")
        and 0 < len(train_views) < 4
        and not model.train_views_fake
    ):
        return f"transforms_train_{''.join(sorted(train_views))}.json"
    if set(train_views) == set("01234"):
        return "transforms.json"
    return "transforms_train.json"


def read_scene(cfg: Config, eval_only: bool = False) -> SceneInfo:
    m = cfg.model
    # loader registry parity (dataset_readers.py:8-13): scalar_real[_eval]
    # selects the ScalarReal layout; fluid_nexus_real[_eval] the default
    style = "scalar" if "scalar" in (m.loader or "") else "fluid_nexus"
    common = dict(
        dataset_style=style,
        start_time=m.start_time, duration=m.duration, time_step=m.time_step,
        max_timestamp=m.max_timestamp, gray_image=m.gray_image,
        train_views=m.train_views, is_bg=m.is_bg, capture_part=m.capture_part,
        use_refined_fake=m.use_refined_fake, refined_strength=m.refined_strength,
        gen_future_since=m.gen_future_since, gen_future_strength=m.gen_future_strength,
        data_2_path=m.data_2_path, data_2_since=m.data_2_since, is_wind=m.is_wind,
        resolution=m.resolution, use_demo_cameras=m.use_demo_cameras,
        real_view_repeat=m.real_view_repeat,
    )

    train_cams: List[Camera] = []
    if not eval_only:
        train_cams = read_cameras_real_capture(
            m.data_path, _train_transforms_file(m),
            train_views_fake=m.train_views_fake, test_views_fake=m.test_views_fake,
            **common,
        )
    test_json = "transforms.json" if m.test_all_views else "transforms_test.json"
    test_cams = read_cameras_real_capture(
        m.data_path, test_json, train_views_fake=None, test_views_fake=None, **common,
    )

    norm = nerf_pp_norm(train_cams if train_cams else test_cams)

    pcd = None
    if not m.no_init_pcd:
        rng = np.random.default_rng(cfg.seed)
        parts = []
        if m.init_pcd_bg:
            parts.append(random_background_points(rng=rng))
        if m.init_pcd_object:
            parts.append(object_sphere_points())
        if m.init_pcd_large_smoke:
            parts.append(large_smoke_points(rng=rng))
        if parts:
            pcd = np.concatenate(parts, 0)

    return SceneInfo(
        point_cloud=pcd, train_cameras=train_cams, test_cameras=test_cams,
        nerf_normalization=norm,
    )


def cameras_by_time(cameras: List[Camera]) -> Dict[int, List[Camera]]:
    """Group cameras by frame index (the per-frame training loops iterate
    time-major — train_physical_particle.py:244)."""
    out: Dict[int, List[Camera]] = {}
    for c in cameras:
        out.setdefault(c.time_idx, []).append(c)
    return out
