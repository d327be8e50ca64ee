"""Unified configuration system.

The reference uses three config styles (argparse groups + JSON overlay in
FluidDynamics, OmegaConf in Zero123, SAT argparse in CogVideoX — SURVEY §5).
This framework has ONE: dataclasses with the reference's field names and
defaults (FluidDynamics/arguments/__init__.py:39-433), overlaid from a JSON
config file (which, like the reference helper_parser.py:49-61, OVERRIDES CLI
values), plus a YAML dump of the merged result for reproducibility and
inference re-reading (write_args_to_file / get_combined_args parity).

The reference's shipped configs (e.g. configs/fluid_nexus_smoke_dynamics.json)
load unchanged.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    """Scene/data/particle-init parameters (ref ModelParams, arguments/__init__.py:39-177)."""

    sh_degree: int = 3
    data_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    model: str = "g_model"          # model-registry name, e.g. gm_dynamics
    rgb_function: str = "none"
    basic_function: str = ""
    white_background: bool = False
    random_background: bool = False
    eval: bool = False
    loader: str = "colmap"
    densify: int = 0
    start_time: int = 0
    duration: int = 50
    time_step: int = 1
    max_timestamp: float = 1.0
    is_wind: bool = False
    gen_future_since: int = -1
    gen_prefixed_future: str = "one"
    gen_future_strength: str = "0d75"
    future_since: int = -1
    data_2_path: str = ""
    data_2_since: int = -1
    gray_image: bool = False
    test_all_views: bool = False
    train_views: str = "0134"
    train_views_fake: Optional[str] = None
    test_views_fake: Optional[str] = None
    use_refined_fake: bool = False
    refined_strength: str = "0d26"
    real_view_repeat: int = 1
    source_init: bool = False
    new_pts: int = 10_000
    img_offset: bool = False
    is_bg: bool = False
    capture_part: str = "smoke"
    init_region_type: str = "large"
    init_trbf_c_fix: bool = False
    init_color_fix_value: Optional[float] = None
    init_num_pts_per_time: int = 1000
    spherical_cam_start: int = 0
    spherical_cam_duration: int = 120
    spherical_cam_step: int = 1
    # declared-but-unused in the REFERENCE as well (arguments/__init__.py:89
    # sets is_circle and nothing reads it; circle_cameras_* never read):
    # kept so reference config JSONs load unchanged
    is_circle: bool = False
    circle_cameras_around: str = ""
    circle_cameras_num: int = 0
    circle_cameras_radius: float = 0
    use_demo_cameras: bool = False
    use_extra_transforms: bool = False
    no_init_pcd: bool = False
    init_pcd_bg: bool = False
    init_pcd_object: bool = False
    init_pcd_large_smoke: bool = False
    load_path: str = ""
    level_two_load_path: str = ""
    level_two_color_3ch: bool = False
    bg_load_path: str = ""
    bg_2_load_path: str = ""
    bg_load_iteration: int = 30000
    # particle init geometry (ref :141-176)
    init_visual_num_pts: int = 1000
    init_thick_visual_num_pts: int = 150
    init_visual_radius_small_max: float = 0.014
    init_visual_radius_max: float = 0.028
    init_x_mid: float = 0.326
    init_visual_y_min: float = -0.09
    init_visual_y_max: float = 0.32
    init_z_mid: float = -0.3
    init_rotation_degree: int = 0
    init_visual_y_thick_min: float = 0.16
    init_hidden_radius_max: float = 0.042
    init_hidden_delta: float = 0.009
    init_hidden_y_min: float = -0.11
    init_hidden_y_max: float = 0.35
    emitter_hidden_delta: float = 0.009
    emitter_visual_delta: float = 0.004
    emitter_center_y_hidden: float = -0.11
    emitter_center_y_visual: float = -0.09
    emitter_center_y_hidden_max: float = 0.25
    emitter_center_y_visual_max: float = 0.16
    emitter_visual_radius_ratio: float = 3
    emitter_hidden_radius_ratio: float = 5
    # static capacities (not in the reference)
    hidden_capacity: int = 32768
    visual_capacity: int = 65536


@dataclass
class OptimConfig:
    """Optimization parameters (ref OptimizationParams, arguments/__init__.py:189-433).

    Field names and defaults match the reference so its JSON configs apply."""

    iterations: int = 30_000
    batch: int = 2
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    color_lr: float = 0.0025
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    percent_dense: float = 0.01
    opacity_reset_interval: int = 3_000
    opacity_reset_at: int = 10000
    densification_interval: int = 100
    # JAX-package extension (no reference counterpart), kept so its
    # dumped configs load; the port does not read it
    steps_per_launch: int = 0
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    clone: bool = True
    split: bool = True
    split_prune: bool = True
    prune: bool = True
    opacity_threshold: float = 0.005
    valid_min_y: float = -0.035
    valid_max_z: float = -0.58
    prune_near_interval: int = 0
    prune_near_with_object: bool = False
    prune_near_cam_interval: int = 0
    prune_large_interval: int = 0
    post_prune: bool = False
    post_prune_interval: int = 100
    post_prune_from_iter: int = 25000
    post_prune_until_iter: int = 27000
    # PBF / particle stages
    no_densify_prune: bool = False
    iterations_per_time_first: int = 1000
    iterations_per_time_current: int = 1000
    iterations_per_time_current_max: int = 1000
    iterations_per_time_current_sparse: int = 500
    iterations_per_time_current_level_two: int = 1000
    iterations_per_time_current_level_two_max: int = 1000
    record_time: bool = False
    min_neighbors: int = -1
    remove_out_boundary: bool = False
    secs: float = 0.01
    alpha: float = -1.5
    buoyancy_max_y: float = 0.0
    beta: float = 0.1
    buoyancy_decay_rate: float = 0.0
    H: float = 2.0
    p0: float = 2.0
    p0_future: float = 1.5
    k: float = 10
    KNN_K: int = 100
    extra_visual_ratio: float = 0.0
    extra_visual_num: int = 0
    extra_visual_y_min: float = 0.16
    extra_visual_min_num: int = 0
    pos_lr_scale_factor: float = 1.0
    init_hidden_velocity: float = 0.0
    new_hidden_particles_per_sec: float = 15
    new_visual_particles_per_sec: float = 15
    cur_time_only_iterations: int = 10000
    iterations_per_time: int = 250
    iterations_per_time_post: int = 12
    high_frequency_per_visual: int = 1
    rigid_cuboid_num_one_side: int = 15
    preprocess_points: int = 0
    feature_t_lr: float = 0.001
    omega_lr: float = 0.0001
    stable_iterations: int = 20
    stable_iterations_future: int = 0
    solver_iterations: int = 3
    solver_iterations_future: int = 3
    decay_frames_future_p0: int = 30
    sparse_views_from_time_index: int = -1
    sparse_views: List[str] = field(default_factory=lambda: ["train00"])
    max_hidden_particles: int = 28000
    future_pred_frames: int = 0
    simulation_ratio: int = 3
    emitter_points_off_y0: bool = False
    emit_ratio_hidden: float = 1.32
    emit_ratio_visual: float = 1.32
    lambda_first_distance: float = 0.0
    distance_threshold_hidden: float = 0.001
    distance_threshold_visual: float = 0.001
    lambda_current_distance: float = 0.0
    lambda_exyz: float = 0.0
    lambda_vel: float = 0.0
    lambda_image: float = 1.0
    lambda_gas_constraints: float = 0.0
    lambda_next_gas_constraints: float = 0.0
    xyz_lr: float = 1e-4
    # level-two appearance fit
    fit_xyz: bool = False
    fit_color: bool = False
    visual_color_lr: float = 0.0025
    fit_opacity: bool = False
    visual_opacity_lr: float = 0.05
    fit_scales: bool = False
    visual_scales_lr: float = 0.005
    fit_rotation: bool = False
    visual_rotation_lr: float = 0.001
    lambda_consistency_color: float = 0.0
    consistency_color_threshold: float = 0.0
    lambda_consistency_opacity: float = 0.0
    consistency_opacity_threshold: float = 0.0
    lambda_consistency_scales: float = 0.0
    consistency_scales_threshold: float = 0.0
    lambda_consistency_rotation: float = 0.0
    consistency_rotation_threshold: float = 0.0
    lambda_consistency_xyz: float = 0.0
    lambda_min_update_xyz: float = 0.0
    init_scales_w_xyz_dist: bool = False
    inherit_prev_color: bool = False
    inherit_prev_opacity: bool = False
    inherit_prev_scales: bool = False
    inherit_prev_rotation: bool = False
    lambda_reg_scaling: float = 0.0
    scaling_reg_ratio_threshold: float = 0
    smoothed_window_size: int = 5
    use_smoothed_color: bool = True
    use_smoothed_scales: bool = True
    use_smoothed_opacity: bool = True
    use_smoothed_rotation: bool = True
    use_level_two_in_future: bool = False
    use_level_two_smoothed_in_future: bool = False
    wind_since: int = -1
    wind_force: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    wind_power: float = 1.0
    rigid_since: int = -1
    rigid_body: str = "cuboid"
    rigid_body_center: List[float] = field(default_factory=lambda: [0.34, 0.5, -0.225])
    rigid_particle_radius: float = 0.25
    rigid_cuboid_num: List[int] = field(default_factory=lambda: [5, 10, 55])
    rigid_sphere_radius: float = 5
    rigid_sphere_num: int = 1000
    rigid_cylinder_radius: float = 4
    rigid_cylinder_num: List[int] = field(default_factory=lambda: [50, 50])


@dataclass
class PipelineConfig:
    """(ref PipelineParams, arguments/__init__.py:180-187)"""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    rd_pipe: str = "v2"
    # rasterizer knobs; `backend` is the JAX package's Mosaic switch, kept so
    # its configs load, and the port does not read it
    tile_capacity: int = 512
    dup_x: int = 8
    dup_y: int = 8
    tile_x: int = 16
    tile_y: int = 16
    chunk: int = 32
    backend: str = "auto"
    # camera data-parallelism for the reconstruction stages: shard the
    # per-iteration camera batch over `dp` chips ('data' mesh axis), psum the
    # position grads into one replicated Adam step. The reference is strictly
    # single-GPU here (train_physical_particle.py:45); this is the SPMD
    # improvement SURVEY §2.6 calls out.
    dp: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)
    config: str = ""       # path of the JSON overlay
    seed: int = 0
    # --detect_anomaly parity (helper_parser.py:24,46: autograd anomaly mode)
    detect_anomaly: bool = False
    # raise (instead of warn) when the static neighbor-grid capacities drop
    # points — the reference's dynamic torch_cluster never truncates, so a
    # capacity overflow here is a silent physics divergence
    strict_capacity: bool = False
    test_iteration: int = 30000
    test_iterations: List[int] = field(default_factory=lambda: [7000, 15000, 30000])
    save_iterations: List[int] = field(default_factory=lambda: [7000, 15000, 30000])

    def to_dict(self):
        return dataclasses.asdict(self)


def _apply_overrides(cfg: Config, overrides: dict) -> List[str]:
    """Apply a flat {name: value} dict onto whichever sub-config owns each
    field (the reference JSON files are flat). Returns unknown keys."""
    unknown = []
    sections = [cfg.model, cfg.optim, cfg.pipe]
    section_fields = [{f.name for f in dataclasses.fields(s)} for s in sections]
    # note: top-level Config fields exclude the section names themselves —
    # the reference's flat "model": "gm_dynamics" key belongs to ModelConfig
    top_fields = {"config", "seed", "test_iteration", "test_iterations",
                  "save_iterations", "detect_anomaly", "strict_capacity"}
    for key, value in overrides.items():
        if key in top_fields:
            setattr(cfg, key, value)
            continue
        for sec, names in zip(sections, section_fields):
            if key in names:
                setattr(sec, key, _coerce(getattr(sec, key), value))
                break
        else:
            unknown.append(key)
    return unknown


def _coerce(cur, value):
    """Coerce a CLI/JSON value to the default's type ('--k 3.0' over an int
    default becomes 3.0 not the string '3.0'; list elements coerce too)."""
    if cur is None or value is None:
        return value
    if isinstance(cur, bool):
        return value if isinstance(value, bool) else str(value).lower() in ("1", "true", "yes")
    if isinstance(cur, int) and not isinstance(value, bool):
        f = float(value)
        return int(f) if f == int(f) else f
    if isinstance(cur, float):
        return float(value)
    if isinstance(cur, list) and cur:
        return [_coerce(cur[0], v) for v in value]
    return value


def load_config(json_path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    cfg = Config()
    if json_path:
        with open(json_path) as f:
            data = json.load(f)
        unknown = _apply_overrides(cfg, data)
        if unknown:
            print(f"[config] ignoring unknown keys from {json_path}: {unknown}")
        cfg.config = json_path
    if overrides:
        _apply_overrides(cfg, overrides)
    return cfg


def parse_cli(argv=None, description="fluidnexus_torch") -> Config:
    """CLI: every dataclass field is a flag; --config JSON OVERRIDES flags,
    matching the reference precedence (helper_parser.py:49-61)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", default="")
    registry = {}
    for section_name, dc in (("model", ModelConfig), ("optim", OptimConfig), ("pipe", PipelineConfig)):
        for f in dataclasses.fields(dc):
            flag = "--" + f.name
            if flag in registry:
                continue
            registry[flag] = (section_name, f.name)
            default = argparse.SUPPRESS
            if f.type in ("bool", bool):
                parser.add_argument(flag, action="store_true", default=default)
            elif f.type in ("List[float]", "List[int]", "List[str]"):
                parser.add_argument(flag, nargs="+", default=default)
            else:
                parser.add_argument(flag, default=default)
    parser.add_argument("--seed", type=int, default=argparse.SUPPRESS)
    parser.add_argument("--detect_anomaly", action="store_true", default=argparse.SUPPRESS)
    parser.add_argument("--strict_capacity", action="store_true", default=argparse.SUPPRESS)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=argparse.SUPPRESS)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    cli = {k: v for k, v in vars(args).items() if k != "config"}
    cfg = Config()
    _apply_overrides(cfg, cli)
    if args.config:
        with open(args.config) as f:
            _apply_overrides(cfg, json.load(f))  # JSON wins, like the reference
        cfg.config = args.config
    return cfg


def dump_config(cfg: Config, path: str):
    """YAML-ish dump of the merged config (write_args_to_file parity,
    helper_parser.py:105-126). Written as JSON for lossless re-reading."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)


def read_dumped_config(path: str) -> Config:
    """Re-read a dumped config (get_combined_args parity)."""
    with open(path) as f:
        data = json.load(f)
    cfg = Config()
    for sec in ("model", "optim", "pipe"):
        _apply_overrides(cfg, data.get(sec, {}))
    for k in ("config", "seed", "test_iterations", "save_iterations"):
        if k in data:
            setattr(cfg, k, data[k])
    return cfg
