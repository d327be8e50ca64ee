"""Scene readers (counterpart of ``fluidnexus_tpu/data/readers.py``):
NeRF-style transforms.json + per-frame PNG sequences, with the reference's
fake-view / generated-future substitution rules.

Behavioral parity with FluidDynamics/scene/fluid_nexus_real_reader.py
(read_cameras_from_transforms_real_capture:19-433) and fluid_nexus_real.py
(random init point clouds :134-248), as the JAX package has them:
  - per-camera hand-tuned rotation corrections ("camera hacks", :134-265)
  - fake-view folder naming (zero123_finetune_<steps>_cam{s}to{c}_
    cogvxlora5b_strength{r}_rawsize, :318-338)
  - generated-future folder selection after gen_future_since (:340-352)
  - dual-dataset switch via data_2_path/data_2_since (:354-357)
  - OpenGL->COLMAP axis flip and the R-transposed storage convention.

Images: the JAX package decodes PNGs with its native libpng loader at each
file's own size; the port reads them with ``utils/png.read_png`` (every
distinct path once, on a thread pool) and gives the same float32 pixels: RGB
as ``v / 255`` and gray as the float32 luma ``0.299 r + 0.587 g + 0.114 b``
of those, summed left to right and not rounded to 8 bits. A file that is not
a PNG raises (the JAX package reads it through PIL, which the card's machine
does not have). ``_resize`` is PIL's LANCZOS (``utils/lanczos``): 8 bits for
RGB after truncating to uint8, mode "F" for gray.
"""
from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.utils.lanczos import resize_f32, resize_u8
from fluidnexus_torch.utils.maths import focal2fov, fov2focal
from fluidnexus_torch.utils.png import read_png, to_rgb

DECODE_THREADS = 8   # the pool that decodes a capture's PNGs

# per-(capture_part, cam) c2w rotation corrections in degrees (z, y, x)
# (reference fluid_nexus_real_reader.py:134-265)
CAMERA_HACKS = {
    "smoke": {
        "0": (7.0, -7.3, 0.0),
        "1": (4.8, -4.8, 0.55),
        "2": (0.0, 0.0, 1.15),
        "3": (-2.2, 5.0, 0.5),
        "4": (-4.2, 8.0, 0.0),
    },
    "ball": {
        "0": (7.0, -7.3, 0.0),
        "1": (4.8, -4.8, 0.0),
        "2": (2.0, 0.4, 0.0),
        "3": (-2.1, 4.8, 0.0),
        "4": (-5.5, 7.3, 0.0),
    },
    # object capture, FIRST pose (c2w_1, reader :201-259): the smoke-phase
    # corrections (they coincide with the smoke table)
    "smoke_and_ball_object": {
        "0": (7.0, -7.3, 0.0),
        "1": (4.8, -4.8, 0.55),
        "2": (0.0, 0.0, 1.15),
        "3": (-2.2, 5.0, 0.5),
        "4": (-4.2, 8.0, 0.0),
    },
}
# object capture SECOND pose (c2w_2 -> R_2/T_2, reader :201-283), used from
# data_2_since on: the ball-phase corrections (they coincide with the ball
# table)
CAMERA_HACKS_2 = {
    "smoke_and_ball_object": {
        "0": (7.0, -7.3, 0.0),
        "1": (4.8, -4.8, 0.0),
        "2": (2.0, 0.4, 0.0),
        "3": (-2.1, 4.8, 0.0),
        "4": (-5.5, 7.3, 0.0),
    },
}
# Zero123 finetune checkpoint steps per capture (reader :318-338; ScalarReal
# uses 15500 — scalar_real_reader.py:127)
ZERO123_STEPS = {"smoke": 52000, "ball": 88000, "scalar": 15500}


def _rot4(axis: str, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4)
    if axis == "z":
        m[:2, :2] = [[c, -s], [s, c]]
    elif axis == "y":
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def apply_camera_hack(c2w: np.ndarray, capture_part: str, cam_name: str,
                      table=None) -> np.ndarray:
    """Right-multiply the c2w by per-axis corrections, z then y then x
    (reference functions.py:100-130 — C2W @ R)."""
    hacks = (table if table is not None else CAMERA_HACKS).get(capture_part, {})
    if cam_name not in hacks:
        return c2w
    dz, dy, dx = hacks[cam_name]
    if dz:
        c2w = c2w @ _rot4("z", np.deg2rad(dz))
    if dy:
        c2w = c2w @ _rot4("y", np.deg2rad(dy))
    if dx:
        c2w = c2w @ _rot4("x", np.deg2rad(dx))
    return c2w


def c2w_to_rt(c2w: np.ndarray):
    """OpenGL c2w -> (R stored transposed, T) in COLMAP convention
    (reader :268-276)."""
    c2w = c2w.copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return np.transpose(w2c[:3, :3]), w2c[:3, 3]


def fake_view_folder(capture_part: str, source_cam: str, cam_name: str,
                     refined_strength: str, data2: bool = False) -> str:
    """Folder holding CogVideoX-refined Zero123 views (reader :318-338)."""
    if capture_part == "smoke":
        return (f"zero123_finetune_{ZERO123_STEPS['smoke']}_cam{source_cam}to{cam_name}"
                f"_cogvxlora5b_strength{refined_strength}_rawsize")
    if capture_part == "ball":
        return (f"zero123_finetune_{ZERO123_STEPS['ball']}_cam{source_cam}to{cam_name}"
                f"_cogvxlora5b_strength{refined_strength}_rawsize")
    if capture_part == "smoke_and_ball_object":
        if data2:
            return (f"zero123_finetune_{ZERO123_STEPS['ball']}_cam{source_cam}to{cam_name}"
                    f"_cogvxlora5b_strength{refined_strength}_rawsize")
        return (f"zero123_finetune_{ZERO123_STEPS['smoke']}_cam{source_cam}to{cam_name}"
                f"_cogvxlora5b_strength{refined_strength}_start033_rawsize")
    if capture_part == "scalar":
        return (f"zero123_finetune_{ZERO123_STEPS['scalar']}_cam{source_cam}to{cam_name}"
                f"_cogvxlora5b_strength{refined_strength}_rawsize")
    raise ValueError(f"Unknown capture_part: {capture_part}")


def future_view_folder(capture_part: str, cam_name: str, gen_future_strength: str,
                       gen_future_since: int, is_wind: bool = False) -> str:
    """Folder holding generated-future frames (reader :340-352)."""
    if capture_part == "smoke":
        if is_wind:
            return (f"camera0{cam_name}_cogvxlora5b_prefix9_i2v3_strength{gen_future_strength}"
                    f"_start{gen_future_since}_wind_smoke_rawsize")
        return (f"camera0{cam_name}_cogvxlora5b_future_prefix9_i2v3_strength{gen_future_strength}"
                f"_start{gen_future_since}_smoke_rawsize")
    if capture_part == "ball":
        return (f"camera0{cam_name}_cogvxlora5b_future_prefix9_i2v3_strength{gen_future_strength}"
                f"_start{gen_future_since}_ball_rawsize")
    if capture_part == "scalar":
        # ScalarReal names future folders by the train0x view (scalar_real_reader.py:136)
        return (f"train0{cam_name}_cogvxlora5b_future_prefix9_i2v3_strength{gen_future_strength}"
                f"_start{gen_future_since}_scalar_rawsize")
    raise ValueError(f"Unknown capture_part: {capture_part}")


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(16)
    return head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"


def _decode(path: str, gray: bool) -> np.ndarray:
    """One file as the JAX package's native loader gives it at its own size:
    float32 (H, W, 3) in [0, 1], or the float32 luma (H, W)."""
    if not _is_png(path):
        raise ValueError(f"{path} is not a PNG: the JAX package reads other formats through PIL, "
                         "which the port does not use; convert the capture's frames to PNG")
    rgb = to_rgb(read_png(path)).astype(np.float32) / np.float32(255.0)
    if not gray:
        return rgb
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (np.float32(0.299) * r + np.float32(0.587) * g) + np.float32(0.114) * b


def _decode_many(paths, gray: bool):
    """Every distinct path decoded once, on a pool of DECODE_THREADS threads
    (zlib and the compiled unfilter release the GIL). Returns {path: float32
    (H, W) or (H, W, 3)}."""
    todo = sorted(set(paths))
    with ThreadPoolExecutor(max_workers=max(1, min(DECODE_THREADS, len(todo)))) as pool:
        return dict(zip(todo, pool.map(lambda p: _decode(p, gray), todo)))


def target_size(w: int, h: int, resolution: int):
    """The JAX package's ``_resize`` target (width, height), its float
    arithmetic kept: ``resolution == -1`` on a frame over 1600 pixels wide
    computes ``int(w / (w / 1600))``, which can give 1599."""
    if resolution in (1, 2, 4, 8):
        return round(w / resolution), round(h / resolution)
    if resolution == -1:
        down = w / 1600 if w > 1600 else 1
        return int(w / down), int(h / down)
    down = w / resolution
    return int(w / down), int(h / down)


def _resize(img: np.ndarray, resolution: int):
    """PIL's LANCZOS as the JAX package applies it: RGB truncated to uint8,
    resampled in 8 bits and divided by 255; gray in mode "F", unclipped."""
    h, w = img.shape[:2]
    tw, th = target_size(w, h, resolution)
    if (tw, th) == (w, h):
        return img
    if img.ndim == 3:
        return resize_u8((img * 255).astype(np.uint8), tw, th).astype(np.float32) / 255.0
    return resize_f32(img.astype(np.float32), tw, th)


def read_cameras_real_capture(
    path: str,
    transforms_file: str = "transforms_train.json",
    start_time: int = 0,
    duration: int = 50,
    time_step: int = 1,
    max_timestamp: float = 1.0,
    gray_image: bool = False,
    train_views: str = "0134",
    train_views_fake: Optional[str] = None,
    test_views_fake: Optional[str] = None,
    is_bg: bool = False,
    capture_part: str = "smoke",
    use_refined_fake: bool = False,
    refined_strength: str = "0d26",
    gen_future_since: int = -1,
    gen_future_strength: str = "0d75",
    data_2_path: str = "",
    data_2_since: int = -1,
    is_wind: bool = False,
    read_image: bool = True,
    resolution: int = -1,
    extension: str = ".png",
    dataset_style: str = "fluid_nexus",
    use_demo_cameras: bool = False,
    real_view_repeat: int = 1,
) -> List[Camera]:
    """Build the per-(camera, frame) Camera list from a FluidNexus capture.

    dataset_style="scalar" switches to the ScalarReal layout
    (scalar_real_reader.py: real frames under colmap_frames/colmap_{t}/
    {file_path}.png, no camera hacks, capture_part forced to "scalar")."""
    if dataset_style == "scalar":
        capture_part = "scalar"
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)

    # demo camera sweep 2->4->0->2, every 2nd pose (reader :99-126)
    demo_rt = None
    if use_demo_cameras:
        raw = np.load(os.path.join(path, "demo_cams_poses_extra.npy"))
        demo = np.concatenate([raw[raw.shape[0] // 2:], raw[::-1],
                               raw[: raw.shape[0] // 2]], axis=0)[::2]
        demo_rt = [c2w_to_rt(np.array(c, np.float64)) for c in demo]

    cameras: List[Camera] = []
    uid = 0
    for frame in contents["frames"]:
        cam_name = frame["file_path"][-1:]
        c2w_in = np.array(frame["transform_matrix"], np.float64)
        c2w = apply_camera_hack(c2w_in, capture_part, cam_name)
        R, T = c2w_to_rt(c2w)
        R2 = T2 = None
        if capture_part in CAMERA_HACKS_2:
            # object capture: second pose R_2/T_2 from the data_2 corrections
            # (reader :201-283), switched in at data_2_since (:399-401)
            c2w_2 = apply_camera_hack(c2w_in, capture_part, cam_name, CAMERA_HACKS_2)
            R2, T2 = c2w_to_rt(c2w_2)

        h, w = frame["camera_hw"]
        fovx = frame["camera_angle_x"]
        focal = fov2focal(fovx, w)
        fovy = focal2fov(focal, h)

        for time_idx in range(start_time, start_time + duration * time_step, time_step):
            timestamp = (time_idx - start_time) / (duration * time_step) * max_timestamp
            # the smoke capture has only 410 frames; clamp like the reference (:303)
            tmp_time_idx = min(409, time_idx) if capture_part == "smoke" else time_idx

            is_fake_view = False
            image = real_image = None
            if read_image:
                if dataset_style == "scalar":
                    # ScalarReal layout (scalar_real_reader.py:115)
                    frame_name = os.path.join("colmap_frames", f"colmap_{time_idx}",
                                              frame["file_path"] + extension)
                elif is_bg:
                    frame_name = os.path.join(frame["file_path"] + "_bg", f"{time_idx:03d}{extension}")
                else:
                    frame_name = os.path.join(frame["file_path"], f"{tmp_time_idx:03d}{extension}")
                real_frame_name = frame_name

                in_fake = (train_views_fake and cam_name in train_views_fake) or (
                    test_views_fake and cam_name in test_views_fake
                )
                if in_fake:
                    is_fake_view = True
                    source_cam = train_views[:1]
                    fake_time_idx = (time_idx - start_time) // time_step
                    data2 = data_2_since >= 0 and fake_time_idx >= data_2_since
                    folder = fake_view_folder(capture_part, source_cam, cam_name, refined_strength, data2)
                    frame_name = os.path.join(folder, f"frame_{fake_time_idx:06d}.png")

                if gen_future_since >= 0 and time_idx >= gen_future_since * time_step + start_time:
                    folder = future_view_folder(capture_part, cam_name, gen_future_strength,
                                                gen_future_since, is_wind)
                    fut = gen_future_since + (time_idx - gen_future_since * time_step - start_time) // time_step
                    frame_name = os.path.join(folder, f"frame_{fut:06d}.png")

                cur_path = data_2_path if (
                    data_2_path and data_2_since >= 0 and time_idx >= data_2_since * time_step + start_time
                ) else path
                image_path = os.path.join(cur_path, frame_name)
                real_image_path = os.path.join(cur_path, real_frame_name)
                if not os.path.exists(real_image_path):
                    real_image_path = image_path
                assert os.path.exists(image_path), f"Image path {image_path} does not exist!"
                ch = cw = -1  # filled in after the batch decode
            else:
                is_fake_view = True
                image_path = real_image_path = None
                ch, cw = h, w

            # object capture: the second COLMAP solve's pose takes over at
            # data_2_since (reader :399-401)
            cur_R, cur_T = R, T
            if (R2 is not None and data_2_path and data_2_since >= 0
                    and time_idx >= data_2_since * time_step + start_time):
                cur_R, cur_T = R2, T2
            image_name = frame["file_path"].split("/")[-1]
            camera_time_idx = (time_idx - start_time) // time_step
            if demo_rt is not None:
                cur_R, cur_T = demo_rt[camera_time_idx]
                image_name += f"_demo{camera_time_idx:03d}"

            cameras.append(
                Camera(
                    uid=uid, R=cur_R, T=cur_T, fovx=fovx, fovy=fovy, width=cw, height=ch,
                    image=image_path, image_real=real_image_path,
                    image_name=image_name,
                    time_idx=camera_time_idx,
                    timestamp=timestamp, is_fake_view=is_fake_view,
                    znear=float(contents.get("near", 0.01)), zfar=float(contents.get("far", 100.0)),
                )
            )
            uid += 1
            # ScalarReal: weight real views against fake ones by repetition
            # (scalar_real_reader.py:226-255)
            if real_view_repeat > 1 and not is_fake_view:
                for _ in range(1, real_view_repeat):
                    cameras.append(dataclasses.replace(cameras[-1], uid=uid))
                    uid += 1

    # batch decode: every unique path once, on a thread pool
    todo = [p for c in cameras for p in (c.image, c.image_real) if isinstance(p, str)]
    if todo:
        decoded = _decode_many(todo, gray_image)
        for c in cameras:
            if not isinstance(c.image, str):
                continue
            c.image = _resize(decoded[c.image], resolution)
            c.image_real = _resize(decoded[c.image_real], resolution)
            c.height, c.width = c.image.shape[:2]
    return cameras


# ------------------------------- init point clouds ---------------------------


def random_background_points(num_pts: int = 100_000, rng: Optional[np.random.Generator] = None):
    """Random wall slab behind the smoke (fluid_nexus_real.py:140-168)."""
    rng = rng or np.random.default_rng()
    x = rng.uniform(-1.0, 2.5, (num_pts, 1))
    y = rng.uniform(-0.2, 2.5, (num_pts, 1))
    z = rng.uniform(-0.6, -0.5, (num_pts, 1))
    return np.concatenate([x, y, z], 1).astype(np.float32)


def object_sphere_points(num_pts: int = 50_000, center=(0.328, 0.378, -0.28), radius=0.11):
    """Fibonacci-sphere shell for the ball object (fluid_nexus_real.py:170-199)."""
    golden = (1 + np.sqrt(5)) / 2
    i = np.arange(num_pts)
    theta = 2 * np.pi * i / golden
    phi = np.arccos(1 - 2 * (i + 0.5) / num_pts)
    x = center[0] + radius * np.sin(phi) * np.cos(theta)
    y = center[1] + radius * np.sin(phi) * np.sin(theta)
    z = center[2] + radius * np.cos(phi)
    return np.stack([x, y, z], 1).astype(np.float32)


def large_smoke_points(num_pts: int = 100_000, rng: Optional[np.random.Generator] = None):
    """(fluid_nexus_real.py:201-226)"""
    rng = rng or np.random.default_rng()
    x = rng.uniform(0.0, 0.5, (num_pts, 1))
    y = rng.uniform(0.0, 0.7, (num_pts, 1))
    z = rng.uniform(-0.5, 0.0, (num_pts, 1))
    return np.concatenate([x, y, z], 1).astype(np.float32)


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
