"""Inter-stage format conversions (counterpart of
``fluidnexus_tpu/data/conversions.py``): the DataProcessing subproject's
hand-offs between the capture, Zero123 and CogVideoX, with no imaging
library.

Parity targets (DataProcessing/):
  - convert_original_to_zero123.py:36-51: pad to square, 512 x 512 resize
    into frame_%03d/{cam:02d}.png
  - fluid_nexus_real/create_zero123_cams.py (get_w2c_RT_from_c2w:10-15):
    transforms.json c2w -> per-camera W2C .npy
  - utils/image_utils.py pad_square:131, prepare_generative_image_crop_first
    :374-430 (centre crop to the 1080/1920 strip, then letterbox to
    720 x 480), crop_and_resize:446-463 (centre crop to the target aspect,
    then resize)
  - convert_zero123_to_cogvideox.py / convert_cogvideox_to_original.py: the
    folder plumbing around those.

The JAX package reads, resizes and writes through PIL. Here a frame is read
by ``utils/png.read_png`` and ``to_rgb`` (a PNG only; gray repeated, alpha
dropped, as PIL's ``convert("RGB")`` gives them for 8-bit files; a 16-bit
gray file reads as its high byte where PIL clips the 16-bit value to 255),
resized by ``utils/lanczos.resize_u8`` (PIL's 8-bit LANCZOS, bit for bit)
and written by ``utils/png.write_png``. Each function also has a CLI:
``python -m fluidnexus_torch convert <cmd>`` or
``python -m fluidnexus_torch.data.conversions <cmd>``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from fluidnexus_torch.utils.lanczos import resize_u8
from fluidnexus_torch.utils.png import read_png, to_rgb, write_png


def imread_rgb(path: str) -> np.ndarray:
    """The PNG at ``path`` as uint8 (H, W, 3)."""
    return to_rgb(read_png(path))


def imwrite(path: str, arr: np.ndarray):
    write_png(path, np.asarray(arr).astype(np.uint8))


def resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """PIL's 8-bit LANCZOS to (h, w)."""
    return resize_u8(np.asarray(arr).astype(np.uint8), w, h)


def pad_square(img: np.ndarray) -> np.ndarray:
    """(image_utils.pad_square:131-139)"""
    h, w = img.shape[:2]
    if h > w:
        pad = (h - w) // 2
        return np.pad(img, ((0, 0), (pad, pad), (0, 0)))
    if h < w:
        pad = (w - h) // 2
        return np.pad(img, ((pad, pad), (0, 0), (0, 0)))
    return img


def letterbox(img: np.ndarray, width_new: int, height_new: int, bg_color=(0, 0, 0)):
    """Resize by the smaller ratio and pad with ``bg_color`` to exactly
    (height_new, width_new) (image_utils.prepare_generative_image:327-372)."""
    h, w = img.shape[:2]
    ratio = min(width_new / w, height_new / h)
    nw, nh = int(w * ratio), int(h * ratio)
    out = np.zeros((height_new, width_new, 3), np.uint8)
    out[:] = np.asarray(bg_color, np.uint8)
    top, left = (height_new - nh) // 2, (width_new - nw) // 2
    out[top:top + nh, left:left + nw] = resize(img, nw, nh)
    return out


def prepare_generative_image_crop_first(img: np.ndarray, width_new=720, height_new=480,
                                        bg_color=(0, 0, 0)) -> np.ndarray:
    """Centre-crop the square Zero123 output to the 1080/1920 vertical strip,
    then letterbox it into (width_new, height_new) (image_utils.py:374-430;
    the strip is computed at 256 scale, then scaled to this image)."""
    w0 = img.shape[1]
    crop_width = int(int(256 * (1080 / 1920)) * w0 / 256)
    left = (w0 - crop_width) // 2
    return letterbox(img[:, left:left + crop_width], width_new, height_new, bg_color)


def crop_and_resize(img: np.ndarray, new_width=1080, new_height=1920) -> np.ndarray:
    """Centre-crop to the target aspect, then resize (image_utils.py:446-463)."""
    h, w = img.shape[:2]
    crop_width = int(h * (new_width / new_height))
    x = (w - crop_width) // 2
    return resize(img[:, x:x + crop_width], new_width, new_height)


def _pngs(folder: str):
    return sorted(n for n in os.listdir(folder) if n.endswith(".png"))


def convert_original_to_zero123(data_root: str, out_root: str, num_cameras=5,
                                camera_prefix="camera", size=512, log=print) -> int:
    """(convert_original_to_zero123.py:36-51)"""
    count = 0
    for cam_id in range(num_cameras):
        folder = os.path.join(data_root, f"{camera_prefix}{cam_id:02d}")
        if not os.path.isdir(folder):
            continue
        for name in _pngs(folder):
            frame_id = int(name.split(".")[0])
            img = resize(pad_square(imread_rgb(os.path.join(folder, name))), size, size)
            imwrite(os.path.join(out_root, f"frame_{frame_id:03d}", f"{cam_id:02d}.png"), img)
            count += 1
    log(f"converted {count} frames -> {out_root}")
    return count


def get_w2c_rt_from_c2w(c2w: np.ndarray) -> np.ndarray:
    """(create_zero123_cams.py:10-15): OpenGL c2w -> [R|T] W2C (3, 4)."""
    c2w = np.array(c2w, np.float64).copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return np.concatenate([w2c[:3, :3], w2c[:3, 3:4]], 1).astype(np.float32)


def create_zero123_cams(transforms_json: str, out_dir: str, log=print) -> int:
    """transforms.json -> camera/{i:02d}.npy (create_zero123_cams.py)."""
    with open(transforms_json) as f:
        frames = json.load(f)["frames"]
    os.makedirs(out_dir, exist_ok=True)
    for frame in frames:
        cam = int(frame["file_path"][-1:])
        np.save(os.path.join(out_dir, f"{cam:02d}.npy"),
                get_w2c_rt_from_c2w(np.array(frame["transform_matrix"])))
    log(f"wrote {len(frames)} camera npys -> {out_dir}")
    return len(frames)


def convert_zero123_to_cogvideox(zero123_folder: str, out_folder: str,
                                 width=720, height=480, log=print) -> int:
    """(convert_zero123_to_cogvideox.py:19-50, without the mp4 packing)"""
    names = _pngs(zero123_folder)
    for name in names:
        img = imread_rgb(os.path.join(zero123_folder, name))
        imwrite(os.path.join(out_folder, name),
                prepare_generative_image_crop_first(img, width, height))
    log(f"converted {len(names)} frames -> {out_folder}")
    return len(names)


def convert_cogvideox_to_original(refined_folder: str, out_folder: str,
                                  width=1080, height=1920, log=print) -> int:
    """Refined CogVideoX frames -> the original portrait frame layout read as
    fake views (convert_cogvideox_to_original.py; the '_rawsize' folders)."""
    names = _pngs(refined_folder)
    for name in names:
        img = imread_rgb(os.path.join(refined_folder, name))
        imwrite(os.path.join(out_folder, name), crop_and_resize(img, width, height))
    log(f"converted {len(names)} frames -> {out_folder}")
    return len(names)


def main(argv=None):
    ap = argparse.ArgumentParser(description="FluidNexus format conversions")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("original_to_zero123")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--num_cameras", type=int, default=5)
    p.add_argument("--camera_prefix", default="camera")

    p = sub.add_parser("zero123_cams")
    p.add_argument("--transforms_json", required=True)
    p.add_argument("--out_dir", required=True)

    p = sub.add_parser("zero123_to_cogvideox")
    p.add_argument("--zero123_folder", required=True)
    p.add_argument("--out_folder", required=True)

    p = sub.add_parser("cogvideox_to_original")
    p.add_argument("--refined_folder", required=True)
    p.add_argument("--out_folder", required=True)
    p.add_argument("--width", type=int, default=1080)
    p.add_argument("--height", type=int, default=1920)

    args = ap.parse_args(argv)
    if args.cmd == "original_to_zero123":
        return convert_original_to_zero123(args.data_root, args.out_root, args.num_cameras,
                                           args.camera_prefix)
    if args.cmd == "zero123_cams":
        return create_zero123_cams(args.transforms_json, args.out_dir)
    if args.cmd == "zero123_to_cogvideox":
        return convert_zero123_to_cogvideox(args.zero123_folder, args.out_folder)
    return convert_cogvideox_to_original(args.refined_folder, args.out_folder, args.width,
                                         args.height)


if __name__ == "__main__":
    main()
