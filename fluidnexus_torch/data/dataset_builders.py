"""Dataset-tree builders (counterpart of ``fluidnexus_tpu/data/dataset_builders.py``):
raw ScalarFlow captures -> per-camera PNG trees, captures -> Zero123 /
CogVideoX training trees, simulation renders -> CogVideoX frames, and the
temporal smoothing of the level-two attributes.

Parity targets (reference DataProcessing/):
  - scalar_flow/preprocess.py:26-117 + helpers.py (raw ScalarFlow npz ->
    per-camera raw / denoised / background-separated PNG folders)
  - fluid_nexus_real/create_zero123_dataset.py (square 512 crops per
    (sequence, frame, camera)) and create_zero123_paths.py (seq_to_cam.json +
    train/val path lists)
  - fluid_nexus_real/create_cogvideox_dataset.py (sliding-window 49-frame
    clips letterboxed to 720 x 480 + caption labels),
    create_cogvideox_paths.py and copy_cogvideox_val_dataset.py
  - convert_simulation_original_to_cogvideox[_unshift].py (simulation renders
    -> CogVideoX-ready frames, optionally undoing the ScalarReal shift)

As in the JAX package, clips are frame folders under videos/<name>/ (what
``data/video_dataset.ClipFolderDataset`` reads); ``--pack_video`` also
writes each clip through ``utils/video_io.write_video`` as an AVI (the
port's holds uncompressed frames). Frames are read, resized and written as
``data/conversions`` does, with no imaging library. The ScalarFlow
preprocess runs on the entry point's device: on the card each frame stays
there from its uint8 cast to its last output, and the non-local-means
denoise (OpenCV's ``fastNlMeansDenoising`` in the JAX package) is the
kernel of ``ops/nlmeans_cuda``; on the CPU it is ``utils/nlmeans.
denoise_plain``. Both equal OpenCV bit for bit.

CLI: python -m fluidnexus_torch.data.dataset_builders <cmd> ...
(``main(argv, device="cuda")``; only ``scalar_flow_preprocess`` uses the
device).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from typing import List, Optional, Sequence

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.data.conversions import imread_rgb, imwrite, letterbox, pad_square, resize
from fluidnexus_torch.ops.nlmeans_cuda import nlmeans_cuda
from fluidnexus_torch.utils.nlmeans import denoise_plain

# ScalarFlow camera order inside the raw npz stacks (preprocess.py:21; the
# order of the capture rig's info.json)
SCALARFLOW_CAMERA_IDS = (2, 1, 0, 4, 3)

# ScalarReal per-view un-shift offsets (image_utils.unshift:168-204)
SCALAR_UNSHIFT = {
    "train00": (12, -18),
    "train01": (-52, -18),
    "train02": (0, 0),
    "train03": (-11, 12),
    "train04": (-11, 18),
}


def prepare_generative_image(img: np.ndarray, width_new=720, height_new=480,
                             bg_color=(0, 0, 0)) -> np.ndarray:
    """Aspect-preserving letterbox fit (image_utils.prepare_generative_image
    :327-372)."""
    return letterbox(img, width_new, height_new, bg_color)


def shift_image(image: np.ndarray, offset_h: int, offset_w: int) -> np.ndarray:
    """Zero-fill translate (image_utils.shift_image:142-166)."""
    if offset_h == 0 and offset_w == 0:
        return image
    out = np.zeros_like(image)
    hs = slice(max(offset_h, 0), image.shape[0] + min(offset_h, 0))
    ws = slice(max(offset_w, 0), image.shape[1] + min(offset_w, 0))
    hsrc = slice(max(-offset_h, 0), image.shape[0] + min(-offset_h, 0))
    wsrc = slice(max(-offset_w, 0), image.shape[1] + min(-offset_w, 0))
    out[hs, ws] = image[hsrc, wsrc]
    return out


# ------------------------------- ScalarFlow ----------------------------------


def denoise_image(gray, strength: int = 3, device="cuda") -> torch.Tensor:
    """Non-local-means denoise (helpers.denoise:8-33, single-frame branch):
    OpenCV's ``fastNlMeansDenoising(gray, None, strength, 7, 21)`` of a 2-D
    image cast to uint8, bit for bit, as a uint8 tensor on ``device``: the
    kernel on a card, ``denoise_plain`` on the CPU."""
    g = torch.as_tensor(gray, device=resolve_device(device)).to(torch.uint8).contiguous()
    if g.device.type == "cpu":
        return denoise_plain(g, float(strength))
    return nlmeans_cuda(g, float(strength))


def separate_background(cur, first, threshold: int = 8, scale: float = 1.0) -> torch.Tensor:
    """Subtract the first (smoke-free) frame and zero everything at or under
    the threshold (helpers.separate_background:36-59), on the inputs' device:
    uint8 in int16, clipped to 0-255; with ``scale`` > 1 multiplied in
    float32 by float32(scale), clipped and truncated to uint8, as the JAX
    package's numpy does."""
    cur, first = torch.as_tensor(cur), torch.as_tensor(first)
    sub = (cur.to(torch.int16) - first.to(torch.int16)).clamp(0, 255).to(torch.uint8)
    out = torch.where(sub > threshold, sub, torch.zeros_like(sub))
    if scale > 1.0:
        f32 = torch.tensor(scale, dtype=torch.float32, device=out.device)
        out = (out.to(torch.float32) * f32).clamp(0, 255).to(torch.uint8)
    return out


def scalar_flow_preprocess(sim_input_path: str, camera_ids: Sequence[int] = SCALARFLOW_CAMERA_IDS,
                           threshold: int = 8, log=print, device="cuda") -> int:
    """Raw ScalarFlow npz stacks -> per-camera PNG trees
    (preprocess.py:26-84): cam/<imgsUnproc_%06d.npz>["data"] (one gray frame
    per camera, stored upside down, float [0,1]) becomes
      cam{j}_raw/imgs_%06d.png                 flipped + u8
      cam{j}_denoise/...                       NL-means denoised
      cam{j}_no_bg/...                         denoised minus first frame
      cam{j}_no_denoise_no_bg/...              raw minus first frame
      cam{j}_no_denoise_no_bg_scale145/...     ... scaled by 1.45
    The first file gives raw and denoise only. A file ``np.load`` cannot
    open is logged ("Error loading <name>") and skipped. Each stack goes to
    ``device`` once and each PNG comes back once. Returns the number of
    frames processed."""
    dev = resolve_device(device)
    cam_dir = os.path.join(sim_input_path, "cam")
    names = sorted(os.listdir(cam_dir))
    firsts_raw, firsts_den = {}, {}
    n_frames = 0

    def write(tree, name, img):
        imwrite(os.path.join(sim_input_path, tree, name), img.cpu().numpy())

    for t, name in enumerate(names):
        try:
            npz = np.load(os.path.join(cam_dir, name))
        except Exception:   # whatever np.load raises skips the file, as in the JAX package
            log(f"Error loading {name}")
            continue
        with npz:
            frames = torch.as_tensor(npz["data"], device=dev)
        out_name = name.replace(".npz", ".png").replace("Unproc", "")
        for idx, cam in enumerate(camera_ids):
            raw = torch.flip(torch.clamp(frames[idx] * 255, 0, 255).to(torch.uint8), (0,))
            write(f"cam{cam}_raw", out_name, raw)
            den = denoise_image(raw, device=dev)
            write(f"cam{cam}_denoise", out_name, den)
            if t == 0:
                firsts_raw[cam], firsts_den[cam] = raw, den
                continue
            write(f"cam{cam}_no_bg", out_name, separate_background(den, firsts_den[cam], threshold))
            write(f"cam{cam}_no_denoise_no_bg", out_name,
                  separate_background(raw, firsts_raw[cam], threshold))
            write(f"cam{cam}_no_denoise_no_bg_scale145", out_name,
                  separate_background(raw, firsts_raw[cam], threshold, scale=1.45))
        n_frames += 1
    log(f"scalar_flow_preprocess: {n_frames} frames x {len(camera_ids)} cams -> {sim_input_path}")
    return n_frames


# ----------------------------- Zero123 dataset -------------------------------


def create_zero123_dataset(capture_root: str, out_root: str, sequences: Sequence[str],
                           num_cams: int = 5, size: int = 512, log=print) -> int:
    """Per (sequence, frame) folders of square 512 crops, one PNG per camera
    (create_zero123_dataset.py:35-55)."""
    n = 0
    for seq in sequences:
        for cam in range(num_cams):
            folder = os.path.join(capture_root, seq, f"camera{cam:02d}")
            frames = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
            for frame_id, frame in enumerate(frames):
                img = resize(pad_square(imread_rgb(os.path.join(folder, frame))), size, size)
                imwrite(os.path.join(out_root, seq, f"frame_{frame_id:03d}", f"{cam:02d}.png"),
                        img)
                n += 1
    log(f"create_zero123_dataset: {n} images -> {out_root}")
    return n


def create_zero123_paths(out_root: str, sequences: Sequence[str], num_val: int = 20,
                         paths_post: str = "20", log=print):
    """seq_to_cam.json + train/val frame-path lists
    (create_zero123_paths.py:36-71; the first num_val sequences are val)."""
    with open(os.path.join(out_root, "seq_to_cam.json"), "w") as f:
        json.dump({s: 1 for s in sequences}, f)
    splits = {"train": list(sequences)[num_val:], "val": list(sequences)[:num_val]}
    for split, seqs in splits.items():
        paths = []
        for seq in seqs:
            paths.extend(os.path.join(seq, f) for f in os.listdir(os.path.join(out_root, seq)))
        with open(os.path.join(out_root, f"{split}_paths{paths_post}.json"), "w") as f:
            json.dump(paths, f)
    log(f"create_zero123_paths: {len(splits['train'])} train / {len(splits['val'])} val seqs")
    return splits


# ---------------------------- CogVideoX dataset ------------------------------


def clip_name(seq: str, cam: int, start: int, num_frames: int) -> str:
    """seq_<seq>_cam_<02d>_start_<03d>_frames_<03d> (create_cogvideox_dataset.py:66)"""
    return f"seq_{seq}_cam_{cam:02d}_start_{start:03d}_frames_{num_frames:03d}"


def create_cogvideox_dataset(capture_root: str, out_root: str, sequences: Sequence[str],
                             num_cams: int = 5, min_frame_id: int = 15,
                             num_all_frames: int = 370, start_frame_step: int = 5,
                             frame_step: int = 2, num_frames: int = 49,
                             width: int = 720, height: int = 480,
                             caption: str = "smoke rising from an incense stick",
                             pack_video: bool = False, log=print) -> List[str]:
    """Sliding-window clips letterboxed to 720 x 480
    (create_cogvideox_dataset.py:42-88): videos/<clip>/NNN.png frame folders
    and labels/<clip>.txt captions; with ``pack_video`` also avi/<clip>.avi."""
    names = []
    for seq in sequences:
        starts = range(min_frame_id, num_all_frames - num_frames * frame_step, start_frame_step)
        for cam in range(num_cams):
            for start in starts:
                name = clip_name(seq, cam, start, num_frames)
                clip_dir = os.path.join(out_root, "videos", name)
                frames_out = []
                for fid in range(start, start + num_frames * frame_step, frame_step):
                    src = os.path.join(capture_root, seq, f"camera{cam:02d}", f"{fid:03d}.png")
                    img = prepare_generative_image(imread_rgb(src), width, height)
                    imwrite(os.path.join(clip_dir, f"{fid:03d}.png"), img)
                    frames_out.append(img)
                os.makedirs(os.path.join(out_root, "labels"), exist_ok=True)
                with open(os.path.join(out_root, "labels", name + ".txt"), "w") as f:
                    f.write(caption)
                if pack_video:
                    from fluidnexus_torch.utils.video_io import write_video

                    write_video(os.path.join(out_root, "avi", name + ".avi"),
                                np.stack(frames_out), fps=8)
                names.append(name)
    log(f"create_cogvideox_dataset: {len(names)} clips -> {out_root}")
    return names


def create_cogvideox_paths(out_root: str, sequences: Sequence[str], num_val: int = 20,
                           cam: int = -1, paths_post: str = "20", log=print):
    """all/train/val clip-name lists split by sequence
    (create_cogvideox_paths.py:24-90; cam=-1 keeps every camera)."""
    names = sorted(os.listdir(os.path.join(out_root, "videos")))
    if cam != -1:
        names = [n for n in names if f"cam_{cam:02d}" in n]
    cam_str = "all" if cam == -1 else f"cam_{cam:02d}"
    train_seqs, val_seqs = list(sequences)[num_val:], list(sequences)[:num_val]
    train = [n for n in names if n.split("_cam_")[0][4:] in train_seqs]
    val = [n for n in names if n.split("_cam_")[0][4:] in val_seqs]
    for split, lst in (("train", train), ("val", val)):
        with open(os.path.join(out_root, f"{cam_str}_{split}_paths{paths_post}.json"), "w") as f:
            json.dump(lst, f)
    log(f"create_cogvideox_paths: {len(train)} train / {len(val)} val clips ({cam_str})")
    return train, val


def copy_cogvideox_val_dataset(dataset_root: str, out_root: str,
                               start_frame_ids: Sequence[int] = (235,), log=print) -> int:
    """Copy the clips whose start frame is in start_frame_ids into a compact
    validation tree (copy_cogvideox_val_dataset.py:20-70)."""
    n = 0
    for name in sorted(os.listdir(os.path.join(dataset_root, "labels"))):
        if int(name.split("_")[-3]) not in start_frame_ids:
            continue
        clip = name[:-4]
        shutil.copytree(os.path.join(dataset_root, "videos", clip),
                        os.path.join(out_root, "videos", clip), dirs_exist_ok=True)
        os.makedirs(os.path.join(out_root, "labels"), exist_ok=True)
        shutil.copyfile(os.path.join(dataset_root, "labels", name),
                        os.path.join(out_root, "labels", name))
        n += 1
    log(f"copy_cogvideox_val_dataset: {n} clips -> {out_root}")
    return n


# ------------------------- simulation -> CogVideoX ---------------------------


def convert_simulation_to_cogvideox(exp_path: str, render_sub_dir: str = "training_render",
                                    out_sub_dir: str = "training_render_for_cogvideox",
                                    identifier: str = "0000", width: int = 720,
                                    height: int = 480, unshift: bool = False, log=print) -> int:
    """Future-simulation renders -> CogVideoX-ready letterboxed frames
    (convert_simulation_original_to_cogvideox.py; with ``unshift`` the
    ScalarReal per-view training shift is undone first, image_utils.unshift)."""
    src_dir = os.path.join(exp_path, render_sub_dir)
    frames = sorted(f for f in os.listdir(src_dir) if identifier in f)
    for frame in frames:
        img = imread_rgb(os.path.join(src_dir, frame))
        if unshift:
            off_h, off_w = SCALAR_UNSHIFT[frame.split("_")[2]]
            img = shift_image(img, off_h, off_w)
            imwrite(os.path.join(exp_path, render_sub_dir + "_unshift", frame), img)
        imwrite(os.path.join(exp_path, out_sub_dir, frame),
                prepare_generative_image(img, width, height))
    log(f"convert_simulation_to_cogvideox: {len(frames)} frames -> {out_sub_dir}")
    return len(frames)


# ------------------------- level-two smoothing -------------------------------


def smooth_visual_attrs(ckpt_dir: str, window: int = 5,
                        names: Sequence[str] = ("color", "scales", "rotation", "opacity")) -> int:
    """Write ``frame_XXX_visual_{name}_smoothed_ws{window}.npy``, centred
    moving averages of the per-frame visual attributes, which
    ``splat/dynamics.load_visual`` reads under ``use_level_two_smoothed_in_future``.

    The window is clamped at the sequence's ends; visual particles are only
    appended across frames, so a row index is a particle's identity and a
    row past a neighbour frame's count averages over fewer frames.
    Quaternions are sign-aligned to the centre frame before the average and
    normalised after it. ``window`` must be odd. Sums run in float64, as in
    the JAX package. Returns the number of frames written."""
    if window % 2 == 0:
        raise ValueError(f"smooth_visual_attrs needs an odd centered window, got {window}")
    frame_re = re.compile(r"frame_(\d+)_visual_xyz\.npy$")
    frames = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                    if (m := frame_re.match(f)) is not None)
    half = window // 2
    for fi in frames:
        pre = os.path.join(ckpt_dir, f"frame_{fi:03d}_")
        for name in names:
            center = np.load(pre + f"visual_{name}.npy").astype(np.float64)
            acc = np.zeros_like(center)
            cnt = np.zeros((len(center),) + (1,) * (center.ndim - 1))
            for fj in range(fi - half, fi + half + 1):
                if fj not in frames:
                    continue
                a = np.load(os.path.join(ckpt_dir, f"frame_{fj:03d}_visual_{name}.npy"))
                m = min(len(a), len(center))
                a = a[:m].astype(np.float64)
                if name == "rotation":   # q and -q are the same rotation
                    sign = np.sign(np.sum(a * center[:m], axis=-1, keepdims=True))
                    a = a * np.where(sign == 0, 1.0, sign)
                acc[:m] += a
                cnt[:m] += 1
            out = (acc / np.maximum(cnt, 1)).astype(np.float32)
            if name == "rotation":
                out = out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
            np.save(pre + f"visual_{name}_smoothed_ws{window}.npy", out)
    return len(frames)


# ----------------------------------- CLI -------------------------------------


def _read_sequences(capture_root: str) -> List[str]:
    """The sequence list of capture_set.csv (first column, header skipped)."""
    with open(os.path.join(capture_root, "capture_set.csv")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    return [ln.split(",")[0] for ln in lines[1:]]


def main(argv: Optional[List[str]] = None, device="cuda"):
    ap = argparse.ArgumentParser(description="FluidNexus dataset-tree builders")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scalar_flow_preprocess")
    p.add_argument("--sim_input_path", required=True)

    p = sub.add_parser("zero123_dataset")
    p.add_argument("--capture_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--num_cams", type=int, default=5)
    p.add_argument("--size", type=int, default=512)

    p = sub.add_parser("zero123_paths")
    p.add_argument("--capture_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--num_val", type=int, default=20)

    p = sub.add_parser("cogvideox_dataset")
    p.add_argument("--capture_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--num_cams", type=int, default=5)
    p.add_argument("--min_frame_id", type=int, default=15)
    p.add_argument("--num_all_frames", type=int, default=370)
    p.add_argument("--start_frame_step", type=int, default=5)
    p.add_argument("--frame_step", type=int, default=2)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--caption", default="smoke rising from an incense stick")
    p.add_argument("--pack_video", action="store_true")

    p = sub.add_parser("cogvideox_paths")
    p.add_argument("--capture_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--num_val", type=int, default=20)
    p.add_argument("--cam", type=int, default=-1)

    p = sub.add_parser("copy_cogvideox_val")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--start_frame_ids", type=int, nargs="+", default=[235])

    p = sub.add_parser("simulation_to_cogvideox")
    p.add_argument("--exp_path", required=True)
    p.add_argument("--render_sub_dir", default="training_render")
    p.add_argument("--out_sub_dir", default="training_render_for_cogvideox")
    p.add_argument("--identifier", default="0000")
    p.add_argument("--unshift", action="store_true")

    p = sub.add_parser("smooth_visual")
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--window", type=int, default=5)

    a = ap.parse_args(argv)
    if a.cmd == "scalar_flow_preprocess":
        return scalar_flow_preprocess(a.sim_input_path, device=device)
    if a.cmd == "zero123_dataset":
        return create_zero123_dataset(a.capture_root, a.out_root, _read_sequences(a.capture_root),
                                      a.num_cams, a.size)
    if a.cmd == "zero123_paths":
        return create_zero123_paths(a.out_root, _read_sequences(a.capture_root), a.num_val)
    if a.cmd == "cogvideox_dataset":
        return create_cogvideox_dataset(
            a.capture_root, a.out_root, _read_sequences(a.capture_root), a.num_cams,
            a.min_frame_id, a.num_all_frames, a.start_frame_step, a.frame_step, a.num_frames,
            caption=a.caption, pack_video=a.pack_video)
    if a.cmd == "cogvideox_paths":
        return create_cogvideox_paths(a.out_root, _read_sequences(a.capture_root), a.num_val,
                                      a.cam)
    if a.cmd == "copy_cogvideox_val":
        return copy_cogvideox_val_dataset(a.dataset_root, a.out_root, tuple(a.start_frame_ids))
    if a.cmd == "simulation_to_cogvideox":
        return convert_simulation_to_cogvideox(a.exp_path, a.render_sub_dir, a.out_sub_dir,
                                               a.identifier, unshift=a.unshift)
    n = smooth_visual_attrs(a.ckpt_dir, a.window)
    print(f"smoothed {n} frames (ws{a.window})")
    return n


if __name__ == "__main__":
    main()
