"""Video finetune datasets (counterpart of
``fluidnexus_tpu/data/video_dataset.py``), the reference's SFTDataset and
webdataset loader (CogVideoX data_video.py), and ``make_video_dataset``,
which picks one by the content of the root as the JAX package does:
  - ``WebVideoDataset``: webdataset tar shards (``<key>.mp4``, a caption, an
    optional ``<key>.json`` of duration and fps), streamed through a
    reservoir shuffle of the raw samples, a random temporal window each;
  - ``SFTVideoDataset``: ``videos/<name>.mp4`` and ``labels/<name>.txt``,
    resampled to the target fps from the start, snapped to 4k+1 frames;
  - ``ClipFolderDataset``: ``videos/<name>/*.png`` frame folders, read with
    the port's own PNG decoder (no process of the port imports Pillow); a
    frame of another size is resampled with PIL's 8-bit LANCZOS
    (``utils/lanczos``), as the JAX package's PIL path does.
The video files decode through ``utils/video_io.read_video_with_fps`` (OpenCV
for an mp4), and their frames are cover-resized with OpenCV's bicubic filter
and centre-cropped, as in the JAX package; OpenCV is imported when a clip is
read, and its absence raises an ImportError naming it.

Two findings of the JAX package are kept: ``WebVideoDataset.sample_batch``
ignores its ``rng`` (the stream draws from ``seed``), and a long clip's
stride is floored to at least 1.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from fluidnexus_torch.utils.lanczos import resize_u8
from fluidnexus_torch.utils.png import read_png, to_rgb
from fluidnexus_torch.utils.video_io import read_video_with_fps

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm")


def nearest_smaller_4k_plus_1(n: int) -> int:
    """The causal VAE needs 4k+1 frames."""
    r = n % 4
    return n - 3 if r == 0 else n - r + 1


def read_frames(paths, height: int, width: int) -> np.ndarray:
    """PNG frames as (T, H, W, 3) f32 in [-1, 1] (data_video.py:
    (x-127.5)/127.5): each converted to RGB, and one at another size than
    (height, width) resampled with PIL's 8-bit LANCZOS, as the JAX package's
    PIL path does."""
    out = []
    for p in paths:
        img = to_rgb(read_png(p))
        if img.shape[:2] != (height, width):
            img = resize_u8(np.ascontiguousarray(img), width, height)
        out.append(img.astype(np.float32))
    return (np.stack(out) - 127.5) / 127.5


def pad_last_frame(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """Repeat the final frame up to num_frames, or truncate past it."""
    if len(frames) < num_frames:
        pad = np.repeat(frames[-1:], num_frames - len(frames), axis=0)
        return np.concatenate([frames, pad], 0)
    return frames[:num_frames]


def resize_for_rectangle_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(T, H, W, C) uint8 frames cover-resized with OpenCV's bicubic filter
    so that (height, width) fits inside, then cropped to it at the centre
    (the JAX package's ``mode="center"``, the one its datasets use)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("resizing video frames needs OpenCV (cv2), as the JAX package's "
                          "INTER_CUBIC resize does; it does not import here") from e
    h, w = frames.shape[1:3]
    if w / h > width / height:
        nh, nw = height, int(round(w * height / h))
    else:
        nh, nw = int(round(h * width / w)), width
    out = np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC) for f in frames])
    top, left = (out.shape[1] - height) // 2, (out.shape[2] - width) // 2
    return out[:, top:top + height, left:left + width]


def select_clip_frames(ori_vlen: int, actual_fps: float, fps: float, max_num_frames: int,
                       skip_frms_num: int = 0) -> Tuple[np.ndarray, int]:
    """SFTDataset's frame indices into the raw clip and the item's frame
    count: a clip longer than ``max_num_frames`` at ``fps`` is strided from
    the margin at actual_fps / fps; one with more raw frames but a short
    duration is strided uniformly; a short one is snapped down to 4k+1."""
    start = int(skip_frms_num)
    if actual_fps > 0 and ori_vlen / actual_fps * fps > max_num_frames:
        num = max_num_frames
        end = int(start + num / fps * actual_fps)
        idx = np.arange(start, end, max((end - start) // num, 1)).astype(int)
        return np.clip(idx, 0, ori_vlen - 1), num
    if ori_vlen > max_num_frames:
        num = max_num_frames
        end = int(ori_vlen - skip_frms_num)
        return np.arange(start, end, max((end - start) // num, 1)).astype(int), num
    end = int(ori_vlen - skip_frms_num)
    num = nearest_smaller_4k_plus_1(end - start)
    return np.arange(start, start + num), num


def _normalize(frames: np.ndarray) -> np.ndarray:
    return (frames.astype(np.float32) - 127.5) / 127.5


class SFTVideoDataset:
    """videos/<name>.mp4 (or .avi/.mkv/.webm) + labels/<name>.txt (the first
    line): the reference's finetune layout."""

    def __init__(self, root: str, num_frames: int = 49, height: int = 480, width: int = 720,
                 fps: float = 8.0, skip_frms_num: int = 0):
        self.root = root
        self.num_frames = num_frames
        self.height, self.width = height, width
        self.fps = fps
        self.skip_frms_num = skip_frms_num
        vids = os.path.join(root, "videos")
        self.clips = sorted(f for f in os.listdir(vids)
                            if os.path.isfile(os.path.join(vids, f))
                            and f.lower().endswith(VIDEO_EXTS))
        if not self.clips:
            raise ValueError(f"no video files under {root}/videos")

    def __len__(self):
        return len(self.clips)

    def caption(self, clip: str) -> str:
        p = os.path.join(self.root, "labels", os.path.splitext(clip)[0] + ".txt")
        if not os.path.exists(p):
            return ""
        with open(p) as f:
            lines = f.read().splitlines()
        return lines[0] if lines else ""

    def load_clip(self, clip: str, rng=None):
        """(num_frames, H, W, 3) f32 in [-1, 1]: the selected frames, the
        last repeated up to num_frames, resized and centre-cropped."""
        frames, actual_fps = read_video_with_fps(os.path.join(self.root, "videos", clip))
        idx, _ = select_clip_frames(len(frames), actual_fps, self.fps, self.num_frames,
                                    self.skip_frms_num)
        out = pad_last_frame(frames[idx], self.num_frames)
        return _normalize(resize_for_rectangle_crop(out, self.height, self.width))

    def sample_batch(self, batch: int, rng: np.random.Generator):
        names = [self.clips[rng.integers(len(self.clips))] for _ in range(batch)]
        frames = np.stack([self.load_clip(n, rng) for n in names])
        return frames, [self.caption(n) for n in names]


class ClipFolderDataset:
    """videos/<name>/*.png (+ labels/<name>.txt caption): the frame layout
    the data processing emits before mp4 packing."""

    def __init__(self, root: str, num_frames: int = 49, height: int = 480, width: int = 720):
        self.root = root
        self.num_frames = num_frames
        self.height, self.width = height, width
        vids = os.path.join(root, "videos")
        self.clips = sorted(
            d for d in os.listdir(vids) if os.path.isdir(os.path.join(vids, d))
        ) if os.path.isdir(vids) else []
        if not self.clips:
            raise ValueError(f"no clip folders under {root}/videos")

    def caption(self, clip: str) -> str:
        p = os.path.join(self.root, "labels", clip + ".txt")
        if not os.path.exists(p):
            return ""
        with open(p) as f:
            return f.read().strip()

    def load_clip(self, clip: str, rng: np.random.Generator):
        """(n, H, W, 3) f32 in [-1, 1]: a window of n = 4k+1 frames (at most
        num_frames) from a random start drawn from ``rng``."""
        folder = os.path.join(self.root, "videos", clip)
        frames = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        n = min(len(frames), self.num_frames)
        n = (n - 1) // 4 * 4 + 1
        start = rng.integers(0, max(len(frames) - n, 0) + 1)
        return read_frames([os.path.join(folder, f) for f in frames[start:start + n]],
                           self.height, self.width)

    def sample_batch(self, batch: int, rng: np.random.Generator):
        names = [self.clips[rng.integers(len(self.clips))] for _ in range(batch)]
        frames = np.stack([self.load_clip(n, rng) for n in names])
        captions = [self.caption(n) for n in names]
        return frames, captions


def select_random_window(ori_vlen: int, actual_fps: float, fps: float, num_frames: int,
                         skip_frms_num: int, rng: np.random.Generator) -> np.ndarray:
    """The webdataset loader's temporal crop: a random start past the
    margin, then ``num_frames`` indices strided at actual_fps / fps."""
    span = num_frames / fps * actual_fps
    max_seek = int(ori_vlen - skip_frms_num - span)
    start = int(rng.integers(skip_frms_num, max(max_seek, skip_frms_num) + 1))
    end = int(start + span)
    idx = np.arange(start, end, max((end - start) / num_frames, 1e-6)).astype(int)
    return np.clip(idx[:num_frames], 0, ori_vlen - 1)


class WebVideoDataset:
    """Streaming tar shards (the reference's webdataset ``VideoDataset``).

    Members are grouped into samples by the key before the first dot of the
    base name and stored under the last extension (``clip.x264.mp4`` ->
    "mp4"): the video (mp4 or avi), the caption (``txt_key`` or "txt") and
    optional json metadata. A sample is skipped when it has no video, when
    its json lacks duration or fps, when it does not decode, or when it is
    shorter than num_frames / fps + 2 margins; without a json the duration
    and fps come from the decoded clip. Shards are shuffled by ``seed`` and
    dealt round-robin to (rank, world); raw samples pass a reservoir of
    ``shuffle_buffer`` before decoding. A tar member decodes through a
    temporary file, as OpenCV cannot decode from memory."""

    def __init__(self, path: str, image_size=(480, 720), num_frames: int = 49,
                 fps: float = 8.0, skip_frms_num: float = 0.0, seed: int = 1,
                 shuffle_buffer: int = 1000, txt_key: str = "caption", rank: int = 0,
                 world: int = 1):
        import glob

        if os.path.isdir(path):
            shards = sorted(glob.glob(os.path.join(path, "**", "*.tar"), recursive=True))
        else:
            shards = sorted(glob.glob(path))
        if not shards:
            raise ValueError(f"no .tar shards under {path}")
        self.shards = list(np.random.default_rng(seed).permutation(shards))[rank::world]
        self.image_size = tuple(image_size)
        self.num_frames = num_frames
        self.fps = fps
        self.skip_frms_num = skip_frms_num
        self.shuffle_buffer = shuffle_buffer
        self.txt_key = txt_key
        self.seed = seed
        self._stream = None

    def _iter_samples(self):
        """{extension: bytes} of each sample, in shard order."""
        import tarfile

        for shard in self.shards:
            with tarfile.open(shard) as tf:
                cur_key, cur = None, {}
                for m in tf:
                    if not m.isfile():
                        continue
                    base = os.path.basename(m.name)
                    key = base.partition(".")[0]
                    ext = base.rsplit(".", 1)[-1] if "." in base else ""
                    if cur_key is not None and key != cur_key and cur:
                        yield cur
                        cur = {}
                    cur_key = key
                    cur[ext.lower()] = tf.extractfile(m).read()
                if cur:
                    yield cur

    def _decode(self, raw: dict, rng: np.random.Generator):
        import json
        import tempfile

        ext = next((e for e in ("mp4", "avi") if e in raw), None)
        if ext is None:
            return None
        txt = raw.get(self.txt_key.lower(), raw.get("txt", b""))
        txt = txt.decode("utf-8") if isinstance(txt, bytes) else str(txt)
        meta = json.loads(raw["json"]) if "json" in raw else None
        if meta is not None and (meta.get("duration") is None or meta.get("fps") is None):
            return None
        with tempfile.NamedTemporaryFile(suffix="." + ext) as f:
            f.write(raw[ext])
            f.flush()
            try:
                frames, actual_fps = read_video_with_fps(f.name)
            except Exception:
                return None
        if meta is not None:
            actual_fps = float(meta["fps"])
            ori_vlen = min(int(float(meta["duration"]) * actual_fps), len(frames))
        else:
            ori_vlen = len(frames)
        if ori_vlen < self.num_frames / self.fps * actual_fps + 2 * self.skip_frms_num:
            return None
        idx = select_random_window(ori_vlen, actual_fps, self.fps, self.num_frames,
                                   int(self.skip_frms_num), rng)
        out = pad_last_frame(frames[idx], self.num_frames)
        out = resize_for_rectangle_crop(out, *self.image_size)
        return {"mp4": _normalize(out), "txt": txt, "num_frames": self.num_frames,
                "fps": self.fps}

    def __iter__(self):
        """Decoded samples through the reservoir of raw ones (shuffle before
        decode, as the reference's pipeline orders it), from ``seed``."""
        rng = np.random.default_rng(self.seed)
        buf: List[dict] = []
        for raw in self._iter_samples():
            buf.append(raw)
            if len(buf) >= self.shuffle_buffer:
                item = self._decode(buf.pop(int(rng.integers(len(buf)))), rng)
                if item is not None:
                    yield item
        rng.shuffle(buf)
        for raw in buf:
            item = self._decode(raw, rng)
            if item is not None:
                yield item

    def sample_batch(self, batch: int, rng: np.random.Generator):
        """The next ``batch`` items of the stream (``rng`` unused), starting
        a new pass when one ends; a pass that yields nothing raises."""
        if self._stream is None:
            self._stream = iter(self)
            self._epoch_items = 0
        frames, captions = [], []
        while len(frames) < batch:
            try:
                item = next(self._stream)
            except StopIteration:
                if self._epoch_items == 0:
                    raise RuntimeError(
                        f"WebVideoDataset: a full pass over {len(self.shards)} shard(s) yielded "
                        "zero usable clips (all skipped by decode/metadata/length filters)")
                self._stream = iter(self)
                self._epoch_items = 0
                continue
            self._epoch_items += 1
            frames.append(item["mp4"])
            captions.append(item["txt"])
        return np.stack(frames), captions


def make_video_dataset(root: str, num_frames: int = 49, height: int = 480, width: int = 720,
                       fps: float = 8.0):
    """Pick the dataset by content of <root>: .tar shards (here or under
    videos/) -> WebVideoDataset; video files under videos/ ->
    SFTVideoDataset; frame-folder directories -> ClipFolderDataset."""
    vids = os.path.join(root, "videos")
    for d in (root, vids):
        if os.path.isdir(d) and any(f.endswith(".tar") for f in os.listdir(d)):
            return WebVideoDataset(d, (height, width), num_frames, fps=fps)
    if os.path.isdir(vids) and any(f.lower().endswith(VIDEO_EXTS) for f in os.listdir(vids)):
        return SFTVideoDataset(root, num_frames, height, width, fps=fps)
    return ClipFolderDataset(root, num_frames, height, width)
