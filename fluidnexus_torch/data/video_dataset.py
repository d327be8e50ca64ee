"""Video finetune datasets (counterpart of
``fluidnexus_tpu/data/video_dataset.py``): the frame-folder layout,
``ClipFolderDataset``, read with the port's own PNG decoder (no process of
the port imports Pillow), and ``make_video_dataset``, which picks a dataset by
the content of the root as the JAX package does.

A frame whose size differs from (height, width) is resampled with PIL's
8-bit LANCZOS (``utils/lanczos``), as the JAX package's PIL path does.
Waiting for their piece, named in the error they raise: the mp4 datasets
``SFTVideoDataset`` and ``WebVideoDataset`` (a video decoder: the JAX
package's goes through OpenCV).
"""
from __future__ import annotations

import os

import numpy as np

from fluidnexus_torch.utils.lanczos import resize_u8
from fluidnexus_torch.utils.png import read_png, to_rgb

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


def _needs_video_decoder(kind, root):
    raise NotImplementedError(
        f"{root} holds {kind}: reading them needs a video decoder, which is not ported yet "
        "(the JAX package's goes through OpenCV); the port reads frame folders of PNGs")


def make_video_dataset(root: str, num_frames: int = 49, height: int = 480, width: int = 720):
    """Pick the dataset by content of <root>: .tar shards (here or under
    videos/) -> WebVideoDataset; video files under videos/ -> SFTVideoDataset
    (both raise: not ported yet); frame-folder directories ->
    ClipFolderDataset."""
    vids = os.path.join(root, "videos")
    for d in (root, vids):
        if os.path.isdir(d) and any(f.endswith(".tar") for f in os.listdir(d)):
            _needs_video_decoder("webdataset tar shards (WebVideoDataset)", d)
    if os.path.isdir(vids) and any(f.lower().endswith(VIDEO_EXTS) for f in os.listdir(vids)):
        _needs_video_decoder("video files (SFTVideoDataset)", vids)
    return ClipFolderDataset(root, num_frames, height, width)
