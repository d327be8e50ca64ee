"""Helpers of the long-video refinement stage that ``sample_video`` uses
(counterpart of ``fluidnexus_tpu/pipelines/gen_refine_video.py``, its
``load_frames``, ``latent_prefix_len`` and ``save_frames``). The chained
refinement itself comes with its own slice.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from fluidnexus_torch.data.video_dataset import read_frames
from fluidnexus_torch.pipelines.train_background import save_image


def load_frames(folder: str, indices: Sequence[int], pattern: str, height: int, width: int):
    """The frames ``folder/(pattern % i)`` as ``video_dataset.read_frames``
    gives them: (T, H, W, 3) in [-1, 1], at (height, width)."""
    return read_frames([os.path.join(folder, pattern % i) for i in indices], height, width)


def save_frames(folder: str, frames, start_index: int, pattern="frame_%06d.png"):
    """(T, H, W, 3) frames in [-1, 1] as 8-bit PNGs: the pixels of the JAX
    package's ``clip((f + 1) 127.5, 0, 255).astype(uint8)``."""
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(np.asarray(frames, np.float32)):
        arr = np.clip((f + 1) * 127.5, 0, 255).astype(np.uint8)
        # save_image multiplies by 255 and truncates: k / 255 gives back k
        save_image(os.path.join(folder, pattern % (start_index + i)),
                   arr.transpose(2, 0, 1).astype(np.float32) / 255.0)


def latent_prefix_len(prefix_frames: int) -> int:
    """frames -> causal-VAE latent frames: (n-1)/4 + 1."""
    return (prefix_frames - 1) // 4 + 1
