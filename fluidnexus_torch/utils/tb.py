"""TensorBoard logging for the training pipelines (counterpart of
``fluidnexus_tpu/utils/tb.py``, what the port's pipelines use of it): a
``SummaryWriter`` rooted at the run's folder, and a no-op when tensorboard is
not importable, so no pipeline depends on it. Images are (H, W), (H, W, C)
or (C, H, W) float arrays in [0, 1]."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class TrainLogger:
    """SummaryWriter wrapper rooted at ``model_path``."""

    def __init__(self, model_path: Optional[str]):
        self._w = None
        if not model_path:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        os.makedirs(model_path, exist_ok=True)
        self._w = SummaryWriter(model_path)

    def add_scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def add_image(self, tag: str, img, step: int):
        """(H, W) / (H, W, C) / (C, H, W) float in [0, 1] -> a TB image."""
        if self._w is None:
            return
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3) and arr.shape[0] not in (1, 3):
            arr = arr.transpose(2, 0, 1)
        self._w.add_image(tag, np.clip(arr, 0.0, 1.0), step)

    def image_grid(self, tag: str, imgs, step: int, ncol: int = 8):
        """(N, H, W), (N, H, W, C) or (N, C, H, W) floats in [0, 1] as one
        tiled grid."""
        if self._w is None:
            return
        arr = np.asarray(imgs, np.float32)
        if arr.ndim == 3:
            arr = arr[..., None]
        elif arr.ndim == 4 and arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = arr.transpose(0, 2, 3, 1)
        n, h, w, c = arr.shape
        ncol = min(ncol, n)
        nrow = -(-n // ncol)
        pad = nrow * ncol - n
        if pad:
            arr = np.concatenate([arr, np.zeros((pad, h, w, c), np.float32)])
        grid = (arr.reshape(nrow, ncol, h, w, c).transpose(0, 2, 1, 3, 4)
                .reshape(nrow * h, ncol * w, c))
        self.add_image(tag, grid, step)
