"""PyTorch + CUDA port of ``fluidnexus_tpu`` for NVIDIA Hopper.

The subpackages mirror the JAX package's layout and names. Every entry point
takes an explicit ``device``: it runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises when ``cuda`` is asked for and absent.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on. A CUDA device without a
    visible card raises; there is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain CPU path")
    return dev
