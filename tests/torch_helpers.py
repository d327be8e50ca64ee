"""Shared helpers of the port's tests (tests/test_torch_*.py). Imports no JAX,
so the card-only tests that use it run where JAX is not installed."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def packed_tiles(t=4, k=64, c=3, seed=0, tiles_x=2, tile=16):
    """Depth-sorted packed rows ``(t, k, 7 + c)`` around each tile, with a live
    prefix per tile; returns (packed, counts, live) as numpy. The tiles sit
    near the origin: the Pallas kernel's expanded power (px^2, px py, ...
    monomials) loses digits as px grows, and a flip of the 1/255 skip test
    would then show as a difference of the reference."""
    rng = np.random.default_rng(seed)
    ty, tx = np.divmod(np.arange(t), tiles_x)
    x = tx[:, None] * tile + rng.uniform(-4, tile + 4, (t, k))
    y = ty[:, None] * tile + rng.uniform(-4, tile + 4, (t, k))
    s = rng.uniform(0.05, 0.5, (t, k))
    conic = np.stack([s, rng.uniform(-0.3, 0.3, (t, k)) * s, s * rng.uniform(0.5, 1.5, (t, k))], -1)
    op = rng.uniform(0.1, 1.0, (t, k, 1))           # some alphas hit the .99 clamp
    col = rng.uniform(0, 1, (t, k, c))
    dep = np.sort(rng.uniform(1, 5, (t, k)), 1)[..., None]
    packed = np.concatenate([x[..., None], y[..., None], conic, op, col, dep], -1).astype(np.float32)
    counts = rng.integers(0, k + 1, (t,)).astype(np.int32)
    counts[0], counts[1] = k, 0
    live = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    return packed, counts, live
