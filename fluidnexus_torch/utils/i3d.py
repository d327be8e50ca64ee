"""Inflated 3D Inception-V1 (I3D) feature network for FVD (counterpart of
``fluidnexus_tpu/utils/i3d.py``).

Parity target: Zero123/ldm/modules/evaluate/torch_frechet_video_distance.py
(I3D 400-class Kinetics logits as FVD features) and
frechet_video_distance.py (the TF-hub I3D). The standard InceptionI3d graph
(Carreira & Zisserman 2017) as a forward over a flat parameter dict keyed by
the community ``pytorch-i3d`` state-dict names (Conv3d_1a_7x7.conv3d.weight,
Mixed_3b.b1a.bn.running_mean, ...), so ``rgb_imagenet.pt`` and its npz
conversion load directly.

The JAX package's numerics are kept: every convolution pads TF-SAME (the odd
row of padding at the end, at stride 2 too), every max pool pads SAME with
-inf, batch norm at eps 1e-3 in inference form, the head averages (2, 7, 7)
VALID windows, and the input is resized to 224 as ``jax.image.resize(...,
"bilinear")`` does it (antialiased when it shrinks; ``utils/resize``).
``F.conv3d(padding="same")`` refuses stride 2 and pads the other way round,
so the padding is explicit. Inside, tensors are (N, C, T, H, W).

No weights ship; ``random_params(seed)`` draws the JAX package's
deterministic network.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import float_tensors
from fluidnexus_torch.utils.resize import resize_linear

BN_EPS = 1e-3

# (name, out, kernel, stride) for the stem; inception blocks listed below
_STEM = (
    ("Conv3d_1a_7x7", 64, (7, 7, 7), (2, 2, 2)),
    ("Conv3d_2b_1x1", 64, (1, 1, 1), (1, 1, 1)),
    ("Conv3d_2c_3x3", 192, (3, 3, 3), (1, 1, 1)),
)
# name -> (b0, b1a, b1b, b2a, b2b, b3b)
_MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
NUM_CLASSES = 400


def same_pads(sizes, kernel, stride):
    """TF "SAME" padding of (T, H, W) as ``F.pad`` takes it (last axis
    first): out = ceil(n / s), total max((out - 1) s + k - n, 0), the
    smaller half before."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def conv_same(x, w, stride):
    """x (N, C, T, H, W), w torch-layout (O, I, kT, kH, kW); TF-SAME."""
    x = F.pad(x, same_pads(x.shape[2:], w.shape[2:], stride))
    return F.conv3d(x, w, stride=stride)


def max_pool_same(x, kernel, stride):
    """``reduce_window(max, SAME)``: pads with -inf, then a VALID max pool."""
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-float("inf"))
    return F.max_pool3d(x, kernel, stride)


def _vec(v):
    return v[None, :, None, None, None]


def _unit(p: Dict[str, torch.Tensor], prefix: str, x, stride=(1, 1, 1), relu=True):
    x = conv_same(x, p[f"{prefix}.conv3d.weight"], stride)
    if f"{prefix}.bn.running_mean" in p:
        mean = p[f"{prefix}.bn.running_mean"]
        var = p[f"{prefix}.bn.running_var"]
        gamma = p.get(f"{prefix}.bn.weight", torch.ones_like(mean))
        beta = p.get(f"{prefix}.bn.bias", torch.zeros_like(mean))
        x = (x - _vec(mean)) * _vec(torch.rsqrt(var + BN_EPS)) * _vec(gamma) + _vec(beta)
    elif f"{prefix}.conv3d.bias" in p:
        x = x + _vec(p[f"{prefix}.conv3d.bias"])
    return F.relu(x) if relu else x


def _mixed(p, name, x):
    b0 = _unit(p, f"{name}.b0", x)
    b1 = _unit(p, f"{name}.b1b", _unit(p, f"{name}.b1a", x))
    b2 = _unit(p, f"{name}.b2b", _unit(p, f"{name}.b2a", x))
    b3 = _unit(p, f"{name}.b3b", max_pool_same(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_logits(params, videos, device="cuda") -> torch.Tensor:
    """videos (N, T, H, W, 3) in [0, 1] -> Kinetics-400 logits (N, 400) on
    ``device``.

    Matches the torchscript FVD detector's preprocessing: bilinear resize to
    224x224 and rescale to [-1, 1] (torch_frechet_video_distance.py:66-79)."""
    dev = resolve_device(device)
    p = float_tensors(params, dev)
    x = torch.as_tensor(videos, dtype=torch.float32, device=dev)
    n, t, h, w, c = x.shape
    x = resize_linear(x, (n, t, 224, 224, c))
    x = (x * 2.0 - 1.0).permute(0, 4, 1, 2, 3)

    x = _unit(p, "Conv3d_1a_7x7", x, (2, 2, 2))
    x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
    x = _unit(p, "Conv3d_2b_1x1", x)
    x = _unit(p, "Conv3d_2c_3x3", x)
    x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
    x = _mixed(p, "Mixed_3b", x)
    x = _mixed(p, "Mixed_3c", x)
    x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
    for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _mixed(p, name, x)
    x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
    x = _mixed(p, "Mixed_5b", x)
    x = _mixed(p, "Mixed_5c", x)

    # global average pool over (2,7,7) windows = full spatial at 224 input,
    # then the 1x1x1 logits conv and temporal mean (pytorch-i3d logits head)
    x = F.avg_pool3d(x, (2, 7, 7), stride=1)
    x = _unit(p, "logits", x, relu=False)
    return x.mean(dim=(2, 3, 4))


def _branch_channels(in_ch: int, spec) -> Sequence[Tuple[str, int, int, Tuple[int, int, int]]]:
    b0, b1a, b1b, b2a, b2b, b3b = spec
    return (("b0", in_ch, b0, (1, 1, 1)), ("b1a", in_ch, b1a, (1, 1, 1)),
            ("b1b", b1a, b1b, (3, 3, 3)), ("b2a", in_ch, b2a, (1, 1, 1)),
            ("b2b", b2a, b2b, (3, 3, 3)), ("b3b", in_ch, b3b, (1, 1, 1)))


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random init with the exact checkpoint key layout (the
    JAX package's draws) — substitutes for real Kinetics weights in tests
    and regression tracking."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def unit(prefix, cin, cout, k):
        fan_in = cin * int(np.prod(k))
        p[f"{prefix}.conv3d.weight"] = rng.normal(
            0, 1.0 / np.sqrt(fan_in), (cout, cin) + tuple(k)).astype(np.float32)
        p[f"{prefix}.bn.running_mean"] = np.zeros(cout, np.float32)
        p[f"{prefix}.bn.running_var"] = np.ones(cout, np.float32)
        p[f"{prefix}.bn.weight"] = np.ones(cout, np.float32)
        p[f"{prefix}.bn.bias"] = np.zeros(cout, np.float32)

    cin = 3
    for name, cout, k, _ in _STEM:
        unit(name, cin, cout, k)
        cin = cout
    for name, spec in _MIXED:
        for bname, bc_in, bc_out, k in _branch_channels(cin, spec):
            unit(f"{name}.{bname}", bc_in, bc_out, k)
        cin = spec[0] + spec[2] + spec[4] + spec[5]
    p["logits.conv3d.weight"] = rng.normal(
        0, 1.0 / np.sqrt(cin), (NUM_CLASSES, cin, 1, 1, 1)).astype(np.float32)
    p["logits.conv3d.bias"] = np.zeros(NUM_CLASSES, np.float32)
    return p


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Load an I3D checkpoint: .npz (converted) or a torch .pt state dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}
