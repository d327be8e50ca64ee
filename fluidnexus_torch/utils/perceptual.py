"""Perceptual similarity (LPIPS-style VGG16 feature distance; counterpart of
``fluidnexus_tpu/utils/perceptual.py``).

Parity target: Zero123/ldm/modules/evaluate/evaluate_perceptualsim.py —
PNet(pnet_type="vgg") (:234-296): images in [-1,1] are normalized by the
LPIPS shift/scale constants, run through torchvision vgg16's five feature
slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 — :143-185), and the
score is the sum over slices of (1 - spatial-mean cosine similarity of
unit-normalized channel features) (:272-293, cos_sim :25-37).

Weights are a plain dict of numpy arrays keyed as torchvision's
``vgg16.features`` state dict names them (``features.<idx>.weight/bias``,
OIHW kernels); ``load_torch_vgg16`` reads one, ``random_params`` draws the
JAX package's deterministic random net. The network runs (B, 3, H, W) on the
device of its input, in the matmul precision the process sets (the CLIs turn
TF32 off).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import float_tensors

# torchvision vgg16.features conv indices and the slice boundaries
# (evaluate_perceptualsim.py:143-166: slice1 = layers [0,4), slice2 [4,9),
# slice3 [9,16), slice4 [16,23), slice5 [23,30))
CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
CONV_CH = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_AFTER = (4, 9, 16, 23)          # maxpool layer indices inside .features
SLICE_END = (4, 9, 16, 23, 30)       # feature taps AFTER the last relu of each slice

# LPIPS input normalization (:246-247)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def vgg16_features(params, x) -> List[torch.Tensor]:
    """x: (B,3,H,W) tensor, already shift/scale normalized. Returns the 5
    slice outputs (B,C,h,w). Params keyed ``features.<idx>.weight/bias``
    with torch OIHW kernels (numpy, or tensors on x's device)."""
    outs = []
    h = x
    li = 0
    for idx in CONV_IDX:
        while li < idx:
            if li in POOL_AFTER:
                h = F.max_pool2d(h, 2, 2)
            li += 1
        w = torch.as_tensor(params[f"features.{idx}.weight"], device=x.device)
        b = torch.as_tensor(params[f"features.{idx}.bias"], device=x.device)
        h = F.relu(F.conv2d(h, w, padding=1) + b[None, :, None, None])
        li = idx + 2                                         # past conv + relu
        if li in SLICE_END:  # tap after the slice's last relu
            outs.append(h)
    return outs


def _cos_sim(a, b, eps=1e-10):
    """1 - mean cosine similarity over channel-unit-normalized features
    (evaluate_perceptualsim.py:18-37)."""
    na = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + eps)
    nb = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + eps)
    return torch.mean(torch.sum(na * nb, dim=1), dim=(1, 2))


def perceptual_sim(img0, img1, params, device="cuda") -> torch.Tensor:
    """PNet.forward (:272-293): img0/img1 (B,3,H,W) in [-1,1] (numpy, or
    tensors on ``device``); returns (B,) distances (sum over slices of 1 -
    cos_sim). Matches the reference's ``perceptual_sim(img1, img2, vgg16)``
    with inputs already in [-1,1]."""
    dev = resolve_device(device)
    w = float_tensors(params, dev)
    sh = torch.as_tensor(SHIFT, device=dev)[None, :, None, None]
    sc = torch.as_tensor(SCALE, device=dev)[None, :, None, None]
    f0 = vgg16_features(w, (torch.as_tensor(img0, dtype=torch.float32, device=dev) - sh) / sc)
    f1 = vgg16_features(w, (torch.as_tensor(img1, dtype=torch.float32, device=dev) - sh) / sc)
    val = 0.0
    for a, b in zip(f0, f1):
        val = val + (1.0 - _cos_sim(a, b))
    return val


def compute_perceptual_similarity_from_list(pred_list: Sequence[np.ndarray],
                                            tgt_list: Sequence[np.ndarray],
                                            params, batch: int = 8, device="cuda"):
    """Folder-tool parity (:416-…): lists of (3,H,W) images in [0,1] ->
    dict of mean Percsim/PSNR/SSIM like the reference's summary."""
    from fluidnexus_torch.utils.losses import psnr, ssim

    dev = resolve_device(device)
    w = float_tensors(params, dev)
    sims, psnrs, ssims = [], [], []
    with torch.no_grad():
        for i in range(0, len(pred_list), batch):
            p = torch.stack([torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
                             for x in pred_list[i:i + batch]])
            t = torch.stack([torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
                             for x in tgt_list[i:i + batch]])
            sims.extend(perceptual_sim(p * 2 - 1, t * 2 - 1, w, dev).cpu().numpy().tolist())
            for j in range(p.shape[0]):
                psnrs.append(float(psnr(p[j], t[j])))
                ssims.append(float(ssim(p[j][None], t[j][None])))
    return {"Perceptual similarity": float(np.mean(sims)),
            "PSNR": float(np.mean(psnrs)),
            "SSIM": float(np.mean(ssims))}


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random VGG16-features weights (pnet_rand equivalent),
    the JAX package's draws."""
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    for idx, cout in zip(CONV_IDX, CONV_CH):
        fan = cin * 9
        params[f"features.{idx}.weight"] = (
            rng.normal(0, np.sqrt(2.0 / fan), (cout, cin, 3, 3)).astype(np.float32))
        params[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
        cin = cout
    return params


def load_torch_vgg16(path: str) -> Dict[str, np.ndarray]:
    """Load a torchvision vgg16 (or vgg16.features) state dict (.pth/.pt)
    into the plain numpy param dict this module consumes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        kk = k if k.startswith("features.") else f"features.{k}"
        if any(kk == f"features.{i}.{s}" for i in CONV_IDX for s in ("weight", "bias")):
            out[kk] = np.asarray(v.detach().cpu().numpy(), np.float32)
    missing = [i for i in CONV_IDX if f"features.{i}.weight" not in out]
    assert not missing, f"state dict missing conv layers {missing}"
    return out
