"""The non-local-means kernel (``csrc/nlmeans.cu`` through
``ops/nlmeans_cuda``) on the card against ``utils/nlmeans.denoise_plain``,
bit for bit: ScalarFlow-sized frames, edge shapes where the reflected border
wraps again, a strided input refused, the strength, the launch count, and
no fall back when the library does not load. Marked `cuda`; skips where
there is no card. The file imports no JAX and no OpenCV:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nlmeans_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.data import dataset_builders as db
from fluidnexus_torch.ops import nlmeans_cuda as nc
from fluidnexus_torch.utils.nlmeans import denoise_plain
from tests.torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

SHAPES = ((1062, 600), (16, 12), (7, 5), (1, 1), (2, 3), (33, 600), (9, 33), (130, 70))


def _image(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "smooth":
        img = 120 + 80 * np.sin(x / 5.0) * np.cos(y / 7.0) + rng.normal(0, 12, (h, w))
        return np.clip(img, 0, 255).astype(np.uint8)
    return np.where(x < w // 2, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "smooth", "halves"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_kernel_equals_plain(cuda_device, shape, kind):
    img = torch.as_tensor(_image(kind, *shape, seed=sum(shape)), device=cuda_device)
    before = nc.LAUNCHES["nlmeans"]
    got = nc.nlmeans_cuda(img)
    torch.cuda.synchronize()
    assert nc.LAUNCHES["nlmeans"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert torch.equal(got, denoise_plain(img))


@pytest.mark.parametrize("h", [1.0, 7.0, 12.5])
def test_kernel_takes_the_strength(cuda_device, h):
    img = torch.as_tensor(_image("smooth", 70, 90, seed=3), device=cuda_device)
    assert torch.equal(nc.nlmeans_cuda(img, h), denoise_plain(img, h))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    img = torch.zeros((20, 30), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        nc.nlmeans_cuda(img[:, ::2])
    with pytest.raises(TypeError, match="uint8"):
        nc.nlmeans_cuda(img.float())
    with pytest.raises(ValueError, match="one"):
        nc.nlmeans_cuda(img[None])


def test_denoise_image_on_the_card_does_not_fall_back(cuda_device, monkeypatch):
    def broken():
        raise RuntimeError("the nlmeans library did not build")

    monkeypatch.setattr(nc, "_lib", broken)
    with pytest.raises(RuntimeError, match="did not build"):
        db.denoise_image(_image("noise", 8, 8, seed=0), device="cuda")


def test_preprocess_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """``scalar_flow_preprocess`` through the CLI on the card and on the CPU
    writes the same bytes, with one kernel launch a camera frame."""
    rng = np.random.default_rng(2)
    for root in (tmp_path / "card", tmp_path / "cpu"):
        (root / "cam").mkdir(parents=True)
    for t in range(3):
        data = np.clip(0.3 + 0.2 * rng.normal(size=(5, 40, 24)), 0, 1).astype(np.float32)
        for root in (tmp_path / "card", tmp_path / "cpu"):
            np.savez(root / "cam" / f"imgsUnproc_{t:06d}.npz", data=data)
    nc.reset_launches()
    assert db.main(["scalar_flow_preprocess", "--sim_input_path", str(tmp_path / "card")]) == 3
    assert nc.LAUNCHES["nlmeans"] == 15
    db.main(["scalar_flow_preprocess", "--sim_input_path", str(tmp_path / "cpu")], device="cpu")
    files = sorted(p.relative_to(tmp_path / "cpu") for p in (tmp_path / "cpu").rglob("*.png"))
    assert len(files) == 5 * (3 + 3 + 2 + 2 + 2)
    for rel in files:
        assert (tmp_path / "card" / rel).read_bytes() == (tmp_path / "cpu" / rel).read_bytes(), rel
