"""The ScalarFlow preprocess in the port against the JAX package, on the CPU:
the non-local-means denoise (``denoise_image(device="cpu")``, which is
``utils/nlmeans.denoise_plain``) against the JAX package's, which is
OpenCV's ``fastNlMeansDenoising``, exactly, on edge shapes where the
reflected border wraps more than once and on the image classes that reach
both ends of the weight table; the weight table's constants;
``separate_background`` exactly; and ``scalar_flow_preprocess`` through the
port's CLI against the JAX function, every tree, name and pixel. The card's
kernel is held to ``denoise_plain`` in ``test_torch_nlmeans_kernels.py``."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from fluidnexus_torch.data import dataset_builders as tdb
from fluidnexus_torch.ops import nlmeans_cuda
from fluidnexus_torch.utils import nlmeans
from fluidnexus_tpu.data import dataset_builders as jdb
from tests.test_torch_conversions import _same_tree
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((16, 12), (7, 5), (1, 1), (2, 3), (33, 600), (64, 48))


def _image(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "smooth":
        img = 120 + 80 * np.sin(x / 5.0) * np.cos(y / 7.0) + rng.normal(0, 12, (h, w))
        return np.clip(img, 0, 255).astype(np.uint8)
    if kind == "constant":
        return np.full((h, w), 77, np.uint8)
    return np.where(x < w // 2, 0, 255).astype(np.uint8)    # 0 / 255 halves


@pytest.mark.parametrize("kind", ["noise", "smooth", "constant", "halves"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_denoise_image_matches_jax(shape, kind):
    img = _image(kind, *shape, seed=shape[0] * 1000 + shape[1])
    got = tdb.denoise_image(img, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jdb.denoise_image(img))


def test_denoise_image_takes_the_strength():
    img = _image("smooth", 20, 30, seed=5)
    for strength in (1, 7):
        np.testing.assert_array_equal(tdb.denoise_image(img, strength, device="cpu").numpy(),
                                      jdb.denoise_image(img, strength))


def test_weight_table_has_opencvs_constants():
    """INT_MAX // (21^2 255) = 19 096, the shift of 49 into 64 = 6, 65 025
    x 49 / 64 + 1 entries, and 48 non-zero ones, falling."""
    table, shift, mult = nlmeans.nlmeans_weight_table(3.0, 7, 21)
    assert (len(table), shift, mult) == (49785, 6, 19096)
    head = nlmeans.weight_head(3.0)
    assert len(head) == 48 and table[0] == 19096 and np.all(np.diff(head) < 0)
    assert np.count_nonzero(table) == 48 and np.all(table[48:] == 0)


def test_border_index_reflects_again_past_the_edge():
    assert nlmeans.border_index(5, 3).tolist() == [3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1]
    assert nlmeans.border_index(2, 4).tolist() == [0, 1, 0, 1, 0, 1, 0, 1, 0, 1]
    assert nlmeans.border_index(1, 2).tolist() == [0] * 5


@pytest.mark.parametrize("scale", [1.0, 1.45])
def test_separate_background_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 100))
    cur = rng.integers(0, 256, (40, 30), dtype=np.uint8)
    first = rng.integers(0, 256, (40, 30), dtype=np.uint8)
    first[:5] = cur[:5] - rng.integers(0, 12, (5, 30)).astype(np.uint8)  # about the threshold
    got = tdb.separate_background(torch.as_tensor(cur), torch.as_tensor(first), 8, scale)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jdb.separate_background(cur, first, 8, scale))


def _write_stacks(sim, frames=3, h=16, w=12, seed=1):
    """``frames`` (5, h, w) float32 stacks in [0, 1] (smooth plumes with
    noise, so the denoise has structure to keep) and one file np.load
    cannot open, second in order."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(sim, "cam"))
    y, x = np.mgrid[:h, :w]
    for t in range(frames + 1):
        name = os.path.join(sim, "cam", f"imgsUnproc_{t:06d}.npz")
        if t == 1:
            with open(name, "wb") as f:
                f.write(b"not an npz")
            continue
        plume = np.exp(-((x - w / 2) ** 2) / 8.0 - ((y - t) ** 2) / 40.0)
        data = 0.2 + 0.5 * plume + rng.normal(0, 0.05, (5, h, w))
        np.savez(name, data=np.clip(data, -0.1, 1.1).astype(np.float32))


def test_scalar_flow_preprocess_cli_matches_jax(tmp_path, capsys):
    """3 frames x 5 cameras of 16 x 12 and an unreadable npz: the port's CLI
    and the JAX function write the same trees, names and pixels and count
    the same frames."""
    sim_t, sim_j = str(tmp_path / "torch" / "input"), str(tmp_path / "jax" / "input")
    _write_stacks(sim_t)
    shutil.copytree(sim_t, sim_j)
    logs = []
    n_j = jdb.scalar_flow_preprocess(sim_j, log=logs.append)
    n_t = tdb.main(["scalar_flow_preprocess", "--sim_input_path", sim_t], device="cpu")
    assert n_t == n_j == 3
    skipped = "Error loading imgsUnproc_000001.npz"
    assert logs == [skipped, f"scalar_flow_preprocess: 3 frames x 5 cams -> {sim_j}"]
    assert capsys.readouterr().out.splitlines() == [
        skipped, f"scalar_flow_preprocess: 3 frames x 5 cams -> {sim_t}"]
    trees = sorted(os.listdir(sim_t))
    assert len(trees) == 1 + 5 * 5 and trees == sorted(os.listdir(sim_j))
    assert _same_tree(sim_t, sim_j) == 4 + 5 * (3 + 3 + 2 + 2 + 2)
    assert sorted(os.listdir(os.path.join(sim_t, "cam2_no_bg"))) == ["imgs_000002.png",
                                                                     "imgs_000003.png"]


def test_denoise_image_on_cuda_raises_without_a_card():
    """No fall back: asking for the card where there is none raises, and the
    kernel's wrapper refuses a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img = _image("noise", 8, 8, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tdb.denoise_image(img, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nlmeans_cuda.nlmeans_cuda(torch.as_tensor(img))
    with pytest.raises(RuntimeError, match="cuda"):
        tdb.main(["scalar_flow_preprocess", "--sim_input_path", REPO])
    assert nlmeans_cuda.LAUNCHES["nlmeans"] == 0


def test_scalar_flow_preprocess_runs_without_pil_or_cv2(tmp_path):
    """A fresh interpreter in which PIL, cv2, jax and the JAX package cannot
    be imported runs the preprocess through the CLI on the CPU."""
    sim = str(tmp_path / "input")
    _write_stacks(sim, frames=2, h=9, w=7)
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("PIL", "cv2", "jax", "fluidnexus_tpu")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        from fluidnexus_torch.data.dataset_builders import main
        from fluidnexus_torch.utils.png import read_png
        assert main(["scalar_flow_preprocess", "--sim_input_path", {sim!r}], device="cpu") == 2
        assert read_png({sim!r} + "/cam0_no_bg/imgs_000002.png").shape == (9, 7, 1)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("no imaging library")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert "no imaging library" in res.stdout
