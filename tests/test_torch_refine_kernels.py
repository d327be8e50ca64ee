"""The refinement CLIs on the card against the same runs on the CPU, where
the attention wrapper takes its plain version: ``gen_refine_video.main`` and
``gen_future_video.main`` at ``--tiny`` (f32: the mma.sync kernel), with the
CPU run's noise draws replayed on the card. PNGs within one 8-bit level,
the same names, every attention call on the kernel; the packed video read
back. Marked `cuda`; skips where there is no card. The file imports no JAX
and no Pillow:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_refine_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import flax_params_to_numpy
from fluidnexus_torch.core.checkpoint import save_params
from fluidnexus_torch.diffusion.video import sampling
from fluidnexus_torch.diffusion.video.dit import init_video_dit
from fluidnexus_torch.diffusion.video.vae3d import init_vae
from fluidnexus_torch.ops import attention_cuda as ac
from fluidnexus_torch.pipelines import gen_future_video as tfut
from fluidnexus_torch.pipelines import gen_refine_video as tref
from fluidnexus_torch.pipelines.sample_video import configs
from fluidnexus_torch.utils.png import read_png, write_png
from fluidnexus_torch.utils.video_io import read_video
from tests.torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _inputs(root):
    rng = np.random.default_rng(0)
    for folder, pattern, idx, hw in (("in", "frame_%06d.png", range(3, 18, 2), (64, 96)),
                                     ("gt", "%03d.png", range(1, 10, 2), (80, 120)),
                                     ("sim", "render_frame%03d_train00_0000.png",
                                      range(50, 57, 2), (64, 96)),
                                     ("recon", "%03d.png", range(45, 50), (80, 120))):
        os.makedirs(root / folder, exist_ok=True)
        for i in idx:
            write_png(str(root / folder / (pattern % i)),
                      rng.integers(0, 256, (*hw, 3)).astype(np.uint8))


def _checkpoints(root):
    """The ``--tiny`` DiT and VAE at 9 x 64 x 96 with every weight drawn from
    numpy (the adaLN projections too, so attention reaches the frames),
    saved as the flat npz both runs load: a generator on the card draws
    other numbers than one on the CPU."""
    rng = np.random.default_rng(1)
    paths = []
    for name, module in zip(("dit", "vae"), (init_video_dit, init_vae)):
        model = module(configs(9, 64, 96, tiny=True)[name == "vae"], torch.Generator())
        params = {}
        for n, p in model.named_parameters():
            if p.dim() >= 2:
                x = rng.normal(size=p.shape) / np.sqrt(np.prod(p.shape[1:]))
            else:
                x = 1.0 + 0.1 * rng.normal(size=p.shape) if n.endswith("scale") \
                    else 0.1 * rng.normal(size=p.shape)
            params[n] = torch.as_tensor(x, dtype=torch.float32)
        paths += [f"--{name}_ckpt", save_params(str(root / name), flax_params_to_numpy(params))]
    return paths


def _argv(root, kind, out):
    small = ["--tiny", "--window_frames", "9", "--prefix_frames", "5", "--num_steps", "4",
             "--height", "64", "--width", "96", "--pack_video", *_checkpoints(root)]
    if kind == "refine":
        return small + ["--preset", "refine_smoke", "--input_folder", str(root / "in"),
                        "--gt_prefix_folder", str(root / "gt"), "--out_folder", out,
                        "--num_windows", "2", "--window_start_indices", "3", "11",
                        "--gt_prefix_start", "1"]
    return small + ["--preset", "wind_smoke", "--sim_render_folder", str(root / "sim"),
                    "--recon_frames_folder", str(root / "recon"), "--out_root", out]


@pytest.mark.parametrize("kind", ["refine", "future"])
def test_cli_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch, kind):
    _inputs(tmp_path)
    main = tref.main if kind == "refine" else tfut.main
    draws, replayed, real = [], [], sampling._normal

    def recording(shape, generator, device):
        draws.append(real(shape, generator, device))
        return draws[-1]

    def replaying(shape, generator, device):
        replayed.append(draws[len(replayed)])
        return replayed[-1].to(device)

    monkeypatch.setattr(sampling, "_normal", recording)
    cpu_out, _ = main(_argv(tmp_path, kind, str(tmp_path / "cpu")), device="cpu")
    monkeypatch.setattr(sampling, "_normal", replaying)
    ac.reset_launches()
    card_out, video = main(_argv(tmp_path, kind, str(tmp_path / "card")), device="cuda")
    assert len(replayed) == len(draws) > 0
    if kind == "refine":
        assert cpu_out == card_out == [9, 4]
        a, b = tmp_path / "cpu", tmp_path / "card"
    else:
        a, b = cpu_out, card_out
        assert os.path.basename(a) == os.path.basename(b)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == (13 if kind == "refine" else 4)
    for n in names:
        x, y = read_png(os.path.join(a, n)), read_png(os.path.join(b, n))
        assert x.shape == (64, 96, 3)
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1, n
    frames = read_video(video)
    assert frames.shape == (len(names), 64, 96, 3)
    if video.endswith(".avi"):
        np.testing.assert_array_equal(frames, np.stack([read_png(os.path.join(b, n))
                                                        for n in names]))
    # 2 layers a forward, 2 forwards a window at strength 0.5 / 0.55 of 4 steps
    windows = 2 if kind == "refine" else 1
    assert ac.LAUNCHES["attention_fwd"] == 2 * 2 * windows
    assert ac.LAUNCHES["attention_fwd_wgmma"] == 0
