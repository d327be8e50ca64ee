"""The port's LANCZOS resample (utils/lanczos.py) against Pillow, bit for bit,
in 8 bits (modes "L" and "RGB": integer weights, clipped after each pass)
and in mode "F" (double sums stored as float32), downscaling and upscaling,
on smooth and on noise images; and the three JAX callers through their port
counterparts: the scene readers' ``_resize``, ``gen_refine_video.load_frames``
and the frame-folder dataset (in tests/test_torch_video_dataset.py). Pillow
is used here only, never in the port."""
import os

import numpy as np
import pytest
from PIL import Image

from fluidnexus_torch.data import readers as treaders
from fluidnexus_torch.pipelines import gen_refine_video as trefine
from fluidnexus_torch.utils.lanczos import coefficients, resize_f32, resize_u8
from fluidnexus_tpu.data import readers as jreaders
from fluidnexus_tpu.pipelines import gen_refine_video as jrefine

SIZES = [((54, 96), (48, 72)),     # the ratio of 960 x 544 -> 720 x 480
         ((27, 48), (50, 90)),     # upscale on both axes
         ((30, 40), (30, 20)),     # horizontal pass alone
         ((30, 40), (45, 40)),     # vertical pass alone
         ((17, 23), (5, 61)),      # down on one axis, up on the other
         ((3, 5), (1, 1)),         # taps clipped at both edges
         ((136, 240), (120, 180))]


def _image(kind, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(0, 1, (h, w, c))
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([0.5 + 0.4 * np.sin(x / (5.0 + i) + y / 9.0) for i in range(c)], -1)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0][1]}x{s[0][0]}-{s[1][1]}x{s[1][0]}")
def test_resample_matches_pillow(size, kind):
    (h, w), (th, tw) = size
    img = _image(kind, h, w, 3)
    u8 = (img * 255).astype(np.uint8)
    ref = np.asarray(Image.fromarray(u8).resize((tw, th), Image.LANCZOS))
    np.testing.assert_array_equal(resize_u8(u8, tw, th), ref)
    ref_l = np.asarray(Image.fromarray(u8[..., 0]).resize((tw, th), Image.LANCZOS))
    np.testing.assert_array_equal(resize_u8(u8[..., 0].copy(), tw, th), ref_l)
    # mode "F" on values past [0, 1] too: nothing is clipped there
    f = (img[..., 0] * 1.5 - 0.25).astype(np.float32)
    ref_f = np.asarray(Image.fromarray(f, mode="F").resize((tw, th), Image.LANCZOS), np.float32)
    got_f = resize_f32(f, tw, th)
    assert got_f.dtype == np.float32
    np.testing.assert_array_equal(got_f, ref_f)


def test_weights_sum_to_one_and_stay_in_the_axis():
    for n_in, n_out in ((960, 720), (544, 480), (48, 90), (5, 1)):
        xmin, taps, kk = coefficients(n_in, n_out)
        assert (xmin >= 0).all() and (xmin + taps <= n_in).all()
        np.testing.assert_allclose(kk.sum(1), 1.0, rtol=0, atol=1e-12)


def test_resize_rejects_other_types():
    with pytest.raises(TypeError):
        resize_u8(np.zeros((4, 4), np.float32), 2, 2)
    with pytest.raises(TypeError):
        resize_f32(np.zeros((4, 4, 3), np.float32), 2, 2)


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("resolution", [1, 2, 4, 8, 40, -1])
def test_readers_resize_matches_jax(resolution, gray):
    """``_resize`` as the readers call it on decoded frames: RGB floats
    truncated to uint8 and resampled in 8 bits, gray floats (the unrounded
    luma) resampled in mode "F"."""
    img = _image("noise", 34, 63, 3, seed=resolution % 7).astype(np.float32)
    if gray:
        img = (np.float32(0.299) * img[..., 0] + np.float32(0.587) * img[..., 1]) \
            + np.float32(0.114) * img[..., 2]
    ref = jreaders._resize(img, resolution)
    got = treaders._resize(img, resolution)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("frame_hw", [(32, 48), (27, 61), (64, 96)])
def test_load_frames_matches_jax(tmp_path, frame_hw):
    """``load_frames`` (the ``sample_video --prefix_folder`` frames) at the
    sampler's own size and resampled from other sizes."""
    h, w = frame_hw
    for i in range(3):
        img = (_image("noise" if i % 2 else "smooth", h, w, 3, seed=i) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"{i:03d}.png")
    ref = jrefine.load_frames(str(tmp_path), range(3), "%03d.png", 32, 48)
    got = trefine.load_frames(str(tmp_path), range(3), "%03d.png", 32, 48)
    assert got.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(got, ref)


def test_sample_video_reads_prefix_frames(tmp_path):
    """``sample_video --tiny`` with ``--prefix_folder``: the frames are read
    and resampled, encoded, and their latents held clean through sampling."""
    import torch

    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.pipelines import sample_video

    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)).save(
            tmp_path / f"{i:03d}.png")
    seen = {}
    real = VideoEngine.sample

    def spy(self, *a, **kw):
        seen["prefix"] = kw.get("prefix_clean_frames")
        return real(self, *a, **kw)

    VideoEngine.sample = spy
    try:
        out = sample_video.main(["--tiny", "--prompt", "x", "--out_folder", str(tmp_path / "out"),
                                 "--num_frames", "9", "--height", "32", "--width", "48",
                                 "--num_steps", "2", "--prefix_folder", str(tmp_path),
                                 "--prefix_frames", "5"], device="cpu")
    finally:
        VideoEngine.sample = real
    assert seen["prefix"] is not None and tuple(seen["prefix"].shape[:2]) == (1, 2)
    assert torch.isfinite(out).all() and len(os.listdir(tmp_path / "out")) == 9
