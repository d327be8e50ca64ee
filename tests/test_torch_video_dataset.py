"""The port's PNG reader (fluidnexus_torch/utils/png.py) against PIL on
PIL-written PNGs, and its clip-folder dataset (data/video_dataset.py)
against the JAX package's on the CPU: the same frames, captions and draws
from the same numpy generator. PIL is used here only, never in the port."""
import os

import numpy as np
import pytest
from PIL import Image

from fluidnexus_torch.data import video_dataset as tds
from fluidnexus_torch.pipelines.train_background import save_image
from fluidnexus_torch.utils.png import read_png, to_rgb
from fluidnexus_tpu.data import video_dataset as jds
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)


def _smooth(rng, h, w, c):
    """An image whose rows PIL's adaptive filter stores with every filter type."""
    x = rng.integers(0, 256, (h, w, c))
    return (np.cumsum(x, 1) // (np.arange(w)[None, :, None] + 1)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_read_png_matches_pil(tmp_path, mode):
    c = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    rng = np.random.default_rng(c)
    a = _smooth(rng, 37, 53, c)
    img = Image.fromarray(a[..., 0] if c == 1 else a, mode)
    seen = set()
    for i, opts in enumerate((dict(), dict(optimize=True), dict(compress_level=0))):
        path = str(tmp_path / f"{i}.png")
        img.save(path, **opts)
        got = read_png(path)
        ref = np.asarray(Image.open(path))
        np.testing.assert_array_equal(got, ref.reshape(got.shape))
        np.testing.assert_array_equal(to_rgb(got), np.asarray(Image.open(path).convert("RGB")))
        seen.add(i)
    assert seen == {0, 1, 2}


def test_read_png_reads_save_image_and_refuses_16_bit(tmp_path):
    x = np.random.default_rng(0).uniform(0, 1, (3, 9, 11))
    save_image(str(tmp_path / "a.png"), x)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "a.png")))
    # 16-bit gray is read as its high byte, as libpng's strip_16 gives it;
    # 16 bits on a palette image is outside the PNG standard and refused
    a16 = np.random.default_rng(1).integers(0, 65536, (4, 5)).astype(np.uint16)
    Image.fromarray(a16).save(tmp_path / "b.png")
    np.testing.assert_array_equal(read_png(str(tmp_path / "b.png"))[..., 0], a16 >> 8)
    data = bytearray((tmp_path / "b.png").read_bytes())
    data[24], data[25] = 16, 3
    (tmp_path / "c.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bit depth 16, color type 3"):
        read_png(str(tmp_path / "c.png"))


def _clips(root, sizes, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "labels")
    for name, (n, h, w) in sizes.items():
        os.makedirs(root / "videos" / name)
        for i in range(n):
            Image.fromarray(_smooth(rng, h, w, 3)).save(root / "videos" / name / f"f_{i:04d}.png")
        (root / "labels" / f"{name}.txt").write_text(f"  caption of {name}\n")


def test_clip_folder_dataset_matches_jax(tmp_path):
    """Two clips of 11 and 7 frames at the dataset's own size: the batch's
    frames (a 4k+1 window from a random start), captions and the draws of
    the numpy generator are the JAX package's exactly."""
    _clips(tmp_path, {"a": (11, 16, 24), "b": (7, 16, 24)})
    jd, td = jds.ClipFolderDataset(str(tmp_path), 9, 16, 24), tds.make_video_dataset(
        str(tmp_path), 9, 16, 24)
    assert isinstance(td, tds.ClipFolderDataset) and td.clips == jd.clips == ["a", "b"]
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        f_ref, c_ref = jd.sample_batch(1, r1)
        f, c = td.sample_batch(1, r2)
        np.testing.assert_array_equal(f, f_ref)
        assert c == c_ref
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


def test_dataset_helpers_and_what_is_not_ported(tmp_path):
    for n in range(1, 30):
        assert tds.nearest_smaller_4k_plus_1(n) == jds.nearest_smaller_4k_plus_1(n)
    x = np.arange(5 * 2).reshape(5, 2)
    for n in (3, 5, 8):
        np.testing.assert_array_equal(tds.pad_last_frame(x, n), jds.pad_last_frame(x, n))
    # a frame at another size is resampled with PIL's 8-bit LANCZOS, as JAX's is
    _clips(tmp_path, {"a": (5, 16, 20)})
    got, _ = tds.ClipFolderDataset(str(tmp_path), 5, 16, 24).sample_batch(
        1, np.random.default_rng(0))
    ref, _ = jds.ClipFolderDataset(str(tmp_path), 5, 16, 24).sample_batch(
        1, np.random.default_rng(0))
    np.testing.assert_array_equal(got, ref)
    # a video file under videos/ picks the mp4 dataset, as in JAX (the mp4 and
    # tar-shard datasets: tests/test_torch_video_files.py)
    (tmp_path / "videos" / "x.mp4").write_bytes(b"")
    assert isinstance(tds.make_video_dataset(str(tmp_path), 5, 16, 20), tds.SFTVideoDataset)
    assert isinstance(jds.make_video_dataset(str(tmp_path), 5, 16, 20), jds.SFTVideoDataset)


def test_raw_avi_holds_the_frames(tmp_path):
    """write_video's last resort (no OpenCV, no imageio-ffmpeg): a RIFF AVI
    whose '00db' chunks are the frames, bottom-up BGR rows padded to 4
    bytes; parsed back here chunk by chunk."""
    import struct

    from fluidnexus_torch.utils.video_io import write_avi_raw

    frames = np.random.default_rng(0).integers(0, 256, (5, 17, 23, 3)).astype(np.uint8)
    data = open(write_avi_raw(str(tmp_path / "a.avi"), frames, fps=8), "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    i = data.index(b"avih") + 8
    assert struct.unpack("<IIIIIIIIII", data[i:i + 40])[4] == 5            # total frames
    assert struct.unpack("<II", data[i + 32:i + 40]) == (23, 17)
    row, got, pos = 72, [], data.index(b"movi") + 4
    while data[pos:pos + 4] == b"00db":
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        raw = np.frombuffer(data[pos + 8:pos + 8 + size], np.uint8).reshape(17, row)
        got.append(raw[::-1, :69].reshape(17, 23, 3)[..., ::-1])
        pos += 8 + size + size % 2
    np.testing.assert_array_equal(np.stack(got), frames)
    assert data[pos:pos + 4] == b"idx1"
