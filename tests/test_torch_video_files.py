"""The port's video-file datasets (``data/video_dataset.py``:
``SFTVideoDataset`` over ``videos/*.mp4`` + ``labels/*.txt``,
``WebVideoDataset`` over webdataset tar shards, ``make_video_dataset``'s
pick) against the JAX package's on the CPU, on mp4 files and shards written
here as ``tests/test_video_dataset.py`` writes them (OpenCV's mp4 encoder),
at a tiny size: the same frames, bit for bit, and captions under the same
seeds. Both packages decode with OpenCV and resize with its bicubic filter."""
import json
import os
import sys
import tarfile

import numpy as np
import pytest

from fluidnexus_torch.data import video_dataset as tds
from fluidnexus_tpu.data import video_dataset as jds
from fluidnexus_tpu.utils.video_io import write_video
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)


def write_clip(path, n, fps=8, h=40, w=56, seed=0):
    """n frames, each distinct (its index in two channels) over a spatial
    ramp, so a wrong frame, resize or crop shows."""
    rng = np.random.default_rng(seed)
    ramp = (np.arange(w)[None, :] * 4 + np.arange(h)[:, None] * 2) % 256
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i, ..., 0] = (i * 9) % 256
        frames[i, ..., 1] = (ramp + i * 37) % 256
        frames[i, ..., 2] = rng.integers(0, 256)
    return write_video(str(path), frames, fps=fps)


def sft_root(root):
    os.makedirs(root / "videos")
    os.makedirs(root / "labels")
    # long at 24 fps (resampled from the start), more raw frames than wanted
    # at a short duration (strided), short (snapped to 4k+1 and padded)
    for name, n, fps in (("long", 60, 24), ("dense", 30, 100), ("short", 7, 8)):
        write_clip(root / "videos" / f"{name}.mp4", n, fps, seed=n)
        (root / "labels" / f"{name}.txt").write_text(f"{name} plume\nsecond line")
    return root


def test_sft_video_dataset_matches_jax(tmp_path):
    root = str(sft_root(tmp_path))
    jd, td = jds.SFTVideoDataset(root, 9, 16, 24), tds.make_video_dataset(root, 9, 16, 24)
    assert isinstance(td, tds.SFTVideoDataset) and td.clips == jd.clips
    for clip in td.clips:
        np.testing.assert_array_equal(td.load_clip(clip), jd.load_clip(clip), err_msg=clip)
    short = td.load_clip("short.mp4")
    np.testing.assert_array_equal(short[5:], np.repeat(short[4:5], 4, 0))   # padded by frame 4
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        f_ref, c_ref = jd.sample_batch(2, r1)
        f, c = td.sample_batch(2, r2)
        np.testing.assert_array_equal(f, f_ref)
        assert c == c_ref and f.shape == (2, 9, 16, 24, 3) and f.dtype == np.float32
    assert r1.integers(1 << 30) == r2.integers(1 << 30)
    for args in ((60, 24, 8, 9), (30, 100, 8, 10), (11, 8, 8, 49), (240, 24, 8, 9, 3),
                 (5, 0.0, 8, 49)):
        i_ref, n_ref = jds.select_clip_frames(*args)
        i, n = tds.select_clip_frames(*args)
        np.testing.assert_array_equal(i, i_ref)
        assert n == n_ref


def write_shard(path, clips, stage):
    """A webdataset tar: each clip (key, frames, caption, meta) as
    ``<key>.mp4``, ``<key>.txt`` and, where meta is a dict, ``<key>.json``."""
    os.makedirs(stage, exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for key, n, caption, meta in clips:
            video = write_clip(stage / f"{key}.x264.mp4", n, seed=len(key) + n)
            tf.add(video, arcname=f"{key}.x264.mp4")
            if caption is not None:
                (stage / f"{key}.txt").write_text(caption)
                tf.add(stage / f"{key}.txt", arcname=f"{key}.txt")
            if meta is not None:
                (stage / f"{key}.json").write_text(json.dumps(meta))
                tf.add(stage / f"{key}.json", arcname=f"{key}.json")
    return str(path)


def shards(root):
    stage = root / "stage"
    write_shard(root / "s0.tar", [("a", 30, "plume left", {"duration": 30 / 8, "fps": 8}),
                                  ("b", 24, "plume right", None),
                                  ("c", 40, "slow", {"duration": 2.0, "fps": 16})], stage)
    write_shard(root / "s1.tar", [("d", 24, "third", {"duration": 3.0, "fps": 8}),
                                  ("e", 4, "too short", {"duration": 0.5, "fps": 8}),
                                  ("f", 24, "no duration", {"duration": None, "fps": 8}),
                                  ("g", 26, None, {"duration": 26 / 8, "fps": 8})], stage)
    return str(root)


@pytest.mark.parametrize("buffer", [2, 100])
def test_web_video_dataset_matches_jax(tmp_path, buffer):
    """Shards with and without json metadata, skipped samples (too short, no
    duration), a sample without a caption, the reservoir, the batch adapter
    across a pass's end (it ignores its rng and restarts from the seed), and
    two ranks."""
    root = shards(tmp_path)
    kw = dict(image_size=(16, 24), num_frames=9, fps=8, shuffle_buffer=buffer, seed=3)
    jd, td = jds.WebVideoDataset(root, **kw), tds.WebVideoDataset(root, **kw)
    assert td.shards == jd.shards
    ref, got = list(jd), list(td)
    assert [i["txt"] for i in got] == [i["txt"] for i in ref]
    assert sorted(i["txt"] for i in got) == ["", "plume left", "plume right", "slow", "third"]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["mp4"], b["mp4"])
        assert (a["num_frames"], a["fps"]) == (b["num_frames"], b["fps"])
    for _ in range(3):   # 3 x 4 = 12 items: two passes and part of a third
        f_ref, c_ref = jd.sample_batch(4, np.random.default_rng(0))
        f, c = td.sample_batch(4, np.random.default_rng(1))
        np.testing.assert_array_equal(f, f_ref)
        assert c == c_ref and f.shape == (4, 9, 16, 24, 3)
    r0, r1 = (tds.WebVideoDataset(root, (16, 24), 9, 8, rank=r, world=2) for r in (0, 1))
    assert r0.shards == jds.WebVideoDataset(root, (16, 24), 9, 8, rank=0, world=2).shards
    assert sorted(r0.shards + r1.shards) == sorted(td.shards) and len(r0.shards) == 1


def test_web_video_dataset_with_no_usable_clip_raises(tmp_path):
    write_shard(tmp_path / "bad.tar", [("e", 4, "too short", None)], tmp_path / "stage")
    for mod in (jds, tds):
        with pytest.raises(RuntimeError, match="zero usable clips"):
            mod.WebVideoDataset(str(tmp_path), (16, 24), 9, 8).sample_batch(
                1, np.random.default_rng(0))


def test_make_video_dataset_picks_as_jax(tmp_path, monkeypatch):
    """Tar shards (in the root or under videos/) before video files before
    frame folders, with ``fps`` passed on; no OpenCV raises naming it."""
    shards(tmp_path / "web")
    os.makedirs(tmp_path / "nested" / "videos")
    write_shard(tmp_path / "nested" / "videos" / "s.tar", [("a", 24, "x", None)],
                tmp_path / "stage")
    sft_root(tmp_path / "sft")
    for root, kind in (("web", "WebVideoDataset"), ("nested", "WebVideoDataset"),
                       ("sft", "SFTVideoDataset")):
        got = tds.make_video_dataset(str(tmp_path / root), 9, 16, 24, fps=4.0)
        ref = jds.make_video_dataset(str(tmp_path / root), 9, 16, 24, fps=4.0)
        assert type(got).__name__ == type(ref).__name__ == kind and got.fps == ref.fps == 4.0
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tds.resize_for_rectangle_crop(np.zeros((1, 8, 8, 3), np.uint8), 4, 4)
