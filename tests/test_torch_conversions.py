"""The DataProcessing hand-offs in the port against the JAX package, on the
CPU: the format conversions (``data/conversions.py``, through
``python -m fluidnexus_torch convert``) and the dataset builders
(``data/dataset_builders.py``, through its CLI), each on the same inputs as
the JAX package's, with output PNGs pixel for pixel (read back with PIL),
JSON lists, captions and npys exactly. The smoothed level-two attributes
are exact too: both packages sum in float64 in the same order. The port
reads, resizes and writes with no imaging library: a subprocess with PIL
and OpenCV blocked imports every new module and runs a conversion.

Where the port's PNG read parts from PIL's ``convert("RGB")``: a 16-bit
gray PNG (PIL clips the 16-bit value to 255, ``read_png`` keeps its high
byte, as libpng's strip does). Every other PNG format reads alike."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from fluidnexus_torch.__main__ import STAGES
from fluidnexus_torch.__main__ import main as runner
from fluidnexus_torch.data import conversions as tconv
from fluidnexus_torch.data import dataset_builders as tdb
from fluidnexus_tpu.data import conversions as jconv
from fluidnexus_tpu.data import dataset_builders as jdb
from tests.test_dataset_builders import capture as capture_fixture
from tests.test_torch_readers import encode_png
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil_png(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(np.asarray(arr, np.uint8))
    (img.convert(mode) if mode else img).save(path)


def _same_tree(a, b):
    """The two folders hold the same names, PNGs with the same mode and
    pixels, and the same JSON, text and npy contents. Returns the count of
    files compared."""
    files = []
    for root, _, names in os.walk(b):
        files += [os.path.relpath(os.path.join(root, n), b) for n in names]
    got = []
    for root, _, names in os.walk(a):
        got += [os.path.relpath(os.path.join(root, n), a) for n in names]
    assert sorted(got) == sorted(files)
    for rel in files:
        x, y = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            ix, iy = Image.open(x), Image.open(y)
            assert ix.mode == iy.mode, rel
            np.testing.assert_array_equal(np.asarray(ix), np.asarray(iy), err_msg=rel)
        elif rel.endswith(".npy"):
            p, q = np.load(x), np.load(y)
            assert p.dtype == q.dtype, rel
            np.testing.assert_array_equal(p, q, err_msg=rel)
        elif rel.endswith(".json"):
            with open(x) as f, open(y) as g:
                assert json.load(f) == json.load(g), rel
        elif rel.endswith(".avi"):
            continue   # the JAX package's holds JPEGs, the port's raw frames: test_pack_video
        else:
            with open(x, "rb") as f, open(y, "rb") as g:
                assert f.read() == g.read(), rel
    return len(files)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Inputs of every hand-off, and the JAX package's outputs from them:
    a capture tree (tests/test_dataset_builders.py's ``capture``), an
    original-layout folder with RGB, gray, RGBA and palette PNGs of odd
    sizes, Zero123 and refined frames, a transforms.json, simulation
    renders of three views and a level-two checkpoint of 4 frames."""
    root = str(tmp_path_factory.mktemp("handoffs"))
    cap, seqs = capture_fixture.__wrapped__(tmp_path_factory.mktemp("cap"))
    rng = np.random.default_rng(5)
    inp = os.path.join(root, "in")
    for cam, (mode, shape) in enumerate((("RGB", (20, 12, 3)), ("L", (13, 22, 3)),
                                         ("RGBA", (17, 17, 3)), ("P", (9, 30, 3)))):
        for t in range(2):
            _pil_png(os.path.join(inp, "original", f"camera{cam:02d}", f"{t:03d}.png"),
                     rng.integers(0, 256, shape), mode)
    for i in range(3):
        _pil_png(os.path.join(inp, "zero123", f"frame_{i:06d}.png"),
                 rng.integers(0, 256, (64, 64, 3)))
        _pil_png(os.path.join(inp, "refined", f"frame_{i:06d}.png"),
                 rng.integers(0, 256, (48, 72, 3)))
    frames = []
    for cam in range(3):
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        c2w[:3, 3] = rng.normal(size=3)
        frames.append({"file_path": f"train0{cam}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(inp, "transforms.json"), "w") as f:
        json.dump({"frames": frames}, f)
    for view in ("train00", "train01", "train02"):
        for t in range(2):
            _pil_png(os.path.join(inp, "exp", "training_render",
                                  f"render_frame_{view}_{t:04d}_0000.png"),
                     rng.integers(0, 256, (64, 36, 3)))
    _pil_png(os.path.join(inp, "exp", "training_render", "render_frame_train00_0003_0001.png"),
             rng.integers(0, 256, (64, 36, 3)))   # another identifier: left alone
    for i, n in enumerate((5, 5, 7, 7)):
        pre = os.path.join(inp, "ckpt", f"frame_{i:03d}_visual_")
        os.makedirs(os.path.dirname(pre), exist_ok=True)
        np.save(pre + "xyz.npy", rng.normal(size=(n, 3)).astype(np.float32))
        np.save(pre + "color.npy", rng.uniform(0, 1, (n, 3)).astype(np.float32))
        np.save(pre + "scales.npy", rng.uniform(-6, -3, (n, 3)).astype(np.float32))
        q = rng.normal(size=(n, 4)).astype(np.float32)
        np.save(pre + "rotation.npy", q * np.where(rng.random((n, 1)) < 0.5, -1, 1))
        np.save(pre + "opacity.npy", rng.normal(size=(n, 1)).astype(np.float32))

    jax_out = os.path.join(root, "jax")
    for argv in _convert_argvs(inp, jax_out):
        jconv.main(argv)
    for argv in _builder_argvs(inp, cap, jax_out):
        jdb.main(argv)
    return inp, cap, seqs, jax_out, root


def _convert_argvs(inp, out):
    return [
        ["original_to_zero123", "--data_root", os.path.join(inp, "original"),
         "--out_root", os.path.join(out, "zero123_frames"), "--num_cameras", "5"],
        ["zero123_cams", "--transforms_json", os.path.join(inp, "transforms.json"),
         "--out_dir", os.path.join(out, "camera")],
        ["zero123_to_cogvideox", "--zero123_folder", os.path.join(inp, "zero123"),
         "--out_folder", os.path.join(out, "cogvideox_frames")],
        ["cogvideox_to_original", "--refined_folder", os.path.join(inp, "refined"),
         "--out_folder", os.path.join(out, "rawsize"), "--width", "54", "--height", "96"],
    ]


def _builder_argvs(inp, cap, out):
    import shutil

    shutil.copytree(os.path.join(inp, "exp"), os.path.join(out, "exp"))
    shutil.copytree(os.path.join(inp, "ckpt"), os.path.join(out, "ckpt"))
    z, c = os.path.join(out, "z123"), os.path.join(out, "cvx")
    return [
        ["zero123_dataset", "--capture_root", cap, "--out_root", z, "--num_cams", "2",
         "--size", "40"],
        ["zero123_paths", "--capture_root", cap, "--out_root", z, "--num_val", "1"],
        ["cogvideox_dataset", "--capture_root", cap, "--out_root", c, "--num_cams", "1",
         "--min_frame_id", "2", "--num_all_frames", "40", "--start_frame_step", "20",
         "--num_frames", "3", "--frame_step", "3", "--caption", "tiny smoke", "--pack_video"],
        ["cogvideox_paths", "--capture_root", cap, "--out_root", c, "--num_val", "1"],
        ["cogvideox_paths", "--capture_root", cap, "--out_root", c, "--num_val", "1",
         "--cam", "0"],
        ["copy_cogvideox_val", "--dataset_root", c, "--out_root", os.path.join(out, "cvx_val"),
         "--start_frame_ids", "22"],
        ["simulation_to_cogvideox", "--exp_path", os.path.join(out, "exp"), "--unshift"],
        ["smooth_visual", "--ckpt_dir", os.path.join(out, "ckpt"), "--window", "3"],
    ]


def test_conversions_through_the_runner_match_jax(inputs, tmp_path):
    """The four ``convert`` subcommands through ``python -m fluidnexus_torch
    convert``: every PNG pixel for pixel and the camera npys exactly."""
    inp, _, _, jax_out, _ = inputs
    assert STAGES["convert"] == "fluidnexus_torch.data.conversions"
    out = str(tmp_path)
    for argv in _convert_argvs(inp, out):
        runner(["convert"] + argv)
    counts = {d: _same_tree(os.path.join(out, d), os.path.join(jax_out, d))
              for d in ("zero123_frames", "camera", "cogvideox_frames", "rawsize")}
    assert counts == {"zero123_frames": 8, "camera": 3, "cogvideox_frames": 3, "rawsize": 3}
    assert Image.open(os.path.join(out, "zero123_frames", "frame_001", "03.png")).size == (512, 512)
    assert Image.open(os.path.join(out, "cogvideox_frames", "frame_000000.png")).size == (720, 480)
    assert Image.open(os.path.join(out, "rawsize", "frame_000002.png")).size == (54, 96)


def test_builders_match_jax(inputs, tmp_path):
    """Every builder subcommand but the ScalarFlow preprocess: the Zero123
    tree and its path lists, the CogVideoX clips (frame folders, captions,
    path lists, the validation copy), the simulation renders letterboxed
    with the un-shift, and the smoothed level-two attributes."""
    inp, cap, seqs, jax_out, _ = inputs
    out = str(tmp_path)
    for argv in _builder_argvs(inp, cap, out):
        tdb.main(argv)
    counts = {d: _same_tree(os.path.join(out, d), os.path.join(jax_out, d))
              for d in ("z123", "cvx", "cvx_val", "exp", "ckpt")}
    assert counts == {"z123": 2 * 2 * 40 + 3, "cvx": 4 * (3 + 1 + 1) + 4,
                      "cvx_val": 2 * (3 + 1), "exp": 7 + 6 + 6, "ckpt": 4 * 5 + 4 * 4}
    with open(os.path.join(out, "cvx", "all_val_paths20.json")) as f:
        assert json.load(f) == [tdb.clip_name(seqs[0], 0, s, 3) for s in (2, 22)]
    assert Image.open(os.path.join(out, "cvx", "videos", tdb.clip_name(seqs[1], 0, 22, 3),
                                   "025.png")).size == (720, 480)


def test_pack_video_holds_the_frames(inputs, tmp_path):
    """``--pack_video``: each clip's AVI holds its PNG frames, uncompressed
    (the JAX package's holds JPEGs of them)."""
    from fluidnexus_torch.utils.png import read_png

    _, cap, seqs, _, _ = inputs
    names = tdb.create_cogvideox_dataset(cap, str(tmp_path), seqs[:1], num_cams=1,
                                         min_frame_id=5, num_all_frames=20, start_frame_step=20,
                                         frame_step=1, num_frames=2, width=32, height=24,
                                         pack_video=True, log=lambda *a: None)
    assert names == [tdb.clip_name(seqs[0], 0, 5, 2)]
    with open(tmp_path / "avi" / (names[0] + ".avi"), "rb") as f:
        data = f.read()
    frames, pos = [], data.find(b"movi") + 4
    while data[pos:pos + 4] == b"00db":
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        frames.append(np.frombuffer(data[pos + 8:pos + 8 + size], np.uint8)
                      .reshape(24, 32, 3)[::-1, :, ::-1])   # bottom-up BGR rows
        pos += 8 + size + size % 2
    pngs = [read_png(str(tmp_path / "videos" / names[0] / f"{t:03d}.png")) for t in (5, 6)]
    assert len(frames) == 2
    for a, b in zip(frames, pngs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(20, 12, 3), (12, 20, 3), (17, 17, 3), (480, 270, 3),
                                   (31, 64, 3)])
def test_image_functions_match_jax(shape):
    """``pad_square``, ``prepare_generative_image_crop_first``,
    ``crop_and_resize``, ``prepare_generative_image`` and ``shift_image``
    on the same arrays, exactly."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(tconv.pad_square(img), jconv.pad_square(img))
    np.testing.assert_array_equal(tconv.prepare_generative_image_crop_first(img, 96, 64),
                                  jconv.prepare_generative_image_crop_first(img, 96, 64))
    np.testing.assert_array_equal(tconv.crop_and_resize(img, 27, 48),
                                  jconv.crop_and_resize(img, 27, 48))
    np.testing.assert_array_equal(tdb.prepare_generative_image(img, 40, 30, (10, 20, 30)),
                                  jdb.prepare_generative_image(img, 40, 30, (10, 20, 30)))
    for off in ((3, -5), (-2, 0), (0, 0)):
        np.testing.assert_array_equal(tdb.shift_image(img, *off), jdb.shift_image(img, *off))
    rt = tconv.get_w2c_rt_from_c2w(np.diag([1.0, 2.0, 3.0, 1.0]))
    np.testing.assert_array_equal(rt, jconv.get_w2c_rt_from_c2w(np.diag([1.0, 2.0, 3.0, 1.0])))


def test_smooth_visual_attrs_needs_an_odd_window(tmp_path):
    with pytest.raises(ValueError, match="odd"):
        tdb.smooth_visual_attrs(str(tmp_path), window=4)


def test_imread_parts_from_pil_only_at_16_bit_gray(tmp_path):
    """``imread_rgb`` against PIL's ``convert("RGB")``: equal on an 8-bit
    gray, a 16-bit RGB and a 16-bit gray + alpha PNG; on a 16-bit gray PNG
    PIL clips each value to 255 and the port keeps the high byte."""
    rng = np.random.default_rng(9)
    for name, ctype, c, same in (("gray8", 0, 1, True), ("rgb16", 2, 3, True),
                                 ("gray_alpha16", 4, 2, True), ("gray16", 0, 1, False)):
        depth = 8 if name.endswith("8") else 16
        samples = rng.integers(0, 1 << depth, (6, 5, c))
        path = str(tmp_path / f"{name}.png")
        encode_png(path, samples, depth, ctype)
        got, ref = tconv.imread_rgb(path), np.asarray(Image.open(path).convert("RGB"))
        assert got.shape == ref.shape == (6, 5, 3)
        assert np.array_equal(got, ref) == same, name
        if not same:
            np.testing.assert_array_equal(got[..., 0], samples[..., 0] >> 8)
            np.testing.assert_array_equal(ref[..., 0], np.minimum(samples[..., 0], 255))


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (7, 9, 3)])
def test_write_png_matches_pil(tmp_path, shape):
    """``write_png`` against Pillow's writer: the same mode and pixels, and
    ``read_png`` reads them back."""
    from fluidnexus_torch.utils.png import read_png, write_png

    img = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "t" / "a.png"), img)
    _pil_png(str(tmp_path / "j" / "a.png"), img[..., 0] if img.ndim == 3 and shape[-1] == 1
             else img)
    a, b = Image.open(tmp_path / "t" / "a.png"), Image.open(tmp_path / "j" / "a.png")
    assert a.mode == b.mode == ("RGB" if shape[-1] == 3 else "L")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(read_png(str(tmp_path / "t" / "a.png")).reshape(shape), img)
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "f.png"), img.astype(np.float32))


def test_hand_offs_run_without_pil_or_cv2(tmp_path):
    """A fresh interpreter in which PIL, cv2, jax, the JAX package,
    tensorboard and TensorFlow cannot be imported: the new modules import,
    ``convert original_to_zero123`` runs through the runner on PNGs
    ``write_png`` wrote, and the stages' ``TrainLogger`` writes an image."""
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("PIL", "cv2", "jax", "fluidnexus_tpu", "tensorboard", "tensorflow")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import fluidnexus_torch.data.dataset_builders, fluidnexus_torch.ops.knn
        import fluidnexus_torch.pipelines.train_visual_particle
        from fluidnexus_torch.__main__ import main
        from fluidnexus_torch.utils.png import read_png, write_png
        root = {str(tmp_path)!r}
        write_png(root + "/in/camera00/000.png",
                  np.arange(10 * 6 * 3, dtype=np.uint8).reshape(10, 6, 3))
        main(["convert", "original_to_zero123", "--data_root", root + "/in",
              "--out_root", root + "/out"])
        assert read_png(root + "/out/frame_000/00.png").shape == (512, 512, 3)
        from fluidnexus_torch.utils.tb import TrainLogger
        TrainLogger(root + "/tb").add_image("render", np.zeros((4, 6), np.float32), 0)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("no imaging library")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})   # one intra-op thread
    assert res.returncode == 0, res.stderr
    assert "no imaging library" in res.stdout and "converted 1 frames" in res.stdout
