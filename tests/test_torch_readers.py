"""The port's scene readers (data/readers.py, data/scene.py) against the JAX
package's on synthetic captures on disk, on the CPU: cameras, names, frame
indices, timestamps, fake-view flags, poses and FoVs to 1e-12, the init point
clouds and the decoded images bit for bit. The JAX side decodes PNGs through
its native libpng loader (the test asserts it built), so the gray luma is
held to the path that ran. Pillow writes the frames (it adapts the row
filter per row, so every filter type is read)."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.data import readers as treaders
from fluidnexus_torch.data.scene import read_scene as t_read_scene
from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.data import readers as jreaders
from fluidnexus_tpu.data.scene import read_scene as j_read_scene
from fluidnexus_tpu.runtime.native_loader import native_available
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

N_FRAMES = 4


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _frame(rng, h, w):
    """A smooth RGB frame with noise, so rows take several filter types."""
    y, x = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(x / 5.0 + y / 7.0 + rng.uniform(0, 6))
    img = base[..., None] + rng.integers(-20, 21, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_capture(root, h=24, w=32, n_frames=N_FRAMES, seed=0, frame=None):
    """A FluidNexus-style capture: 5 cameras ``train0{c}`` with frames,
    ``_bg`` frames, fake views of cams 1 and 4 from cam 2 (smoke, strength
    0d5), generated futures from frame 2 (strength 0d75, and the wind
    variant), the ScalarReal ``colmap_frames`` layout, a demo-pose sweep,
    and a second capture under ``<root>_2`` for ``data_2_path``."""
    rng = np.random.default_rng(seed)
    frame = frame or (lambda: _frame(rng, h, w))
    frames = []
    for cam in range(5):
        angle = (cam - 2) * 0.3
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                       [-np.sin(angle), 0, np.cos(angle)]]
        c2w[:3, 3] = [np.sin(angle) * 3, 0.2, np.cos(angle) * 3]
        frames.append({"file_path": f"train0{cam}", "transform_matrix": c2w.tolist(),
                       "camera_hw": [h, w], "camera_angle_x": 0.8})
    for r in (root, root + "_2"):
        for name, sel in (("transforms_train.json", [0, 1, 3, 4]), ("transforms_test.json", [2]),
                          ("transforms.json", list(range(5)))):
            os.makedirs(r, exist_ok=True)
            with open(os.path.join(r, name), "w") as f:
                json.dump({"near": 0.1, "far": 10.0, "frames": [frames[i] for i in sel]}, f)
        for cam in range(5):
            for t in range(n_frames):
                _write_png(os.path.join(r, f"train0{cam}", f"{t:03d}.png"), frame())
    for cam in range(5):
        for t in range(n_frames):
            _write_png(os.path.join(root, f"train0{cam}_bg", f"{t:03d}.png"), frame())
            _write_png(os.path.join(root, "colmap_frames", f"colmap_{t}", f"train0{cam}.png"),
                       frame())
        for wind in (False, True):
            folder = jreaders.future_view_folder("smoke", str(cam), "0d75", 2, is_wind=wind)
            for t in range(2, n_frames):
                _write_png(os.path.join(root, folder, f"frame_{t:06d}.png"), frame())
    for cam in ("1", "4"):
        folder = jreaders.fake_view_folder("smoke", "2", cam, "0d5")
        for t in range(n_frames):
            _write_png(os.path.join(root, folder, f"frame_{t:06d}.png"), frame())
    raw = np.stack([np.eye(4) for _ in range(n_frames)])
    raw[:, :3, 3] = rng.normal(size=(n_frames, 3))
    np.save(os.path.join(root, "demo_cams_poses_extra.npy"), raw)
    return root


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return write_capture(str(tmp_path_factory.mktemp("capture") / "scene"))


def assert_same_cameras(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert (a.uid, a.image_name, a.time_idx, a.is_fake_view, a.width, a.height) == \
            (b.uid, b.image_name, b.time_idx, b.is_fake_view, b.width, b.height)
        assert a.timestamp == b.timestamp
        assert (a.znear, a.zfar) == (b.znear, b.zfar)
        np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.T, b.T, rtol=0, atol=1e-12)
        np.testing.assert_allclose([a.fovx, a.fovy], [b.fovx, b.fovy], rtol=0, atol=1e-12)
        for x, y in ((a.image, b.image), (a.image_real, b.image_real)):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x is None and y is None


def assert_same_scene(t, j):
    assert_same_cameras(t.train_cameras, j.train_cameras)
    assert_same_cameras(t.test_cameras, j.test_cameras)
    assert t.nerf_normalization["radius"] == pytest.approx(j.nerf_normalization["radius"],
                                                           rel=0, abs=1e-12)
    np.testing.assert_allclose(t.nerf_normalization["translate"],
                               j.nerf_normalization["translate"], rtol=0, atol=1e-12)
    if j.point_cloud is None:
        assert t.point_cloud is None
    else:
        assert t.point_cloud.dtype == j.point_cloud.dtype
        np.testing.assert_array_equal(t.point_cloud, j.point_cloud)


CASES = {
    "real_views": dict(train_views="0134", init_pcd_bg=True),
    "fake_views": dict(train_views="20134", train_views_fake="14", refined_strength="0d5",
                       init_pcd_object=True, init_pcd_large_smoke=True),
    "gen_future": dict(train_views="0134", gen_future_since=2, gen_future_strength="0d75"),
    "gen_future_wind": dict(train_views="0134", gen_future_since=2, gen_future_strength="0d75",
                            is_wind=True, test_all_views=True),
    "object_data_2": dict(train_views="0134", capture_part="smoke_and_ball_object",
                          data_2_since=2),
    "scalar_repeat": dict(train_views="0134", loader="scalar_real", gray_image=True,
                          real_view_repeat=3),
    "is_bg": dict(train_views="01234", is_bg=True, duration=2, init_pcd_bg=True),
    "demo_cameras": dict(train_views="0134", use_demo_cameras=True),
    "gray_image": dict(train_views="0134", gray_image=True, time_step=2, duration=2,
                       start_time=1, max_timestamp=0.5),
}


def _configs(root, **model):
    out = []
    for cfg in (JConfig(), TConfig()):
        m = cfg.model
        m.data_path, m.start_time, m.duration, m.capture_part = root, 0, N_FRAMES, "smoke"
        for k, v in model.items():
            setattr(m, k, v)
        if "data_2_since" in model:
            m.data_2_path = root + "_2"
        cfg.seed = 3
        out.append(cfg)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_scene_matches_jax(capture, case):
    assert native_available(), "the JAX package's native PNG loader did not build"
    jcfg, tcfg = _configs(capture, **CASES[case])
    ref = j_read_scene(jcfg)
    got = t_read_scene(tcfg)
    assert_same_scene(got, ref)
    if case == "fake_views":
        assert any(c.is_fake_view for c in got.train_cameras)
    if case == "scalar_repeat":
        assert len(got.train_cameras) == 3 * 4 * N_FRAMES and got.train_cameras[0].image.ndim == 2


@pytest.fixture(scope="module")
def wide_capture(tmp_path_factory):
    rng = np.random.default_rng(7)
    return write_capture(str(tmp_path_factory.mktemp("wide") / "scene"), h=13, w=1700,
                         n_frames=1, frame=lambda: _frame(rng, 13, 1700))


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("resolution", [1, 2, 640, -1])
def test_resolution_matches_jax(wide_capture, resolution, gray):
    """``_resize`` through ``read_scene`` on a 1 700-pixel-wide frame: gray in
    PIL's mode "F", RGB truncated to uint8 and resampled in 8 bits."""
    jcfg, tcfg = _configs(wide_capture, train_views="0134", duration=1, gray_image=gray,
                          resolution=resolution)
    ref = j_read_scene(jcfg)
    got = t_read_scene(tcfg)
    assert_same_scene(got, ref)
    want = {1: 1700, 2: 850, 640: 640, -1: 1600}[resolution]
    assert got.train_cameras[0].width == want


def test_target_size_keeps_the_float_arithmetic():
    for w, h in ((1700, 13), (3199, 1801), (4001, 2250), (1601, 900), (960, 544)):
        for res in (1, 2, 4, 8, -1, 640, 333):
            img = np.zeros((h, w), np.float32)
            tw, th = treaders.target_size(w, h, res)
            down = w / 1600 if (res == -1 and w > 1600) else (1 if res == -1 else None)
            if res in (1, 2, 4, 8):
                assert (tw, th) == (round(w / res), round(h / res))
            elif down is not None:
                assert (tw, th) == (int(w / down), int(h / down))
            else:
                assert (tw, th) == (int(w / (w / res)), int(h / (w / res)))
            if (tw, th) == (w, h):
                assert treaders._resize(img, res) is img


def test_camera_tables_and_folders_match_jax():
    c2w = np.eye(4)
    c2w[:3, 3] = [0.5, 0.2, 3.0]
    for part in ("smoke", "ball", "smoke_and_ball_object", "scalar"):
        for cam in "012349":
            np.testing.assert_array_equal(treaders.apply_camera_hack(c2w, part, cam),
                                          jreaders.apply_camera_hack(c2w, part, cam))
            np.testing.assert_array_equal(
                treaders.apply_camera_hack(c2w, part, cam, treaders.CAMERA_HACKS_2),
                jreaders.apply_camera_hack(c2w, part, cam, jreaders.CAMERA_HACKS_2))
            for data2 in (False, True):
                assert treaders.fake_view_folder(part, "2", cam, "0d26", data2) == \
                    jreaders.fake_view_folder(part, "2", cam, "0d26", data2)
            if part != "smoke_and_ball_object":
                for wind in (False, True):
                    assert treaders.future_view_folder(part, cam, "0d75", 90, wind) == \
                        jreaders.future_view_folder(part, cam, "0d75", 90, wind)
    for a, b in zip(treaders.c2w_to_rt(c2w), jreaders.c2w_to_rt(c2w)):
        np.testing.assert_array_equal(a, b)


def test_smoke_clamp_and_real_image_fallback(tmp_path):
    """The smoke capture clamps frame indices to 409; a fake view whose real
    frame is missing falls back to the fake image for ``image_real``."""
    root = write_capture(str(tmp_path / "scene"), n_frames=2)
    for cam in range(5):
        os.rename(os.path.join(root, f"train0{cam}", "000.png"),
                  os.path.join(root, f"train0{cam}", "409.png"))
    os.remove(os.path.join(root, "train01", "409.png"))
    kw = dict(start_time=409, duration=2, train_views="20134", train_views_fake="14",
              refined_strength="0d5", read_image=True)
    ref = jreaders.read_cameras_real_capture(root, "transforms.json", **kw)
    got = treaders.read_cameras_real_capture(root, "transforms.json", **kw)
    assert_same_cameras(got, ref)
    fake = [c for c in got if c.image_name == "train01"]
    assert fake and all(np.array_equal(c.image, c.image_real) for c in fake)


def test_non_png_frame_raises(tmp_path):
    path = tmp_path / "f.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path, format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        treaders._decode_many([str(path)], gray=False)


# ------------------------------ PNG decode -----------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag, data):
    import struct
    import zlib

    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _filter_rows(rows, bpp):
    """Each row filtered with type y % 5 (none, sub, up, average, Paeth)."""
    out, prev = [], np.zeros_like(rows[0]) if len(rows) else None
    for y, cur in enumerate(rows):
        cur = cur.astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up = prev.astype(np.int64)
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        ft = y % 5
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _pack(samples, depth):
    """(h, w, c) samples -> (h, rowbytes) bytes at ``depth`` bits a sample."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    pad = (-bits.shape[1]) % 8
    bits = np.concatenate([bits, np.zeros((h, pad), bits.dtype)], 1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def encode_png(path, samples, depth, ctype, interlace=0, plte=None, trns=None):
    """A PNG of (h, w, c) ``samples`` at ``depth`` bits, every filter type
    used, plain or Adam7: for the formats Pillow cannot write."""
    import struct
    import zlib

    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp)
                       for x0, y0, dx, dy in _ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                                 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _native_rgb(path, h, w):
    from fluidnexus_tpu.runtime.native_loader import decode_png

    return decode_png(str(path), h, w).transpose(1, 2, 0)


def _held_to_native(path):
    from fluidnexus_torch.utils.png import read_png, to_rgb

    got = to_rgb(read_png(str(path)))
    ref = _native_rgb(path, *got.shape[:2])
    np.testing.assert_array_equal(got.astype(np.float32) / np.float32(255.0), ref)
    return got


FORMATS = {  # name: (ctype, depth, channels of the samples, max sample)
    "gray1": (0, 1, 1, 1), "gray2": (0, 2, 1, 3), "gray4": (0, 4, 1, 15), "gray8": (0, 8, 1, 255),
    "gray16": (0, 16, 1, 65535), "gray_alpha16": (4, 16, 2, 65535), "rgb16": (2, 16, 3, 65535),
    "rgba16": (6, 16, 4, 65535), "rgba8": (6, 8, 4, 255), "palette1": (3, 1, 1, 1),
    "palette2": (3, 2, 1, 3), "palette4": (3, 4, 1, 15), "palette8": (3, 8, 1, 200),
}


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_read_png_matches_native_loader(tmp_path, fmt, interlace):
    """Every bit depth and color type, plain and Adam7, written by the test's
    encoder with every filter type, against the JAX package's libpng loader;
    palette images also with a tRNS chunk, gray and RGB with a tRNS key."""
    assert native_available()
    ctype, depth, c, top = FORMATS[fmt]
    rng = np.random.default_rng(depth * 7 + ctype)
    h, w = 11, 19
    samples = rng.integers(0, top + 1, (h, w, c))
    plte = rng.integers(0, 256, (top + 1, 3)) if ctype == 3 else None
    variants = [None]
    if ctype == 3:
        variants.append(bytes(rng.integers(0, 256, min(top + 1, 7)).tolist()))
    elif ctype in (0, 2):
        import struct

        variants.append(struct.pack(f">{c}H", *samples[0, 0].tolist()))
    for i, trns in enumerate(variants):
        path = tmp_path / f"{fmt}_{i}.png"
        encode_png(path, samples, depth, ctype, interlace, plte, trns)
        got = _held_to_native(path)
        assert got.shape == (h, w, 3)


@pytest.mark.parametrize("mode", ["P", "1", "L", "I;16", "LA", "RGB", "RGBA", "P_trns", "L_trns",
                                  "RGB_trns"])
def test_read_png_matches_native_loader_on_pil_files(tmp_path, mode):
    """The formats Pillow writes, against the native loader, and for the 8-bit
    ones against Pillow's own convert("RGB")."""
    rng = np.random.default_rng(len(mode))
    a = rng.integers(0, 256, (21, 34, 4)).astype(np.uint8)
    base = mode.split("_")[0]
    if base == "P":
        img = Image.fromarray(a[..., :3]).convert("P", palette=Image.Palette.ADAPTIVE, colors=37)
    elif base == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (21, 34)).astype(np.uint16))
    else:
        c = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[base]
        img = Image.fromarray(a[..., 0] if c == 1 else a[..., :c], "L" if c == 1 else base)
        if base == "1":
            img = img.convert("1")
    opts = {}
    if mode.endswith("_trns"):
        opts["transparency"] = 5 if base in ("P", "L") else (1, 2, 3)
    path = tmp_path / "x.png"
    img.save(path, **opts)
    got = _held_to_native(path)
    if base != "I;16":
        np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_compiled_unfilter_matches_plain():
    """The compiled row unfilter against its plain Python version, on random
    filtered data of every filter type and pixel width."""
    from fluidnexus_torch.utils import png

    rng = np.random.default_rng(0)
    for bpp in (1, 2, 3, 4, 6, 8):
        h, rowbytes = 23, bpp * 17 + (1 if bpp == 1 else 0)
        rows = rng.integers(0, 256, (h, rowbytes + 1)).astype(np.uint8)
        rows[:, 0] = np.arange(h) % 5
        raw = rows.tobytes()
        np.testing.assert_array_equal(png.unfilter(raw, h, rowbytes, bpp),
                                      png._unfilter_plain(raw, h, rowbytes, bpp))
    rows[3, 0] = 7
    for fn in (png.unfilter, png._unfilter_plain):
        with pytest.raises(ValueError, match="row 3 has filter type 7"):
            fn(rows.tobytes(), h, rowbytes, bpp)


def test_read_png_names_the_file_and_format(tmp_path):
    from fluidnexus_torch.utils.png import read_png

    path = tmp_path / "bad.png"
    encode_png(path, np.zeros((2, 2, 1), np.int64), 8, 0)
    data = bytearray(path.read_bytes())
    data[24] = 16   # bit depth 16 on a palette image: not in the standard
    data[25] = 3
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"bad.png.*bit depth 16, color type 3"):
        read_png(str(path))


def test_host_build_is_safe_under_threads(tmp_path, monkeypatch):
    """The readers decode on a thread pool: the first decodes of a fresh
    checkout must build the unfilter library once, not race on it."""
    from concurrent.futures import ThreadPoolExecutor

    from fluidnexus_torch.ops import cuda_build
    from fluidnexus_torch.utils import png

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    cuda_build._load_host.cache_clear()
    try:
        rows = np.random.default_rng(0).integers(0, 256, (6, 3 * 5 + 1)).astype(np.uint8)
        rows[:, 0] = np.arange(6) % 5
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda _: png.unfilter(rows.tobytes(), 6, 15, 3), range(16)))
        ref = png._unfilter_plain(rows.tobytes(), 6, 15, 3)
        assert all(np.array_equal(o, ref) for o in outs)
        assert len(list((tmp_path / "_build").glob("libpng_unfilter-*.so"))) == 1
    finally:
        cuda_build._load_host.cache_clear()
