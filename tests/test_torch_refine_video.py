"""The port's refinement stage against the JAX package's on the CPU:
``refine_long_video`` (contiguous windows, and with window starts, a frame
step and a GT prefix start), ``refine_future`` (wind and not), both CLIs
``--tiny --preset`` from npz checkpoints the JAX package wrote and through
the stage runner; the port's noise is recorded at ``sampling._normal`` (the
VAE posterior's draw, then the sampler's) and replayed into JAX by patching
``jax.random.normal``. Decoded frames at 1e-4 of their scale, PNGs (read
with PIL) within one 8-bit level, the same file names. And
``utils/video_io``: ``frames_folder_to_video``'s AVI read back equal to the
PNGs as PIL reads them."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fluidnexus_torch.convert import vae3d_from_numpy, video_dit_from_numpy
from fluidnexus_torch.diffusion.video.engine import VideoEngine
from fluidnexus_torch.pipelines import gen_future_video as tfut
from fluidnexus_torch.pipelines import gen_refine_video as tref
from fluidnexus_torch.pipelines import sample_video as tsv
from fluidnexus_torch.utils import video_io as tvio
from fluidnexus_tpu.diffusion.video import engine as jeng
from fluidnexus_tpu.pipelines import gen_future_video as jfut
from fluidnexus_tpu.pipelines import gen_refine_video as jref
from fluidnexus_tpu.utils import video_io as jvio
from tests.test_torch_sample_video import save_with_jax
from tests.test_torch_video_dit import dit_params, random_flax_params
from tests.test_torch_video_sampling import record_noise, replay_noise

H = W = 32
WIN, PRE = 9, 5


@pytest.fixture(scope="module")
def tiny():
    """The ``--tiny`` configs at 9 x 32 x 32 in both packages, and random
    param trees (adaLN non-zero) for the DiT and the VAE."""
    from fluidnexus_tpu.diffusion.video.dit import VideoDiTConfig
    from fluidnexus_tpu.diffusion.video.vae3d import VAE3DConfig

    jdc = VideoDiTConfig(hidden_size=64, num_layers=2, num_heads=4, text_hidden_size=64,
                         text_length=8, latent_frames=3, latent_height=4, latent_width=4,
                         dtype=jnp.float32)
    jvc = VAE3DConfig(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1)
    _, dit = dit_params(jdc, seed=31)
    shapes = jax.eval_shape(lambda: jeng.VideoVAE(jvc).init({"params": jax.random.PRNGKey(0)},
                                                            jnp.zeros((1, WIN, H, W, 3))))
    vae = random_flax_params(shapes["params"], seed=32)
    return dict(jcfg=(jdc, jvc), tcfg=tsv.configs(WIN, H, W, tiny=True), dit=dit, vae=vae)


def write_pngs(folder, pattern, indices, size, seed):
    """Seeded RGB PNGs written by PIL; ``size`` (w, h) other than 32 x 32
    makes both packages resample them with LANCZOS."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in indices:
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)).save(
            os.path.join(folder, pattern % i))
    return folder


def keep_decodes(monkeypatch, cls):
    """Wrap ``cls.decode_first_stage``; returns the list of its outputs."""
    out, real = [], cls.decode_first_stage

    def keep(self, *a, **kw):
        res = real(self, *a, **kw)
        out.append(np.array(res))
        return res

    monkeypatch.setattr(cls, "decode_first_stage", keep)
    return out


def assert_same_pngs(port_dir, jax_dir, n):
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and len(names) == n, (names, n)
    for name in names:
        port = np.asarray(Image.open(os.path.join(port_dir, name)))
        ref = np.asarray(Image.open(os.path.join(jax_dir, name)))
        assert port.shape == ref.shape == (H, W, 3)
        assert np.abs(port.astype(int) - ref.astype(int)).max() <= 1, name
    return names


def assert_same_decodes(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


def models(tiny):
    (jdc, jvc), (tdc, tvc) = tiny["jcfg"], tiny["tcfg"]
    return (jeng.VideoEngine(jdc, jvc), VideoEngine(tdc, tvc),
            video_dit_from_numpy(tiny["dit"], tdc, device="cpu"),
            vae3d_from_numpy(tiny["vae"], tvc, device="cpu"))


CASES = {"contiguous": {},
         "indexed": dict(frame_step=2, window_start_indices=(3, 11), gt_prefix_start=1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_long_video_matches_jax(tiny, tmp_path, monkeypatch, case):
    """Two chained 9-frame windows (prefix 5, 4 steps at strength 0.6):
    window 1 writes 9 frames, window 2 the 4 after its re-decoded prefix."""
    inp = write_pngs(str(tmp_path / "in"), "frame_%06d.png", range(18), (W, H), seed=33)
    gt = write_pngs(str(tmp_path / "gt"), "%03d.png", range(10), (48, 40), seed=34)
    kw = dict(window_frames=WIN, prefix_frames=PRE, num_windows=2, sdedit_strength=0.6,
              num_steps=4, height=H, width=W, **CASES[case])
    text = np.random.default_rng(35).normal(size=(1, 8, 64)).astype(np.float32)
    jeng_, teng, dit, vae = models(tiny)

    draws = record_noise(monkeypatch)
    port_dec = keep_decodes(monkeypatch, VideoEngine)
    written = tref.refine_long_video(teng, dit, vae, torch.as_tensor(text), torch.zeros(1, 8, 64),
                                     inp, gt, str(tmp_path / "port"), tref.RefineConfig(**kw),
                                     torch.Generator().manual_seed(0), log=lambda *a: None)
    assert written == [9, 4] and len(draws) == 2 * 4  # a window: posterior, start, SDEdit, 1 step

    rest = replay_noise(monkeypatch, draws)
    jax_dec = keep_decodes(monkeypatch, jeng.VideoEngine)
    jwritten = jref.refine_long_video(jeng_, tiny["dit"], tiny["vae"], jnp.asarray(text),
                                      jnp.zeros((1, 8, 64)), inp, gt, str(tmp_path / "jax"),
                                      jref.RefineConfig(**kw), jax.random.PRNGKey(0),
                                      log=lambda *a: None)
    assert next(rest, None) is None and written == jwritten
    assert_same_decodes(port_dec, jax_dec)
    names = assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"), 13)
    assert names == [f"frame_{i:06d}.png" for i in range(13)]


@pytest.mark.parametrize("is_wind", [False, True])
def test_refine_future_matches_jax(tiny, tmp_path, monkeypatch, is_wind):
    """One 9-frame window over the simulation's renders (frame_step 2) after
    the reconstruction's last 5 frames: the 4 frames after the prefix, in
    the folder the reader looks in."""
    recon = write_pngs(str(tmp_path / "recon"), "%03d.png", range(1, 6), (48, 40), seed=36)
    renders = write_pngs(str(tmp_path / "sim"), "render_frame%03d_train03_0000.png",
                         range(6, 13, 2), (W, H), seed=37)
    kw = dict(window_frames=WIN, prefix_frames=PRE, num_steps=4, height=H, width=W, frame_step=2)
    text = np.random.default_rng(38).normal(size=(1, 8, 64)).astype(np.float32)
    jeng_, teng, dit, vae = models(tiny)
    args = (renders, recon)

    draws = record_noise(monkeypatch)
    port_dec = keep_decodes(monkeypatch, VideoEngine)
    out = tfut.refine_future(teng, dit, vae, torch.as_tensor(text), torch.zeros(1, 8, 64), *args,
                             str(tmp_path / "port"), "train03", "smoke", 6, 0.75,
                             tref.RefineConfig(**kw), torch.Generator().manual_seed(1),
                             is_wind=is_wind, log=lambda *a: None)
    rest = replay_noise(monkeypatch, draws)
    jax_dec = keep_decodes(monkeypatch, jeng.VideoEngine)
    jout = jfut.refine_future(jeng_, tiny["dit"], tiny["vae"], jnp.asarray(text),
                              jnp.zeros((1, 8, 64)), *args, str(tmp_path / "jax"), "train03",
                              "smoke", 6, 0.75, jref.RefineConfig(**kw), jax.random.PRNGKey(1),
                              is_wind=is_wind, log=lambda *a: None)
    assert next(rest, None) is None
    assert os.path.relpath(out, tmp_path / "port") == os.path.relpath(jout, tmp_path / "jax")
    assert ("wind" in os.path.basename(out)) == is_wind and "strength0d75_start6" in out
    assert_same_decodes(port_dec, jax_dec)
    names = assert_same_pngs(out, jout, 4)
    assert names == [f"frame_{i:06d}.png" for i in range(6, 10)]


def _cli_inputs(tmp_path):
    write_pngs(str(tmp_path / "in"), "frame_%06d.png", range(3, 18, 2), (W, H), seed=40)
    write_pngs(str(tmp_path / "gt"), "%03d.png", range(1, 10, 2), (48, 40), seed=41)
    write_pngs(str(tmp_path / "sim"), "render_frame%03d_train00_0000.png", range(50, 57, 2),
               (W, H), seed=42)
    write_pngs(str(tmp_path / "recon"), "%03d.png", range(45, 50), (W, H), seed=43)


def _cli_argv(tmp_path, kind, out):
    small = ["--tiny", "--window_frames", str(WIN), "--prefix_frames", str(PRE), "--num_steps",
             "4", "--height", str(H), "--width", str(W)]
    if kind == "refine":
        return small + ["--preset", "refine_smoke", "--input_folder", str(tmp_path / "in"),
                        "--gt_prefix_folder", str(tmp_path / "gt"), "--out_folder", out,
                        "--num_windows", "2", "--window_start_indices", "3", "11",
                        "--gt_prefix_start", "1"]
    return small + ["--preset", "wind_smoke", "--sim_render_folder", str(tmp_path / "sim"),
                    "--recon_frames_folder", str(tmp_path / "recon"), "--out_root", out]


@pytest.mark.parametrize("kind", ["refine", "future"])
def test_main_tiny_preset_from_jax_checkpoints_matches_the_jax_cli(tiny, tmp_path, monkeypatch,
                                                                   kind):
    """Both CLIs from the same npz checkpoints (written by the JAX package)
    with the same noise; the preset gives the strength and frame step
    (refine_smoke: 0.5 and 2; wind_smoke: 0.55, 2, the wind folder, since
    50), explicit flags the rest. The port also packs its frames."""
    _cli_inputs(tmp_path)
    ckpts = ["--dit_ckpt", save_with_jax(tiny["dit"], str(tmp_path / "dit.npz"), monkeypatch),
             "--vae_ckpt", save_with_jax(tiny["vae"], str(tmp_path / "vae.npz"), monkeypatch)]
    tmain, jmain = (tref.main, jref.main) if kind == "refine" else (tfut.main, jfut.main)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    draws = record_noise(monkeypatch)
    got, video = tmain(_cli_argv(tmp_path, kind, port) + ckpts + ["--pack_video"], device="cpu")
    rest = replay_noise(monkeypatch, draws)
    jmain(_cli_argv(tmp_path, kind, ref) + ckpts)
    assert next(rest, None) is None
    if kind == "refine":
        assert got == [9, 4]
        names = assert_same_pngs(port, ref, 13)
        folder = port
    else:
        sub = "camera00_cogvxlora5b_prefix9_i2v3_strength0d55_start50_wind_smoke_rawsize"
        assert got == os.path.join(port, sub) and os.listdir(ref) == [sub]
        names = assert_same_pngs(got, os.path.join(ref, sub), 4)
        folder = got
    assert video == folder + ".mp4" or video == folder + ".avi"
    frames = tvio.read_video(video)
    assert frames.shape == (len(names), H, W, 3)


@pytest.mark.parametrize("stage", ["gen_refine_video", "gen_future_video"])
def test_stage_runner_runs_the_clis(tmp_path, monkeypatch, stage):
    """``python -m fluidnexus_torch gen_refine_video|gen_future_video``
    (the runner's device is the card; here ``resolve_device`` is patched to
    the CPU) with weights drawn from seeds: the frames land where the CLI
    run in process puts them, pixel for pixel."""
    from fluidnexus_torch.__main__ import STAGES
    from fluidnexus_torch.__main__ import main as runner

    mod = tref if stage == "gen_refine_video" else tfut
    assert STAGES[stage] == mod.__name__
    _cli_inputs(tmp_path)
    kind = "refine" if stage == "gen_refine_video" else "future"
    monkeypatch.setattr(mod, "resolve_device", lambda d: torch.device("cpu"))
    runner([stage] + _cli_argv(tmp_path, kind, str(tmp_path / "a")))
    mod.main(_cli_argv(tmp_path, kind, str(tmp_path / "b")), device="cpu")
    a = [os.path.join(d, f) for d, _, fs in sorted(os.walk(tmp_path / "a")) for f in sorted(fs)]
    b = [os.path.join(d, f) for d, _, fs in sorted(os.walk(tmp_path / "b")) for f in sorted(fs)]
    assert len(a) == len(b) == (13 if kind == "refine" else 4)
    for x, y in zip(a, b):
        assert os.path.relpath(x, tmp_path / "a") == os.path.relpath(y, tmp_path / "b")
        np.testing.assert_array_equal(np.asarray(Image.open(x)), np.asarray(Image.open(y)))


def test_t5_dir_raises_until_t5_is_ported(tmp_path):
    _cli_inputs(tmp_path)
    for kind, main in (("refine", tref.main), ("future", tfut.main)):
        with pytest.raises(NotImplementedError, match="T5 not ported yet"):
            main(_cli_argv(tmp_path, kind, str(tmp_path / kind)) + ["--t5_dir", "/t5"],
                 device="cpu")
        assert not os.path.exists(tmp_path / kind)


def _png_modes(folder, seed=44):
    """Frames in the PNG modes PIL writes (RGB, RGBA, L, LA, P): what
    ``frames_folder_to_video`` packs is each as RGB."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    rgb = rng.integers(0, 256, (5, 17, 23, 3)).astype(np.uint8)
    imgs = [Image.fromarray(rgb[0]), Image.fromarray(rgb[1]).convert("RGBA"),
            Image.fromarray(rgb[2]).convert("L"), Image.fromarray(rgb[3]).convert("LA"),
            Image.fromarray(rgb[4]).convert("P")]
    for i, img in enumerate(imgs):
        img.save(os.path.join(folder, f"frame_{i:06d}.png"))
    return np.stack([np.asarray(Image.open(os.path.join(folder, f"frame_{i:06d}.png"))
                                .convert("RGB")) for i in range(5)])


def test_frames_folder_to_video_avi_holds_the_pngs(tmp_path, monkeypatch):
    want = _png_modes(str(tmp_path / "f"))
    path = tvio.frames_folder_to_video(str(tmp_path / "f"), str(tmp_path / "v.avi"), fps=12)
    assert path == str(tmp_path / "v.avi")
    frames, fps = tvio.read_video_with_fps(path)
    np.testing.assert_array_equal(frames, want)
    assert fps == 12.0
    # without OpenCV: the port's AVI through its own parser, a JPEG one refused
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tvio.read_video(path), want)
    mjpeg = jvio.write_avi_mjpeg(str(tmp_path / "m.avi"), want, fps=8)
    with pytest.raises(NotImplementedError, match="JPEG decoder"):
        tvio.read_video(mjpeg)
    with pytest.raises(FileNotFoundError, match="no .jpg frames"):
        tvio.frames_folder_to_video(str(tmp_path / "f"), pattern=".jpg")


def test_read_video_takes_opencv_for_other_files(tmp_path):
    """An MJPEG AVI (the JAX package's writer) and an mp4 go through OpenCV
    when it imports, as in the JAX package: the same frames and fps."""
    pytest.importorskip("cv2")
    frames = np.random.default_rng(45).integers(0, 256, (4, 16, 24, 3)).astype(np.uint8)
    for path in (jvio.write_avi_mjpeg(str(tmp_path / "m.avi"), frames, fps=8),
                 jvio.write_video(str(tmp_path / "v.mp4"), frames, fps=8)):
        got, fps = tvio.read_video_with_fps(path)
        ref, jfps = jvio.read_video_with_fps(path)
        np.testing.assert_array_equal(got, ref)
        assert fps == jfps
