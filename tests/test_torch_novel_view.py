"""The port's Zero123 CLIs and datasets (``pipelines/train_novel_view.py``,
``pipelines/infer_novel_view.py``) against the JAX package's on the CPU.

- ``train_novel_view --tiny``, 2 steps of batch 2 from the same npz
  checkpoint, the port's draws replayed into JAX's jitted step
  (``tests/test_torch_ldm.KeyReplay``): both logs' losses to 1e-5, the
  updates of the UNet and ``cc`` and their EMA to 2e-2 of the rate (Adam
  divides by sqrt(v) + 1e-8, which magnifies the last-bit differences of a
  gradient element near 0);
- ``infer_novel_view`` from the checkpoint each package wrote in that run,
  sampled by the other with the same draws: the PNGs within one level (the
  truncating ``astype(uint8)`` flips a level where the two sit on either side
  of a boundary);
- both datasets give the same pairs, images and pose deltas bit for bit
  (PIL's LANCZOS and ``convert("RGB")`` against the port's, gray and RGBA
  files among them), the tar shards through the reservoir shuffle and a
  restart;
- the two CLIs and the logger import and run with PIL, OpenCV, JAX and
  tensorboard blocked.
"""
import io
import os
import subprocess
import sys
import tarfile
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fluidnexus_torch.__main__ import STAGES
from fluidnexus_torch.convert import _flatten_flax, _torch_layout, novel_view_from_numpy
from fluidnexus_torch.core.checkpoint import save_params
from fluidnexus_torch.pipelines import infer_novel_view as tinf
from fluidnexus_torch.pipelines import train_novel_view as ttr
from fluidnexus_tpu.core import checkpoint as jckpt
from fluidnexus_tpu.pipelines import infer_novel_view as jinf
from fluidnexus_tpu.pipelines import train_novel_view as jtr
from tests.test_torch_ldm import KeyReplay, pair_inputs, tiny_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def write_views(root, frames=2, cams=3, size=32, seed=0, modes=("RGB",)):
    """frame_%03d/{cam:02d}.png (written by PIL, mode by mode in turn) and
    camera/{cam:02d}.npy W2C matrices on a ring."""
    rng = np.random.default_rng(seed)
    k = 0
    for t in range(frames):
        os.makedirs(os.path.join(root, f"frame_{t:03d}"), exist_ok=True)
        for c in range(cams):
            mode = modes[k % len(modes)]
            k += 1
            arr = rng.integers(0, 256, (size, size, len(mode))).astype(np.uint8)
            Image.fromarray(arr[..., 0] if mode == "L" else arr).save(
                os.path.join(root, f"frame_{t:03d}", f"{c:02d}.png"))
    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    for c in range(cams):
        a = 2 * np.pi * c / cams
        r = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        center = np.array([2.0 * np.sin(a), 0.3 * c, 2.0 * np.cos(a)])
        np.save(os.path.join(root, "camera", f"{c:02d}.npy"),
                np.concatenate([r, (-r @ center)[:, None]], 1).astype(np.float32))


# --------------------------------- training ---------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' ``train`` for 2 steps from one random --tiny tree,
    each writing its iter_0000002 checkpoints: {"port", "jax"}: (save dir,
    params, loss, ema, logs), and the start tree."""
    tmp = tmp_path_factory.mktemp("nv_train")
    write_views(str(tmp / "data"))
    _, start, _ = tiny_models(seed=7)
    save_params(str(tmp / "start"), start)
    argv = ["--data_dir", str(tmp / "data"), "--iterations", "2", "--batch", "2",
            "--image_size", "32", "--tiny", "--log_every", "1", "--ckpt", str(tmp / "start"),
            "--lr", str(LR), "--warmup_steps", "1", "--save_every", "2", "--sample_every", "0"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        replay = KeyReplay(mp)
        logs = []
        model, loss, ema = ttr.main(argv + ["--save_dir", str(tmp / "port")], device="cpu",
                                    log=logs.append)
        out["port"] = (str(tmp / "port"), dict(model.named_parameters()), loss, ema, logs)
        assert {k: len(v) for k, v in replay.seen.items()} == {
            "normal": 4, "uniform": 2, "randint": 2}
        replay.loss_rows(2)
        replay.install()
        jlogs = []
        jp, jloss, jema = jtr.train(jtr.build_argparser().parse_args(argv), log=jlogs.append)
        # the JAX train's iter_0000002 pair, written as it writes them (a
        # --save_dir there would also load tensorboard, and TensorFlow with
        # it), in its flat-npz branch: orbax is blocked, as the port reads npz
        os.makedirs(tmp / "jax")
        mp.setitem(sys.modules, "orbax", None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        jckpt.save_params(str(tmp / "jax" / "iter_0000002"), jax.device_get(jp))
        jckpt.save_params(str(tmp / "jax" / "iter_0000002_ema"), jax.device_get({**jp, **jema}))
        out["jax"] = (str(tmp / "jax"), jp, jloss, jema, jlogs)
    out["start"] = start
    out["noise_only"] = noise_only_leaves(start)
    return out


def noise_only_leaves(params):
    """The UNet and ``cc`` leaves whose loss gradient at ``params`` is 0 but
    for rounding (below 1e-6 of the largest): at the --tiny geometry the
    cross-attention's to_q, to_k and LayerNorm_1 (a softmax over the one
    context token is 1 whatever its logit) and the per-channel shifts that
    reach a GroupNorm of one-channel groups (the 32-channel level's biases).
    Adam's steps on them follow the rounding noise, which the two packages
    do not share: they are held to the step's bound."""
    model = novel_view_from_numpy(params, ttr.TINY_CONFIGS, "cpu")
    tgt, cond, dt = (torch.as_tensor(a) for a in pair_inputs(b=2))
    loss = model.loss_fn(tgt, cond, dt, torch.Generator().manual_seed(0))
    named = {n: p for n, p in model.named_parameters() if n.startswith(("unet.", "cc."))}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items() if float(g.abs().max()) < 1e-6 * top}


def _flat(tree):
    return dict(_torch_layout(k, np.asarray(v)) for k, v in _flatten_flax(tree).items())


def test_train_cli_tiny_matches_jax(trained):
    """Losses, the updated UNet and ``cc``, their EMA; the frozen VAE and
    CLIP leaves unmoved in both."""
    _, params, loss, ema, logs = trained["port"]
    _, jp, jloss, jema, jlogs = trained["jax"]
    assert [ln.split(" (")[0] for ln in logs] == [ln.split(" (")[0] for ln in jlogs]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    start, jflat, jeflat = _flat(trained["start"]), _flat(jax.device_get(jp)), _flat(jax.device_get(
        {**jp, **jema}))
    assert set(params) == set(jflat)
    moved = 0
    for name, p in params.items():
        p = p.detach().numpy()
        if name.startswith(("vae.", "clip.")):
            np.testing.assert_array_equal(p, start[name], err_msg=name)
            np.testing.assert_array_equal(jflat[name], start[name], err_msg=name)
            continue
        atol = 2 * LR if name in trained["noise_only"] else 2e-2 * LR
        np.testing.assert_allclose(p - start[name], jflat[name] - start[name], rtol=0,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy() - start[name], jeflat[name] - start[name],
                                   rtol=0, atol=atol, err_msg=name)
        moved += bool(np.abs(p - start[name]).max() > 0.1 * LR)
    assert moved > 0.5 * sum(1 for n in params if n.startswith(("unet.", "cc.")))
    assert "unet.mid_attn.block_0.attn2.to_q.weight" in trained["noise_only"]
    assert len(trained["noise_only"]) < 0.25 * len(params)


def test_lambda_linear_schedule_matches_jax():
    """The warm-up from f_start, the first step at f_start, and the
    plateau: the same f32 values."""
    for warm in (1, 100):
        mine = ttr.lambda_linear_schedule(1e-4, warm_up_steps=warm)
        ref = jtr.lambda_linear_schedule(1e-4, warm_up_steps=warm)
        for step in [0, 1, 2, 50, 99, 100, 101, 5000, 52000]:
            assert np.float32(mine(step)) == np.float32(ref(step)), (warm, step)
    assert ttr.lambda_linear_schedule(1e-4)(0) == float(np.float32(1e-4) * np.float32(1e-6))


# --------------------------------- sampling ---------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_infer_cli_samples_the_other_packages_checkpoint(trained, tmp_path, writer, monkeypatch):
    """``infer_novel_view`` (the port's ``main``, the JAX package's
    ``run_inference``) from the ``iter_0000002`` checkpoint ``writer``'s
    training wrote, its ``_ema`` sibling preferred by both: 2 frames x 2
    target cameras, 3 DDIM steps, the port's draws replayed."""
    ckpt = os.path.join(trained[writer][0], "iter_0000002")
    data = str(tmp_path / "data")
    write_views(data, seed=3)
    replay = KeyReplay(monkeypatch)
    argv = ["--data_dir", data, "--ckpt", ckpt, "--num_frames", "2", "--num_steps", "3",
            "--image_size", "32", "--target_cams", "0", "1", "--finetune_steps", "2"]
    tinf.main(argv + ["--out_dir", str(tmp_path / "port")], device="cpu",
              configs=ttr.TINY_CONFIGS, log=lambda *a: None)
    replay.sample_rows(4, 3)
    replay.install()
    jmodel = tiny_models()[0]
    jinf.run_inference(jmodel, jckpt.load_params_prefer_ema(ckpt), data, str(tmp_path / "jax"),
                       source_cam=2, target_cams=(0, 1), num_frames=2, num_steps=3,
                       image_size=32, finetune_steps=2, log=lambda *a: None)
    names = [os.path.join(f"zero123_finetune_2_cam2to{c}", f"frame_{i:06d}.png")
             for c in (0, 1) for i in range(2)]
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert a.shape == (32, 32, 3) and np.abs(a - b).max() <= 1, name
        assert (a != b).mean() < 0.01 and a.std() > 1, name


def test_save_image_truncates_and_load_image_is_pil(tmp_path):
    x = np.array([[[0.999, 0.5, 1.2], [-0.1, 0.00392, 0.00393]]], np.float32)
    tinf.save_image(str(tmp_path / "a" / "x.png"), x)
    jinf.save_image(str(tmp_path / "b" / "x.png"), x)
    assert (tmp_path / "a" / "x.png").read_bytes() == (tmp_path / "b" / "x.png").read_bytes()
    write_views(str(tmp_path / "v"), frames=1, size=40, modes=("RGBA", "L", "RGB"))
    for c in range(3):
        p = str(tmp_path / "v" / "frame_000" / f"{c:02d}.png")
        np.testing.assert_array_equal(tinf.load_image(p, 32), jinf.load_image(p, 32))


# --------------------------------- datasets ---------------------------------


@pytest.mark.parametrize("pair", [(-1, -1), (0, 2)], ids=["random", "fixed"])
def test_view_pair_dataset_matches_jax(tmp_path, pair):
    """Frames of 40 px (resized to 32) in RGB, gray and RGBA: the same
    pairs, images and pose deltas over three batches."""
    write_views(str(tmp_path), frames=3, cams=4, size=40, modes=("RGB", "L", "RGBA"))
    mine = ttr.make_pair_dataset(str(tmp_path), 32, cond_view=pair[0], target_view=pair[1])
    ref = jtr.make_pair_dataset(str(tmp_path), 32, cond_view=pair[0], target_view=pair[1])
    assert isinstance(mine, ttr.ViewPairDataset) and mine.fixed_pair == ref.fixed_pair
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        for a, b in zip(mine.sample_batch(5, r1), ref.sample_batch(5, r2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _shards(root, frames=7, cams=3, size=24, per_shard=3, seed=5):
    """Tar shards of whole frames (members <key>.<cam:02d>.png, PIL-encoded),
    one frame missing camera 1, and camera/*.npy beside them."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    write_views(os.path.join(root, "views"), frames=1, cams=cams)   # for the cameras
    os.rename(os.path.join(root, "views", "camera"), os.path.join(root, "camera"))
    for s in range(0, frames, per_shard):
        with tarfile.open(os.path.join(root, f"{s // per_shard:06d}.tar"), "w") as tf:
            for f in range(s, min(s + per_shard, frames)):
                for c in range(cams):
                    if f == 4 and c == 1:
                        continue
                    buf = io.BytesIO()
                    Image.fromarray(rng.integers(0, 256, (size, size, 3)).astype(np.uint8)).save(
                        buf, format="png")
                    info = tarfile.TarInfo(f"frame_{f:03d}.{c:02d}.png")
                    info.size = len(buf.getvalue())
                    tf.addfile(info, io.BytesIO(buf.getvalue()))


@pytest.mark.parametrize("pair,buffer", [((-1, -1), 2), ((0, 1), 4)], ids=["random", "fixed"])
def test_view_pair_webdataset_matches_jax(tmp_path, pair, buffer):
    """Tar shards (24 px resized to 16), the reservoir shuffle at a buffer
    smaller than a pass, and enough batches to restart the stream: the same
    images and deltas in the same order."""
    root = str(tmp_path / "shards")
    _shards(root)
    kw = dict(image_size=16, cond_view=pair[0], target_view=pair[1], seed=3,
              shuffle_buffer=buffer)
    mine, ref = ttr.ViewPairWebDataset(root, **kw), jtr.ViewPairWebDataset(root, **kw)
    assert mine.shards == ref.shards
    assert isinstance(ttr.make_pair_dataset(root, 16), ttr.ViewPairWebDataset)
    for _ in range(4):
        for a, b in zip(mine.sample_batch(3, None), ref.sample_batch(3, None)):
            np.testing.assert_array_equal(a, b)


# ------------------------------- the processes -------------------------------


def test_stages_registered():
    assert STAGES["train_novel_view"] == ttr.__name__
    assert STAGES["infer_novel_view"] == tinf.__name__


def test_clis_run_without_pil_jax_or_tensorboard(tmp_path):
    """Both CLIs at --tiny on the CPU in a process where PIL, OpenCV, JAX,
    the JAX package and tensorboard cannot be imported: a step that logs
    the three TensorBoard grids and writes both checkpoints, then a sample
    from them."""
    write_views(str(tmp_path / "data"))
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("PIL", "cv2", "jax", "fluidnexus_tpu", "tensorboard", "tensorflow")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import os
        from fluidnexus_torch.pipelines import infer_novel_view as inf, train_novel_view as tr
        root = {str(tmp_path)!r}
        tr.main(["--data_dir", root + "/data", "--iterations", "1", "--batch", "2",
                 "--image_size", "32", "--tiny", "--save_dir", root + "/run", "--save_every", "1",
                 "--sample_every", "1", "--sample_steps", "2", "--max_log_images", "1"],
                device="cpu", log=lambda *a: None)
        inf.main(["--data_dir", root + "/data", "--out_dir", root + "/out", "--ckpt",
                  root + "/run/iter_0000001", "--num_frames", "1", "--num_steps", "2",
                  "--image_size", "32", "--target_cams", "1"], device="cpu",
                 configs=tr.TINY_CONFIGS, log=lambda *a: None)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print(sorted(os.listdir(root + "/run")))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})   # one intra-op thread
    assert res.returncode == 0, res.stderr
    assert "iter_0000001.npz" in res.stdout and "iter_0000001_ema.npz" in res.stdout
    assert os.path.exists(tmp_path / "out" / "zero123_finetune_52000_cam2to1" / "frame_000000.png")
    from tensorboard.compat.proto.event_pb2 import Event

    from tests.test_torch_tb import _records

    tags = {v.tag for r in _records(str(tmp_path / "run"))
            for v in Event.FromString(r).summary.value}
    assert {"train/conditioning", "train/targets", "train/samples_cfg_scale_3.00"} <= tags


def test_keyboard_interrupt_saves_last(tmp_path, monkeypatch):
    """An interrupt mid-run writes ``last`` and ``last_ema`` and re-raises."""
    write_views(str(tmp_path / "data"))

    def interrupt(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(ttr.NovelViewTrainer, "step", interrupt)
    with pytest.raises(KeyboardInterrupt):
        ttr.main(["--data_dir", str(tmp_path / "data"), "--iterations", "2", "--batch", "1",
                  "--image_size", "32", "--tiny", "--save_dir", str(tmp_path / "run")],
                 device="cpu", log=lambda *a: None)
    assert {"last.npz", "last_ema.npz"} <= set(os.listdir(tmp_path / "run"))
    assert set(jckpt.load_params(str(tmp_path / "run" / "last"))) == {"unet", "vae", "clip", "cc"}
