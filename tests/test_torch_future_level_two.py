"""Stage 4 from stage 3's output in the port against the JAX package, on the
CPU: ``predict`` with ``--use_level_two_in_future``, with and without
``--use_level_two_smoothed_in_future`` (over the files
``dataset_builders.smooth_visual_attrs`` writes), 3-colour attributes over a
background, to tests/test_torch_future.py's tolerances: p0 and the counts
exact, p_ratio 1e-4 relative, positions 1e-6 (1e-4 scaled units), velocity
and force scaled alike, every other npy exact, PNGs pixel for pixel.

The level-two positions are in world units (stage 3 saves them unscaled)
while the hidden particles are in scaled units (x100): both packages advect
and render them so (ROADMAP, findings about the JAX package)."""
import os

import numpy as np
import pytest
from PIL import Image

from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.core.ply import save_background_ply
from fluidnexus_torch.data.dataset_builders import smooth_visual_attrs
from fluidnexus_torch.pipelines import future_simulation as tfuture
from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.pipelines import future_simulation as jfuture
from tests.test_future_and_level_two import fake_level_one_checkpoint
from tests.test_torch_fit_first_frame import _port_scene
from tests.test_torch_future import _future_cfg
from tests.test_torch_small_math import _background
from tests.test_train_physical import smoke_like_scene
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

BG_ITERATION = 7


def level_two_checkpoint(recon, out, seed=6):
    """``checkpoint_level_two`` as stage 3 writes it from ``recon``'s visual
    positions (world units, unscaled), with seeded 3-colour attributes."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    for t in range(2):
        xyz = np.load(os.path.join(recon, f"frame_{t:03d}_visual_xyz.npy"))
        n = len(xyz)
        pre = os.path.join(out, f"frame_{t:03d}_visual_")
        rot = rng.normal(size=(n, 4)).astype(np.float32)
        for name, arr in (("xyz", xyz), ("color", rng.uniform(0, 1, (n, 3))),
                          ("scales", rng.uniform(-5.5, -4.0, (n, 3))),
                          ("rotation", rot / np.linalg.norm(rot, axis=-1, keepdims=True)),
                          ("opacity", rng.normal(size=(n, 1)))):
            np.save(pre + f"{name}.npy", np.asarray(arr, np.float32))


@pytest.mark.parametrize("smoothed", [False, True])
def test_predict_from_level_two_matches_jax(tmp_path, smoothed):
    """One future frame (1 solver iteration, wind on) from the level-one
    hidden particles and the level-two visual particles."""
    recon = str(tmp_path / "recon")
    fake_level_one_checkpoint(os.path.join(recon, "checkpoint"), n_frames=2)
    lvl2 = str(tmp_path / "lvl2")
    level_two_checkpoint(os.path.join(recon, "checkpoint"),
                         os.path.join(lvl2, "checkpoint_level_two"))
    if smoothed:
        assert smooth_visual_attrs(os.path.join(lvl2, "checkpoint_level_two")) == 2
    d = _background(n=48, seed=11)
    d["xyz"] = d["xyz"] * 0.05 + np.array([0.326, 0.06, -0.3], np.float32)
    bg = str(tmp_path / "bg")
    save_background_ply(os.path.join(bg, "point_cloud", f"iteration_{BG_ITERATION:05d}",
                                     "point_cloud.ply"),
                        d["xyz"], d["color"], d["opacity"], d["scaling"], d["rotation"])

    def cfg(c, out):
        c = _future_cfg(c, recon, str(tmp_path / out))
        o, m = c.optim, c.model
        o.future_pred_frames, o.solver_iterations_future = 1, 1
        o.wind_since, o.rigid_since = 2, -1
        m.level_two_load_path, m.level_two_color_3ch = lvl2, True
        m.bg_load_path, m.bg_load_iteration = bg, BG_ITERATION
        o.use_level_two_in_future, o.use_level_two_smoothed_in_future = True, smoothed
        return c

    scene = smoke_like_scene(n_frames=2)
    ref = jfuture.predict(cfg(JConfig(), "jax"), scene_info=scene, log=lambda *a: None)
    got = tfuture.predict(cfg(TConfig(), "torch"), scene_info=_port_scene(scene),
                          log=lambda *a: None, device="cpu")
    assert [f["frame"] for f in got] == [f["frame"] for f in ref] == [2]
    for a, b in zip(got, ref):
        assert a["p0"] == b["p0"] and (a["hidden"], a["visual"]) == (b["hidden"], b["visual"])
        np.testing.assert_allclose(a["p_ratio"], b["p_ratio"], rtol=1e-4)

    secs, k, iters = 0.033, 3.0, 1
    tol = {"xyz": 1e-6, "velocity": 1e-4 / secs, "force": 1e-4 / secs * k * iters}
    ck_j, ck_t = tmp_path / "jax" / "checkpoint", tmp_path / "torch" / "checkpoint"
    names = sorted(os.listdir(ck_j))
    assert names == sorted(os.listdir(ck_t)) and len(names) == 15
    for name in names:
        a, b = ck_t / name, ck_j / name
        if name.endswith(".json"):
            assert a.read_text() == b.read_text(), name
            continue
        x, y = np.load(a), np.load(b)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        key = next((key for key in tol if key in name), None)
        if key is None:
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=tol[key], err_msg=name)
    # each saved row's colour is a (smoothed) level-two row's or an emitted
    # row's constant 0.7
    src = os.path.join(lvl2, "checkpoint_level_two", "frame_001_visual_color"
                       + ("_smoothed_ws5.npy" if smoothed else ".npy"))
    fitted = {tuple(r) for r in np.load(src)}
    rows = [tuple(r) for r in np.load(ck_t / "frame_002_visual_color.npy")]
    assert all(len(r) == 3 for r in rows) and any(r in fitted for r in rows)
    assert all(r in fitted or r == (np.float32(0.7),) * 3 for r in rows)

    r_j, r_t = tmp_path / "jax" / "training_render", tmp_path / "torch" / "training_render"
    pngs = sorted(os.listdir(r_j))
    assert pngs == sorted(os.listdir(r_t)) and len(pngs) == 3
    for name in pngs:
        a = np.asarray(Image.open(r_t / name))
        np.testing.assert_array_equal(a, np.asarray(Image.open(r_j / name)), err_msg=name)
        assert a.shape[-1] == 3 and a.any()
