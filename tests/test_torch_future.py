"""The future stage in the port against the JAX package, on the CPU:
``predict`` with wind and a rigid cylinder (per-frame dicts, npy checkpoints,
PNG renders), the future emitter lattices, the bottom cut and the smoothed
visual checkpoint, and the PNG writer against the JAX package's PIL one.

On the CPU the JAX ``update_visual`` takes the padded top-K splat
(sim/pbf.py:306-307) while the port runs the dense splat; they agree where
``knn_k`` covers every neighbourhood and the plume lies inside the padded
grid's 32-cell box, as here."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.pipelines import future_simulation as jfuture
from fluidnexus_tpu.pipelines.train_background import save_image as j_save_image
from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.pipelines import future_simulation as tfuture
from fluidnexus_torch.pipelines.train_background import save_image as t_save_image
from fluidnexus_torch.splat import dynamics as tdyn
from tests.test_future_and_level_two import fake_level_one_checkpoint
from tests.test_torch_fit_first_frame import _port_scene
from tests.test_train_physical import smoke_like_scene

CPU = torch.device("cpu")


def _future_cfg(cfg, load_path, model_path):
    """tests/test_future_and_level_two.py's rollout config, with wind and a
    rigid cylinder (radius 2, 16 x 8 surface particles, 4 units long) in the
    middle of the loaded cloud from the second future frame on."""
    o, m = cfg.optim, cfg.model
    m.load_path, m.model_path = load_path, model_path
    m.hidden_capacity, m.visual_capacity = 1024, 512
    o.future_pred_frames, o.solver_iterations_future = 3, 2
    o.p0, o.p0_future, o.decay_frames_future_p0 = 1.5, 1.2, 2
    o.H, o.k, o.secs, o.alpha = 2.0, 3.0, 0.033, 0.0
    o.emit_ratio_hidden = o.emit_ratio_visual = 1.0
    o.init_hidden_velocity = 100.0
    o.wind_since, o.wind_force = 3, [35.0, 0.0, 0.0]
    o.rigid_since, o.rigid_body = 3, "cylinder"
    o.rigid_body_center = [0.326, 0.08, -0.3]
    o.rigid_cylinder_radius, o.rigid_cylinder_num = 2.0, [16, 8]
    cfg.pipe.tile_capacity, cfg.pipe.chunk = 32, 8
    cfg.pipe.dup_x = cfg.pipe.dup_y = 3
    return cfg


def test_predict_matches_jax(tmp_path):
    """``predict`` over 3 future frames from one checkpoint: p0 exact, alive
    counts exact, p_ratio 1e-4; every npy checkpoint (positions 1e-4 scaled
    units, velocity that over secs, force k x iterations times that, the
    rest exactly) and every PNG pixel for pixel, both read back with PIL."""
    load_path = str(tmp_path / "recon")
    fake_level_one_checkpoint(os.path.join(load_path, "checkpoint"))
    jcfg = _future_cfg(JConfig(), load_path, str(tmp_path / "jax"))
    tcfg = _future_cfg(TConfig(), load_path, str(tmp_path / "torch"))
    scene = smoke_like_scene(n_frames=2)
    ref = jfuture.predict(jcfg, scene_info=scene, log=lambda *a: None, save_renders=True)
    logs = []
    got = tfuture.predict(tcfg, scene_info=_port_scene(scene), log=logs.append,
                          save_renders=True, device="cpu")

    assert [f["frame"] for f in got] == [2, 3, 4] and len(logs) == 4
    for a, b in zip(got, ref):
        assert a["p0"] == b["p0"]
        assert (a["hidden"], a["visual"]) == (b["hidden"], b["visual"])
        np.testing.assert_allclose(a["p_ratio"], b["p_ratio"], rtol=1e-4)
    # the cylinder stands in the cloud from frame 3 on and moves points there
    assert got[0]["rigid_hidden"] == got[0]["rigid_visual"] == 0
    assert got[1]["rigid_hidden"] > 0 and got[1]["rigid_visual"] > 0

    secs, k, iters = 0.033, 3.0, 2
    tol = {"xyz": 1e-6, "velocity": 1e-4 / secs, "force": 1e-4 / secs * k * iters}
    ck_j, ck_t = tmp_path / "jax" / "checkpoint", tmp_path / "torch" / "checkpoint"
    names = sorted(os.listdir(ck_j))
    assert names == sorted(os.listdir(ck_t)) and len(names) == 3 * 15
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

    r_j, r_t = tmp_path / "jax" / "training_render", tmp_path / "torch" / "training_render"
    pngs = sorted(os.listdir(r_j))
    assert pngs == sorted(os.listdir(r_t)) and len(pngs) == 3 * 3
    lit = 0
    for name in pngs:
        a, b = np.asarray(Image.open(r_t / name)), np.asarray(Image.open(r_j / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        lit += int((a > 0).sum())
    assert lit > 0


def test_predict_needs_a_scene(tmp_path):
    """Without a scene_info, ``predict`` reads the scene at data_path, and a
    folder with no capture raises before any work."""
    cfg = TConfig()
    cfg.model.data_path = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="transforms"):
        tfuture.predict(cfg, None, device="cpu")


def test_future_emitters_match_jax():
    """The four lattices of EmitterPoints, reconstruction and future."""
    jc, tc = JConfig(), TConfig()
    for is_future in (False, True):
        je = jdyn.EmitterPoints.from_config(jc.model, is_future=is_future)
        te = tdyn.EmitterPoints.from_config(tc.model, is_future=is_future)
        for name in ("hidden", "visual", "hidden_first", "visual_first"):
            assert len(getattr(te, name)) > 0
            np.testing.assert_array_equal(getattr(te, name), getattr(je, name), err_msg=name)
    assert len(te.visual_first) > len(te.visual)


def test_remove_bottom_visual_and_smoothed_load_match_jax(tmp_path):
    """The bottom cut at y = -1.7 scaled units, and ``load_visual`` reading
    the smoothed attribute files where asked and present."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-3.0, 3.0, (40, 3)).astype(np.float32)
    vis_j = j_make_visual_state(64, jnp.asarray(xyz))
    ref = jdyn.remove_bottom_visual(vis_j)
    got = tdyn.remove_bottom_visual(convert.visual_state_from_numpy(vis_j, device=CPU))
    assert 0 < int(got.alive.sum()) < 40
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))

    path = str(tmp_path)
    jdyn.save_visual(vis_j, jdyn.constant_visual_attrs(64, 1), path, 4)
    pre = os.path.join(path, "frame_004_")
    np.save(pre + "visual_color_smoothed_ws5.npy", rng.random((40, 1)).astype(np.float32))
    np.save(pre + "visual_scales_smoothed_ws5.npy", rng.random((40, 3)).astype(np.float32))
    use = {"color": True, "scales": False, "opacity": True, "rotation": True}
    for window, channels in ((5, 1), (5, 3), (None, 1)):
        vj, aj = jdyn.load_visual(path, 4, 64, channels=channels, smoothed_window=window,
                                  use_smoothed=use)
        vt, at = tdyn.load_visual(path, 4, 64, channels=channels, smoothed_window=window,
                                  use_smoothed=use, device=CPU)
        np.testing.assert_array_equal(vt.xyz.numpy(), np.asarray(vj.xyz))
        for name, a, b in zip(at._fields, at, aj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("channels", [1, 3])
def test_save_image_matches_pil(tmp_path, channels):
    """The stdlib PNG writer against the JAX package's PIL writer: the same
    mode and pixels, out-of-range values clipped."""
    img = np.random.default_rng(channels).uniform(-0.2, 1.2, (channels, 24, 32)).astype(np.float32)
    j_save_image(str(tmp_path / "j" / "a.png"), jnp.asarray(img))
    t_save_image(str(tmp_path / "t" / "a.png"), torch.as_tensor(img))
    a, b = Image.open(tmp_path / "t" / "a.png"), Image.open(tmp_path / "j" / "a.png")
    assert a.mode == b.mode == ("L" if channels == 1 else "RGB")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
