"""Stage 3 (the level-two appearance fit) in the port against the JAX package,
on the CPU: ``mean_dist_to_knn`` (the simple-knn scale init), ``train`` over
one level-one checkpoint folder in two configurations (3 colour channels
over a background with the knn init and every field inherited; 1 channel
with no background fitting colour and scales alone), and ``main`` through
``python -m fluidnexus_torch train_visual_particle`` on a capture on disk.

Tolerances: the knn at 1e-6 relative (the two packages sum the squared
differences in a different order, ~1 ulp apart); per-frame loss and l1 at
1e-4 relative and every saved npy at 1e-4 absolute (the same inputs through
the rasterizer's plain version and JAX's ``backend="xla"``, 12 Adam steps);
positions exactly (they are loaded and saved as they are)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.core.ply import save_background_ply
from fluidnexus_torch.ops.knn import mean_dist_to_knn as t_knn
from fluidnexus_torch.pipelines import train_visual_particle as tvp
from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.ops.knn import mean_dist_to_knn as j_knn
from fluidnexus_tpu.pipelines import train_visual_particle as jvp
from tests.test_future_and_level_two import fake_level_one_checkpoint
from tests.test_torch_fit_first_frame import _port_scene
from tests.test_torch_small_math import _background
from tests.test_train_physical import smoke_like_scene
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

BG_ITERATION = 7
CHECKPOINT_FILES = ("xyz", "color", "scales", "rotation", "opacity")


def _knn_points(n, seed, duplicates=0):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-0.03, 0.03, (n, 3)) + [0.326, 0.05, -0.3]).astype(np.float32)
    p[1:1 + duplicates] = p[0]
    return p


@pytest.mark.parametrize("n, n_alive, duplicates", [
    (300, None, 1),      # every row live, N not a multiple of the chunk, a pair coincident
    (513, 400, 3),       # a mask, four points coincident
    (256, 3, 0),         # 2 live others: the third neighbour adds 0
    (40, 1, 0),          # one live row: no neighbour at all
])
def test_mean_dist_to_knn_matches_jax(n, n_alive, duplicates):
    p = _knn_points(n, n + (n_alive or 0), duplicates)
    alive = None
    if n_alive is not None:
        alive = np.zeros(n, bool)
        alive[np.random.default_rng(n).choice(n, n_alive, replace=False)] = True
        alive[:duplicates + 1] = True
    ref = np.asarray(j_knn(jnp.asarray(p), None if alive is None else jnp.asarray(alive)))
    got = t_knn(torch.as_tensor(p), None if alive is None else torch.as_tensor(alive)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    if alive is not None:
        assert (got[~alive] == 0).all()
    # the self pair alone is excluded: k coincident others give 0, fewer do not
    assert ((got[:duplicates + 1] == 0) == (duplicates >= 3)).all()


def _with_background(cfg, bg_path):
    o, m = cfg.optim, cfg.model
    m.level_two_color_3ch = True
    m.bg_load_path, m.bg_load_iteration = bg_path, BG_ITERATION
    o.fit_color = o.fit_opacity = o.fit_scales = o.fit_rotation = True
    o.init_scales_w_xyz_dist = True
    o.inherit_prev_color = o.inherit_prev_opacity = True
    o.inherit_prev_scales = o.inherit_prev_rotation = True
    o.lambda_consistency_color, o.lambda_consistency_opacity = 10.0, 8.0
    o.lambda_consistency_scales, o.lambda_consistency_rotation = 2.0, 0.1
    o.lambda_reg_scaling, o.scaling_reg_ratio_threshold = 1.0, 1.2
    o.iterations_per_time_current_level_two = 4
    o.iterations_per_time_current_level_two_max = 8   # 4 then 6 iterations
    o.batch = 2
    return cfg


def _gray_alone(cfg, bg_path):
    o = cfg.optim
    o.fit_color = o.fit_scales = True
    o.lambda_consistency_scales = 5.0
    o.lambda_reg_scaling, o.scaling_reg_ratio_threshold = 0.5, 1.5
    o.iterations_per_time_current_level_two = o.iterations_per_time_current_level_two_max = 6
    o.batch = 1
    return cfg


CASES = {"rgb_background_knn_inherit": _with_background, "gray_no_background": _gray_alone}


def _cfg(cfg, case, root, out):
    m, p = cfg.model, cfg.pipe
    m.load_path, m.model_path, m.visual_capacity = os.path.join(root, "recon"), out, 128
    p.tile_capacity, p.chunk, p.dup_x, p.dup_y = 32, 8, 3, 3
    return CASES[case](cfg, os.path.join(root, "bg"))


@pytest.fixture(scope="module")
def level_one(tmp_path_factory):
    """A level-one checkpoint of 2 frames (60 visual particles in 128 slots),
    a stage-1 PLY of 48 splats around the plume, and the JAX package's
    stage 3 on them in each case."""
    root = str(tmp_path_factory.mktemp("level_two"))
    fake_level_one_checkpoint(os.path.join(root, "recon", "checkpoint"), n_frames=2)
    d = _background(n=48, seed=11)
    d["xyz"] = d["xyz"] * 0.05 + np.array([0.326, 0.06, -0.3], np.float32)
    save_background_ply(os.path.join(root, "bg", "point_cloud", f"iteration_{BG_ITERATION:05d}",
                                     "point_cloud.ply"),
                        d["xyz"], d["color"], d["opacity"], d["scaling"], d["rotation"])
    scene = smoke_like_scene(n_frames=2)
    ref = {case: jvp.train(_cfg(JConfig(), case, root, os.path.join(root, "jax", case)),
                           scene_info=scene, log=lambda *a: None) for case in CASES}
    return root, scene, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(level_one, case):
    """Per-frame loss and l1, the log lines, and every npy of
    ``checkpoint_level_two``."""
    root, scene, ref = level_one
    out = os.path.join(root, "torch", case)
    logs = []
    got = tvp.train(_cfg(TConfig(), case, root, out), scene_info=_port_scene(scene),
                    log=logs.append, device="cpu")
    assert [r["frame"] for r in got] == [r["frame"] for r in ref[case]] == [0, 1]
    for a, b in zip(got, ref[case]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["l1"], b["l1"], rtol=1e-4)
        assert np.isfinite(a["loss"])
    assert [ln for ln in logs if ln.startswith("level-two")] == [
        f"level-two frame {t}/1: loss={r['loss']:.5f}" for t, r in enumerate(got)]
    ck_t = os.path.join(out, "checkpoint_level_two")
    ck_j = os.path.join(root, "jax", case, "checkpoint_level_two")
    names = sorted(os.listdir(ck_j))
    assert names == sorted(os.listdir(ck_t)) == sorted(
        f"frame_{t:03d}_visual_{f}.npy" for t in range(2) for f in CHECKPOINT_FILES)
    channels = 3 if case.startswith("rgb") else 1
    for name in names:
        x, y = np.load(os.path.join(ck_t, name)), np.load(os.path.join(ck_j, name))
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, name
        if name.endswith("xyz.npy"):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4, err_msg=name)
    color = np.load(os.path.join(ck_t, "frame_001_visual_color.npy"))
    assert color.shape == (60, channels) and not np.allclose(color, 0.7)
    scales = np.load(os.path.join(ck_t, "frame_001_visual_scales.npy"))
    assert not np.allclose(scales, -5.9)


def test_knn_init_writes_every_axis_and_keeps_dead_rows():
    """``init_scales_from_knn`` against the JAX one on a half-live buffer."""
    from fluidnexus_torch.sim.state import make_visual_state as t_visual
    from fluidnexus_torch.splat.dynamics import constant_visual_attrs as t_attrs
    from fluidnexus_tpu.sim.state import make_visual_state as j_visual
    from fluidnexus_tpu.splat.dynamics import constant_visual_attrs as j_attrs

    p = _knn_points(50, 5)
    vj, aj = j_visual(96, jnp.asarray(p)), j_attrs(96, 3)
    vt, at = t_visual(96, p, device="cpu"), t_attrs(96, 3, device="cpu")
    ref = np.asarray(jvp.init_scales_from_knn(vj, aj, True).scales)
    got = tvp.init_scales_from_knn(vt, at, True).scales.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert (got[:50, 0] == got[:50, 2]).all() and (got[50:] == np.float32(-5.9)).all()
    assert tvp.init_scales_from_knn(vt, at, False) is at


def test_scale_ratio_penalty_shares_tied_gradients_as_jax():
    """The regulariser of stages 1 and 3 and its gradient against the JAX
    package's expression (``train_visual_particle.py:98-101``) at rows with
    three tied scales (as the knn init writes them), rows with two tied
    (the max or the min), untied rows and dead rows, at a threshold under 1
    so that the tied rows reach the loss. ``torch.max`` would give a tied
    row's gradient to one axis; ``jnp.max`` shares it."""
    import jax

    from fluidnexus_torch.utils.losses import scale_ratio_penalty

    rng = np.random.default_rng(4)
    log_s = rng.uniform(-6.0, -3.0, (40, 3)).astype(np.float32)
    log_s[:10] = log_s[:10, :1]                     # all three tied
    log_s[10:15, 1] = log_s[10:15, 0]               # the two largest or smallest tied
    alive = np.arange(40) < 34

    def j_penalty(ls):
        s = jnp.exp(ls)
        ratio = s.max(-1) / jnp.maximum(s.min(-1), 1e-12)
        reg = jnp.where(alive, jnp.maximum(ratio - 0.5, 0.0), 0.0)
        return reg.sum() / jnp.maximum(alive.sum(), 1)

    ref, ref_g = jax.value_and_grad(j_penalty)(jnp.asarray(log_s))
    x = torch.tensor(log_s, requires_grad=True)
    got = scale_ratio_penalty(x, torch.as_tensor(alive), 0.5)
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    # a tied row's shares cancel to rounding (~1e-9) in both packages
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)
    assert np.abs(g.numpy()[:10]).max() < 1e-7 < np.abs(g.numpy()[15:34]).max(-1).min()


class _Logger:
    """Stands in for ``utils/tb.TrainLogger`` (tensorboard may pull in a whole
    TensorFlow here) and records the scalars."""
    scalars = {}

    def __init__(self, model_path=None):
        pass

    def add_scalar(self, tag, value, step):
        _Logger.scalars.setdefault(tag, {})[step] = float(value)


def test_main_through_the_runner(tmp_path, monkeypatch):
    """``python -m fluidnexus_torch train_visual_particle`` on a capture on
    disk: ``cfg_args.json`` equal to the JAX package's ``dump_config`` of
    the same argv, the scalars logged, and the outputs equal to
    ``train(parse_cli(argv))`` in process."""
    from fluidnexus_torch.__main__ import STAGES
    from fluidnexus_torch.__main__ import main as runner
    from fluidnexus_torch.core.config import parse_cli as t_parse_cli
    from fluidnexus_tpu.core.config import dump_config as j_dump_config
    from fluidnexus_tpu.core.config import parse_cli as j_parse_cli
    from tests.test_torch_readers import write_capture

    assert STAGES["train_visual_particle"] == "fluidnexus_torch.pipelines.train_visual_particle"
    cap = write_capture(str(tmp_path / "capture"), n_frames=2)
    fake_level_one_checkpoint(str(tmp_path / "recon" / "checkpoint"), n_frames=2)
    config = tmp_path / "stage3.json"
    config.write_text(json.dumps(dict(
        duration=2, visual_capacity=128, level_two_color_3ch=True, fit_color=True,
        fit_opacity=True, iterations_per_time_current_level_two=2,
        iterations_per_time_current_level_two_max=2, batch=1, tile_capacity=32, chunk=8,
        dup_x=3, dup_y=3)))
    out = str(tmp_path / "lvl2")
    argv = ["--config", str(config), "--data_path", cap, "--load_path", str(tmp_path / "recon"),
            "--model_path", out, "--init_scales_w_xyz_dist", "--fit_scales", "--seed", "3"]

    real_train = tvp.train
    returned = []

    def on_cpu(cfg, **kw):
        returned.append(real_train(cfg, **dict(kw, device="cpu")))
        return returned[-1]

    monkeypatch.setattr(tvp, "train", on_cpu)
    monkeypatch.setattr("fluidnexus_torch.utils.tb.TrainLogger", _Logger)
    _Logger.scalars = {}
    runner(["train_visual_particle"] + argv)

    j_dump_config(j_parse_cli(argv), str(tmp_path / "jax_cfg_args.json"))
    with open(tmp_path / "jax_cfg_args.json") as f, open(os.path.join(out, "cfg_args.json")) as g:
        assert json.load(g) == json.load(f)
    cfg = t_parse_cli(argv)
    assert cfg.optim.init_scales_w_xyz_dist and cfg.optim.fit_scales and cfg.seed == 3
    cfg.model.model_path = str(tmp_path / "again")
    again = real_train(cfg, log=lambda *a: None, device="cpu")
    assert returned == [again]
    assert _Logger.scalars == {
        "level_two/loss": {r["frame"]: r["loss"] for r in again},
        "level_two/l1": {r["frame"]: r["l1"] for r in again}}
    for name in os.listdir(os.path.join(out, "checkpoint_level_two")):
        a = np.load(os.path.join(out, "checkpoint_level_two", name))
        b = np.load(os.path.join(cfg.model.model_path, "checkpoint_level_two", name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(os.listdir(os.path.join(out, "checkpoint_level_two"))) == 2 * 5

