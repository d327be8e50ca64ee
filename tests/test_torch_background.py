"""Stage 1 (the background Gaussians) in the port against the JAX package, on
the CPU: ``densify_and_prune`` given the JAX package's ``jax.random`` draws
and deliberate gradient ties (alive, slots, fields, stats, both Adam
moments), stage-1 ``train`` against the JAX ``train`` (``backend="xla"``)
over iterations in which densify, the opacity reset and the large prune all
fire, and the three stage CLIs in sequence on a small capture on disk.
Stage 2's and stage 4's numerics are held by tests/test_torch_phase_c.py and
tests/test_torch_future.py."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.data.cameras import Camera as TCamera
from fluidnexus_torch.data.readers import SceneInfo as TSceneInfo
from fluidnexus_torch.ops.rasterizer import RasterizerConfig as TRasterizerConfig
from fluidnexus_torch.ops.rasterizer import rasterize as t_rasterize
from fluidnexus_torch.pipelines import train_background as tbg
from fluidnexus_torch.splat import background as tback
from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.core.optim import adam_init as j_adam_init
from fluidnexus_tpu.data.readers import SceneInfo as JSceneInfo
from fluidnexus_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.ops.rasterizer import rasterize as j_rasterize
from fluidnexus_tpu.pipelines import train_background as jbg
from fluidnexus_tpu.splat import background as jback
from tests.test_train_background import synthetic_scene

CPU = torch.device("cpu")
TRAINABLE = ("xyz", "color", "scaling", "rotation", "opacity")


def _np(x):
    return np.asarray(x)


def _jax_draws(key, max_new):
    return np.stack([_np(jax.random.normal(key, (max_new, 3))),
                     _np(jax.random.normal(jax.random.fold_in(key, 1), (max_new, 3)))])


def _model_state(cap, n_alive, seed):
    """A JAX BackgroundModel with random fields: scales both below and above
    the clone/split limit, opacities around min_opacity, big screen radii,
    and accumulated gradients with ties among the candidates (and at -1's
    stand-in for non-candidates: zero denominators)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n_alive, replace=False)] = True
    grads = rng.choice([1e-4, 3e-4, 5e-4, 5e-4, 8e-4], cap).astype(f)
    denom = rng.integers(0, 4, cap).astype(f)
    model = jback.BackgroundModel(
        xyz=jnp.asarray(rng.uniform(-1, 1, (cap, 3)).astype(f)),
        color=jnp.asarray(rng.uniform(0, 1, (cap, 3)).astype(f)),
        scaling=jnp.asarray(rng.uniform(-6.0, -2.0, (cap, 3)).astype(f)),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)).astype(f)),
        opacity=jnp.asarray(rng.normal(-3.0, 2.0, (cap, 1)).astype(f)),
        alive=jnp.asarray(alive),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, cap).astype(f)),
        xyz_gradient_accum=jnp.asarray(grads * denom),
        denom=jnp.asarray(denom),
    )
    mu = {k: jnp.asarray(rng.normal(size=getattr(model, k).shape).astype(f)) for k in TRAINABLE}
    nu = {k: jnp.asarray(rng.uniform(0, 1, getattr(model, k).shape).astype(f)) for k in TRAINABLE}
    return model, mu, nu


@pytest.mark.parametrize("cap,n_alive,max_new,size", [
    (512, 300, 4096, 20.0),   # every candidate finds a dead slot
    (512, 480, 4096, 20.0),   # more candidates than dead slots: the rest are dropped
    (512, 200, 40, 0.0),      # max_new caps the candidates; no screen-size prune
])
def test_densify_and_prune_matches_jax(cap, n_alive, max_new, size):
    model_j, mu_j, nu_j = _model_state(cap, n_alive, seed=cap + n_alive)
    key = jax.random.PRNGKey(7)
    args = (2e-4, 0.005, 3.0, size, 0.01)
    ref, mu_r, nu_r, st_r = jback.densify_and_prune(model_j, mu_j, nu_j, key, *args,
                                                    max_new=max_new)
    opt_j = j_adam_init({k: getattr(model_j, k) for k in TRAINABLE})._replace(mu=mu_j, nu=nu_j)
    model_t, opt_t = convert.background_model_from_numpy(
        jax.tree.map(_np, model_j), jax.tree.map(np.array, opt_j), device=CPU)
    noise = torch.as_tensor(_jax_draws(key, min(max_new, cap)))
    got, mu_g, nu_g, st_g = tback.densify_and_prune(model_t, opt_t.mu, opt_t.nu, noise, *args,
                                                    max_new=max_new)

    assert {k: int(v) for k, v in st_g.items()} == {k: int(v) for k, v in st_r.items()}
    assert int(st_r["cloned"]) > 0 and int(st_r["split"]) > 0 and int(st_r["pruned"]) > 0
    if n_alive == 480:
        assert int(st_r["dropped"]) > 0
    np.testing.assert_array_equal(got.alive.numpy(), _np(ref.alive))
    for name in ("xyz", "scaling"):
        np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("color", "rotation", "opacity", "max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(getattr(ref, name)),
                                      err_msg=name)
    for k in TRAINABLE:
        np.testing.assert_array_equal(mu_g[k].numpy(), _np(mu_r[k]), err_msg=k)
        np.testing.assert_array_equal(nu_g[k].numpy(), _np(nu_r[k]), err_msg=k)


def test_model_ops_match_jax():
    """``create_from_points``, ``reset_opacity``, the three prunes and
    ``add_densification_stats``."""
    model_j, _, _ = _model_state(256, 200, seed=1)
    model_t, _ = convert.background_model_from_numpy(jax.tree.map(_np, model_j), device=CPU)

    def same(a, b, rtol=0.0):
        for name in jback.BackgroundModel._fields:
            np.testing.assert_allclose(getattr(a, name).numpy(), _np(getattr(b, name)),
                                       rtol=rtol, atol=0, err_msg=name)

    pts = np.random.default_rng(2).uniform(-1, 1, (100, 3)).astype(np.float32)
    bp = jback.BackgroundParams(capacity=128)
    same(tback.create_from_points(pts, tback.BackgroundParams(capacity=128), device=CPU),
         jback.create_from_points(pts, bp))
    same(tback.reset_opacity(model_t), jback.reset_opacity(model_j), rtol=1e-6)
    same(tback.prune_near_points(model_t, 0.1, -0.2), jback.prune_near_points(model_j, 0.1, -0.2))
    same(tback.prune_near_points(model_t, 0.1, -0.2, (0.3, 0.3, -0.3), 0.5),
         jback.prune_near_points(model_j, 0.1, -0.2, (0.3, 0.3, -0.3), 0.5))
    cams = np.random.default_rng(3).uniform(-2, 2, (5, 3))
    same(tback.prune_near_cam_points(model_t, cams, (0.328, -0.04, -0.34)),
         jback.prune_near_cam_points(model_j, cams, (0.328, -0.04, -0.34)))
    same(tback.prune_large_points(model_t), jback.prune_large_points(model_j))
    rng = np.random.default_rng(4)
    xy_grad = rng.normal(size=(256, 2)).astype(np.float32)
    radii = rng.integers(0, 3, 256).astype(np.int32)
    same(tback.add_densification_stats(model_t, torch.as_tensor(xy_grad), torch.as_tensor(radii)),
         jback.add_densification_stats(model_j, jnp.asarray(xy_grad), jnp.asarray(radii)),
         rtol=1e-6)


def test_xy_offset_gradient_is_the_screen_mean_gradient():
    """The zero ``xy_offset`` leaves the render's bits alone and takes the
    gradient of the pixel-space means, the JAX package's hook."""
    cams, gt = synthetic_scene(n_cams=1, n_gauss=30)
    cam = cams[0]
    rc = dict(tile_capacity=64, chunk=16, dup_x=3, dup_y=3)
    args = [gt["means"], gt["cols"], gt["ops"], gt["scales"], gt["rots"]]
    kw = dict(tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)
    off_j = jnp.zeros((30, 2), jnp.float32)

    def loss_j(off):
        out = j_rasterize(*map(jnp.asarray, args), xy_offset=off,
                          view_matrix=jnp.asarray(cam.world_view),
                          proj_matrix=jnp.asarray(cam.full_proj), bg_color=jnp.zeros(3),
                          config=JRasterizerConfig(backend="xla", **rc), **kw)
        return (out.color ** 2).sum()

    g_j = _np(jax.grad(loss_j)(off_j))
    off_t = torch.zeros((30, 2), requires_grad=True)
    t_args = [torch.as_tensor(a) for a in args]
    tkw = dict(view_matrix=torch.as_tensor(cam.world_view), proj_matrix=torch.as_tensor(
        cam.full_proj), bg_color=torch.zeros(3), config=TRasterizerConfig(**rc), **kw)
    out = t_rasterize(*t_args, xy_offset=off_t, **tkw)
    (g_t,) = torch.autograd.grad((out.color ** 2).sum(), off_t)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-4 * np.abs(g_j).max())
    assert np.abs(g_j).max() > 0
    plain = t_rasterize(*t_args, **tkw)
    assert torch.equal(plain.color, out.color.detach())


# ------------------------------- stage-1 train -------------------------------


def _stage1_cfg(cfg, model_path=""):
    o, p = cfg.optim, cfg.pipe
    cfg.model.model_path = model_path
    o.iterations = 8
    o.densify_from_iter, o.densification_interval, o.densify_until_iter = 2, 3, 100
    o.opacity_reset_interval = 5
    o.prune_large_interval = 4
    o.percent_dense = 1e-4   # every candidate splits: the densify noise is used
    o.lambda_reg_scaling, o.scaling_reg_ratio_threshold = 0.01, 2.0   # the shipped config's ratio
    p.tile_capacity, p.chunk, p.dup_x, p.dup_y = 64, 16, 3, 3
    cfg.save_iterations = [8]
    cfg.seed = 5
    return cfg


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[step] = float(value)


def _scenes(n_pts=2000):
    cams, _ = synthetic_scene(n_cams=3, width=48, height=32, n_gauss=40)
    pcd = np.random.default_rng(1).uniform(-0.6, 0.6, (n_pts, 3)).astype(np.float32)
    norm = {"radius": 3.0, "translate": np.zeros(3)}
    jscene = JSceneInfo(point_cloud=pcd, train_cameras=cams, test_cameras=cams[:1],
                        nerf_normalization=norm)
    tcams = [TCamera(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)}) for c in cams]
    tscene = TSceneInfo(point_cloud=pcd, train_cameras=tcams, test_cameras=tcams[:1],
                        nerf_normalization=norm)
    return jscene, tscene


@pytest.mark.parametrize("threshold", [1.5e-5, 5e-5])
def test_stage1_train_matches_jax(tmp_path, monkeypatch, threshold):
    """Eight iterations of stage 1 from one seed: densify at 3 and 6, the
    opacity reset at 5, the large prune at 4 and 8. At the lower gradient
    threshold the second densify fills the capacity and drops candidates; at
    the higher one it prunes by screen size. The port's densify noise
    is the JAX package's draws (its key split once a densify). Per-step
    losses to rtol 1e-4; positions within 2 x the summed position lrs (an
    eps-1e-15 Adam step moves a coordinate with a ~0 gradient by +-lr on the
    sign alone); alive masks, slot for slot, exact. Every densify's
    candidates and clone/split choices must stand clear of their thresholds
    by 1e-3 relative, so that the exact alive masks test the port's
    arithmetic and not a rounding flip."""
    jscene, tscene = _scenes()
    bp_kw = dict(capacity=2304, position_lr_init=0.002, position_lr_final=0.0002)
    jcfg = _stage1_cfg(JConfig(), str(tmp_path / "jax"))
    jcfg.pipe.backend = "xla"
    tcfg = _stage1_cfg(TConfig(), str(tmp_path / "torch"))
    jcfg.optim.densify_grad_threshold = tcfg.optim.densify_grad_threshold = threshold
    jw, tw = _Recorder(), _Recorder()
    ref, _ = jbg.train(jcfg, jscene, jw, bg_params=jback.BackgroundParams(**bp_kw), log_every=1)

    key = jax.random.PRNGKey(tcfg.seed)
    margins = []

    def jax_noise(gen, max_new, device):
        nonlocal key
        key, sub = jax.random.split(key)
        return torch.as_tensor(_jax_draws(sub, max_new))

    real_densify = tbg.densify_and_prune

    def checked_densify(model, mu, nu, noise, thr, min_op, extent, size, pd, max_new=4096):
        g = torch.where(model.denom > 0, model.xyz_gradient_accum / model.denom, 0.0)
        margins.append(float(((g[model.alive] - thr).abs() / thr).min()))
        lim = pd * extent
        s = model.get_scaling.max(-1).values[(g >= thr) & model.alive]
        margins.append(float(((s - lim).abs() / lim).min()))
        return real_densify(model, mu, nu, noise, thr, min_op, extent, size, pd, max_new)

    monkeypatch.setattr(tbg, "densify_noise", jax_noise)
    monkeypatch.setattr(tbg, "densify_and_prune", checked_densify)
    logs = []
    got, stats = tbg.train(tcfg, tscene, tw, bg_params=tback.BackgroundParams(**bp_kw),
                           log_every=1, log=logs.append, device="cpu")

    assert [d["iteration"] for d in stats["densify"]] == [3, 6]
    assert all(d["split"] > 0 for d in stats["densify"])
    assert stats["densify"][1]["dropped" if threshold < 2e-5 else "pruned"] > 0
    assert min(margins) > 1e-3, margins
    lj = [jw.scalars["train_loss/total_loss"][i] for i in range(1, 9)]
    lt = [tw.scalars["train_loss/total_loss"][i] for i in range(1, 9)]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    np.testing.assert_array_equal([tw.scalars["points"][i] for i in range(1, 9)],
                                  [jw.scalars["points"][i] for i in range(1, 9)])
    np.testing.assert_array_equal(got.alive.numpy(), _np(ref.alive))
    lrs = [tbg.expon_lr(i, 0.002 * 3.0, 0.0002 * 3.0, lr_delay_mult=0.01, max_steps=30_000)
           for i in range(1, 9)]
    alive = _np(ref.alive)
    np.testing.assert_allclose(got.xyz.numpy()[alive], _np(ref.xyz)[alive], rtol=0,
                               atol=2 * sum(lrs))
    moved = np.abs(got.xyz.numpy()[alive] - _np(ref.xyz)[alive]).max()
    assert moved < 2 * sum(lrs)
    # the PLY of the alive rows and the camera poses, as the JAX stage writes them
    for root in ("jax", "torch"):
        assert os.path.exists(tmp_path / root / "point_cloud" / "iteration_8" / "point_cloud.ply")
    np.testing.assert_allclose(np.load(tmp_path / "torch" / "gs_all_cam_poses.npy"),
                               np.load(tmp_path / "jax" / "gs_all_cam_poses.npy"), atol=1e-12)


# -------------------------------- stage CLIs ---------------------------------


def _overrides(apply):
    """The flat {field: value} a config function changes from the defaults,
    for a --config JSON."""
    base, cfg = TConfig(), apply(TConfig())
    out = {}
    for sec in ("model", "optim", "pipe"):
        a, b = dataclasses.asdict(getattr(base, sec)), dataclasses.asdict(getattr(cfg, sec))
        out.update({k: v for k, v in b.items() if a[k] != v})
    return out


def _write_json(path, d):
    with open(path, "w") as f:
        json.dump(d, f)
    return str(path)


class _Logger(_Recorder):
    """Stands in for ``utils/tb.TrainLogger``: tensorboard may pull in a
    whole TensorFlow, which the stages do not need to be tested."""

    def __init__(self, model_path=None):
        super().__init__()

    def add_image(self, tag, img, step):
        pass


@pytest.fixture
def one_thread():
    """One intra-op thread: stage 1 always runs 120 000 Gaussians, whose
    ops torch splits over every core, and with other test workers on those
    cores each split op waits for its slowest thread (906 s against 7 s
    alone under the 6-worker tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_clis_run_in_sequence(tmp_path, monkeypatch, one_thread):
    """``train_background.main`` -> ``train_physical_particle.main`` ->
    ``future_simulation.main`` on a capture on disk, as a user runs them:
    the stage-1 PLY (its fields as the JAX package writes them), the
    ``cfg_args.json`` of each stage equal to the JAX package's
    ``dump_config`` of the same argv, stage 1's ``main`` equal to
    ``train(read_scene(cfg))``, stage 2's frame checkpoints and stage 4's
    renders. Stage 1 writes ``iteration_4`` and stages 2 and 4 read
    ``iteration_00004``: the JAX package's hand-off, kept as it is."""
    from fluidnexus_torch.core.config import parse_cli as t_parse_cli
    from fluidnexus_torch.core.ply import read_ply
    from fluidnexus_torch.data.scene import read_scene as t_read_scene
    from fluidnexus_torch.pipelines import future_simulation as tfuture
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain
    from fluidnexus_tpu.core.config import dump_config as j_dump_config
    from fluidnexus_tpu.core.config import parse_cli as j_parse_cli
    from tests.test_torch_phase_c import _small
    from tests.test_torch_readers import write_capture

    monkeypatch.setattr("fluidnexus_torch.utils.tb.TrainLogger", _Logger)
    cap = write_capture(str(tmp_path / "capture"), n_frames=2)
    bg_dir, recon, future = (str(tmp_path / n) for n in ("bg", "recon", "future"))

    def held_to_jax_dump(argv, out_dir, is_bg=False):
        jcfg = j_parse_cli(argv)
        jcfg.model.is_bg = jcfg.model.is_bg or is_bg
        j_dump_config(jcfg, str(tmp_path / "jax_cfg_args.json"))
        with open(tmp_path / "jax_cfg_args.json") as f, \
                open(os.path.join(out_dir, "cfg_args.json")) as g:
            assert json.load(g) == json.load(f)

    stage1 = _write_json(tmp_path / "stage1.json", dict(
        iterations=4, save_iterations=[4], init_pcd_bg=True, train_views="01234", duration=1,
        tile_capacity=64, chunk=16, dup_x=3, dup_y=3, densify_from_iter=1,
        densification_interval=2, opacity_reset_interval=3, prune_large_interval=4))
    argv1 = ["--config", stage1, "--data_path", cap, "--model_path", bg_dir]
    model, stats = tbg.main(argv1, device="cpu")
    held_to_jax_dump(argv1, bg_dir, is_bg=True)
    cfg1 = t_parse_cli(argv1)
    cfg1.model.is_bg, cfg1.model.model_path = True, str(tmp_path / "bg_again")
    again, _ = tbg.train(cfg1, t_read_scene(cfg1), log=lambda *a: None, device="cpu")
    for name in tback.BackgroundModel._fields:
        assert torch.equal(getattr(model, name), getattr(again, name)), name
    assert [d["iteration"] for d in stats["densify"]] == [2, 4]
    ply = os.path.join(bg_dir, "point_cloud", "iteration_4", "point_cloud.ply")
    fields = read_ply(ply)
    assert list(fields) == (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
                            + [f"f_rest_{i}" for i in range(3)] + ["opacity"]
                            + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
                            + [f"color_{i}" for i in range(3)])
    assert len(fields["x"]) == int(model.num_alive)
    assert os.path.exists(os.path.join(bg_dir, "gs_all_cam_poses.npy"))
    os.symlink("iteration_4", os.path.join(bg_dir, "point_cloud", "iteration_00004"))

    def recon_cfg(cfg):
        cfg = _small(cfg)
        cfg.model.train_views, cfg.model.duration = "0134", 2
        return cfg

    stage2 = _write_json(tmp_path / "stage2.json", _overrides(recon_cfg))
    argv2 = ["--config", stage2, "--data_path", cap, "--model_path", recon, "--bg_load_path",
             bg_dir, "--bg_load_iteration", "4"]
    result = ttrain.main(argv2, device="cpu")
    held_to_jax_dump(argv2, recon)
    assert [m["frame"] for m in result["metrics"]] == [1]
    assert all(np.isfinite(m["loss"]) for m in result["metrics"])
    ckpt = os.path.join(recon, "checkpoint")
    assert any(f.startswith("frame_001_") for f in os.listdir(ckpt))

    def future_cfg(cfg):
        cfg = recon_cfg(cfg)
        cfg.optim.future_pred_frames, cfg.optim.solver_iterations_future = 2, 2
        return cfg

    stage4 = _write_json(tmp_path / "stage4.json", _overrides(future_cfg))
    argv4 = ["--config", stage4, "--data_path", cap, "--load_path", recon, "--model_path", future,
             "--bg_load_path", bg_dir, "--bg_load_iteration", "4"]
    frames = tfuture.main(argv4, device="cpu")
    held_to_jax_dump(argv4, future)
    assert [f["frame"] for f in frames] == [2, 3]
    renders = os.listdir(os.path.join(future, "training_render"))
    assert len(renders) == 2 * 5 and all(np.isfinite(f["p_ratio"]) for f in frames)
