"""The reconstruction's camera data parallelism (``pipe.dp``) in the port on
two gloo ranks of this host: the phase-A and phase-C fit steps with their
camera batch split over the 'data' group, against the same steps on one
rank and the JAX package's step (whose own sharded step
tests/test_recon_dp.py holds to it), and ``fit_first_frame`` at ``pipe.dp``
2 against one rank. One process group serves the file: a module fixture
starts the two ranks once; each test reads its case.

Tolerances: against one rank those of tests/test_recon_dp.py (loss ``rtol``
1e-5, positions ``atol`` 1e-6); against JAX those of the port's own
cross-package step tests (tests/test_torch_phase_c.py,
tests/test_torch_fit_first_frame.py): losses 1e-4 relative, positions to
the Adam bound (eps 1e-15 moves a ~0 gradient by +-lr on its sign)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.core.optim import adam_init as j_adam_init
from fluidnexus_tpu.data.scene import cameras_by_time as j_cameras_by_time
from fluidnexus_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.pipelines import train_physical_particle as ttrain
from tests.test_torch_fit_first_frame import _port_scene
from tests.test_torch_phase_c import _caps, _jax_raster, _small, _start_state
from tests.test_train_physical import smoke_like_scene
from tests.torch_dist_ranks import ok, spawn
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

DP = 2
BATCHES = [2, 3, 2]      # camera batch a step; 3 pads to 4 with a zero-weight slot
LR = np.float32(2e-4)
CASES = "tests.torch_parallel_cases."


def _sels():
    rng = np.random.default_rng(0)
    return [ttrain._select_batch(rng, 3, b, DP) for b in BATCHES]


def _phase_c_setup():
    """The JAX start state of tests/test_torch_phase_c.py and frame 1's
    cameras, for both packages; nn 0.3 scaled units off the estimates."""
    jcfg, tcfg = _small(JConfig()), _small(TConfig())
    params_j, st_j, vis_j, attrs_j = _start_state(jcfg)
    scene = smoke_like_scene()
    cams_j = j_cameras_by_time(scene.train_cameras)[1]
    cams_t = [c for c in _port_scene(scene).train_cameras if c.time_idx == 1]
    nn0 = (np.asarray(st_j.estimate_xyz) / 100.0 + 0.003 * np.random.default_rng(2).normal(
        size=st_j.estimate_xyz.shape)).astype(np.float32)
    w, h = cams_j[0].width, cams_j[0].height
    port = dict(raster=ttrain.raster_config_from(tcfg), w=w, h=h,
                params=_caps(ttrain.pbf_params_from_config(tcfg)), optim=tcfg.optim,
                state=convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu"),
                visual=convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), "cpu"),
                attrs=convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), "cpu"),
                cams=ttrain._cam_tensors(cams_t, "cpu"), gts=ttrain._gts(cams_t, 3, "cpu"),
                x0=torch.as_tensor(nn0))
    jax_side = dict(cfg=jcfg, params=params_j, state=st_j, visual=vis_j, attrs=attrs_j,
                    cams=jtrain._cam_tensors(cams_j), gts=jtrain._gts(cams_j, 3), x0=nn0, w=w,
                    h=h)
    return port, jax_side


def _phase_a_setup():
    """Frame 0's cameras and a visual column, for both packages."""
    cfg = _small(JConfig())
    o, m = cfg.optim, cfg.model
    scene = smoke_like_scene()
    cams_j = j_cameras_by_time(scene.train_cameras)[0]
    cams_t = [c for c in _port_scene(scene).train_cameras if c.time_idx == 0]
    pts = jdyn.create_visual_points(m, np.random.default_rng(5))
    vis_j = j_make_visual_state(m.visual_capacity, jnp.asarray(pts))
    attrs_j = jdyn.constant_visual_attrs(m.visual_capacity, channels=1)
    vis_t = convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), "cpu")
    w, h = cams_j[0].width, cams_j[0].height
    lambdas = (o.lambda_dssim, o.lambda_first_distance, o.distance_threshold_visual)
    port = dict(raster=ttrain.raster_config_from(_small(TConfig())), w=w, h=h, lambdas=lambdas,
                alive=vis_t.alive, x0=vis_t.xyz,
                attrs=convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), "cpu"),
                cams=ttrain._cam_tensors(cams_t, "cpu"), gts=ttrain._gts(cams_t, 3, "cpu"))
    jax_side = dict(visual=vis_j, attrs=attrs_j, cams=jtrain._cam_tensors(cams_j),
                    gts=jtrain._gts(cams_j, 3), w=w, h=h, lambdas=lambdas)
    return port, jax_side


def _fit_cfg(dp):
    cfg = _small(TConfig())
    cfg.seed, cfg.optim.batch, cfg.pipe.dp = 3, 3, dp
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    sels = _sels()
    setups = {"a": _phase_a_setup(), "c": _phase_c_setup()}
    scene = _port_scene(smoke_like_scene())
    cases = [(f"step_{k}", CASES + "recon_steps",
              dict(kind=k, setup=setups[k][0], sels=sels, lr=float(LR), dp=DP)) for k in "ac"]
    cases.append(("fit_first_frame", CASES + "recon_fit_first_frame",
                  dict(cfg=_fit_cfg(DP), scene=scene)))
    results = spawn(DP, cases, str(tmp_path_factory.mktemp("recon_dp")), timeout=180)
    return dict(results=results, sels=sels, setups=setups, scene=scene)


def _jax_steps(kind, j, sels):
    """The JAX package's single-device step at the same batches."""
    out = []
    if kind == "a":
        rc = JRasterizerConfig(backend="xla", tile_capacity=64, chunk=16, dup_x=3, dup_y=3)
        step = jtrain.make_first_frame_step(None, rc, j["w"], j["h"], *j["lambdas"], 3)
        x, opt = j["visual"].xyz, j_adam_init({"xyz": j["visual"].xyz})
        for sel, w, inv_w in sels:
            x, opt, loss, l1 = step(x, j["visual"].alive, j["attrs"], opt,
                                    tuple(c[sel] for c in j["cams"]), j["gts"][sel], LR, w, inv_w)
            out.append({"x": np.asarray(x), "loss": float(loss), "aux": {"l1": float(l1)}})
    else:
        cfg = j["cfg"]
        step = jtrain.make_current_frame_step(None, _jax_raster(cfg), j["w"], j["h"], j["params"],
                                              cfg.optim, 3)
        x = jnp.asarray(j["x0"])
        opt = j_adam_init({"nn": x})
        for sel, w, inv_w in sels:
            x, opt, loss, aux = step(x, opt, j["state"], j["visual"], j["attrs"],
                                     tuple(c[sel] for c in j["cams"]), j["gts"][sel], LR, w,
                                     inv_w)
            out.append({"x": np.asarray(x), "loss": float(loss),
                        "aux": {k: float(v) for k, v in aux.items()}})
    return out


@pytest.mark.parametrize("kind", ["a", "c"], ids=["phase_a", "phase_c"])
def test_fit_steps_at_dp2_match_one_rank_and_jax(world, kind):
    """Three steps, the second on a batch of 3 cameras padded to 4 (its
    zero-weight slot on rank 1): loss, each aux term and the positions on
    both ranks, against one rank and JAX."""
    from tests.torch_parallel_cases import recon_steps

    port, j = world["setups"][kind]
    one = recon_steps(kind, port, world["sels"], float(LR), 1)
    ref = _jax_steps(kind, j, world["sels"])
    assert [float(w.sum()) for _, w, _ in world["sels"]] == [2.0, 3.0, 2.0]
    assert [len(s) for s, _, _ in world["sels"]] == [2, 4, 2]
    for r in range(DP):
        got = ok(world["results"][f"step_{kind}"], r)
        for it, (g, o, f) in enumerate(zip(got, one, ref), 1):
            np.testing.assert_allclose(g["loss"], o["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["loss"], f["loss"], rtol=1e-4)
            assert set(g["aux"]) == set(f["aux"])
            for k in g["aux"]:
                np.testing.assert_allclose(g["aux"][k], o["aux"][k], rtol=1e-5, err_msg=k)
                np.testing.assert_allclose(g["aux"][k], f["aux"][k], rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(g["x"], o["x"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(g["x"], f["x"], rtol=0, atol=2 * it * float(LR))
    moved = np.abs(got[-1]["x"] - port["x0"].numpy()).max()
    assert moved > 0.5 * float(LR)


def test_fit_first_frame_at_pipe_dp2_matches_one_rank(world):
    """Phase A through ``fit_first_frame`` with ``pipe.dp`` 2 (its own mesh
    of the two ranks; the batch of 3 padded to 4) against ``pipe.dp`` 1."""
    visual, _, losses = ttrain.fit_first_frame(_fit_cfg(1), world["scene"],
                                               log=lambda *a: None, device="cpu")
    for r in range(DP):
        got = ok(world["results"]["fit_first_frame"], r)
        np.testing.assert_allclose(got["losses"], losses.numpy(), rtol=1e-5)
        # positions are x100 after phase A
        np.testing.assert_allclose(got["xyz"], visual.xyz.numpy(), rtol=0, atol=100 * 1e-6)


def test_pipe_dp_raises_without_its_ranks():
    """``pipe.dp`` 2 on one process raises the JAX package's error before
    any step: no process group, no fall back to one device."""
    with pytest.raises(ValueError, match=r"^--dp 2 but only 1 devices visible$"):
        ttrain.fit_first_frame(_fit_cfg(2), _port_scene(smoke_like_scene()),
                               log=lambda *a: None, device="cpu")
    assert not torch.distributed.is_initialized()
