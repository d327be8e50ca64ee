"""Phase C of the reconstruction in the port against the JAX package, on the
CPU: emission into dead slots and the emitters, the phase-C fit step, the
whole ``_phase_c`` from one converted state with its npy checkpoints, and the
port's ``train`` A -> B -> C with ``resume_from_frame``.

On the CPU the JAX step and ``_phase_c`` take the padded top-K paths of the
gas density and the splat (``dense`` is on only for the TPU: sim/pbf.py
:306-307, 344-345, 471-472), while the port always runs the dense pair sums.
The two agree where ``knn_k`` covers every neighbourhood, every particle lies
inside the padded grid's box (32 cells of h, 64 scaled units at h = 2) and no
cell of that grid exceeds ``cell_capacity``. The pillar here is therefore
0.4 units tall (40 scaled units, with the emitter layer 11 below it), unlike
phase B's 90-unit pillar (tests/test_torch_phase_b.py), which shows the
box-edge kill on purpose."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.core.config import load_config as j_load_config
from fluidnexus_tpu.core.optim import adam_init as j_adam_init
from fluidnexus_tpu.data.scene import cameras_by_time as j_cameras_by_time
from fluidnexus_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_tpu.sim import state as jstate
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.core.config import load_config as t_load_config
from fluidnexus_torch.core.optim import adam_init as t_adam_init
from fluidnexus_torch.pipelines import train_physical_particle as ttrain
from fluidnexus_torch.sim import state as tstate
from fluidnexus_torch.splat import dynamics as tdyn
from tests.test_torch_fit_first_frame import _port_scene
from tests.test_train_physical import smoke_like_scene
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x)


def _small(cfg):
    """A 0.02-radius pillar over y 0..0.4 (inside the padded grid's box),
    200 visual particles, 3 fit iterations a frame, every loss term on."""
    o, m, p = cfg.optim, cfg.model, cfg.pipe
    m.hidden_capacity, m.visual_capacity = 2048, 1024
    m.init_hidden_radius_max, m.init_hidden_y_min, m.init_hidden_y_max = 0.02, 0.0, 0.4
    m.init_visual_num_pts, m.init_thick_visual_num_pts = 150, 50
    m.init_visual_y_min, m.init_visual_y_thick_min, m.init_visual_y_max = 0.0, 0.1, 0.4
    o.iterations_per_time_first = 2
    o.iterations_per_time_current = o.iterations_per_time_current_max = 3
    o.stable_iterations, o.solver_iterations = 2, 3
    o.alpha, o.init_hidden_velocity, o.min_neighbors = 0.0, 100.0, 1
    o.emit_ratio_hidden = o.emit_ratio_visual = 1.0
    o.extra_visual_ratio, o.extra_visual_y_min = 0.05, 0.2
    o.batch = 2
    o.lambda_current_distance, o.lambda_exyz = 0.1, 0.1
    o.lambda_gas_constraints, o.lambda_next_gas_constraints = 1.0, 0.1
    p.tile_capacity, p.chunk, p.dup_x, p.dup_y = 64, 16, 3, 3
    return cfg


def _caps(params, cell_capacity=32):
    return dataclasses.replace(params, dense_max_cells=512, dense_cell_capacity=cell_capacity)


def _jax_raster(cfg):
    p = cfg.pipe
    return JRasterizerConfig(tile_capacity=p.tile_capacity, tile_x=p.tile_x, tile_y=p.tile_y,
                             dup_x=p.dup_x, dup_y=p.dup_y, chunk=p.chunk, backend="xla")


def _start_state(cfg, seed=0, cell_capacity=32):
    """A JAX hidden state on the small pillar (one stable guess moved the
    estimates; random imass), the visual column x100 and its attrs, as
    numpy-backed JAX trees."""
    o, m = cfg.optim, cfg.model
    rng = np.random.default_rng(seed)
    params = _caps(jtrain.pbf_params_from_config(cfg), cell_capacity)
    pts = jdyn.create_hidden_points(m)
    st = jstate.make_particle_state(m.hidden_capacity, jnp.asarray(pts),
                                    init_velocity_y=o.init_hidden_velocity)
    st = jtrain.guess_hidden(st, params, stable=True)
    n = m.hidden_capacity
    st = st._replace(imass=jnp.asarray((0.9 + 0.2 * rng.random(n)).astype(np.float32)),
                     force=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)))
    vis = jstate.make_visual_state(m.visual_capacity,
                                   jnp.asarray(jdyn.create_visual_points(m, rng) * 100.0))
    attrs = jdyn.constant_visual_attrs(m.visual_capacity, channels=1)
    return params, st, vis, attrs


# ------------------------------- emission -------------------------------------


@pytest.mark.parametrize("n_dead,n_new", [(40, 25), (10, 25)])
def test_emit_into_dead_slots_matches_jax(n_dead, n_new):
    """Lowest dead slots first, candidates in order, the mask's holes
    skipped, and what does not fit dropped (n_dead 10 < 25 candidates)."""
    rng = np.random.default_rng(n_dead)
    cap = 64
    st = jstate.make_particle_state(cap, jnp.asarray(rng.normal(size=(cap, 3)).astype(np.float32)))
    alive = np.ones(cap, bool)
    alive[rng.choice(cap, n_dead, replace=False)] = False
    st = st._replace(alive=jnp.asarray(alive))
    new = rng.normal(size=(n_new, 3)).astype(np.float32)
    mask = rng.random(n_new) > 0.2
    extra = {"imass": rng.random(n_new).astype(np.float32)}
    ref, ref_drop = jstate.emit_into_dead_slots(st, jnp.asarray(new), jnp.asarray(mask),
                                                {k: jnp.asarray(v) for k, v in extra.items()})
    got, got_drop = tstate.emit_into_dead_slots(
        convert.particle_state_from_numpy(jax.tree.map(np.asarray, st), device=CPU),
        torch.as_tensor(new), torch.as_tensor(mask), {k: torch.as_tensor(v) for k, v in extra.items()})
    assert int(got_drop) == int(ref_drop)
    if n_dead < mask.sum():
        assert int(got_drop) > 0
    for name, a, b in zip(got._fields, convert.particle_state_to_numpy(got), ref):
        np.testing.assert_array_equal(a, _np(b), err_msg=name)
    vis = jstate.make_visual_state(cap, jnp.asarray(new[:5]))
    vref, _ = jstate.emit_into_dead_slots(vis, jnp.asarray(new), jnp.asarray(mask))
    vgot, _ = tstate.emit_into_dead_slots(convert.visual_state_from_numpy(vis, device=CPU),
                                          torch.as_tensor(new), torch.as_tensor(mask))
    np.testing.assert_array_equal(vgot.xyz.numpy(), _np(vref.xyz))
    np.testing.assert_array_equal(vgot.alive.numpy(), _np(vref.alive))


def test_emitters_and_plans_match_jax():
    """EmitterPoints, plan_emission (whole and fractional ratios),
    plan_extra_visual and pad_emission (cut at its cap) from generators of
    one seed, and the generators left in the same state."""
    jc, tc = JConfig(), TConfig()
    je, te = jdyn.EmitterPoints.from_config(jc.model), tdyn.EmitterPoints.from_config(tc.model)
    for name in ("hidden", "visual"):
        assert len(getattr(te, name)) > 0
        np.testing.assert_array_equal(getattr(te, name), getattr(je, name), err_msg=name)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for ratio in (1.0, 1.32, 0.4, 0.0):
        np.testing.assert_array_equal(tdyn.plan_emission(te.visual, ratio, rt),
                                      jdyn.plan_emission(je.visual, ratio, rj))
    xyz = np.random.default_rng(1).uniform(0, 40, (300, 3)).astype(np.float32)
    alive = np.arange(300) < 250
    for ratio, num, min_num in ((0.1, 0, 0), (0.0, 7, 0), (0.01, 5, 12)):
        a = tdyn.plan_extra_visual(xyz, alive, ratio, num, 0.16, min_num, 0.004, rt)
        b = jdyn.plan_extra_visual(xyz, alive, ratio, num, 0.16, min_num, 0.004, rj)
        assert len(a) > 0
        np.testing.assert_array_equal(a, b)
    assert rt.random() == rj.random()
    for cap in (10, 400):
        for a, b in zip(tdyn.pad_emission(xyz, cap), jdyn.pad_emission(xyz, cap)):
            np.testing.assert_array_equal(a, b)


def test_emit_hidden_and_visual_match_jax():
    """emit_hidden: fresh ids, velocity, buoyancy, force, imass, ALL counts
    zeroed, next_id advanced by the mask; emit_visual into dead slots."""
    cfg = JConfig()
    rng = np.random.default_rng(6)
    cap = 96
    st = jstate.make_particle_state(cap, jnp.asarray(rng.normal(size=(60, 3)).astype(np.float32)),
                                    init_velocity_y=3.0)
    st = st._replace(counts=jnp.full((cap,), 4.0), alive=st.alive.at[jnp.asarray([2, 7])].set(False))
    em = jdyn.EmitterPoints.from_config(cfg.model)
    plan, mask = jdyn.pad_emission(jdyn.plan_emission(em.hidden, 1.0, rng), 48)
    ref = jdyn.emit_hidden(st, plan, 100.0, -0.2, mask=mask)
    got = tdyn.emit_hidden(convert.particle_state_from_numpy(jax.tree.map(np.asarray, st), CPU),
                           plan, 100.0, -0.2, mask=mask)
    for name, a, b in zip(got._fields, convert.particle_state_to_numpy(got), ref):
        np.testing.assert_array_equal(a, _np(b), err_msg=name)
        assert a.dtype == _np(b).dtype, name
    vis = jstate.make_visual_state(64, jnp.asarray(rng.normal(size=(30, 3)).astype(np.float32)))
    vplan, vmask = jdyn.pad_emission(rng.normal(size=(50, 3)).astype(np.float32), 40)
    vref = jdyn.emit_visual(vis, vplan, mask=vmask)
    vgot = tdyn.emit_visual(convert.visual_state_from_numpy(vis, CPU), vplan, mask=vmask)
    np.testing.assert_array_equal(vgot.xyz.numpy(), _np(vref.xyz))
    np.testing.assert_array_equal(vgot.alive.numpy(), _np(vref.alive))


@pytest.mark.parametrize("max_y", [0.0, 0.5])
def test_guess_from_nn_matches_jax(max_y):
    """The next-step positions of the next-gas loss, with and without the
    height-scaled buoyancy."""
    from fluidnexus_tpu.sim import pbf as jpbf
    from fluidnexus_torch.sim import pbf as tpbf

    rng = np.random.default_rng(8)
    st = jstate.make_particle_state(64, jnp.asarray(rng.uniform(0, 40, (50, 3)).astype(np.float32)))
    st = st._replace(buoyancy=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
                     force=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)))
    nn = (_np(st.xyz) / 100.0 + 0.01 * rng.normal(size=(64, 3))).astype(np.float32)
    ref = jpbf.guess_from_nn(jnp.asarray(nn), st, jpbf.PBFParams(buoyancy_max_y=max_y))
    got = tpbf.guess_from_nn(torch.as_tensor(nn),
                             convert.particle_state_from_numpy(jax.tree.map(np.asarray, st), CPU),
                             tpbf.PBFParams(buoyancy_max_y=max_y))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-5)


# ------------------------------ the fit step ---------------------------------


def test_current_frame_step_matches_jax():
    """Loss, each aux term and nn after 1 and 3 steps, to 1e-4 relative
    (nn to the Adam bound: eps 1e-15 moves a ~0 gradient by +-lr)."""
    jcfg, tcfg = _small(JConfig()), _small(TConfig())
    o = jcfg.optim
    params_j, st_j, vis_j, attrs_j = _start_state(jcfg)
    params_t = _caps(ttrain.pbf_params_from_config(tcfg))
    st_t = convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), CPU)
    vis_t = convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), CPU)
    attrs_t = convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), CPU)
    scene = smoke_like_scene()
    cams_j = j_cameras_by_time(scene.train_cameras)[1]
    cams_t = [c for c in _port_scene(scene).train_cameras if c.time_idx == 1]
    w, h = cams_j[0].width, cams_j[0].height
    step_j = jtrain.make_current_frame_step(None, _jax_raster(jcfg), w, h, params_j, o, 3)
    step_t = ttrain.make_current_frame_step(None, ttrain.raster_config_from(tcfg), w, h,
                                            params_t, tcfg.optim, 3)
    cj, gts_j = jtrain._cam_tensors(cams_j), jtrain._gts(cams_j, 3)
    ct, gts_t = ttrain._cam_tensors(cams_t, CPU), ttrain._gts(cams_t, 3, CPU)
    # nn starts 0.3 scaled units off the estimates, so exyz is no rounding noise
    nn0 = (_np(st_j.estimate_xyz) / 100.0
           + 0.003 * np.random.default_rng(2).normal(size=st_j.estimate_xyz.shape))
    nn_j, nn_t = jnp.asarray(nn0.astype(np.float32)), torch.as_tensor(nn0.astype(np.float32))
    opt_j, opt_t = j_adam_init({"nn": nn_j}), t_adam_init({"nn": nn_t})
    rng = np.random.default_rng(0)
    lr, steps = np.float32(2e-4), 3
    for it in range(1, steps + 1):
        sel, wt, inv_w = ttrain._select_batch(rng, len(cams_j), o.batch, 1)
        nn_j, opt_j, l_j, aux_j = step_j(nn_j, opt_j, st_j, vis_j, attrs_j,
                                         tuple(c[sel] for c in cj), gts_j[sel], lr, wt, inv_w)
        st = torch.as_tensor(sel)
        nn_t, opt_t, l_t, aux_t = step_t(nn_t, opt_t, st_t, vis_t, attrs_t,
                                         tuple(c[st] for c in ct), gts_t[st], float(lr),
                                         torch.as_tensor(wt), torch.as_tensor(inv_w))
        if it in (1, 3):
            np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
            assert set(aux_t) == set(aux_j) == {"l1", "exyz", "gas", "next_gas"}
            for key in aux_j:
                np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-4,
                                           err_msg=key)
            np.testing.assert_allclose(nn_t.numpy(), _np(nn_j), rtol=0,
                                       atol=2 * it * float(lr))
    assert float(aux_t["gas"]) > 0 and float(aux_t["next_gas"]) > 0
    moved = np.abs(nn_t.numpy() - nn0)[st_t.alive.numpy()]
    assert moved.max() > 0.5 * float(lr)


# --------------------------------- _phase_c ---------------------------------


def _frame_files(path, t):
    return sorted(f for f in os.listdir(path) if f.startswith(f"frame_{t:03d}_"))


def _run_phase_c(tmp_path, jcfg, tcfg, scene, cell_capacity=32):
    """``_phase_c`` over frames 1-2 from one converted state and one seed in
    both packages, each writing its per-frame npy checkpoints under
    ``tmp_path``. Returns (port's result, JAX's result, the JAX start
    state)."""
    params_j, st_j, vis_j, attrs_j = _start_state(jcfg, seed=1, cell_capacity=cell_capacity)
    params_t = _caps(ttrain.pbf_params_from_config(tcfg), cell_capacity)
    ref = jtrain._phase_c(jcfg, scene, st_j, vis_j, attrs_j, None, _jax_raster(jcfg), params_j,
                          np.random.default_rng(7), None, lambda *a: None,
                          str(tmp_path / "jax"), start_frame=1)
    logs = []
    got = ttrain._phase_c(tcfg, _port_scene(scene),
                          convert.particle_state_from_numpy(jax.tree.map(np.asarray, st_j), CPU),
                          convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), CPU),
                          convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), CPU),
                          None, ttrain.raster_config_from(tcfg), params_t,
                          np.random.default_rng(7), None, logs.append, str(tmp_path / "torch"),
                          start_frame=1)
    assert [m["frame"] for m in got["metrics"]] == [1, 2]
    assert any("emitted" in line for line in logs)
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert (a["hidden"], a["visual"]) == (b["hidden"], b["visual"])
    assert got["metrics"][1]["visual"] > got["metrics"][0]["visual"] > int(vis_j.alive.sum())
    return got, ref, st_j


def _check_checkpoints(tmp_path, jcfg, t, rows=None):
    """Frame ``t``'s npy checkpoints of both packages: positions (saved in
    world units) to 1e-4 scaled units; the velocity dx / secs to that over
    secs, the drag force (k v (1 - p_ratio) over the solver iterations) to k
    x iterations times that; the rest exactly. With ``rows`` (checkpoint name
    -> row mask, or None), the toleranced arrays are held on those rows
    alone, or not at all."""
    secs, k, iters = 0.033, jcfg.optim.k, jcfg.optim.solver_iterations
    tol = {"xyz": 1e-6, "velocity": 1e-4 / secs, "force": 1e-4 / secs * k * iters}
    names = _frame_files(tmp_path / "jax", t)
    assert names == _frame_files(tmp_path / "torch", t) and len(names) == 15
    for name in names:
        a = tmp_path / "torch" / name
        b = tmp_path / "jax" / name
        if name.endswith(".json"):
            assert a.read_text() == b.read_text(), name
            continue
        x, y = np.load(a), np.load(b)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        key = next((key for key in tol if key in name), None)
        if key is None:
            np.testing.assert_array_equal(x, y, err_msg=name)
            continue
        if rows is not None:
            keep = rows(name)
            if keep is None:
                continue
            x, y = x[keep], y[keep]
        np.testing.assert_allclose(x, y, rtol=0, atol=tol[key], err_msg=name)


def _phase_c_parity(tmp_path, jcfg, tcfg, scene, cell_capacity=32):
    """``_run_phase_c``, then per-frame loss (1e-4 relative), alive counts
    (exact) and every row of the per-frame npy checkpoints
    (``_check_checkpoints``: positions within the Adam bound)."""
    got, ref, _ = _run_phase_c(tmp_path, jcfg, tcfg, scene, cell_capacity)
    for a, b in zip(got["metrics"], ref["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    for t in (1, 2):
        _check_checkpoints(tmp_path, jcfg, t)
    return got


def test_phase_c_matches_jax(tmp_path):
    """``_phase_c`` over frames 1-2 x 3 iterations at ``_small``'s settings."""
    _phase_c_parity(tmp_path, _small(JConfig()), _small(TConfig()), smoke_like_scene())


def _gm_fluid(load_config):
    """configs/scalar_dynamics.json's optimisation and model settings, the
    ScalarReal configuration (``gm_fluid``: no background, gray images; emit
    ratios 1.61, alpha -3, buoyancy_max_y 0.8, its lambdas, thresholds and
    batch 1), at ``_small``'s sizes: its capacities, pillar, raster caps and
    iterations (3 a frame, 2 stable ticks of 3 Jacobi iterations)."""
    cfg = load_config(os.path.join(REPO, "configs", "scalar_dynamics.json"))
    o, m, p = cfg.optim, cfg.model, cfg.pipe
    m.hidden_capacity, m.visual_capacity = 2048, 1024
    m.init_hidden_radius_max, m.init_hidden_y_min, m.init_hidden_y_max = 0.02, 0.0, 0.4
    m.init_visual_num_pts, m.init_thick_visual_num_pts = 150, 50
    m.init_visual_y_min, m.init_visual_y_thick_min, m.init_visual_y_max = 0.0, 0.1, 0.4
    o.iterations_per_time_first = 2
    o.iterations_per_time_current = o.iterations_per_time_current_max = 3
    o.stable_iterations, o.solver_iterations = 2, 3
    p.tile_capacity, p.chunk, p.dup_x, p.dup_y = 64, 16, 3, 3
    return cfg


def _gray_scene():
    """``smoke_like_scene`` with its frames as the ScalarReal reader gives
    them under ``gray_image``: float32 (H, W)."""
    scene = smoke_like_scene()
    for c in scene.train_cameras:
        c.image = c.image_real = np.ascontiguousarray(c.image[..., 0])
    return scene


# 1.61 emits the emitter lattice once and 61 % of it again onto itself, so
# emissions pile visual particles into the emitter's cells of h. The port's
# dense splat bins the visual particles into query cells of
# dense_cell_capacity (32 by default) and leaves those past it unmoved, as
# the JAX package's dense (TPU) branch does; the JAX package's CPU branch,
# the reference here, has no such cap (tests/test_torch_gas_splat.py,
# ``test_queries_past_a_cells_capacity_stay_still_as_in_the_dense_branch``).
# So the runs at 1.61 give the query cells 64 slots.
NO_QUERY_DROPS = 64


def test_phase_c_gm_fluid_matches_jax(tmp_path):
    """The same harness at the ScalarReal configuration (``_gm_fluid``) on
    gray frames, with its own visual emission ratio of 1.61: its buoyancy,
    alpha, thresholds, lambdas, batch and visual emission reach both
    packages' phase C alike. The hidden emission runs at a ratio of 1 here:
    above 1 its coincident particles part the packages by rounding in the
    solver tick (``test_phase_c_gm_fluid_parts_only_near_hidden_duplicates``)."""
    jcfg, tcfg = _gm_fluid(j_load_config), _gm_fluid(t_load_config)
    assert jcfg.model.gray_image and tcfg.model.model == "gm_fluid"
    assert (tcfg.optim.alpha, tcfg.optim.buoyancy_max_y, tcfg.optim.emit_ratio_hidden,
            tcfg.optim.emit_ratio_visual, tcfg.optim.batch) == (-3.0, 0.8, 1.61, 1.61, 1)
    for o in (jcfg.optim, tcfg.optim):
        o.emit_ratio_hidden = 1.0
    got = _phase_c_parity(tmp_path, jcfg, tcfg, _gray_scene(), cell_capacity=NO_QUERY_DROPS)
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])


def _hidden_duplicate_ids(plans, emitters, next_id):
    """Particle ids of the hidden candidates that share their position with
    another candidate of their frame's plan: ``emit_hidden`` numbers a
    plan's rows from the state's ``next_id`` on, in order."""
    ids = []
    for points, plan in plans:
        if not np.array_equal(points, emitters.hidden):
            continue
        _, inv, cnt = np.unique(plan, axis=0, return_inverse=True, return_counts=True)
        ids.append(next_id + np.flatnonzero(cnt[inv.ravel()] > 1))
        next_id += len(plan)
    return np.concatenate(ids)


@pytest.mark.parametrize("lambda_image", [1.0, 0.0])
def test_phase_c_gm_fluid_parts_only_near_hidden_duplicates(tmp_path, monkeypatch, lambda_image):
    """``_gm_fluid`` at both of its emission ratios of 1.61. The hidden
    duplicates part the packages in the solver tick
    (``test_hidden_emission_over_one_parts_the_packages_only_at_its_duplicates``),
    and with them the loss, a sum over every particle, so the loss is not
    held here. Alive counts are held exactly, and so is every untoleranced
    array on every row. Every hidden and visual particle farther than 1.5 h
    from a hidden duplicate is held at ``_check_checkpoints``' tolerances
    after frame 1. In frame 2 the emitted layer's difference reaches the
    pillar through the image loss, whose pixels and SSIM windows the two
    share, so with that term the far particles are held after frame 1 alone;
    without it (``lambda_image`` 0) they are held after frame 2 too."""
    plans = []
    real_plan = jtrain.plan_emission

    def plan_emission(points, *a, **kw):
        plans.append((points, real_plan(points, *a, **kw)))
        return plans[-1][1]

    monkeypatch.setattr(jtrain, "plan_emission", plan_emission)
    jcfg, tcfg = _gm_fluid(j_load_config), _gm_fluid(t_load_config)
    for o in (jcfg.optim, tcfg.optim):
        o.lambda_image = lambda_image
    got, _, st_j = _run_phase_c(tmp_path, jcfg, tcfg, _gray_scene(),
                                cell_capacity=NO_QUERY_DROPS)
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    dup_ids = _hidden_duplicate_ids(plans, jdyn.EmitterPoints.from_config(jcfg.model),
                                    int(st_j.next_id))
    assert len(dup_ids) == 2 * 88
    reach = 1.5 * float(_caps(ttrain.pbf_params_from_config(tcfg)).h) / 100.0
    for t in (1, 2):
        ids = np.load(tmp_path / "jax" / f"frame_{t:03d}_particle_id.npy").ravel()
        xyz = np.load(tmp_path / "jax" / f"frame_{t:03d}_xyz.npy")
        vxyz = np.load(tmp_path / "jax" / f"frame_{t:03d}_visual_xyz.npy")
        dups = xyz[np.isin(ids, dup_ids)]
        assert len(dups) == 88 * t

        def far(pos):
            return np.linalg.norm(pos[:, None] - dups[None], axis=-1).min(1) > reach

        far_hidden, far_visual = far(xyz), far(vxyz)
        assert far_hidden.mean() > 0.7 and far_visual.mean() > 0.7
        held = t == 1 or lambda_image == 0.0

        def rows(name):
            if not held:
                return None
            return far_visual if "visual" in name else far_hidden

        _check_checkpoints(tmp_path, jcfg, t, rows)


def test_hidden_emission_over_one_parts_the_packages_only_at_its_duplicates():
    """At configs/scalar_dynamics.json's emit_ratio_hidden of 1.61 both
    packages plan the same candidates (the emitter lattice once and 61 % of
    it again, as the reference's emit_new_particles does), so 44 of the 117
    sit on another. A solver tick's spiky gradient between two coincident
    particles has no direction (x_i - x_j = 0), and each package forms it
    from sums whose rounding, at rlen = sqrt(eps) where its coefficient is
    ~9 000, pushes the pair apart: duplicates leave the tick apart, in each
    package in its own directions. Alive counts agree, and every particle
    farther than h from a duplicate agrees to 1e-5 scaled units."""
    from fluidnexus_tpu.sim import pbf as jpbf

    jcfg, tcfg = _gm_fluid(j_load_config), _gm_fluid(t_load_config)
    o = jcfg.optim
    params_j, st_j, _, _ = _start_state(jcfg, seed=1)
    params_t = _caps(ttrain.pbf_params_from_config(tcfg))
    plan_j = jdyn.plan_emission(jdyn.EmitterPoints.from_config(jcfg.model).hidden,
                                o.emit_ratio_hidden, np.random.default_rng(7))
    plan_t = tdyn.plan_emission(tdyn.EmitterPoints.from_config(tcfg.model).hidden,
                                tcfg.optim.emit_ratio_hidden, np.random.default_rng(7))
    np.testing.assert_array_equal(plan_t, plan_j)
    counts = np.unique(plan_j, axis=0, return_counts=True)[1]
    assert (len(plan_j), int((counts > 1).sum())) == (117, 44)
    new, mask = jdyn.pad_emission(plan_j, len(plan_j))
    st = jdyn.emit_hidden(jpbf.remove_invalid(st_j, params_j), new, o.init_hidden_velocity,
                          o.alpha, mask=mask)
    ref, _ = jtrain.solver_tick(st, params_j, o.solver_iterations, False)
    got, _ = ttrain.solver_tick(convert.particle_state_from_numpy(
        jax.tree.map(np.asarray, st), CPU), params_t, o.solver_iterations, False)
    x0, alive = _np(st.estimate_xyz), _np(st.alive)
    xj, xt = _np(ref.estimate_xyz), got.estimate_xyz.numpy()
    np.testing.assert_array_equal(got.alive.numpy(), _np(ref.alive))
    rows = np.flatnonzero(alive)
    coincident = [r for r in rows
                  if np.count_nonzero(np.all(x0[rows] == x0[r], axis=1)) > 1]
    assert len(coincident) == 88
    far = rows[np.min(np.linalg.norm(x0[rows][:, None] - x0[coincident][None], axis=-1),
                      axis=1) > float(params_t.h)]
    assert len(far) > 0.8 * len(rows)
    np.testing.assert_allclose(xt[far], xj[far], rtol=0, atol=1e-5)


def test_evaluate_frame_matches_jax():
    """Held-out L1 and PSNR against the supervision and the real images, and
    the first camera's gray render, against the JAX package."""
    jcfg, tcfg = _small(JConfig()), _small(TConfig())
    _, _, vis_j, attrs_j = _start_state(jcfg, seed=4)
    scene = smoke_like_scene()
    cams_j = j_cameras_by_time(scene.train_cameras)[2]
    cams_t = [c for c in _port_scene(scene).train_cameras if c.time_idx == 2]
    ref, img_j = jtrain.evaluate_frame(vis_j, attrs_j, None, cams_j, _jax_raster(jcfg),
                                       return_image=True)
    got, img_t = ttrain.evaluate_frame(
        convert.visual_state_from_numpy(jax.tree.map(np.asarray, vis_j), CPU),
        convert.visual_attrs_from_numpy(jax.tree.map(np.asarray, attrs_j), CPU), None, cams_t,
        ttrain.raster_config_from(tcfg), return_image=True)
    assert set(got) == set(ref) == {"l1", "psnr", "l1_real", "psnr_real"}
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, err_msg=key)
    assert img_t.shape == np.asarray(img_j).shape and img_t.max() > 0
    np.testing.assert_allclose(img_t, np.asarray(img_j), atol=1e-5)


# ---------------------------------- train ------------------------------------


def test_train_runs_a_b_c_and_resumes(tmp_path):
    """The port's ``train``: phases A -> B -> C with the frame checkpoints
    0-2, and ``resume_from_frame=2`` from the frame-1 checkpoint giving the
    straight run's frame-2 checkpoint. One camera a frame and no fractional
    emission, so the resumed run draws nothing the straight run drew
    differently; hidden rows are compared by particle id, since a reloaded
    state is compacted."""
    import shutil

    cfg = _small(TConfig())
    cfg.optim.extra_visual_ratio = 0.0
    cfg.optim.batch = 1
    scene = _port_scene(smoke_like_scene(n_cams=1))
    straight = tmp_path / "straight"
    cfg.model.model_path = str(straight)
    res = ttrain.train(cfg, scene, log=lambda *a: None, device="cpu")
    assert [m["frame"] for m in res["metrics"]] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    ck = straight / "checkpoint"
    for t in (0, 1, 2):
        assert len(_frame_files(ck, t)) == 15

    resumed = tmp_path / "resumed"
    shutil.copytree(ck, resumed / "checkpoint",
                    ignore=lambda d, names: [n for n in names if n.startswith("frame_002_")])
    cfg.model.model_path = str(resumed)
    logs = []
    res2 = ttrain.train(cfg, scene, log=logs.append, resume_from_frame=2, device="cpu")
    assert logs[0].startswith("resumed from frame 1")
    assert [m["frame"] for m in res2["metrics"]] == [2]
    assert res2["metrics"][0]["hidden"] == res["metrics"][1]["hidden"]
    assert res2["metrics"][0]["visual"] == res["metrics"][1]["visual"]
    np.testing.assert_allclose(res2["metrics"][0]["loss"], res["metrics"][1]["loss"], rtol=1e-4)

    def load(root, name):
        return np.load(root / "checkpoint" / f"frame_002_{name}.npy")

    order_a = np.argsort(load(straight, "particle_id")[:, 0])
    order_b = np.argsort(load(resumed, "particle_id")[:, 0])
    for name in ("particle_id", "xyz", "estimate_xyz", "imass", "buoyancy"):
        np.testing.assert_allclose(load(resumed, name)[order_b], load(straight, name)[order_a],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(load(resumed, "visual_xyz"), load(straight, "visual_xyz"),
                               rtol=1e-5, atol=1e-5)


def test_train_needs_a_scene(tmp_path):
    """Without a scene_info, ``train`` reads the scene at data_path, and a
    folder with no capture raises before any work."""
    cfg = _small(TConfig())
    cfg.model.data_path = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="transforms"):
        ttrain.train(cfg, None, device="cpu")
