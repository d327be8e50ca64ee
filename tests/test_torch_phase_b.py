"""Phase B of the reconstruction (hidden-particle stabilisation) in the port
against the JAX package, on the CPU: ``stabilize_hidden`` against the JAX
``train`` lines it lifts, driven through the JAX functions from one config;
the particle state; the capacity warning; and the hidden npy checkpoint
across the two packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim.state import make_particle_state as j_make_particle_state
from fluidnexus_tpu.splat import dynamics as jdyn
from fluidnexus_torch import convert
from fluidnexus_torch.core.config import Config as TConfig
from fluidnexus_torch.pipelines import train_physical_particle as ttrain
from fluidnexus_torch.sim import pbf as tpbf
from fluidnexus_torch.sim.state import make_particle_state
from fluidnexus_torch.splat import dynamics as tdyn
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _small(cfg):
    """A 0.02-radius pillar over y -0.1..0.8: 90 scaled units against the
    64-unit box of remove_invalid's grid at h = 2, so points above the box
    clamp into its top cells, overflow them and are removed (the JAX
    package's behaviour). 2 ticks of 3 Jacobi iterations."""
    o, m = cfg.optim, cfg.model
    m.init_hidden_radius_max = 0.02
    m.init_hidden_y_min, m.init_hidden_y_max = -0.1, 0.8
    m.hidden_capacity = 2048
    o.stable_iterations, o.solver_iterations = 2, 3
    o.min_neighbors, o.init_hidden_velocity, o.alpha = 1, 100.0, 0.0
    return cfg


def _jax_phase_b(cfg, params):
    """Lines 433-444 of the JAX ``train``, through the JAX functions."""
    o, m = cfg.optim, cfg.model
    tick = jax.jit(jtrain.solver_tick,
                   static_argnames=("params", "solver_iterations", "use_wind", "stable"))
    pts = jdyn.create_hidden_points(m)
    state = j_make_particle_state(m.hidden_capacity, jnp.asarray(pts),
                                  init_velocity_y=o.init_hidden_velocity,
                                  gravity_alpha_buoyancy=np.array([0, -9.8, 0]) * o.alpha)
    alive0, diags = int(state.alive.sum()), []
    for _ in range(o.stable_iterations):
        state = jpbf.remove_invalid(state, params)
        state, d = tick(state, params=params, solver_iterations=o.solver_iterations,
                        use_wind=False, stable=True)
        jpbf.warn_capacity_overflow(d, "phase B stabilization")
        state = jpbf.confirm_guess(state, params)
        diags.append(d)
    return alive0, state, diags


def test_stabilize_hidden_matches_jax():
    jcfg, tcfg = _small(JConfig()), _small(TConfig())
    caps = dict(dense_max_cells=512, dense_cell_capacity=32)
    params_j = dataclasses.replace(jtrain.pbf_params_from_config(jcfg), **caps)
    params_t = dataclasses.replace(ttrain.pbf_params_from_config(tcfg), **caps)
    alive0, ref, ref_d = _jax_phase_b(jcfg, params_j)
    logs = []
    got, got_d = ttrain.stabilize_hidden(tcfg, params_t, log=logs.append, device="cpu")
    assert logs[0] == f"hidden init: {alive0} particles"
    n_alive = int(got.alive.sum())
    assert 0 < n_alive < alive0, "the box-edge kill did not happen"
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    for name in ("xyz", "estimate_xyz"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # velocity = dx / secs carries one ulp of a position near 80 (7.6e-6) as
    # 2.3e-4: it is held as the displacement velocity * secs, at 1e-4
    secs = params_t.secs
    np.testing.assert_allclose(got.velocity.numpy() * secs, np.asarray(ref.velocity) * secs,
                               rtol=1e-4, atol=1e-4, err_msg="velocity")
    assert len(got_d) == len(ref_d) == 2
    for g, r in zip(got_d, ref_d):
        assert int(g["overflow"].sum()) == 0
        for key in r:
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), rtol=1e-4, atol=1e-4,
                                       err_msg=key)


def test_make_particle_state_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    g = np.array([0, -9.8, 0]) * -0.2
    ref = j_make_particle_state(64, jnp.asarray(pts), init_velocity_y=7.0,
                                gravity_alpha_buoyancy=g)
    got = make_particle_state(64, pts, init_velocity_y=7.0, gravity_alpha_buoyancy=g,
                              device="cpu")
    for name, a, b in zip(got._fields, convert.particle_state_to_numpy(got), ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert a.dtype == np.asarray(b).dtype, name
    with pytest.raises(ValueError, match="capacity"):
        make_particle_state(16, pts, device="cpu")


def test_warn_capacity_overflow():
    msgs = []
    assert tpbf.warn_capacity_overflow({"overflow": torch.tensor([0, 3, 2])}, "tick",
                                       log=msgs.append) == 5
    assert msgs and "dense_cell_capacity" in msgs[0]
    with pytest.raises(RuntimeError, match="strict_capacity"):
        tpbf.warn_capacity_overflow({"overflow": torch.tensor([1])}, "tick", strict=True)
    assert tpbf.warn_capacity_overflow({"overflow": torch.zeros(3, dtype=torch.int64)}, "tick",
                                       log=msgs.append) == 0 and len(msgs) == 1


def _state_pair(seed=3):
    rng = np.random.default_rng(seed)
    cap, n = 48, 30
    st = j_make_particle_state(cap, jnp.asarray(rng.uniform(0, 90, (n, 3)).astype(np.float32)))
    f32 = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    alive = np.arange(cap) < n
    alive[[3, 17]] = False
    st = st._replace(estimate_xyz=st.xyz + f32(cap, 3), velocity=f32(cap, 3), force=f32(cap, 3),
                     buoyancy=f32(cap, 3), imass=1.0 + 0.1 * f32(cap), counts=f32(cap) ** 2,
                     alive=jnp.asarray(alive), next_id=jnp.asarray(57, jnp.int32))
    return st, cap


def _same_alive_rows(a, b_np):
    """``a`` (port state) holds ``b_np``'s alive rows in its first slots."""
    rows = b_np.alive
    n = int(rows.sum())
    for name in ("xyz", "estimate_xyz", "velocity", "force", "buoyancy", "imass", "counts",
                 "particle_id"):
        np.testing.assert_allclose(getattr(a, name).numpy()[:n], getattr(b_np, name)[rows],
                                   rtol=1e-6, atol=1e-5, err_msg=name)
    assert a.alive.numpy()[:n].all() and not a.alive.numpy()[n:].any()
    assert int(a.next_id) == int(b_np.next_id)


def test_hidden_checkpoint_round_trips_between_packages(tmp_path):
    params_j, params_t = jpbf.PBFParams(), tpbf.PBFParams()
    st_j, cap = _state_pair()
    jdyn.save_hidden(st_j, params_j, str(tmp_path / "jax"), 4)
    got = tdyn.load_hidden(str(tmp_path / "jax"), 4, cap, params_t, device="cpu")
    _same_alive_rows(got, jax.tree.map(np.asarray, st_j))

    st_t = convert.particle_state_from_numpy(st_j, device=CPU)
    tdyn.save_hidden(st_t, params_t, str(tmp_path / "torch"), 4)
    back = jdyn.load_hidden(str(tmp_path / "torch"), 4, cap, params_j)
    _same_alive_rows(convert.particle_state_from_numpy(back, device=CPU),
                     jax.tree.map(np.asarray, st_j))
    for name in ("xyz.npy", "scalar_values.json", "gravity.npy", "imass.npy"):
        a = (tmp_path / "jax" / f"frame_004_{name}").read_bytes()
        assert a == (tmp_path / "torch" / f"frame_004_{name}").read_bytes(), name
