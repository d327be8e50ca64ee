"""The port's examples against the JAX package on the CPU:
``render_orbit``'s video, read back with ``read_video``, against JAX
``rasterize`` at JAX's orbit cameras (64 x 48); the demo's PBF ticks against
the JAX functions at the demo's inputs (its fit cut through ``main``'s
arguments), and its initial PSNR; ``profile_raster`` refusing to run
without a card; and every module of this slice imported in a fresh
interpreter in which JAX cannot be."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.ply import load_background_ply as j_load_ply
from fluidnexus_tpu.data.camera_paths import orbit_cameras as j_orbit_cameras
from fluidnexus_tpu.data.cameras import Camera as JCamera
from fluidnexus_tpu.ops import RasterizerConfig as JRasterizerConfig
from fluidnexus_tpu.ops import rasterize as j_rasterize
from fluidnexus_tpu.sim import pbf as jpbf
from fluidnexus_tpu.sim.state import make_particle_state as j_make_particle_state
from fluidnexus_tpu.sim.state import make_visual_state as j_make_visual_state
from fluidnexus_tpu.utils.losses import psnr as j_psnr
from fluidnexus_torch.core.ply import save_background_ply
from fluidnexus_torch.examples import fit_gaussians_demo as demo
from fluidnexus_torch.examples import profile_raster, render_orbit
from fluidnexus_torch.utils.video_io import read_video
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("fluidnexus_torch.tools.run_full_scale_recon", "fluidnexus_torch.data.camera_paths",
               "fluidnexus_torch.examples.render_orbit",
               "fluidnexus_torch.examples.fit_gaussians_demo",
               "fluidnexus_torch.examples.profile_raster")


def _seeded_ply(path, n=400, seed=3):
    rng = np.random.default_rng(seed)
    save_background_ply(path, rng.normal(0.0, 0.4, (n, 3)), rng.uniform(0.05, 0.95, (n, 3)),
                        rng.normal(0.0, 1.5, (n, 1)), rng.uniform(-4.0, -2.5, (n, 3)),
                        rng.normal(size=(n, 4)))


def test_render_orbit_matches_jax_rasterize(tmp_path):
    """Four frames at 64 x 48, written as the port's AVI and read back,
    against the JAX rasterizer at the JAX package's orbit cameras, as its
    ``examples/render_orbit.py`` renders them: within one 8-bit level."""
    ply = str(tmp_path / "splat.ply")
    _seeded_ply(ply)
    path = render_orbit.main(["--ply", ply, "--out", str(tmp_path / "orbit.avi"), "--frames",
                              "4", "--width", "64", "--height", "48"], device="cpu")
    got = read_video(path)
    assert got.shape == (4, 48, 64, 3) and got.dtype == np.uint8

    d = j_load_ply(ply)
    xyz = jnp.asarray(d["xyz"])
    rot = d["rotation"] / (np.linalg.norm(d["rotation"], axis=-1, keepdims=True) + 1e-12)
    center = np.asarray(xyz).mean(0)
    spread = float(np.percentile(np.linalg.norm(np.asarray(xyz) - center, axis=1), 90))
    cams = j_orbit_cameras(center, radius=max(2.5, 1.5 * spread), n_frames=4, height=0.3,
                           width=64, image_height=48)
    for i, cam in enumerate(cams):
        out = j_rasterize(xyz, jnp.asarray(d["color"]),
                          jnp.asarray(1.0 / (1.0 + np.exp(-d["opacity"]))).reshape(-1),
                          jnp.asarray(np.exp(d["scaling"])), jnp.asarray(rot),
                          view_matrix=jnp.asarray(cam.world_view),
                          proj_matrix=jnp.asarray(cam.full_proj), tan_fovx=cam.tan_fovx,
                          tan_fovy=cam.tan_fovy, width=64, height=48, bg_color=jnp.zeros(3),
                          config=JRasterizerConfig(backend="auto"))
        ref = np.clip(np.asarray(out.color).transpose(1, 2, 0), 0, 1) * 255.0
        assert np.abs(got[i].astype(np.float64) - ref).max() <= 1.0, i
    assert got.max() > 100, "nothing drawn"


def _jax_demo_ticks(ticks):
    """The JAX demo's PBF loop (examples/fit_gaussians_demo.py:84-99), its
    tick jitted."""
    p = jpbf.PBFParams(h=2.0, p0=1.5, k=3.0, secs=0.033, alpha=0.0, knn_k=64)

    @jax.jit
    def tick(st, vis):
        st = jpbf.guess_hidden(st, p)
        st, diags = jpbf.solver_loop(st, p, iterations=10)
        st = jpbf.confirm_guess(st, p)
        return st, jpbf.update_visual(vis, st, p), diags["p_ratio"][-1]

    hidden, vis_pts = demo.pbf_inputs()
    st = j_make_particle_state(1024, jnp.asarray(hidden), init_velocity_y=100.0)
    vis = j_make_visual_state(256, jnp.asarray(vis_pts))
    out = []
    for _ in range(ticks):
        st, vis, p_ratio = tick(st, vis)
        out.append((np.asarray(st.xyz), np.asarray(st.velocity), np.asarray(vis.xyz),
                    float(p_ratio)))
    return out


TICKS = 2   # of the demo's 5: a JAX tick at its 4 096-cell dense grid takes ~10 s here


def test_demo_ticks_match_the_jax_functions():
    """``main`` with its fit cut to 2 steps and its rollout to 2 ticks: the
    initial PSNR against the JAX render's (1e-4 relative), then each tick's
    rho / rho0 and visual mean height (1e-4), and the last tick's hidden
    positions and velocities and visual positions against the JAX demo's
    loop on the same inputs: after 20 chained Jacobi iterations, whose f32
    rounding the packages take apart (4e-4 on 3 of 3 072 coordinates here),
    at 1e-3 (the velocity's atol over secs); one projection tick alone is
    held at 1e-4 by the dense tick's own parity test."""
    res = demo.main(device="cpu", fit_iters=2, ticks=TICKS)
    psnrs, rows, st, vis = res["psnrs"], res["ticks"], res["hidden"], res["visual"]
    assert len(psnrs) == 3 and all(np.isfinite(psnrs))
    rng = np.random.default_rng(0)
    n = 256
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cam = JCamera(uid=0, R=R, T=-R.T @ np.array([0.0, 0.0, 3.0]), fovx=0.8, fovy=0.6, width=128,
                  height=96)
    gt = [jnp.asarray(a, jnp.float32) for a in (
        rng.uniform(-0.7, 0.7, (n, 3)), rng.uniform(0, 1, (n, 3)), rng.uniform(0.4, 0.9, (n,)),
        np.exp(rng.uniform(-3.2, -2.2, (n, 3))), rng.normal(size=(n, 4)))]
    rkw = dict(view_matrix=jnp.asarray(cam.world_view), proj_matrix=jnp.asarray(cam.full_proj),
               tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=128, height=96,
               bg_color=jnp.zeros(3), config=JRasterizerConfig(tile_capacity=128, chunk=32))
    target = j_rasterize(*gt, **rkw).color
    means = gt[0] + 0.03 * jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    cols = jnp.clip(gt[1] + 0.2 * jnp.asarray(rng.normal(size=(n, 3)), jnp.float32), 0, 1)
    p0 = float(j_psnr(j_rasterize(means, cols, *gt[2:], **rkw).color, target))
    np.testing.assert_allclose(psnrs[0], p0, rtol=1e-4)

    ref = _jax_demo_ticks(TICKS)
    assert len(rows) == TICKS
    for row, (xyz, vel, vxyz, p_ratio) in zip(rows, ref):
        np.testing.assert_allclose(row["p_ratio"], p_ratio, rtol=1e-4)
        np.testing.assert_allclose(row["vis_y"], vxyz[:128, 1].mean(), rtol=1e-4, atol=1e-4)
    xyz, vel, vxyz, _ = ref[-1]
    np.testing.assert_allclose(st.xyz.numpy(), xyz, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st.velocity.numpy(), vel, rtol=1e-3, atol=1e-3 / 0.033)
    np.testing.assert_allclose(vis.xyz.numpy(), vxyz, rtol=1e-3, atol=1e-3)
    assert rows[-1]["alive"] == 512 and rows[-1]["vis_y"] > rows[0]["vis_y"]


def test_profile_raster_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        profile_raster.main([str(tmp_path / "prof")])
    assert not (tmp_path / "prof").exists()


def test_the_new_modules_import_without_jax(tmp_path):
    """A fresh interpreter in which jax and the JAX package cannot be
    imported imports every module of this slice."""
    script = textwrap.dedent(f"""
        import importlib, sys
        BLOCKED = ("jax", "jaxlib", "fluidnexus_tpu")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("imported without jax")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path), env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert "imported without jax" in res.stdout
