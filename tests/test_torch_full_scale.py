"""``fluidnexus_torch.tools.run_full_scale_recon`` against the repository's
``tools/run_full_scale_recon.py`` (loaded by path), on the CPU: the camera
ring bit for bit, the ground-truth plume (2 frames at 96 x 56, 368 hidden
particles, 1 stable tick: cameras bit for bit, images to the rasterizer
parity tests' 1e-4), and the tool end to end on the CPU at that size, which
writes only under ``--out``. Without ``--cpu`` and a card the tool raises."""
import dataclasses
import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch

from fluidnexus_tpu.core.config import Config as JConfig
from fluidnexus_tpu.pipelines import train_physical_particle as jtrain
from fluidnexus_torch.tools import run_full_scale_recon as tool
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--frames", "2", "--iters", "3", "--first_iters", "3", "--width", "96", "--height", "56",
         "--hidden_delta", "0.04", "--stable_iters", "1"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_run_full_scale_recon", os.path.join(REPO, "tools", "run_full_scale_recon.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(out, argv=SMALL):
    vals = dict(zip(argv[::2], argv[1::2]))
    return types.SimpleNamespace(out=str(out), frames=int(vals["--frames"]),
                                 iters=int(vals["--iters"]), first_iters=int(vals["--first_iters"]),
                                 width=int(vals["--width"]), height=int(vals["--height"]),
                                 stable_iters=int(vals["--stable_iters"]),
                                 hidden_delta=float(vals["--hidden_delta"]), cpu=True)


def _jax_config(tcfg):
    """The JAX package's Config with every field of the port's."""
    jcfg = JConfig()
    for sec in ("model", "optim", "pipe"):
        for f in dataclasses.fields(getattr(tcfg, sec)):
            setattr(getattr(jcfg, sec), f.name, getattr(getattr(tcfg, sec), f.name))
    return jcfg


@pytest.mark.parametrize("size", [(960, 544), (96, 56)])
def test_build_cameras_match_jax(size):
    ref, _ = _jax_tool().build_cameras(*size)
    got = tool.build_cameras(*size)
    assert [(k, i) for k, i, _ in got] == [(k, i) for k, i, _ in ref] and len(got) == 6
    for (_, _, a), (_, _, b) in zip(got, ref):
        assert set(a) == set(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_simulate_gt_matches_jax(tmp_path, monkeypatch):
    """The hidden capacity is cut to 1 024 and the JAX tick jitted (as the
    JAX ``train`` runs it), which keeps the JAX side's compiles short."""
    jt = _jax_tool()
    monkeypatch.setattr(jtrain, "solver_tick", jax.jit(
        jtrain.solver_tick, static_argnames=("params", "solver_iterations", "use_wind", "stable")))
    tcfg = tool.reference_config(_args(tmp_path))
    tcfg.model.hidden_capacity = 1024
    jcfg = _jax_config(tcfg)
    specs_j, camera_j = jt.build_cameras(96, 56)
    logs_j, logs_t = [], []
    ref = jt.simulate_gt(jcfg, 2, specs_j, camera_j, logs_j.append)
    got = tool.simulate_gt(tcfg, 2, tool.build_cameras(96, 56), logs_t.append, device="cpu")
    assert logs_t[0] == logs_j[0] == "GT hidden init: 368 particles"
    assert logs_t[-1].split("(")[-1] == logs_j[-1].split("(")[-1]   # final alive
    for kind in ("train_cameras", "test_cameras"):
        a, b = getattr(got, kind), getattr(ref, kind)
        assert len(a) == len(b) == (10 if kind == "train_cameras" else 2)
        for ca, cb in zip(a, b):
            assert (ca.uid, ca.image_name, ca.time_idx) == (cb.uid, cb.image_name, cb.time_idx)
            for name in ("R", "T", "world_view", "full_proj"):
                np.testing.assert_array_equal(getattr(ca, name), np.asarray(getattr(cb, name)))
            assert ca.image.shape == cb.image.shape == (56, 96, 3) and ca.image.dtype == np.float32
            np.testing.assert_allclose(ca.image, cb.image, atol=1e-4)
    assert float(np.mean([c.image.max() for c in got.train_cameras])) > 0.1, "nothing drawn"
    assert got.nerf_normalization["radius"] == ref.nerf_normalization["radius"]


def test_the_tool_runs_on_the_cpu_and_writes_only_under_out(tmp_path, monkeypatch):
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    res = tool.main(SMALL + ["--cpu", "--out", str(out)])
    assert os.listdir(cwd) == []
    names = sorted(os.listdir(out))
    assert {"RUN.md", "run.log", "metrics.npy", "recon"} <= set(names)
    assert any(n.startswith("events.out.tfevents") for n in names)
    metrics = res["metrics"]
    assert [m["frame"] for m in metrics] == [1] and all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[0]["query_drops"] == 0 and metrics[0]["visual"] > 1050
    text = (out / "RUN.md").read_text()
    for line in ("- frames completed: 1/1", "- device: cpu", "- phases: A ",
                 "- phase C: median ", "- capacity-overflow warnings: 0",
                 f"- alive at the last frame: {metrics[0]['visual']} visual"):
        assert line in text, line
    assert sorted(os.listdir(out / "recon" / "checkpoint"))


def test_the_tool_raises_without_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(SMALL + ["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    assert jax.default_backend() == "cpu"
