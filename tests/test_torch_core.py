"""The port's copies of the JAX package's jax-free core modules
(fluidnexus_torch.core.config, fluidnexus_torch.core.ply) against the
originals: every shipped config loads to the same values, CLI flags parse
alike, and a background PLY written by the JAX package loads into the same
splats."""
import glob
import os

import numpy as np
import pytest

from fluidnexus_tpu.core import config as jcfg
from fluidnexus_tpu.core.ply import save_background_ply as j_save_background_ply
from fluidnexus_tpu.splat.dynamics import BackgroundSplats as JBackgroundSplats
from fluidnexus_torch.core import config as tcfg
from fluidnexus_torch.splat.dynamics import BackgroundSplats as TBackgroundSplats
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_loads_like_jax(path):
    assert tcfg.load_config(path).to_dict() == jcfg.load_config(path).to_dict()


def test_parse_cli_matches_jax():
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..", "configs", "smoke_dynamics.json"),
            "--seed", "7", "--tile_capacity", "128", "--iterations_per_time_first", "30"]
    t, j = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
    assert t.to_dict() == j.to_dict()
    assert t.pipe.tile_capacity == 128 and t.seed == 7


def test_background_ply_from_jax(tmp_path):
    rng = np.random.default_rng(6)
    n = 33
    path = str(tmp_path / "point_cloud.ply")
    j_save_background_ply(path, xyz=rng.normal(size=(n, 3)), color=rng.uniform(0, 1, (n, 3)),
                          opacity=rng.normal(size=(n, 1)), scaling=rng.normal(size=(n, 3)),
                          rotation=rng.normal(size=(n, 4)))
    bj, bt = JBackgroundSplats.from_ply(path), TBackgroundSplats.from_ply(path, device="cpu")
    assert bt.n == n
    for k in ("xyz", "color", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(), np.asarray(getattr(bj, k)), err_msg=k)
