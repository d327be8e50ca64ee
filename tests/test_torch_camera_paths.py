"""``data/camera_paths`` in the port against the JAX package's, on the CPU:
``look_at`` and the ``orbit_cameras`` (rotations, translations, fields of
view and the camera matrices), bit for bit."""
import numpy as np
import pytest

from fluidnexus_tpu.data import camera_paths as jpaths
from fluidnexus_torch.data import camera_paths as tpaths


@pytest.mark.parametrize("eye, target", [((2.0, 0.3, 0.1), (0.0, 0.0, 0.0)),
                                         ((0.326, 0.35, 1.9), (0.326, 0.35, -0.3)),
                                         ((-1.0, 2.0, -3.0), (0.5, -0.25, 0.75))])
def test_look_at_matches_jax(eye, target):
    np.testing.assert_array_equal(tpaths.look_at(np.array(eye), np.array(target)),
                                  jpaths.look_at(np.array(eye), np.array(target)))


@pytest.mark.parametrize("kw", [dict(),
                                dict(height=0.3, fovx=0.9, width=64, image_height=48),
                                dict(start_angle=0.4, sweep=np.pi, elevation_wobble=0.2,
                                     width=97, image_height=31)])
def test_orbit_cameras_match_jax(kw):
    center = np.array([0.326, 0.35, -0.3], np.float32)
    got = tpaths.orbit_cameras(center, 2.5, 7, **kw)
    ref = jpaths.orbit_cameras(center, 2.5, 7, **kw)
    assert len(got) == len(ref) == 7
    for a, b in zip(got, ref):
        for name in ("uid", "fovx", "fovy", "width", "height", "time_idx", "timestamp"):
            assert getattr(a, name) == getattr(b, name), name
        for name in ("R", "T", "world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(b, name)),
                                          err_msg=name)
