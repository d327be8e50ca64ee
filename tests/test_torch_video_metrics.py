"""The port's video and perceptual metrics (``fluidnexus_torch/utils/
video_metrics.py``, ``utils/i3d.py``, ``utils/perceptual.py``) against the
JAX package's on the CPU.

Tolerances: features within 1e-5 of max|ref| (I3D's logits, after 58
convolutions from a 16 x 112 x 112 clip resized to 224, within 1e-4); the
TF-SAME convolution and the SAME max pool within 1e-5 of max|ref| against
``jax.lax``; Fréchet distances from the same features bit for bit (the same
float64 numpy), from each package's own features within 1e-5 relative;
perceptual similarity, PSNR and SSIM within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.utils import i3d as ti3d
from fluidnexus_torch.utils import perceptual as tper
from fluidnexus_torch.utils import video_metrics as tvm
from fluidnexus_tpu.utils import i3d as ji3d
from fluidnexus_tpu.utils import perceptual as jper
from fluidnexus_tpu.utils import video_metrics as jvm
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5
I3D_TOL = 1e-4


def held(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol} x {scale:.3e}"


def clips(n, t, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 4, 16, 16), (3, 6, 20, 12)])
def test_pixel_feature_fn(shape):
    v = clips(*shape, seed=shape[2])
    held(tvm.pixel_feature_fn(v, device="cpu"), jvm.pixel_feature_fn(v), TOL)


def test_frechet_distance_and_fvd():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(300, 6)), rng.normal(size=(300, 6)) @ np.diag([1, 2, 1, .5, 1, 3])
    assert tvm.frechet_distance(a, b) == jvm.frechet_distance(a, b)
    assert tvm.frechet_distance(torch.as_tensor(a), b) == jvm.frechet_distance(a, b)
    va = clips(12, 4, 16, 16, seed=1)
    vb = np.clip(va + rng.normal(scale=0.2, size=va.shape), 0, 1).astype(np.float32)
    got = tvm.frechet_video_distance(va, vb, device="cpu")
    assert got == pytest.approx(jvm.frechet_video_distance(va, vb), rel=TOL) and got > 0
    assert tvm.frechet_video_distance(va, va.copy(), device="cpu") < 1e-4


def test_perceptual_similarity():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(size=(20, 20, 3)), rng.uniform(size=(20, 20, 3))
    assert tvm.perceptual_similarity(a, b, device="cpu") == pytest.approx(
        jvm.perceptual_similarity(a, b), rel=TOL)


@pytest.mark.parametrize("kernel,stride,size", [((3, 3, 3), (1, 1, 1), (5, 7, 6)),
                                                ((7, 7, 7), (2, 2, 2), (5, 9, 8)),
                                                ((1, 3, 3), (1, 2, 2), (4, 7, 10))])
def test_tf_same_conv_and_max_pool_against_lax(kernel, stride, size):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3) + size).astype(np.float32)             # N C T H W
    w = rng.normal(size=(4, 3) + kernel).astype(np.float32)           # O I kT kH kW
    got = ti3d.conv_same(torch.as_tensor(x), torch.as_tensor(w), stride)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
        stride, "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    held(got.numpy().transpose(0, 2, 3, 4, 1), ref, TOL, "conv")
    got = ti3d.max_pool_same(torch.as_tensor(x), kernel, stride)
    ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 1) + kernel,
                                (1, 1) + stride, "SAME")
    held(got.numpy(), ref, TOL, "max pool")


def test_i3d_logits_on_a_clip_resized_to_224():
    params = ji3d.random_params(0)
    v = clips(1, 16, 112, 112, seed=4)
    got = ti3d.i3d_logits(params, v, device="cpu")
    ref = jax.jit(lambda x: ji3d.i3d_logits(params, x))(jnp.asarray(v))
    assert got.shape == (1, ji3d.NUM_CLASSES)
    held(got.numpy(), ref, I3D_TOL, "logits")
    for k, a in ti3d.random_params(0).items():
        assert np.array_equal(a, params[k]), k


def test_i3d_load_params_npz_and_pt(tmp_path):
    params = ti3d.random_params(1)
    small = {k: v for k, v in list(params.items())[:6]}
    np.savez(tmp_path / "i3d.npz", **small)
    torch.save({k: torch.as_tensor(v) for k, v in small.items()}, tmp_path / "rgb_imagenet.pt")
    for name in ("i3d.npz", "rgb_imagenet.pt"):
        got, ref = ti3d.load_params(str(tmp_path / name)), ji3d.load_params(str(tmp_path / name))
        assert sorted(got) == sorted(ref) == sorted(small)
        for k in small:
            assert np.array_equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype


def test_i3d_feature_fn_batches():
    params = ti3d.random_params(0)
    v = clips(2, 16, 16, 16, seed=5)
    got = tvm.i3d_feature_fn(params, batch=2, device="cpu")(v)
    held(got, tvm.i3d_feature_fn(params, batch=1, device="cpu")(v), 1e-6, "batched")
    assert tvm.fvd_i3d(v, v, params, device="cpu") == tvm.frechet_distance(got, got)


def test_vgg16_features_and_perceptual_sim():
    params = tper.random_params(0)
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.3, size=a.shape), -1, 1).astype(np.float32)
    for g, r in zip(tper.vgg16_features(params, torch.as_tensor(a)),
                    jper.vgg16_features(params, jnp.asarray(a))):
        held(g.numpy(), r, TOL, "features")
    held(tper.perceptual_sim(a, b, params, device="cpu").numpy(),
         jper.perceptual_sim(a, b, params), TOL, "perceptual_sim")


def test_perceptual_similarity_from_list():
    params = tper.random_params(0)
    rng = np.random.default_rng(7)
    pred = [rng.uniform(size=(3, 32, 32)).astype(np.float32) for _ in range(4)]
    tgt = [np.clip(p + rng.normal(scale=0.1, size=p.shape), 0, 1).astype(np.float32)
           for p in pred]
    got = tper.compute_perceptual_similarity_from_list(pred, tgt, params, batch=2,
                                                       device="cpu")
    ref = jper.compute_perceptual_similarity_from_list(pred, tgt, params, batch=2)
    assert set(got) == set(ref) == {"Perceptual similarity", "PSNR", "SSIM"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=TOL), k
