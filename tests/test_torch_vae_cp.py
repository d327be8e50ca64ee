"""The port's context parallelism over time (``fluidnexus_torch/parallel/
cp.py`` and ``CPState`` in ``diffusion/video/vae3d.py``) on two gloo ranks
of this host, against the serial pass of both packages and JAX's
``cp_causal_conv_time`` on its mesh (parity target of both:
CogVideoX/vae_modules/cp_enc_dec.py:137-242). One process group serves the
file: a module fixture starts the two ranks once; each test reads its
case. Sizes are below the slow-marked tests/test_vae_cp.py's (9 frames at
most, 8 x 8 pixels); the tolerance is its ``atol``/``rtol`` 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import vae3d_from_numpy
from fluidnexus_torch.diffusion.video import vae3d as tv
from fluidnexus_tpu.diffusion.video.vae3d import VAE3DConfig, VideoVAE
from fluidnexus_tpu.parallel.cp import cp_causal_conv_time as j_cp_conv
from fluidnexus_tpu.parallel.mesh import make_mesh
from tests.test_torch_video_dit import random_flax_params
from tests.torch_dist_ranks import ok, spawn
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

N = 2
CASES = {"tc2": (2, (1, 2), 5), "tc4": (4, (1, 2, 2), 9)}   # name: (tc, ch_mult, frames)
HW = 8
KT = 3


def _build(tc, ch_mult, t, seed):
    """The JAX VAE's random weights, an input clip, and the JAX package's
    serial encode (sample=False) and decode of that latent."""
    cfg = dict(ch=8, ch_mult=ch_mult, num_res_blocks=1, z_channels=4, temporal_compress_times=tc)
    vae = VideoVAE(VAE3DConfig(**cfg))
    x = np.random.default_rng(seed).normal(size=(1, t, HW, HW, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: vae.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_flax_params(shapes["params"], seed + 1)
    encode = jax.jit(lambda p, v: vae.apply({"params": p}, v, sample=False, method=vae.encode,
                                            mutable=["cache"])[0])
    decode = jax.jit(lambda p, v: vae.apply({"params": p}, v, method=vae.decode,
                                            mutable=["cache"])[0])
    z = encode(params, jnp.asarray(x))
    return params, tv.VAE3DConfig(**cfg), x, np.array(z), np.array(decode(params, z))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    built = {name: _build(*spec, seed=3 + i) for i, (name, spec) in enumerate(CASES.items())}
    hx = np.random.default_rng(5).normal(size=(2, 8, 3, 4, 5)).astype(np.float32)
    cases = [("halo", "tests.torch_parallel_cases.halo", dict(x=hx, kernel_t=KT, n=N))]
    cases += [(name, "tests.torch_parallel_cases.vae_cp",
               dict(tree=b[0], cfg=b[1], x=b[2], z=b[3], n=N)) for name, b in built.items()]
    results = spawn(N, cases, str(tmp_path_factory.mktemp("vae_cp")), timeout=180)
    return dict(results=results, built=built, hx=hx)


def test_halo_exchange_and_cp_conv_match_serial_and_jax(world):
    """Each rank's shard with the previous rank's last k_t - 1 frames in
    front (rank 0: its first frame repeated), and a VALID-in-time mean
    filter through ``cp_causal_conv_time``, against the serial causal pass
    and JAX's ``cp_causal_conv_time`` on its time mesh."""
    x = world["hx"]
    serial_pad = np.concatenate([np.repeat(x[:, :1], KT - 1, 1), x], 1)
    serial = sum(serial_pad[:, i:i + x.shape[1]] for i in range(KT)) / KT
    half = x.shape[1] // N
    for r in range(N):
        got = ok(world["results"]["halo"], r)
        want = serial_pad[:, r * half:r * half + half + KT - 1]
        np.testing.assert_array_equal(got["padded"], want)
        np.testing.assert_allclose(got["conv"], serial, atol=1e-5, rtol=1e-5)

    def conv(xp):
        return sum(xp[:, i:i + xp.shape[1] - KT + 1] for i in range(KT)) / KT

    ref = j_cp_conv(conv, make_mesh(N, dp=1, tp=1, time=N), KT)(jnp.asarray(x))
    np.testing.assert_allclose(got["conv"], np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_cp_encode_and_decode_match_serial_and_jax(world, name):
    """``cp_vae_encode`` and ``cp_vae_decode`` over two time ranks (front
    pads, halos, masked group-norm moments, the uniform temporal pool and
    doubling) against the serial pass of the port and of the JAX package
    (whose own time-sharded pass tests/test_vae_cp.py holds to it; its
    shard_map compiles for minutes on this host, so it is not run here)."""
    params, tcfg, x, j_enc, j_dec = world["built"][name]
    port = vae3d_from_numpy(params, tcfg, "cpu")
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(x), sample=False)[0].numpy()
        dec = port.decode(torch.as_tensor(j_enc))[0].numpy()
    for r in range(N):
        got = ok(world["results"][name], r)
        for out, serial, ref in ((got["enc"], enc, j_enc), (got["dec"], dec, j_dec)):
            assert out.shape == serial.shape == ref.shape
            np.testing.assert_allclose(out, serial, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert dec.shape[1] == x.shape[1]
