"""The port's causal 3D VAE (fluidnexus_torch/diffusion/video/vae3d.py)
against the JAX package's on the CPU, from one random param tree: encode,
decode, the chunked decode with its carried conv cache (the reference
split), the chunked encode, and the nearest resize. Two
configs: the JAX tests' tiny VAE, and the 5B's ch_mult (1, 2, 2, 4) with 4x
temporal compression at 16 x 16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import vae3d_from_numpy
from fluidnexus_torch.diffusion.video import vae3d as tv
from fluidnexus_tpu.diffusion.video import vae3d as jv
from tests.test_torch_video_dit import random_flax_params
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CONFIGS = {
    "tiny": dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                 temporal_compress_times=2),
    "cm4": dict(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1, z_channels=4,
                temporal_compress_times=4),
}


def vaes(name, seed=0):
    kw = CONFIGS[name]
    jcfg, tcfg = jv.VAE3DConfig(**kw), tv.VAE3DConfig(**kw)
    jvae = jv.VideoVAE(jcfg)
    x = jnp.zeros((1, 1 + 2 * jcfg.temporal_compress_times, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jvae.init({"params": jax.random.PRNGKey(0)}, x))
    params = random_flax_params(shapes["params"], seed)
    return jvae, params, vae3d_from_numpy(params, tcfg, device="cpu")


def clip(t, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, t, 16, 16, 3)).astype(np.float32)


def close(out, ref, tol=1e-4):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("name", ["tiny", "cm4"])
def test_encode_and_decode_match_jax(name):
    jvae, params, tvae = vaes(name)
    x = clip(1 + 2 * jvae.cfg.temporal_compress_times, seed=1)
    z_ref, _ = jvae.apply({"params": params}, jnp.asarray(x), method=jvae.encode,
                          mutable=["cache"])
    dec_ref, _ = jvae.apply({"params": params}, z_ref, method=jvae.decode, mutable=["cache"])
    with torch.no_grad():
        z, cache = tvae.encode(torch.as_tensor(x))
        dec, _ = tvae.decode(torch.as_tensor(np.array(z_ref)))
    close(z.numpy(), z_ref)
    close(dec.numpy(), dec_ref)
    assert all(v.shape[2] == 2 for v in cache.values())   # k_t - 1 frames per causal conv


def test_chunked_decode_matches_jax():
    jvae, params, tvae = vaes("tiny", seed=2)
    z = np.random.default_rng(3).normal(size=(1, 5, 8, 8, 4)).astype(np.float32)
    ref = jv.chunked_decode(jvae, params, jnp.asarray(z), chunk=2)
    with torch.no_grad():
        out = tv.chunked_decode(tvae, torch.as_tensor(z), chunk=2)
    close(out.numpy(), ref)


def test_chunked_decode_carries_the_cache_across_chunks():
    """The chunked decode differs from the whole-clip decode only through
    the chunk-local GroupNorm statistics: with each chunk's cache replaced
    by the first-frame replicate, the outputs move far more."""
    _, _, tvae = vaes("tiny", seed=2)
    z = torch.as_tensor(np.random.default_rng(3).normal(size=(1, 5, 8, 8, 4)).astype(np.float32))
    with torch.no_grad():
        chunked = tv.chunked_decode(tvae, z, chunk=2)
        first, cache = tvae.decode(z[:, :3])
        cold = torch.cat([first, tvae.decode(z[:, 3:], first_chunk=True)[0]], 1)
        warm = torch.cat([first, tvae.decode(z[:, 3:], first_chunk=False, cache=cache)[0]], 1)
    torch.testing.assert_close(warm, chunked, rtol=0, atol=0)
    assert float((cold - chunked).abs().max()) > 1e-3


def test_chunked_encode_matches_jax():
    jvae, params, tvae = vaes("cm4", seed=4)
    x = clip(13, seed=5)     # 4 latents: a first chunk of 2, then 2
    ref = jv.chunked_encode(jvae, params, jnp.asarray(x), chunk=2)
    with torch.no_grad():
        out = tv.chunked_encode(tvae, torch.as_tensor(x), chunk=2)
    assert out.shape[1] == 4
    close(out.numpy(), ref)


def test_resize_nearest_matches_jax_image_resize():
    x = np.random.default_rng(6).normal(size=(1, 2, 3, 5, 7)).astype(np.float32)
    for size in ((6, 10, 14), (5, 3, 7), (1, 12, 9), (7, 5, 21)):
        ref = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), (1,) + size + (2,),
                               "nearest")
        out = tv.resize_nearest(torch.as_tensor(x), size)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref).transpose(0, 4, 1, 2, 3))
