"""The port's video sampling path against the JAX package's on the CPU: the
engine's ``sample`` and ``decode_first_stage``, and ``sample_video.main
--tiny`` end to end from checkpoints the JAX package wrote, with the port's
noise replayed into JAX (``jax.random.normal`` patched for the test's
duration); the npz loaders and the hash text encoder."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fluidnexus_torch.convert import vae3d_from_numpy, video_dit_from_numpy
from fluidnexus_torch.core import checkpoint as tck
from fluidnexus_torch.diffusion.video import conditioner as tcond
from fluidnexus_torch.diffusion.video.engine import VideoEngine
from fluidnexus_torch.pipelines import sample_video as tsv
from fluidnexus_tpu.core import checkpoint as jck
from fluidnexus_tpu.diffusion.video import conditioner as jcond
from fluidnexus_tpu.diffusion.video import engine as jeng
from fluidnexus_tpu.pipelines import sample_video as jsv
from tests.test_torch_video_dit import dit_params, random_flax_params
from tests.test_torch_video_sampling import record_noise, replay_noise
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

ARGV = ["--tiny", "--prompt", "smoke rises past a cylinder", "--num_frames", "9", "--height",
        "32", "--width", "48", "--num_steps", "4", "--seed", "3"]


@pytest.fixture(scope="module")
def tiny():
    """The ``--tiny`` configs of both CLIs at 9 x 32 x 48, and random param
    trees (adaLN non-zero) for each."""
    jdit_cfg, jvae_cfg = jsv.VideoDiTConfig(
        hidden_size=64, num_layers=2, num_heads=4, text_hidden_size=64, text_length=8,
        latent_frames=3, latent_height=4, latent_width=6, dtype=jnp.float32), \
        jsv.VAE3DConfig(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1)
    tdit_cfg, tvae_cfg = tsv.configs(9, 32, 48, tiny=True)
    _, dit = dit_params(jdit_cfg, seed=11)
    jvae = jeng.VideoVAE(jvae_cfg)
    shapes = jax.eval_shape(lambda: jvae.init({"params": jax.random.PRNGKey(0)},
                                              jnp.zeros((1, 9, 32, 48, 3))))
    vae = random_flax_params(shapes["params"], seed=12)
    return dict(jcfg=(jdit_cfg, jvae_cfg), tcfg=(tdit_cfg, tvae_cfg), dit=dit, vae=vae)


def save_with_jax(tree, path, monkeypatch):
    """The JAX package's ``save_params`` through its flat-npz branch (orbax
    made unimportable for the call)."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "orbax.checkpoint", None)
        jck.save_params(path, tree)
    return path


def test_engine_sample_and_decode_match_jax(tiny, monkeypatch):
    (jdc, jvc), (tdc, tvc) = tiny["jcfg"], tiny["tcfg"]
    text = np.random.default_rng(13).normal(size=(1, 8, 64)).astype(np.float32)
    shape = (1, 3, 16, 4, 6)
    teng = VideoEngine(tdc, tvc)
    dit = video_dit_from_numpy(tiny["dit"], tdc, device="cpu")
    vae = vae3d_from_numpy(tiny["vae"], tvc, device="cpu")
    draws = record_noise(monkeypatch)
    lat = teng.sample(dit, shape, torch.as_tensor(text), torch.zeros(1, 8, 64),
                      rng=torch.Generator().manual_seed(0), num_steps=4)
    frames = teng.decode_first_stage(vae, lat.permute(0, 1, 3, 4, 2))
    assert len(draws) == 1 + 3      # the start, then every step but the last

    rest = replay_noise(monkeypatch, draws)
    jeng_ = jeng.VideoEngine(jdc, jvc)
    lat_ref = jeng_.sample(tiny["dit"], shape, jnp.asarray(text), jnp.zeros((1, 8, 64)),
                           rng=jax.random.PRNGKey(0), num_steps=4)
    frames_ref = jeng_.decode_first_stage(tiny["vae"], jnp.transpose(lat_ref, (0, 1, 3, 4, 2)))
    assert next(rest, None) is None
    for out, ref in ((lat, lat_ref), (frames, frames_ref)):
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert frames.shape == (1, 9, 32, 48, 3)


def test_main_tiny_from_jax_checkpoints_matches_the_jax_cli(tiny, tmp_path, monkeypatch):
    """Both CLIs from the same npz checkpoints (written by the JAX package)
    with the same noise: 9 PNGs each, equal to within one 8-bit level."""
    dit_ckpt = save_with_jax(tiny["dit"], str(tmp_path / "dit.npz"), monkeypatch)
    vae_ckpt = save_with_jax(tiny["vae"], str(tmp_path / "vae.npz"), monkeypatch)
    ckpts = ["--dit_ckpt", dit_ckpt, "--vae_ckpt", vae_ckpt]
    draws = record_noise(monkeypatch)
    out = tsv.main(ARGV + ckpts + ["--out_folder", str(tmp_path / "port")], device="cpu")
    rest = replay_noise(monkeypatch, draws)
    jsv.main(ARGV + ckpts + ["--out_folder", str(tmp_path / "jax")])
    assert next(rest, None) is None
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 9
    for i, name in enumerate(names):
        port = np.asarray(Image.open(tmp_path / "port" / name))
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        assert port.shape == ref.shape == (32, 48, 3)
        assert np.abs(port.astype(int) - ref.astype(int)).max() <= 1, name
        # the PNG holds the returned frame's pixels exactly
        want = np.clip((out[0, i].numpy() + 1) * 127.5, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(port, want)


def test_main_tiny_draws_its_own_weights(tmp_path):
    out = tsv.main(ARGV + ["--out_folder", str(tmp_path)], device="cpu")
    assert out.shape == (1, 9, 32, 48, 3) and torch.isfinite(out).all()
    assert len(os.listdir(tmp_path)) == 9


def test_load_params_reads_the_jax_npz(tiny, tmp_path, monkeypatch):
    path = save_with_jax(tiny["dit"], str(tmp_path / "dit"), monkeypatch)
    loaded = tck.load_params(path)
    ref = jck.load_params(path)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree_util.tree_leaves(loaded))
    for p, x in flat:
        node = loaded
        for k in p:
            node = node[k.key]
        np.testing.assert_array_equal(node, x)
    # an _ema sibling is preferred, as the JAX loader prefers it
    save_with_jax({"a": np.ones(2, np.float32)}, str(tmp_path / "dit_ema.npz"), monkeypatch)
    np.testing.assert_array_equal(tck.load_params_prefer_ema(path)["a"], np.ones(2))
    # a directory is read as an orbax checkpoint (tests/test_torch_checkpoint.py);
    # one without orbax's _METADATA raises
    with pytest.raises(FileNotFoundError, match="orbax"):
        tck.load_params(str(tmp_path))


def test_hash_text_encoder_matches_jax_and_refuses_t5():
    texts = ["smoke rising", "a b c d e f g h i j"]
    ref = np.asarray(jcond.HashTextEncoder(8, 32)(texts))
    np.testing.assert_array_equal(tcond.HashTextEncoder(8, 32)(texts, device="cpu").numpy(), ref)
    if not torch.cuda.is_available():   # the card by default, as every entry point
        with pytest.raises(RuntimeError, match="cuda"):
            tcond.HashTextEncoder(8, 32)(texts)
    assert isinstance(tcond.make_text_encoder(None, 8, 32, allow_fake=True), tcond.HashTextEncoder)
    with pytest.raises(RuntimeError, match="allow_fake_conditioning"):
        tcond.make_text_encoder(None, 8, 32)
    # a T5 directory that does not load falls back to the hash encoder with the
    # opt-in and raises without it, as in JAX (tests/test_torch_t5.py)
    assert isinstance(tcond.make_text_encoder("/nonexistent/t5", 8, 32, allow_fake=True),
                      tcond.HashTextEncoder)
    with pytest.raises(RuntimeError, match="allow_fake_conditioning"):
        tcond.make_text_encoder("/nonexistent/t5", 8, 32)
