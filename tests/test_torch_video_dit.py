"""The port's video DiT (fluidnexus_torch/diffusion/video/dit.py) against the
JAX package's on the CPU: the RoPE tables and timestep embedding, the param
tree conversion, and the whole forward with every leaf random, the adaLN
projections included (the JAX init zeroes them, which would keep attention
out of the output). The other video test files use ``random_flax_params``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import _flatten_flax, video_dit_from_numpy
from fluidnexus_torch.diffusion.video import dit as tdit
from fluidnexus_tpu.diffusion.video import dit as jdit

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=2, in_channels=4,
            out_channels=4, text_hidden_size=32, text_length=5, latent_frames=3,
            latent_height=8, latent_width=8)


def jax_and_torch_cfg(**kw):
    return (jdit.VideoDiTConfig(**kw, dtype=jnp.float32),
            tdit.VideoDiTConfig(**kw, dtype=torch.float32))


def random_flax_params(shapes, seed):
    """numpy leaves for a flax param-shape tree (boxes kept): kernels normal
    / sqrt(fan_in), scales 1 + 0.1 normal, everything else 0.1 normal."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
        leaf = [n for n in names if n != "value"][-1]
        if leaf == "kernel":
            x = rng.normal(size=s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif leaf.endswith("scale"):
            x = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            x = 0.1 * rng.normal(size=s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def dit_params(jcfg, seed):
    c = jcfg
    model = jdit.VideoDiT(c)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, c.latent_frames, c.in_channels, c.latent_height, c.latent_width)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, c.text_length, c.text_hidden_size)))
    return model, random_flax_params(shapes["params"], seed)


def dit_inputs(c, seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c.latent_frames, c.in_channels, c.latent_height,
                         c.latent_width)).astype(np.float32)
    t = np.array([10, 900][:b], np.int32)
    txt = rng.normal(size=(b, c.text_length, c.text_hidden_size)).astype(np.float32)
    return x, t, txt


@pytest.mark.parametrize("kw", [TINY, dict(TINY, hidden_size=128, num_heads=2, latent_frames=5,
                                           latent_height=12, latent_width=20)])
def test_make_3d_rope_matches_jax(kw):
    jc, tc = jax_and_torch_cfg(**kw)
    for a, b in zip(jdit.make_3d_rope(jc), tdit.make_3d_rope(tc)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_timestep_embedding_and_rope_rotation_match_jax():
    # cos and sin of f32 arguments up to 1e3 rad: the two libraries' sin
    # differ by up to ~2e-6 there
    t = np.array([0, 1, 17, 999], np.int32)
    np.testing.assert_allclose(tdit.timestep_embedding(torch.as_tensor(t), 64).numpy(),
                               np.asarray(jdit.timestep_embedding(jnp.asarray(t), 64)),
                               rtol=0, atol=1e-5)
    x = np.random.default_rng(1).normal(size=(2, 3, 7, 16)).astype(np.float32)
    np.testing.assert_array_equal(tdit.rotate_half_interleaved(torch.as_tensor(x)).numpy(),
                                  np.asarray(jdit.rotate_half_interleaved(jnp.asarray(x))))


def test_video_dit_from_numpy_round_trips():
    """Every flax leaf lands on the parameter of the same name, kernels
    transposed to (out, in); nothing is left over on either side."""
    jc, tc = jax_and_torch_cfg(**TINY)
    _, params = dit_params(jc, seed=2)
    model = video_dit_from_numpy(params, tc, device="cpu")
    own = dict(model.named_parameters())
    flat = _flatten_flax(params)
    assert len(flat) == len(own)
    for name, x in flat.items():
        if name.endswith(".kernel"):
            np.testing.assert_array_equal(own[name[:-6] + "weight"].detach().numpy(), x.T)
        else:
            np.testing.assert_array_equal(own[name].detach().numpy(), x)


@pytest.mark.parametrize("variant", [{}, dict(time_embed_dim=None, ln_affine=False)])
def test_dit_forward_matches_jax(variant):
    """1e-4 of the output's scale, with non-zero adaLN in every block."""
    jc, tc = jax_and_torch_cfg(**TINY, **variant)
    model, params = dit_params(jc, seed=3)
    assert np.abs(_flatten_flax(params)["block_1.adaLN.kernel"]).max() > 0
    x, t, txt = dit_inputs(jc, seed=4)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(txt)))
    port = video_dit_from_numpy(params, tc, device="cpu")
    with torch.no_grad():
        out = port(*(torch.as_tensor(a) for a in (x, t, txt))).numpy()
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_dit_gates_carry_attention_to_the_output():
    """With the adaLN projections zeroed (the JAX init) the attention output
    does not reach the prediction; with them random it does."""
    jc, tc = jax_and_torch_cfg(**TINY)
    _, params = dit_params(jc, seed=5)
    port = video_dit_from_numpy(params, tc, device="cpu")
    x, t, txt = (torch.as_tensor(a) for a in dit_inputs(jc, seed=6))
    with torch.no_grad():
        base = port(x, t, txt)
        port.block_0.attn.out.bias.add_(1.0)
        moved = float((port(x, t, txt) - base).abs().max())
        for blk in port.blocks():
            blk.adaLN.weight.zero_()
            blk.adaLN.bias.zero_()
        gated = port(x, t, txt)
        port.block_0.attn.out.bias.add_(1.0)
        still = float((port(x, t, txt) - gated).abs().max())
    assert moved > 1e-3 and still == 0.0


def test_init_video_dit_draws_the_flax_init():
    _, tc = jax_and_torch_cfg(**dict(TINY, hidden_size=256, num_heads=4))
    model = tdit.init_video_dit(tc, torch.Generator().manual_seed(0)).requires_grad_(False)
    blk = model.block_0
    assert float(blk.adaLN.weight.abs().max()) == 0.0 and float(model.final_adaLN.weight.abs().max()) == 0
    assert torch.equal(blk.ln1.scale, torch.ones(256)) and torch.equal(blk.attn.q_ln_bias, torch.zeros(64))
    w = blk.mlp.fc1.weight                      # (1024, 256): lecun normal, truncated at 2 std
    std = math.sqrt(1 / 256) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) - 1 / math.sqrt(256)) < 0.02 / math.sqrt(256)
    assert float(blk.mlp.fc1.bias.abs().max()) == 0.0
    again = tdit.init_video_dit(tc, torch.Generator().manual_seed(0))
    assert torch.equal(again.block_1.attn.qkv.weight, model.block_1.attn.qkv.weight)


def test_dit_refuses_lora():
    """A rank-0 DiT refuses a param tree with LoRA leaves; at rank 4 it builds
    with f32 adapters lora_a (in, rank) and lora_b (rank, out) on every
    attention and MLP projection and takes the tree."""
    jc, tc = jax_and_torch_cfg(**TINY, lora_rank=4)
    _, params = dit_params(jc, seed=7)
    with pytest.raises(ValueError, match="lora"):
        video_dit_from_numpy(params, dataclasses.replace(tc, lora_rank=0), device="cpu")
    model = video_dit_from_numpy(params, tc, device="cpu")
    qkv = model.block_1.attn.qkv
    assert qkv.lora_a.shape == (64, 4) and qkv.lora_b.shape == (4, 192)
    assert qkv.lora_a.dtype == qkv.lora_b.dtype == torch.float32
    assert sum(n.endswith(("lora_a", "lora_b")) for n, _ in model.named_parameters()) == 16
