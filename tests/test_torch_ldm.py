"""The port's novel-view LDM modules (``fluidnexus_torch/diffusion/ldm``)
against the JAX package's on the CPU, at ``tests/test_ldm.py``'s tiny configs
and the ``--tiny`` CLI's, from the same random flax trees. The modules are
held to 1e-5 x max|ref|, the sampler to 1e-4 x max|ref|; the JAX side runs
under ``jax.jit``. The port's draws are recorded and replayed into JAX by
``KeyReplay``. The full-width parameter tree is checked name for name and
shape for shape against ``jax.eval_shape`` of the JAX init, on the ``meta``
device."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import (
    _flatten_flax, _torch_layout, flax_params_to_numpy, load_flax_params, novel_view_from_numpy,
)
from fluidnexus_torch.diffusion.ldm import autoencoder as ta
from fluidnexus_torch.diffusion.ldm import clip as tc
from fluidnexus_torch.diffusion.ldm import model as tm
from fluidnexus_torch.diffusion.ldm import unet as tu
from fluidnexus_tpu.diffusion.ldm import autoencoder as ja
from fluidnexus_tpu.diffusion.ldm import clip as jc
from fluidnexus_tpu.diffusion.ldm import model as jm
from fluidnexus_tpu.diffusion.ldm import unet as ju
from tests.test_torch_video_dit import random_flax_params
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

MODULE_TOL = 1e-5
SAMPLER_TOL = 1e-4

TINY_UNET = dict(in_channels=8, out_channels=4, model_channels=32, channel_mult=(1, 2),
                 num_res_blocks=1, attention_resolutions=(1, 2), num_heads=4, context_dim=16)
CLI_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                attention_resolutions=(2,), num_heads=4, context_dim=768)
TINY_VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
TINY_CLIP = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4, output_dim=12)
CLI_CLIP = dict(image_size=28, patch_size=14, width=32, layers=1, heads=4, output_dim=768)


def held(got, ref, tol, what=""):
    """max|got - ref| <= tol x max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol} x {scale:.3e}"


def tiny_models(seed=0):
    """The JAX and the port's ``NovelViewModel`` at the ``--tiny`` CLI's
    geometry, and a random flax tree (every leaf non-zero) for both."""
    jmodel = jm.NovelViewModel(unet_config=ju.UNetConfig(**CLI_UNET),
                               vae_config=ja.KLVAEConfig(**TINY_VAE),
                               clip_config=jc.CLIPVisionConfig(**CLI_CLIP))
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), image_size=32))
    params = random_flax_params(shapes, seed)
    configs = dict(unet_config=tu.UNetConfig(**CLI_UNET), vae_config=ta.KLVAEConfig(**TINY_VAE),
                   clip_config=tc.CLIPVisionConfig(**CLI_CLIP))
    return jmodel, params, novel_view_from_numpy(params, configs, "cpu")


def pair_inputs(b=4, size=32, seed=1):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    cond = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    dt = rng.normal(size=(b, 4)).astype(np.float32)
    return tgt, cond, dt


class KeyReplay:
    """The port's draws (``model._normal``, ``_uniform``, ``_randint``)
    recorded, then handed to the JAX package's code through a patched
    ``jax.random``, jitted or not. A key is a uint32 [n, s]: the host's key
    is [m, MARK] and its n-th split hands out [n, 0]; below that, split
    children are [n, 8 s + j + 1] and ``fold_in(key, i)`` is [n, FOLD + i].
    A draw reads the table its role's code names at row n - 1 (and step i):
    the loss's split(k, 4) gives the posterior noise (s 1), the timesteps
    (2), the eps noise (3) and the dropout uniform (split of 4: 33); the
    sampler's split(k) gives its start noise (2) and, folded, its step
    noise."""

    MARK, FOLD = 0xFFFF, 1 << 20
    CODES = {("normal", "enc"): 1, ("normal", "eps"): 3, ("normal", "start"): 2,
             ("randint", "t"): 2, ("uniform", "u"): 33}

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.seen = {"normal": [], "uniform": [], "randint": []}
        for kind in self.seen:
            self._record(kind)
        self.rows = {}

    def _record(self, kind):
        real = getattr(tm, "_" + kind)

        def recording(*a):
            x = real(*a)
            self.seen[kind].append(x.cpu().numpy().copy())
            return x

        self.mp.setattr(tm, "_" + kind, recording)

    def put(self, role, n, value):
        """Row n (1-based) of a role's table: "enc", "eps", "t", "u",
        "start", or "step" (all of one sample's step noise)."""
        self.rows.setdefault(role, {})[n] = np.asarray(value)

    def loss_rows(self, n_calls, first=1, stride=1):
        """The recorded draws of ``n_calls`` losses as rows first, first +
        stride, ...: two normals (posterior, eps), a uniform, a randint each."""
        for c in range(n_calls):
            n = first + c * stride
            self.put("enc", n, self.seen["normal"].pop(0))
            self.put("u", n, self.seen["uniform"].pop(0))
            self.put("t", n, self.seen["randint"].pop(0))
            self.put("eps", n, self.seen["normal"].pop(0))

    def sample_rows(self, n_calls, steps, first=1, stride=1):
        for c in range(n_calls):
            n = first + c * stride
            self.put("start", n, self.seen["normal"].pop(0))
            self.put("step", n, np.stack([self.seen["normal"].pop(0) for _ in range(steps)]))

    def install(self):
        tables = {}
        for role, rows in self.rows.items():
            first = next(iter(rows.values()))
            t = np.zeros((max(rows),) + first.shape, first.dtype)
            for n, v in rows.items():
                t[n - 1] = v
            tables[role] = jnp.asarray(t)
        mark, fold = self.MARK, self.FOLD

        def concrete(key):
            try:
                return np.asarray(key)
            except Exception:   # a tracer: inside jitted code
                return None

        def prng_key(seed):
            return jnp.asarray([0, mark], jnp.uint32)

        def split(key, num=2):
            a = concrete(key)
            if a is not None and int(a[1]) == mark:
                n = int(a[0]) + 1
                return jnp.asarray([[n, mark]] + [[n, 0]] * (num - 1), jnp.uint32)
            key = jnp.asarray(key, jnp.uint32)
            return jnp.stack([jnp.stack([key[0], key[1] * 8 + j + 1]) for j in range(num)])

        def fold_in(key, data):
            return jnp.stack([key[0], jnp.uint32(fold) + jnp.asarray(data, jnp.uint32)])

        def pick(kind, key, shape):
            n, s = key[0].astype(jnp.int32) - 1, key[1]
            out = None
            for (k, role), code in self.CODES.items():
                if k == kind and role in tables and tables[role].shape[1:] == tuple(shape):
                    v = tables[role][n]
                    out = v if out is None else jnp.where(s == code, v, out)
            if kind == "normal" and "step" in tables and tables["step"].shape[2:] == tuple(shape):
                i = jnp.clip(s.astype(jnp.int32) - fold, 0, tables["step"].shape[1] - 1)
                v = tables["step"][n, i]
                out = v if out is None else jnp.where(s >= fold, v, out)
            assert out is not None, (kind, shape)
            return out

        self.mp.setattr(jax.random, "PRNGKey", prng_key)
        self.mp.setattr(jax.random, "split", split)
        self.mp.setattr(jax.random, "fold_in", fold_in)
        self.mp.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: pick("normal", key, shape))
        self.mp.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: pick("uniform", key, shape))
        self.mp.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, dtype=jnp.int32:
                        pick("randint", key, shape).astype(jnp.int32))


# --------------------------------- modules ----------------------------------


@pytest.mark.parametrize("cfg", [TINY_UNET, CLI_UNET], ids=["test_ldm", "cli_tiny"])
def test_unet_matches_jax(cfg):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    t = np.array([3, 800], np.int32)
    ctx = rng.normal(size=(2, 1, cfg["context_dim"])).astype(np.float32)
    jnet = ju.UNet(ju.UNetConfig(**cfg))
    params = random_flax_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, t, ctx)
                                ["params"], 1)
    ref = jax.jit(lambda p: jnet.apply({"params": p}, x, t, ctx))(params)
    net = load_flax_params(tu.UNet(tu.UNetConfig(**cfg)), params, "cpu")
    with torch.no_grad():
        got = net(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    held(got, ref, MODULE_TOL, "unet")


def test_timestep_embedding_is_cos_then_sin():
    """[cos, sin] of t x freqs in f32: the port's values are the float64
    cos and sin of its f32 arguments to 1e-6. Against JAX they differ by up
    to 1e-4 at t = 999: XLA's and torch's f32 ``exp`` part in the last bit of
    some frequencies (6e-8), which t multiplies."""
    t = np.array([0, 1, 499, 999], np.int32)
    ref = np.asarray(ju.timestep_embedding(jnp.asarray(t), 320))
    got = tu.timestep_embedding(torch.as_tensor(t), 320).numpy()
    freqs = torch.exp(-math.log(10000) * torch.arange(160, dtype=torch.float32) / 160)
    args = (torch.as_tensor(t).float()[:, None] * freqs[None]).double().numpy()
    np.testing.assert_allclose(got, np.concatenate([np.cos(args), np.sin(args)], -1), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0], np.r_[np.ones(160), np.zeros(160)])


@pytest.mark.parametrize("size", [16, 24])
def test_vae_encode_and_decode_match_jax(size):
    """The posterior mode, a posterior sample on the same noise, and the
    decode of the JAX latent; 24 px runs the encoder's (0, 1) padding on an
    odd-sized 12 x 12 -> 6 x 6 level."""
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    vae = ja.AutoencoderKL(ja.KLVAEConfig(**TINY_VAE))
    params = random_flax_params(jax.eval_shape(
        lambda: vae.init({"params": jax.random.PRNGKey(1)}, x))["params"], 2)
    noise = rng.normal(size=(2, size // 2, size // 2, 4)).astype(np.float32)
    mode = jax.jit(lambda p: vae.apply({"params": p}, x, method=vae.encode))(params)
    sample = jax.jit(lambda p: vae.apply(
        {"params": p}, x, method=vae.encode, rng=jax.random.PRNGKey(0), sample=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
        sample = sample(params)
    dec = jax.jit(lambda p, z: vae.apply({"params": p}, z, method=vae.decode))(params, mode)
    tvae = load_flax_params(ta.AutoencoderKL(ta.KLVAEConfig(**TINY_VAE)), params, "cpu")
    with torch.no_grad():
        held(tvae.encode(torch.as_tensor(x)), mode, MODULE_TOL, "encode mode")
        held(tvae.encode(torch.as_tensor(x), noise=torch.as_tensor(noise)), sample, MODULE_TOL,
             "encode sample")
        held(tvae.decode(torch.as_tensor(np.array(mode))), dec, MODULE_TOL, "decode")


def test_clip_matches_jax():
    """32 px images through the tower's 32 -> 28 bilinear resize, 2 layers."""
    im = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    tower = jc.CLIPVisionTower(jc.CLIPVisionConfig(**TINY_CLIP))
    params = random_flax_params(jax.eval_shape(tower.init, jax.random.PRNGKey(0), im)["params"], 4)
    ref = jax.jit(lambda p: tower.apply({"params": p}, im))(params)
    net = load_flax_params(tc.CLIPVisionTower(tc.CLIPVisionConfig(**TINY_CLIP)), params, "cpu")
    with torch.no_grad():
        held(net(torch.as_tensor(im)), ref, MODULE_TOL, "clip")


@pytest.mark.parametrize("n_in,n_out", [(256, 224), (32, 28), (20, 28)])
def test_clip_resize_is_jax_bilinear(n_in, n_out):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks;
    torch's bilinear without antialiasing does not, and is not held here."""
    x = np.random.default_rng(n_in).normal(size=(2, n_in, n_in, 3)).astype(np.float32)
    ref = jax.image.resize(x, (2, n_out, n_out, 3), "bilinear")
    held(tc.resize_bilinear(torch.as_tensor(x), n_out), ref, 1e-6, "resize")


def test_pose_delta_is_the_jax_function():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = (np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                rng.normal(size=(3, 1)) * 2], 1).astype(np.float32)
                for _ in range(2))
        np.testing.assert_array_equal(tm.get_pose_delta(a, b), jm.get_pose_delta(a, b))


# ------------------------------ the model glue -------------------------------


@pytest.mark.parametrize("dropout", [False, True])
def test_conditioning_matches_jax(monkeypatch, dropout):
    """Context and concat latent; with dropout, the uniform draws 0.02 (drop
    the prompt), 0.07 (both), 0.12 (the image) and 0.5 (neither) give every
    branch of the 5/5/5 scheme, the CLIP embedding zeroed before ``cc``."""
    jmodel, params, model = tiny_models()
    _, cond, dt = pair_inputs()
    r = np.array([0.02, 0.07, 0.12, 0.5], np.float32)
    monkeypatch.setattr(tm, "_uniform", lambda shape, g, d: torch.as_tensor(r))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(r))
    key = jax.random.PRNGKey(0) if dropout else None
    ctx_j, concat_j = jax.jit(lambda p: jmodel.conditioning(p, cond, dt, key, cfg_dropout=dropout))(
        params)
    with torch.no_grad():
        ctx, concat = model.conditioning(torch.as_tensor(cond), torch.as_tensor(dt),
                                         torch.Generator() if dropout else None,
                                         cfg_dropout=dropout)
    held(ctx, ctx_j, MODULE_TOL, "context")
    held(concat, concat_j, MODULE_TOL, "concat")
    if dropout:
        assert (concat.abs().amax((1, 2, 3)) == 0).tolist() == [False, True, True, False]
        pose_only = model.cc(torch.cat([torch.zeros(4, 1, 768), torch.as_tensor(dt)[:, None]], -1))
        assert (ctx == pose_only).all((1, 2)).tolist() == [True, True, False, False]


def test_loss_and_gradient_match_jax(monkeypatch):
    """``loss_fn`` and its gradient for the UNet and ``cc`` (the leaves
    training updates), on the port's draws replayed."""
    jmodel, params, model = tiny_models()
    tgt, cond, dt = pair_inputs()
    replay = KeyReplay(monkeypatch)
    loss = model.loss_fn(*(torch.as_tensor(a) for a in (tgt, cond, dt)),
                         torch.Generator().manual_seed(3))
    named = {n: p for n, p in model.named_parameters() if n.startswith(("unet.", "cc."))}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    replay.loss_rows(1)
    replay.install()
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, k: jmodel.loss_fn(p, tgt, cond, dt, k)))(params, key)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=MODULE_TOL)
    jflat = dict(_torch_layout(k, v) for k, v in _flatten_flax(
        jax.tree.map(np.asarray, {"unet": jgrads["unet"], "cc": jgrads["cc"]})).items())
    assert set(jflat) == set(grads)
    # a leaf whose gradient is 0 but for rounding is held to the tree's
    # largest: the cross-attention's to_q, to_k and LayerNorm_1 (a softmax
    # over the one context token is 1 whatever its logit), and a per-channel
    # shift ahead of a GroupNorm of one-channel groups (down_0_res_0's conv1
    # bias and emb_proj)
    top = max(float(np.abs(v).max()) for v in jflat.values())
    zero = {n for n, v in jflat.items() if np.abs(v).max() < 1e-6 * top}
    assert {"unet.down_0_res_0.conv1.bias", "unet.mid_attn.block_0.attn2.to_q.weight"} <= zero
    assert len(zero) < len(jflat) // 4
    for n, g in grads.items():
        if n in zero:
            assert np.abs(g.numpy() - jflat[n]).max() <= MODULE_TOL * top, n
        else:
            held(g.numpy(), jflat[n], MODULE_TOL, n)


def test_ddim_sample_matches_jax(monkeypatch):
    """A 4-step CFG-3.0 DDIM sample (eta 1) decoded, on the port's start and
    step noise replayed into the jitted JAX sampler."""
    jmodel, params, model = tiny_models()
    _, cond, dt = pair_inputs(b=2)
    replay = KeyReplay(monkeypatch)
    got = model.ddim_sample(torch.as_tensor(cond), torch.as_tensor(dt),
                            torch.Generator().manual_seed(4), num_steps=4, image_size=32)
    replay.sample_rows(1, 4)
    replay.install()
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    ref = jax.jit(lambda p, k: jmodel.ddim_sample(p, cond, dt, k, num_steps=4, image_size=32))(
        params, key)
    held(got, ref, SAMPLER_TOL, "ddim sample")
    assert float(got.std()) > 0.01


# -------------------------------- weights -----------------------------------


def test_tree_round_trips_and_init_families():
    """A JAX tree loads and comes back bit for bit; ``init_novel_view``
    draws flax's families (lecun-normal kernels, zero biases, the zeroed
    UNet convs, the identity ``cc``, normal(0.02) CLIP embeddings)."""
    _, params, model = tiny_models()
    back = _flatten_flax(flax_params_to_numpy(dict(model.named_parameters())))
    ref = _flatten_flax(params)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)

    init = tm.init_novel_view(tm.build_novel_view("cpu", **{
        "unet_config": tu.UNetConfig(**CLI_UNET), "vae_config": ta.KLVAEConfig(**TINY_VAE),
        "clip_config": tc.CLIPVisionConfig(**CLI_CLIP)}), torch.Generator().manual_seed(0))
    p = dict(init.named_parameters())
    for name in ("unet.conv_out.weight", "unet.down_0_res_0.conv2.weight",
                 "unet.down_1_attn_0.proj_out.weight"):
        assert not p[name].any(), name
    assert p["vae.decoder.conv_out.weight"].any() and not p["unet.conv_out.bias"].any()
    np.testing.assert_array_equal(p["cc.weight"][:, :768].detach().numpy(), np.eye(768))
    assert not p["cc.weight"][:, 768:].any()
    assert abs(float(p["clip.positional_embedding"].std()) - 0.02) < 0.002
    w = p["unet.time_fc2.weight"]
    assert abs(float(w.std()) * math.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / math.sqrt(w.shape[1]) + 1e-6
    assert bool((p["unet.GroupNorm32_0.GroupNorm_0.scale"] == 1).all())


def test_full_width_tree_matches_jax_eval_shape():
    """The default geometry (UNet 320 x (1, 2, 4, 4), ViT-L/14, KL-VAE 128)
    built on the ``meta`` device: its names and shapes in the flax layout
    are those of ``jax.eval_shape(NovelViewModel().init_params)`` at 256 px,
    so a real checkpoint loads with ``novel_view_from_numpy``."""
    shapes = jax.eval_shape(lambda: jm.NovelViewModel().init_params(jax.random.PRNGKey(0), 256))
    want = {}
    for name, s in _flatten_flax(jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)).items():
        tname, x = _torch_layout(name, s)
        want[tname] = tuple(x.shape)
    with torch.device("meta"):
        model = tm.NovelViewModel()
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 1_247_746_219
