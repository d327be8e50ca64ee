"""The port's video samplers (fluidnexus_torch/diffusion/video/sampling.py)
against the JAX package's on the CPU, on fixed denoisers. The stochastic
sampler draws its noise from a torch.Generator; the draws are recorded and
replayed into the JAX sampler by patching ``jax.random.normal`` for the
test's duration (the JAX package itself is unchanged)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.diffusion.video import sampling as ts
from fluidnexus_tpu.diffusion.video import sampling as js

SHAPE = (1, 4, 3, 6, 6)   # (B, T, C, H, W) latents


def record_noise(monkeypatch):
    """Wrap the port's noise source; returns the list of its draws."""
    draws = []
    real = ts._normal

    def recording(shape, generator, device):
        x = real(shape, generator, device)
        draws.append(x.numpy().copy())
        return x

    monkeypatch.setattr(ts, "_normal", recording)
    return draws


def replay_noise(monkeypatch, draws):
    """``jax.random.normal`` returns the recorded draws in order."""
    it = iter(draws)

    def normal(key, shape=(), dtype=jnp.float32):
        x = next(it)
        assert tuple(shape) == x.shape, (shape, x.shape)
        return jnp.asarray(x, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    return it


def fixed_denoisers(seed=0):
    """A smooth nonlinear v-network of x, t and the conditioning, the same
    function in both frameworks, wrapped in each package's VDenoiser."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(SHAPE[2], SHAPE[2])).astype(np.float32) * 0.5

    def v_jax(x, t, c):
        tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1, 1) / 1000.0
        return jnp.tanh(jnp.einsum("btchw,cd->btdhw", x, jnp.asarray(w))) * (1 + tt) \
            + c.mean((1, 2)).reshape(-1, 1, 1, 1, 1)

    def v_torch(x, t, c):
        tt = t.to(torch.float32).reshape(-1, 1, 1, 1, 1) / 1000.0
        return torch.tanh(torch.einsum("btchw,cd->btdhw", x, torch.as_tensor(w))) * (1 + tt) \
            + c.mean((1, 2)).reshape(-1, 1, 1, 1, 1)

    return js.VDenoiser(v_jax), ts.VDenoiser(v_torch)


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    cond = rng.normal(size=(1, 5, 8)).astype(np.float32)
    return x, cond, np.zeros_like(cond)


@pytest.mark.parametrize("num_steps", [4, 50, 1000])
def test_zero_snr_alphas_sqrt_is_exact(num_steps):
    for a, b in zip(js.zero_snr_alphas_sqrt(num_steps), ts.zero_snr_alphas_sqrt(num_steps)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_vdenoiser_and_dynamic_cfg_match_jax():
    dj, dt = fixed_denoisers()
    x, cond, _ = inputs()
    for a, t in ((0.0, 999), (0.31, 500), (0.97, 20)):
        np.testing.assert_allclose(dt(torch.as_tensor(x), a, t, torch.as_tensor(cond)).numpy(),
                                   np.asarray(dj(jnp.asarray(x), a, t, jnp.asarray(cond))),
                                   rtol=1e-6, atol=1e-6)
    gj, gt = js.DynamicCFG(scale=6.0, exp=5.0, num_steps=50), ts.DynamicCFG(6.0, 5.0, 50)
    u, c = np.random.default_rng(2).normal(size=(2,) + SHAPE).astype(np.float32)
    for step in (50, 31, 1):
        np.testing.assert_allclose(gt(torch.as_tensor(u), torch.as_tensor(c), step).numpy(),
                                   np.asarray(gj(jnp.asarray(u), jnp.asarray(c), step)),
                                   rtol=1e-6, atol=1e-6)


# SDEdit with a clean prefix (gen_refine_video), full strength (SDEdit
# skipped), the engine's fixed frames alone and with a clean prefix of the
# same length (train_video's preview samples)
@pytest.mark.parametrize("case", ["plain", "sdedit_prefix_clean", "sdedit_full_strength",
                                  "fixed_frames", "fixed_frames_prefix_clean"])
def test_dpmpp2m_sde_matches_jax_with_replayed_noise(case, monkeypatch):
    dj, dt = fixed_denoisers()
    x, cond, uc = inputs()
    rng = np.random.default_rng(3)
    prefix = lambda n: rng.normal(size=SHAPE[:1] + (n,) + SHAPE[2:]).astype(np.float32)
    kw = {}
    if case == "sdedit_prefix_clean":
        kw = dict(frames_z=rng.normal(size=SHAPE).astype(np.float32), sdedit_strength=0.6,
                  prefix_clean_frames=prefix(1))
    elif case == "sdedit_full_strength":
        kw = dict(frames_z=rng.normal(size=SHAPE).astype(np.float32), sdedit_strength=1.0)
    elif case == "fixed_frames":
        kw = dict(fixed_frames=2)
    elif case == "fixed_frames_prefix_clean":
        kw = dict(fixed_frames=2, prefix_clean_frames=prefix(2))
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    flags = {k: v for k, v in kw.items() if not isinstance(v, np.ndarray)}

    draws = record_noise(monkeypatch)
    out = ts.sample_dpmpp2m_sde(dt, torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(uc),
                                num_steps=8, rng=torch.Generator().manual_seed(0),
                                **{k: torch.as_tensor(v) for k, v in arrays.items()}, **flags)
    rest = replay_noise(monkeypatch, draws)
    ref = js.sample_dpmpp2m_sde(dj, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(uc),
                                num_steps=8, rng=jax.random.PRNGKey(0),
                                **{k: jnp.asarray(v) for k, v in arrays.items()}, **flags)
    assert next(rest, None) is None, "the JAX sampler drew fewer noise arrays than the port"
    assert len(draws) == (5 if case == "sdedit_prefix_clean" else 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if "prefix_clean" in case:
        n = kw["prefix_clean_frames"].shape[1]
        np.testing.assert_array_equal(out.numpy()[:, :n], kw["prefix_clean_frames"])
    elif case == "fixed_frames":
        np.testing.assert_array_equal(out.numpy()[:, :2], x[:, :2])
