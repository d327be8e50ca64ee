"""The training half of the port's video DiT against the JAX package's on the
CPU: ``LoRADense`` at rank > 0 and with the int8 base, ``quantize_dit_params``
and the int8 DiT, rematerialisation, ``engine.loss_fn`` and its LoRA
gradients, and the LoRA step and the full step as the JAX ``train`` builds
them (the CLI end to end: tests/test_torch_train_video_cli.py).

The port's draws (the VAE posterior and loss noise, the timestep indices, the
caption drops) are recorded at its draw functions and replayed into the JAX
code by patching ``jax.random.normal``, ``randint`` and ``bernoulli`` for the
test's duration (the JAX package itself is unchanged); the JAX side runs
un-jitted so that every draw is taken at run time. Tolerances, f32 unless
said: the forward and the loss at 1e-5 of scale, gradients at 1e-5 of each
leaf's max|ref|, updated leaves at 1e-2 of the two steps' largest move (Adam
divides by sqrt(v) + 1e-8, which magnifies the last-bit differences of a
gradient element near 0), bf16 at 2e-2 of scale."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fluidnexus_torch.convert import (
    _flatten_flax, flax_params_to_numpy, load_flax_params, video_dit_from_numpy,
)
from fluidnexus_torch.diffusion.video import conditioner as tcond
from fluidnexus_torch.diffusion.video import dit as tdit
from fluidnexus_torch.diffusion.video import engine as teng
from fluidnexus_torch.diffusion.video import sampling as tsamp
from fluidnexus_torch.pipelines import train_video as ttv
from fluidnexus_tpu.diffusion.video import dit as jdit
from fluidnexus_tpu.diffusion.video import engine as jeng
from tests.test_torch_video_dit import TINY, dit_inputs, random_flax_params
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

LR = 1e-3


def nest(flat):
    """{dotted name: array} -> a nested plain tree."""
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def cfgs(rank=4, dtype="f32", **kw):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    base = dict(TINY, lora_rank=rank, **kw)
    return jdit.VideoDiTConfig(**base, dtype=jd), tdit.VideoDiTConfig(**base, dtype=td)


def random_tree(jc, seed, lora_b=True):
    """Every leaf of the JAX DiT random (adaLN and lora_b included), as a
    plain numpy tree; ``lora_b=False`` leaves lora_b at its init, 0."""
    shapes = jax.eval_shape(
        jdit.VideoDiT(jc).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jc.latent_frames, jc.in_channels, jc.latent_height, jc.latent_width)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, jc.text_length, jc.text_hidden_size)))
    flat = _flatten_flax(random_flax_params(shapes["params"], seed))
    if not lora_b:
        flat = {k: (np.zeros_like(v) if k.endswith("lora_b") else v) for k, v in flat.items()}
    return nest(flat)


def close(out, ref, tol, what=""):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


class Draws:
    """Records the port's draws; ``replay`` patches the JAX random functions
    to return them in order."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.seen = {"normal": [], "bernoulli": [], "randint": []}
        for mod, name, kind in ((tsamp, "_normal", "normal"), (tcond, "_bernoulli", "bernoulli"),
                                (teng, "_randint", "randint")):
            self._record(mod, name, kind)

    def _record(self, mod, name, kind):
        real = getattr(mod, name)

        def recording(*a):
            x = real(*a)
            self.seen[kind].append(x.cpu().numpy().copy())
            return x

        self.mp.setattr(mod, name, recording)

    def replay(self):
        its = {k: iter(v) for k, v in self.seen.items()}

        def normal(key, shape=(), dtype=jnp.float32):
            x = next(its["normal"])
            assert tuple(shape) == x.shape, (shape, x.shape)
            return jnp.asarray(x, dtype)

        def bernoulli(key, p=0.5, shape=None):
            return jnp.asarray(next(its["bernoulli"]))

        def randint(key, shape, minval, maxval, dtype=jnp.int32):
            return jnp.asarray(next(its["randint"]), jnp.int32)

        self.mp.setattr(jax.random, "normal", normal)
        self.mp.setattr(jax.random, "bernoulli", bernoulli)
        self.mp.setattr(jax.random, "randint", randint)
        return its


# ------------------------------- the modules ---------------------------------


@pytest.mark.parametrize("rank,quant,dtype", [(4, False, "f32"), (4, True, "f32"),
                                              (0, True, "f32"), (4, False, "bf16"),
                                              (4, True, "bf16")])
def test_lora_dense_matches_jax(rank, quant, dtype):
    """x @ kernel (or (x @ kernel_q) * kernel_scale, the scale after the
    product) + bias + ((x @ lora_a) @ lora_b) * alpha, every leaf random."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(rank + 2 * quant)
    mod = jdit.LoRADense(16, rank=rank, quant=quant, dtype=jd)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.zeros((1, 24), jd))["params"]
    tree = {}
    for name, s in shapes.items():
        s = getattr(s, "value", s)     # unbox a flax Partitioned
        if name == "kernel_q":
            tree[name] = rng.integers(-127, 128, s.shape).astype(np.int8)
        elif name == "kernel_scale":
            tree[name] = rng.uniform(0.5, 1.5, s.shape).astype(np.float32) / 127 / math.sqrt(24)
        else:
            tree[name] = (rng.normal(size=s.shape) / math.sqrt(s.shape[0] if s.ndim == 2 else 10)
                          ).astype(np.float32)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    ref = np.asarray(mod.apply({"params": tree}, jnp.asarray(x, jd)), np.float32)
    port = load_flax_params(tdit.LoRADense(24, 16, td, rank, quant), tree, "cpu")
    with torch.no_grad():
        out = port(torch.as_tensor(x)).float().numpy()
    close(out, ref, 1e-5 if dtype == "f32" else 2e-2)


def test_quantize_dit_params_and_the_int8_dit_match_jax():
    """The int8 tree equal to JAX's leaf for leaf (kernel_q, kernel_scale, the
    adaLN projections included, everything else passed through); the int8
    DiT's forward at 1e-5 of scale."""
    jc, tc = cfgs(rank=4)
    tree = random_tree(jc, seed=11)
    jq = _flatten_flax(jdit.quantize_dit_params(tree))
    tq = tdit.quantize_dit_params(tree)
    flat = _flatten_flax(tq)
    assert set(flat) == set(jq) and "block_0.adaLN.kernel_q" in flat
    for k, v in jq.items():
        assert flat[k].dtype == v.dtype, k
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert not ttv._has_float_block_kernels(tq) and ttv._has_float_block_kernels(tree)
    jcq, tcq = dataclasses.replace(jc, base_quant=True), dataclasses.replace(tc, base_quant=True)
    x, t, txt = dit_inputs(jc, seed=12)
    ref = np.asarray(jdit.VideoDiT(jcq).apply({"params": nest(jq)}, *map(jnp.asarray, (x, t, txt))))
    port = video_dit_from_numpy(tq, tcq, "cpu")
    with torch.no_grad():
        out = port(*map(torch.as_tensor, (x, t, txt))).numpy()
    close(out, ref, 1e-5)


def test_lora_and_int8_trees_convert_both_ways():
    """A LoRA + int8 tree (numpy) -> the port's DiT -> numpy gives the tree
    back leaf for leaf: kernels transposed twice, int8 and f32 leaves in
    their types (what save_params writes)."""
    jc, tc = cfgs(rank=4)
    tree = tdit.quantize_dit_params(random_tree(jc, seed=21))
    model = video_dit_from_numpy(tree, dataclasses.replace(tc, base_quant=True), "cpu")
    back, flat = _flatten_flax(flax_params_to_numpy(dict(model.named_parameters()))), _flatten_flax(tree)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("group", [1, 3])
def test_remat_gives_the_gradients_of_no_remat(group):
    """Four blocks recomputed one by one (group 1) or as a group of 3 and one
    of 1 with a scope per block inside: the LoRA gradients are the same bits
    as without rematerialisation, and the blocks do run again."""
    jc, tc = cfgs(rank=4, num_layers=4)
    tree = random_tree(jc, seed=13)
    x, t, txt = map(torch.as_tensor, dit_inputs(jc, seed=14))
    grads, calls = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat, remat_group=group)
        model = video_dit_from_numpy(tree, cfg, "cpu").requires_grad_(False)
        lora, _ = teng.lora_partition(model)
        for p in lora.values():
            p.requires_grad_(True)
        n = [0]
        for blk in model.blocks():
            blk.register_forward_pre_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        loss = (model(x, t, txt) ** 2).mean()
        grads[remat] = torch.autograd.grad(loss, list(lora.values()))
        calls[remat] = n[0]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert calls[False] == 4 and calls[True] >= 8


@pytest.mark.parametrize("lora_b", [False, True], ids=["init", "trained"])
def test_loss_fn_and_lora_grads_match_jax(monkeypatch, lora_b):
    """loss_fn with prefix-i2v (one clean latent) and its gradient over the
    LoRA leaves. At init (lora_b 0) only lora_b has a gradient."""
    jc, tc = cfgs(rank=4)
    tree = random_tree(jc, seed=15, lora_b=lora_b)
    x, _, txt = dit_inputs(jc, seed=16)
    draws = Draws(monkeypatch)
    port = video_dit_from_numpy(tree, tc, "cpu").requires_grad_(False)
    lora, _ = teng.lora_partition(port)
    for p in lora.values():
        p.requires_grad_(True)
    loss, aux = teng.VideoEngine(tc, fixed_frames=1).loss_fn(
        port, torch.as_tensor(x), torch.as_tensor(txt), torch.Generator().manual_seed(0))
    grads = dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))

    draws.replay()
    engine = jeng.VideoEngine(jc, fixed_frames=1)
    lp, bp = jeng.lora_partition(tree)
    ref, rgrads = jax.value_and_grad(lambda q: engine.loss_fn(
        jeng.lora_merge(q, bp), jnp.asarray(x), jnp.asarray(txt), jax.random.PRNGKey(0))[0])(lp)
    rflat = {k: v for k, v in _flatten_flax(rgrads).items() if tdit.lora_param_filter(k)}
    assert set(rflat) == set(grads)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for k, g in grads.items():
        close(g.numpy(), rflat[k], 1e-5, k)
        if not lora_b:
            assert (float(g.abs().max()) > 0) == k.endswith("lora_b"), k


def _jax_steps(engine, tree, lora, latents, txt, n, decay):
    """``n`` steps of the JAX train step as ``train`` builds it (the LoRA
    step over the partitioned tree, or the full step with freeze_non_lora)."""
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    ema_update = lambda e, p: jax.tree_util.tree_map(lambda a, b: a * decay + (1.0 - decay) * b, e, p)
    losses, norms = [], []
    if lora:
        p, bp = jeng.lora_partition(tree)
        fn = lambda q: engine.loss_fn(jeng.lora_merge(q, bp), latents, txt, jax.random.PRNGKey(0))[0]
    else:
        p = tree
        fn = lambda q: engine.loss_fn(q, latents, txt, jax.random.PRNGKey(0))[0]
    s, ema = opt.init(p), jax.tree_util.tree_map(jnp.copy, p)
    for _ in range(n):
        loss, grads = jax.value_and_grad(fn)(p)
        if not lora:
            grads = jeng.freeze_non_lora(grads)
        norms.append(float(optax.global_norm(grads)))
        updates, s = opt.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        ema = ema_update(ema, p)
        losses.append(float(loss))
    return losses, norms, _flatten_flax(p), _flatten_flax(ema)


@pytest.mark.parametrize("kind", ["lora_clipped", "lora_unclipped", "full_f32", "full_bf16"])
def test_two_steps_match_jax(monkeypatch, kind):
    """Two LoRA steps (the optax chain clipping the first step's gradient, and
    clipping neither) and two
    full steps (rank 0: every gradient frozen, so only the decoupled weight
    decay moves the weights) with an EMA of decay 0.9, against the JAX step.
    In bf16 the full step's masters are JAX's f32 weights bit for bit, though
    the 2 lr * 1e-4 decay is below the bf16 weights' rounding."""
    lora = kind.startswith("lora")
    jc, tc = cfgs(rank=4 if lora else 0, dtype="bf16" if kind == "full_bf16" else "f32")
    tree = random_tree(jc, seed=17)
    x, _, txt = dit_inputs(jc, seed=18)
    if kind == "lora_clipped":
        x = x * 200.0    # large latents, large residuals: |g| > 1
    draws = Draws(monkeypatch)
    dit = video_dit_from_numpy(tree, tc, "cpu")
    masters = {k: torch.as_tensor(v) for k, v in ttv._flat_torch_layout(tree).items()}
    trainer = ttv.VideoTrainer(teng.VideoEngine(tc, fixed_frames=1), dit, LR, 0.9,
                               masters=None if lora else masters)
    losses = [float(trainer.step(torch.as_tensor(x), torch.as_tensor(txt),
                                 torch.Generator().manual_seed(i))) for i in range(2)]

    draws.replay()
    ref_losses, norms, ref, ref_ema = _jax_steps(jeng.VideoEngine(jc, fixed_frames=1), tree, lora,
                                                 jnp.asarray(x), jnp.asarray(txt), 2, 0.9)
    if lora:
        assert (norms[0] >= 1.0) if kind == "lora_clipped" else max(norms) < 1.0, norms
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5 if kind != "full_bf16" else 2e-2)
    port = {k: v.detach() for k, v in trainer.params.items()}
    names = list(port)
    assert len(names) == (sum(k.endswith(("lora_a", "lora_b")) for k in ref) if lora else len(ref))
    for n in names:
        key = n[:-len("weight")] + "kernel" if n.endswith(".weight") else n
        r = ref[key].T if n.endswith(".weight") else ref[key]
        e = ref_ema[key].T if n.endswith(".weight") else ref_ema[key]
        if lora:
            move = 2 * LR
            np.testing.assert_allclose(port[n].numpy(), r, rtol=0, atol=1e-2 * move, err_msg=n)
            np.testing.assert_allclose(trainer.ema[n].numpy(), e, rtol=0, atol=1e-2 * move,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(port[n].numpy(), r, err_msg=n)
            np.testing.assert_array_equal(trainer.ema[n].numpy(), e, err_msg=n)
    if not lora:
        w0 = masters["block_0.mlp.fc1.weight"]
        w2 = trainer.params["block_0.mlp.fc1.weight"]
        torch.testing.assert_close(w2, w0 * (1 - LR * 1e-4) ** 2, rtol=1e-6, atol=0)
        assert float((w2 - w0).abs().max()) > 0
        own = dict(dit.named_parameters())["block_0.mlp.fc1.weight"]
        assert torch.equal(own, w2.to(own.dtype))
        if kind == "full_bf16":   # the decay alone is lost in a bf16 copy
            assert float((w2.bfloat16() != w0.bfloat16()).float().mean()) < 0.05
