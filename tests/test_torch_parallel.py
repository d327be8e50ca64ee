"""The port's parallel layer (``fluidnexus_torch/parallel``) on four gloo
ranks of this host against the JAX package on its 8 virtual CPU devices.

One process group serves the whole file: a module fixture starts four ranks
once (``tests/torch_dist_ranks.spawn``), each runs every case of
``tests/torch_parallel_cases`` in turn, and each test below reads its case's
result. The ranks hold:
- ``make_mesh``'s shapes and its assert;
- the sampled latents at (dp, tp) = (2, 2), (1, 4) and (4, 1) against the
  JAX engine's sample, unsharded and through ``shard_for_generation`` on its
  dp 2 x tp 2 mesh (JAX's ``atol`` 2e-4), the port's noise replayed into
  JAX;
- two LoRA steps at dp 2 x tp 2 (the LoRA leaves, the EMA and the ZeRO
  moments gathered back) against JAX's step on its mesh and the port's on
  one rank, within 1e-5;
- ``sample_video``, ``gen_refine_video`` and ``gen_future_video`` at ``--tp
  2 --dp 2``, ``train_video --tp 2`` (dp 2, a save, then a resume) and
  ``train_novel_view`` (dp 4) through their CLIs against the same CLIs on
  one rank; ranks 1-3 write nothing.
Without the ranks (this process), ``_zero_extend`` and the tensor-parallel
map against JAX's, and each flag's error when its ranks are missing."""
import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

from fluidnexus_torch.convert import _flatten_flax, _torch_layout, video_dit_from_numpy
from fluidnexus_torch.core.checkpoint import save_params
from fluidnexus_torch.diffusion.video import dit as tdit
from fluidnexus_torch.diffusion.video import engine as teng
from fluidnexus_torch.parallel import mesh as pm
from fluidnexus_torch.pipelines import gen_future_video as tfut
from fluidnexus_torch.pipelines import gen_refine_video as tref
from fluidnexus_torch.pipelines import sample_video as tsv
from fluidnexus_torch.pipelines import train_novel_view as tnv
from fluidnexus_torch.pipelines import train_video as ttv
from fluidnexus_tpu.diffusion.video import dit as jdit
from fluidnexus_tpu.diffusion.video import engine as jeng
from fluidnexus_tpu.parallel import mesh as jmesh
from tests.test_torch_novel_view import noise_only_leaves, tiny_models, write_views
from tests.test_torch_refine_video import _cli_argv, _cli_inputs
from tests.test_torch_sample_video import ARGV as SAMPLE_ARGV
from tests.test_torch_train_video import LR, Draws, cfgs, random_tree
from tests.test_torch_train_video_cli import _clip_folder, _tiny_ckpts
from tests.test_torch_video_dit import dit_inputs
from tests.test_torch_video_sampling import record_noise, replay_noise
from tests.torch_dist_ranks import ok, spawn
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 4
MESHES = [(2, 2), (1, 4), (4, 1)]          # (dp, tp) of the sampling cases
STEPS = 3                                   # sampler steps
TRAIN_ARGV = ["--batch", "2", "--num_frames", "9", "--height", "32", "--width", "48", "--tiny",
              "--lora_rank", "2", "--log_every", "1", "--ema_decay", "0.9"]
NV_LR = 1e-3
C = "tests.torch_parallel_cases."


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the four ranks' results of every case, and the single-rank
    runs of the CLIs in this process."""
    tmp = tmp_path_factory.mktemp("parallel")
    jc, tc = cfgs(rank=4)
    tree = random_tree(jc, seed=31)
    rng = np.random.default_rng(32)
    text = rng.normal(size=(1, jc.text_length, jc.text_hidden_size)).astype(np.float32)
    shape = (1, jc.latent_frames, jc.in_channels, jc.latent_height, jc.latent_width)
    x, _, txt = dit_inputs(jc, seed=33)
    x = x * 200.0     # large residuals: the clip's global norm acts on the first step

    dit_ckpt, vae_ckpt = _tiny_ckpts(tmp, 0)
    sample_argv = SAMPLE_ARGV + ["--dit_ckpt", dit_ckpt, "--vae_ckpt", vae_ckpt]
    _cli_inputs(tmp)
    _clip_folder(tmp / "clips")
    write_views(str(tmp / "views"))
    _, nv_start, _ = tiny_models(seed=7)
    save_params(str(tmp / "nv_start"), nv_start)
    nv_argv = ["--data_dir", str(tmp / "views"), "--iterations", "2", "--batch", "4",
               "--image_size", "32", "--tiny", "--ckpt", str(tmp / "nv_start"), "--lr",
               str(NV_LR), "--warmup_steps", "1", "--save_every", "2", "--sample_every", "0"]
    train_argv = TRAIN_ARGV + ["--data_root", str(tmp / "clips")]

    def r(p):
        return str(tmp / "ranks" / p)

    cases = [("mesh", C + "mesh_shapes", dict(shapes=[(None, 2, 1), (None, 2, 2), (None, 1, 1)]))]
    cases += [(f"sample_{dp}x{tp}", C + "sample",
               dict(tree=tree, cfg=tc, text=text, shape=shape, steps=STEPS, dp=dp, tp=tp))
              for dp, tp in MESHES]
    cases += [("train", C + "train_steps", dict(tree=tree, cfg=tc, x=x, txt=txt, dp=2, tp=2)),
              ("sample_cli", C + "cli", dict(
                  stage="sample_video", argv=sample_argv + ["--tp", "2", "--dp", "2",
                                                            "--out_folder", r("sample")],
                  rank_dirs=["--out_folder"])),
              ("refine_cli", C + "cli", dict(
                  stage="gen_refine_video",
                  argv=_cli_argv(tmp, "refine", r("refine")) + ["--tp", "2", "--dp", "2"],
                  rank_dirs=["--out_folder"])),
              ("future_cli", C + "cli", dict(
                  stage="gen_future_video",
                  argv=_cli_argv(tmp, "future", r("future")) + ["--tp", "2", "--dp", "2"],
                  rank_dirs=["--out_root"])),
              ("train_cli", C + "cli", dict(
                  stage="train_video", argv=train_argv + [
                      "--tp", "2", "--iterations", "2", "--save_dir", r("train"),
                      "--save_every", "2"], rank_dirs=["--save_dir"])),
              ("train_resume", C + "cli", dict(
                  stage="train_video", argv=train_argv + [
                      "--tp", "2", "--iterations", "3", "--resume_from", r("train")])),
              ("novel_view_cli", C + "cli", dict(
                  stage="train_novel_view", argv=nv_argv + ["--save_dir", r("nv")],
                  rank_dirs=["--save_dir"])),
              ("files", C + "files_under", dict(root=str(tmp / "ranks")))]
    single = {}

    def one_rank():
        """The same CLIs on one rank, in this process, while the ranks run."""
        single["sample"] = tsv.main(sample_argv + ["--out_folder", str(tmp / "one" / "sample")],
                                    device="cpu")
        tref.main(_cli_argv(tmp, "refine", str(tmp / "one" / "refine")), device="cpu")
        tfut.main(_cli_argv(tmp, "future", str(tmp / "one" / "future")), device="cpu")
        single["train"] = ttv.main(train_argv + ["--iterations", "2", "--save_dir",
                                                 str(tmp / "one" / "train"), "--save_every", "2"],
                                   device="cpu", log=_quiet)[1]
        single["train_resume"] = ttv.main(train_argv + ["--iterations", "3", "--resume_from",
                                                        str(tmp / "one" / "train")],
                                          device="cpu", log=_quiet)[1]
        single["nv"] = tnv.main(nv_argv + ["--save_dir", str(tmp / "one" / "nv")],
                                device="cpu", log=_quiet)[1]

    results = spawn(WORLD, cases, str(tmp / "rendezvous"), meanwhile=one_rank)
    return dict(tmp=tmp, results=results, single=single, jc=jc, tc=tc, tree=tree, text=text,
                shape=shape, x=x, txt=txt, nv_start=nv_start)


def _all_ranks(world, name):
    return [ok(world["results"][name], r) for r in range(WORLD)]


# ------------------------------ the mesh -------------------------------------


def test_make_mesh_shapes_and_assert_match_jax(world):
    got = ok(world["results"]["mesh"])
    for (dp, tp, time), sizes in ((k, v) for k, v in got.items() if isinstance(k, tuple)):
        ref = jmesh.make_mesh(WORLD, dp=dp, tp=tp, time=time)
        assert sizes == dict(ref.shape), (dp, tp, time)
    with pytest.raises(AssertionError) as e:
        jmesh.make_mesh(WORLD, dp=3, tp=2)
    assert got["assert"] == str(e.value) == "3x2x1 != 4"


def test_placement_helpers_follow_the_mesh_coordinates(world):
    """On the (2, 2, 1) mesh: ``replicated`` is rank 0's value everywhere,
    ``data_shard`` a rank's rows by its 'data' coordinate (the JAX
    package's ``data_sharding``), ``shard_params_logical`` a leaf's chunk by
    its 'model' coordinate, the replicated leaves whole."""
    full = np.arange(24.0).reshape(2, 3, 4)
    for r in range(WORLD):
        got = ok(world["results"]["mesh"], r)
        d, m = got["coords"]
        assert (d, m) == divmod(r, 2)
        assert got["replicated"] == [0.0] * 3
        np.testing.assert_array_equal(got["data_shard"], full[d:d + 1])
        np.testing.assert_array_equal(got["logical"]["w"], full[:, :, 2 * m:2 * m + 2])
        np.testing.assert_array_equal(got["logical"]["b"], full[0])


@pytest.mark.parametrize("shape", [(64, 12), (12, 64), (8, 8), (3, 5), (6,), (4, 96), (96, 4),
                                   (2, 3, 4), ()])
@pytest.mark.parametrize("spec", [(), (None, "model"), ("model",), ("data",)])
@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_zero_extend_matches_jax(shape, spec, dp):
    spec = spec[:len(shape)]
    ref = jmesh._zero_extend(P(*spec), shape, dp)
    got = pm._zero_extend(spec, shape, dp)
    assert got == tuple(ref) + (None,) * (len(got) - len(tuple(ref)))


def _jax_axes(quant):
    """{port parameter name: the JAX kernel's logical axes} of the tiny DiT."""
    jc, _ = cfgs(rank=4, base_quant=quant)
    shapes = jax.eval_shape(
        jdit.VideoDiT(jc).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jc.latent_frames, jc.in_channels, jc.latent_height, jc.latent_width)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, jc.text_length, jc.text_hidden_size)))
    specs = jax.tree_util.tree_leaves_with_path(nn.get_partition_spec(shapes["params"]),
                                                is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in specs:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        out[_torch_layout(name, np.zeros((1, 1)))[0]] = tuple(spec)
    return out, jc


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_param_shardings_follow_the_jax_logical_axes(quant):
    """The port's (dim, "model") map is JAX's logical axes read through
    LOGICAL_RULES, a kernel (in, out) being a weight (out, in); the int8
    adaLN, split by JAX, is the one leaf the port keeps replicated."""
    axes, jc = _jax_axes(quant)
    _, tc = cfgs(rank=4, base_quant=quant)
    names = [n for n, _ in tdit.init_video_dit(tc, torch.Generator().manual_seed(0))
             .named_parameters()]
    assert set(names) == set(axes)
    rules = dict(jmesh.LOGICAL_RULES)
    assert rules == dict(pm.LOGICAL_RULES)
    got = pm.param_shardings(names)
    for n in names:
        mesh_axes = [rules.get(a) if a else None for a in axes[n]]
        if n.endswith(".weight"):
            mesh_axes = mesh_axes[::-1]
        want = next(((d, a) for d, a in enumerate(mesh_axes) if a), None)
        if quant and ".adaLN." in n and want is not None:
            assert got[n] is None, n
            continue
        assert got[n] == want, n
    assert sum(v is not None for v in got.values()) >= 6 * jc.num_layers


def test_zero_dims_match_jax_zero_shard_opt_state():
    """Each LoRA moment's 'data' dim, on the JAX package's dp 2 x tp 2 mesh
    and from the port's map, over the full shapes."""
    jc, _ = cfgs(rank=4)
    eng = jeng.VideoEngine(jc)
    shapes = jax.eval_shape(lambda: eng.init_params(jax.random.PRNGKey(0)))
    lora, _ = jeng.lora_partition(jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes))
    mesh = jmesh.make_mesh(8, dp=2, tp=2, time=2)
    state = jmesh.zero_shard_opt_state(optax.adam(1e-3).init(lora), mesh)
    keys = [[str(getattr(k, "key", getattr(k, "name", k))) for k in path]
            for path, _ in jax.tree_util.tree_leaves_with_path(state[0].mu)]
    mu = {".".join(k for k in path if k != "value"): x.sharding.spec
          for path, x in zip(keys, jax.tree_util.tree_leaves(state[0].mu))}
    shapes = {k: v.shape for k, v in _flatten_flax(lora).items() if v.dtype != object}
    shardings = pm.param_shardings(shapes)
    dims = pm.zero_dims(shapes, shardings, 2)
    assert set(dims) == set(mu)
    for k, spec in mu.items():
        spec = tuple(spec) + (None,) * (len(shapes[k]) - len(tuple(spec)))
        assert dims[k] == (spec.index("data") if "data" in spec else None), (k, spec)
        assert pm.spec_of(shardings[k], len(shapes[k])) == tuple(
            None if a == "data" else a for a in spec), k


# ------------------------------ generation -----------------------------------


@pytest.fixture(scope="module")
def jax_sample(world):
    """The JAX engine's sample of the same tree: unsharded, and on its dp 2
    x tp 2 mesh through ``shard_for_generation`` (the plain-tree branch),
    the port's single-rank noise replayed into both. (At tp 4 the JAX
    package's sharded sample departs from its unsharded one: ROADMAP,
    findings about the JAX package.)"""
    with pytest.MonkeyPatch.context() as mp:
        draws = record_noise(mp)
        eng = teng.VideoEngine(world["tc"])
        dit = video_dit_from_numpy(world["tree"], world["tc"], "cpu")
        text = torch.as_tensor(world["text"])
        one = eng.sample(dit, world["shape"], text, torch.zeros_like(text),
                         rng=torch.Generator().manual_seed(3), num_steps=STEPS).numpy()
        refs = []
        for mesh in (None, jmesh.make_mesh(4, dp=2, tp=2)):
            rest = replay_noise(mp, draws)
            jengine = jeng.VideoEngine(world["jc"])
            params = world["tree"] if mesh is None else jengine.shard_for_generation(
                world["tree"], None, mesh)[0]
            refs.append(np.asarray(jengine.sample(
                params, world["shape"], jnp.asarray(world["text"]),
                jnp.zeros_like(jnp.asarray(world["text"])), rng=jax.random.PRNGKey(3),
                num_steps=STEPS)))
            assert next(rest, None) is None
    return one, refs


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"dp{d}_tp{t}" for d, t in MESHES])
def test_sampled_latents_match_jax_shard_for_generation(world, jax_sample, dp, tp):
    one, refs = jax_sample
    outs = _all_ranks(world, f"sample_{dp}x{tp}")
    for r, out in enumerate(outs):
        assert out["qkv_rows"] == 3 * world["tc"].hidden_size // tp
        for ref in refs:
            np.testing.assert_allclose(out["lat"], ref, rtol=0, atol=2e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["lat"], one, rtol=0, atol=2e-4, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["lat"], outs[0]["lat"])


def _pngs(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f)), np.int16)
            for f in sorted(os.listdir(folder))}


def test_sample_video_cli_from_a_plain_tree_across_ranks(world):
    """``--tp 2 --dp 2`` from the npz checkpoints (a plain tree, split as it
    loads): the decoded clip and its PNGs as one rank writes them."""
    got = ok(world["results"]["sample_cli"])
    want = world["single"]["sample"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    tmp = world["tmp"]
    a, b = _pngs(tmp / "ranks" / "sample"), _pngs(tmp / "one" / "sample")
    assert list(a) == list(b) and len(a) == 9
    for f in a:
        assert np.abs(a[f] - b[f]).max() <= 1, f


@pytest.mark.parametrize("stage", ["refine", "future"])
def test_refinement_clis_across_ranks(world, stage):
    ok(world["results"][f"{stage}_cli"])
    tmp = world["tmp"]
    a = [os.path.join(d, f) for d, _, fs in sorted(os.walk(tmp / "ranks" / stage))
         for f in sorted(fs)]
    b = [os.path.join(d, f) for d, _, fs in sorted(os.walk(tmp / "one" / stage))
         for f in sorted(fs)]
    assert len(a) == len(b) == (13 if stage == "refine" else 4)
    for x, y in zip(a, b):
        assert os.path.relpath(x, tmp / "ranks" / stage) == os.path.relpath(y, tmp / "one" / stage)
        diff = np.abs(np.asarray(Image.open(x), np.int16) - np.asarray(Image.open(y), np.int16))
        assert diff.max() <= 1, x


def test_only_rank_0_writes(world):
    files = ok(world["results"]["files"])
    assert files and not [f for f in files if "_rank" in f.split(os.sep)[0]], files


# ------------------------------- training ------------------------------------


def test_lora_steps_dp2_tp2_match_jax_and_one_rank(world, monkeypatch):
    """Two LoRA steps (the first clipped) with an EMA of decay 0.9: the
    loss, the updated LoRA leaves, their EMA and the optimizer's moments
    gathered from the ZeRO chunks, against the JAX step on its dp 2 x tp 2
    mesh (batch and moments sharded over 'data') and against the port on
    one rank, within 1e-5. Each rank holds its shard of the split factors
    and its 'data' chunk of each moment."""
    got = ok(world["results"]["train"])
    jc, tc, tree = world["jc"], world["tc"], world["tree"]
    draws = Draws(monkeypatch)
    trainer = ttv.VideoTrainer(teng.VideoEngine(tc, fixed_frames=1),
                               video_dit_from_numpy(tree, tc, "cpu"), LR, 0.9)
    one = [float(trainer.step(torch.as_tensor(world["x"]), torch.as_tensor(world["txt"]),
                              torch.Generator().manual_seed(i))) for i in range(2)]
    draws.replay()
    mesh = jmesh.make_mesh(4, dp=2, tp=2)
    engine = jeng.VideoEngine(jc, fixed_frames=1)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    lp, bp = jeng.lora_partition(jax.device_put(tree, NamedSharding(mesh, P())))
    s = jmesh.zero_shard_opt_state(opt.init(lp), mesh)
    ema = jax.tree_util.tree_map(jnp.copy, lp)
    lat = jax.device_put(jnp.asarray(world["x"]), NamedSharding(mesh, P("data")))
    txt = jax.device_put(jnp.asarray(world["txt"]), NamedSharding(mesh, P("data")))
    ref_losses, norms = [], []
    for _ in range(2):
        # a fresh jit each step: its trace takes that step's replayed draws
        loss, grads = jax.jit(jax.value_and_grad(lambda q, b, x, t: engine.loss_fn(
            jeng.lora_merge(q, b), x, t, jax.random.PRNGKey(0))[0]))(lp, bp, lat, txt)
        norms.append(float(optax.global_norm(grads)))
        updates, s = opt.update(grads, s, lp)
        lp = optax.apply_updates(lp, updates)
        ema = jax.tree_util.tree_map(lambda e, p: e * 0.9 + 0.1 * p, ema, lp)
        ref_losses.append(float(loss))
    assert norms[0] > 1.0, norms
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], one, rtol=1e-5)
    ref = {k: v for k, v in _flatten_flax(lp).items() if v.dtype != object}
    ref_ema = {k: v for k, v in _flatten_flax(ema).items() if v.dtype != object}
    names = sorted(trainer.params, key=lambda n: tuple(n.split(".")))
    assert set(got["lora"]) == set(names) == set(ref)
    for n in names:
        np.testing.assert_allclose(got["lora"][n], np.asarray(ref[n]), rtol=0, atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(got["ema"][n], np.asarray(ref_ema[n]), rtol=0, atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(got["lora"][n], trainer.params[n].detach().numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
    adam = s[1][0]
    mu = {k: v for k, v in _flatten_flax(adam.mu).items() if v.dtype != object}
    nu = {k: v for k, v in _flatten_flax(adam.nu).items() if v.dtype != object}
    leaves = got["opt"]
    assert int(leaves[0]) == 2 and len(leaves) == 1 + 2 * len(names)
    for i, n in enumerate(names):
        for leaf, want, port in ((leaves[1 + i], mu[n], trainer.opt.mu[n]),
                                 (leaves[1 + len(names) + i], nu[n], trainer.opt.nu[n])):
            np.testing.assert_allclose(leaf, np.asarray(want), rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=n)
            np.testing.assert_allclose(leaf, port.numpy(), rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=n)
    full = {n: v.shape for n, v in trainer.params.items()}
    shardings = pm.param_shardings(full)
    dims = pm.zero_dims(full, shardings, 2)
    for n, (local, moment) in got["local"].items():
        want = list(full[n])
        if shardings[n] is not None:
            want[shardings[n][0]] //= 2
        assert local == tuple(want), n
        if dims[n] is not None:
            want[dims[n]] //= 2
        assert moment == tuple(want), n
    assert any(d is not None for d in dims.values())


def _saved(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".npz"))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_train_video_cli_tp2_dp2_matches_one_rank(world):
    """``train_video --tp 2`` on four ranks (dp = gcd(2, 4 // 2) = 2): the
    loss, the saved weights, EMA and resume state (moments gathered whole)
    as one rank's run writes them; then a resume, which puts the ZeRO
    layout back, and its last loss."""
    got = ok(world["results"]["train_cli"])
    np.testing.assert_allclose(got["loss"], world["single"]["train"], rtol=1e-5)
    resumed = ok(world["results"]["train_resume"])
    np.testing.assert_allclose(resumed["loss"], world["single"]["train_resume"], rtol=1e-5)
    a, b = world["tmp"] / "ranks" / "train", world["tmp"] / "one" / "train"
    assert _saved(a) == _saved(b) == ["iter_0000002.npz", "iter_0000002_ema.npz",
                                      "train_state_0000002.npz"]
    for f in ("iter_0000002.npz", "iter_0000002_ema.npz", "train_state_0000002.npz"):
        x, y = _npz(a / f), _npz(b / f)
        assert set(x) == set(y), f
        for k in x:
            if k == "rng_key":
                np.testing.assert_array_equal(x[k], y[k])
                continue
            np.testing.assert_allclose(x[k], y[k], rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(y[k]).max()),
                                       err_msg=f"{f} {k}")


def test_train_novel_view_cli_dp4_matches_one_rank(world):
    """``train_novel_view`` on four ranks (dp = gcd(4, 4)): the loss and
    the saved weights and EMA as one rank's run writes them, the leaves
    whose gradient is rounding noise held to the Adam step's bound (as in
    tests/test_torch_novel_view.py)."""
    got = ok(world["results"]["novel_view_cli"])
    np.testing.assert_allclose(got["loss"], world["single"]["nv"], rtol=1e-5)
    noise = noise_only_leaves(world["nv_start"])
    a, b = world["tmp"] / "ranks" / "nv", world["tmp"] / "one" / "nv"
    assert _saved(a) == _saved(b) == ["iter_0000002.npz", "iter_0000002_ema.npz"]
    for f in ("iter_0000002.npz", "iter_0000002_ema.npz"):
        x, y = _npz(a / f), _npz(b / f)
        assert set(x) == set(y)
        for k in x:
            name = _torch_layout(k.replace("/", "."), x[k])[0]
            atol = 2 * NV_LR if name in noise else 2e-2 * NV_LR
            np.testing.assert_allclose(x[k], y[k], rtol=0, atol=atol, err_msg=f"{f} {k}")


# ------------------------- missing ranks raise ---------------------------------


@pytest.mark.parametrize("stage", ["sample_video", "gen_refine_video", "gen_future_video",
                                   "train_video"])
def test_flags_raise_without_their_ranks(tmp_path, stage):
    """On one process, each flag raises the JAX package's error shape
    before any work: no process group, no fall back to one device."""
    _cli_inputs(tmp_path)
    _clip_folder(tmp_path / "clips")
    argv = {"sample_video": SAMPLE_ARGV + ["--out_folder", str(tmp_path / "o"), "--tp", "2"],
            "gen_refine_video": _cli_argv(tmp_path, "refine", str(tmp_path / "o")) + ["--dp", "2"],
            "gen_future_video": _cli_argv(tmp_path, "future", str(tmp_path / "o")) + ["--tp", "2"],
            "train_video": TRAIN_ARGV + ["--data_root", str(tmp_path / "clips"), "--tp", "2",
                                         "--iterations", "1"]}[stage]
    mod = {"sample_video": tsv, "gen_refine_video": tref, "gen_future_video": tfut,
           "train_video": ttv}[stage]
    with pytest.raises(ValueError, match=r"but only 1 devices visible"):
        mod.main(argv, device="cpu")
    assert not os.path.exists(tmp_path / "o")
    assert not torch.distributed.is_initialized()
    assert "WORLD_SIZE" not in os.environ and sys.modules.get("jax") is not None


@pytest.mark.parametrize("local,cards", [(0, 2), (1, 2), (2, 2), (1, 1)])
def test_resolve_device_takes_the_local_rank_or_raises(monkeypatch, local, cards):
    """Under ``torchrun``, ``cuda`` is ``cuda:LOCAL_RANK``; a local rank
    past the visible cards raises, naming both numbers, and is never put on
    a card another rank holds (no card here: its presence is patched)."""
    from fluidnexus_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setenv("LOCAL_RANK", str(local))
    if local >= cards:
        with pytest.raises(RuntimeError, match=f"LOCAL_RANK {local} but only {cards} CUDA "
                                               f"devices visible"):
            resolve_device("cuda")
    else:
        assert resolve_device("cuda") == torch.device("cuda", local)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
