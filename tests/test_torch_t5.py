"""The port's T5 text encoder (``diffusion/video/t5.py``, ``conditioner.
T5TextEncoder``) and its Flax checkpoint reader (``utils/flax_msgpack.py``)
against the JAX package's ``T5TextEncoder`` (transformers'
``FlaxT5EncoderModel``) on the CPU, both loaded through ``make_text_encoder``
from one Hugging Face Flax directory the test writes: a tiny relu model (the
configuration of ``tests/test_t5_conditioner.py``) and a tiny gated-gelu one
(t5-v1_1's feed-forward), at the DiT's 226 tokens, which reach the
logarithmic buckets and the clamp beyond ``max_distance``. Held to 1e-5 of
the output's largest magnitude (both run in f32)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from fluidnexus_torch.diffusion.video import conditioner as tcond
from fluidnexus_torch.diffusion.video import t5 as tt5
from fluidnexus_torch.utils import flax_msgpack
from fluidnexus_tpu.diffusion.video import conditioner as jcond

TOL = 1e-5
WORDS = ["<pad>", "</s>", "<unk>", "a", "smoke", "plume", "rises", "ball", "bounces", "the",
         "wind", "over", "cold", "air", "slowly", "in"]
PROMPTS = [" ".join(WORDS[3 + (i * 7) % 13] for i in range(300)),   # truncated to 226
           "the wind over a smoke plume rises slowly in cold air " * 4 + "zebra",
           ""]                                                        # every token masked


def write_tokenizer(d, max_length=16):
    """A WordLevel tokenizer in Hugging Face's format (no sentencepiece)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": max_length}, f)


def write_t5_dir(d, seed=0, max_shard_size=None, **kw):
    from transformers import FlaxT5EncoderModel, T5Config

    cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4, **kw)
    model = FlaxT5EncoderModel(cfg, seed=seed)
    if max_shard_size:
        model.save_pretrained(d, max_shard_size=max_shard_size)
    else:
        model.save_pretrained(d)
    write_tokenizer(d)
    return model


@pytest.fixture(scope="module")
def t5_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("t5")
    dirs = {}
    for name, kw in (("relu", {}), ("gated", {"feed_forward_proj": "gated-gelu"})):
        dirs[name] = str(root / name)
        write_t5_dir(dirs[name], seed=len(dirs), **kw)
    dirs["sharded"] = str(root / "sharded")
    write_t5_dir(dirs["sharded"], seed=1, max_shard_size="8KB", feed_forward_proj="gated-gelu")
    return dirs


class T5Reached(BaseException):
    """Raised where ``t5_spy``'s stand-in is asked to load a T5 directory: a
    BaseException, so ``make_text_encoder``'s fall back does not catch it."""


def t5_spy(monkeypatch):
    """Replace the T5 loader by one that records the directory it is given
    and stops the run; returns the list of directories."""
    seen = []

    def spy(model_dir, max_length=226, device="cuda"):
        seen.append(model_dir)
        raise T5Reached(model_dir)

    monkeypatch.setattr(tcond, "T5TextEncoder", spy)
    return seen


def held(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= TOL * scale, f"{what}: max|err| {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("kind", ["relu", "gated", "sharded"])
def test_encoder_matches_flax_at_226_tokens(t5_dirs, kind):
    d = t5_dirs[kind]
    jenc = jcond.make_text_encoder(d, max_length=226, hidden=32)
    tenc = tcond.make_text_encoder(d, max_length=226, hidden=32, device="cpu")
    assert isinstance(jenc, jcond.T5TextEncoder) and isinstance(tenc, tcond.T5TextEncoder)
    assert tenc.model.cfg.is_gated_act == (kind != "relu")
    ids = tenc.tokenizer(PROMPTS, truncation=True, max_length=226, padding="max_length",
                         return_tensors="np")["attention_mask"].sum(1)
    assert list(ids) == [226, 45, 0]
    got = tenc(PROMPTS)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    held(got.numpy(), jenc(PROMPTS), kind)


def test_sharded_directory_is_the_merged_tree(t5_dirs):
    """The index's shards merge into the tree transformers loads."""
    from transformers import FlaxT5EncoderModel

    d = t5_dirs["sharded"]
    assert os.path.exists(os.path.join(d, flax_msgpack.INDEX_NAME))
    assert not os.path.exists(os.path.join(d, flax_msgpack.WEIGHTS_NAME))
    ref = FlaxT5EncoderModel.from_pretrained(d).params
    got = flax_msgpack.load_flax_checkpoint(d)
    flat_ref = {"/".join(str(k.key) for k in p): v
                for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    flat_got = {"/".join(str(k.key) for k in p): v
                for p, v in jax.tree_util.tree_leaves_with_path(got)}
    assert set(flat_got) == set(flat_ref)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=k)


def test_relative_position_bucket_is_flax(t5_dirs):
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    rel = np.arange(-400, 401, dtype=np.int32)[None, :] - np.arange(0, 5, dtype=np.int32)[:, None]
    for buckets, dist in ((32, 128), (16, 20), (8, 3)):
        ref = np.asarray(FlaxT5Attention._relative_position_bucket(
            jax.numpy.asarray(rel), bidirectional=True, num_buckets=buckets, max_distance=dist))
        got = tt5.relative_position_bucket(torch.as_tensor(rel), buckets, dist).numpy()
        np.testing.assert_array_equal(got, ref)


def test_full_model_checkpoint_gives_its_encoder(tmp_path, t5_dirs):
    """A whole T5's directory (decoder and LM head too) gives the encoder
    ``FlaxT5EncoderModel`` takes from it."""
    from transformers import FlaxT5ForConditionalGeneration, T5Config

    cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                   feed_forward_proj="gated-gelu")
    FlaxT5ForConditionalGeneration(cfg, seed=3).save_pretrained(str(tmp_path))
    write_tokenizer(str(tmp_path))
    assert "decoder" in flax_msgpack.load_flax_checkpoint(str(tmp_path))
    texts = PROMPTS[:2]
    held(tcond.make_text_encoder(str(tmp_path), 226, 32, device="cpu")(texts).numpy(),
         jcond.make_text_encoder(str(tmp_path), 226, 32)(texts), "full model")


def test_make_text_encoder_follows_jax_branches(t5_dirs, tmp_path, capsys):
    """A directory that loads gives T5 (with or without the opt-in); one that
    does not (missing, or with only torch weights, which the Flax loader does
    not read) falls back to the hash encoder with the opt-in, and raises
    naming the flag without it; no directory needs the opt-in."""
    only_torch = tmp_path / "torch_only"
    only_torch.mkdir()
    (only_torch / "config.json").write_text(open(os.path.join(t5_dirs["relu"],
                                                              "config.json")).read())
    (only_torch / "pytorch_model.bin").write_bytes(b"")
    write_tokenizer(str(only_torch))
    for d, fake in ((t5_dirs["gated"], False), (t5_dirs["gated"], True)):
        assert isinstance(tcond.make_text_encoder(d, 8, 32, fake, device="cpu"),
                          tcond.T5TextEncoder)
    for bad in ("/nonexistent/t5", str(only_torch)):
        for mod, kw in ((jcond, {}), (tcond, {"device": "cpu"})):
            with pytest.raises(RuntimeError, match="allow_fake_conditioning"):
                mod.make_text_encoder(bad, 8, 32, **kw)
            capsys.readouterr()
            enc = mod.make_text_encoder(bad, 8, 32, allow_fake=True, **kw)
            assert isinstance(enc, mod.HashTextEncoder)
            assert "using hash fallback" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="allow_fake_conditioning"):
        tcond.make_text_encoder(None, 8, 32, device="cpu")
    assert isinstance(tcond.make_text_encoder("", 8, 32, True), tcond.HashTextEncoder)
    # the card by default, as every entry point
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="allow_fake_conditioning"):
            tcond.make_text_encoder(t5_dirs["gated"], 8, 32)


def test_xxl_geometry_matches_flax_shapes():
    """t5-v1_1-xxl's encoder, built on ``meta``: names and shapes in the flax
    layout are those of ``FlaxT5EncoderModel``'s shape tree, 4.76 B
    parameters (19 GB in f32)."""
    from transformers import FlaxT5EncoderModel, T5Config

    from fluidnexus_torch.convert import _flatten_flax, _torch_layout

    cfg = T5Config(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
                   num_heads=64, feed_forward_proj="gated-gelu")
    shapes = FlaxT5EncoderModel(cfg, _do_init=False).params_shape_tree
    zeros = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    want = {}
    for name, x in _flatten_flax(zeros).items():
        tname, y = _torch_layout(name, x)
        want[tname] = tuple(y.shape)
    with torch.device("meta"):
        model = tt5.T5Encoder(tt5.T5Config())
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 4_762_310_656


def _plain(x):
    """The reader's values as the msgpack package gives them."""
    import msgpack

    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, flax_msgpack._Ext):
        return msgpack.ExtType(x.code, bytes(x.data))
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def test_msgpack_reader_matches_the_msgpack_package(tmp_path, monkeypatch):
    """Every msgpack type against the ``msgpack`` package's decoder, then a
    flax tree of every leaf kind, one leaf over flax's (patched) chunk size
    so that it is written chunked, against flax's ``msgpack_restore``."""
    import jax.numpy as jnp
    import msgpack
    from flax import serialization

    values = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128,
              -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63, 1.5, -2.25e300, None, True, False,
              "", "x" * 31, "é" * 40, "z" * 300, "w" * 70000, b"", b"q" * 300, b"r" * 70000,
              list(range(20)), list(range(70000)), {str(i): [i, {"k": None}] for i in range(20)},
              msgpack.ExtType(5, b"abc"), msgpack.ExtType(6, b"x" * 16), msgpack.ExtType(7, b"y"),
              msgpack.ExtType(8, b"v" * 300), msgpack.ExtType(9, b"u" * 70000)]
    for packed in (msgpack.packb(values, use_bin_type=True),
                   msgpack.packb([1.5, 0.1], use_single_float=True)):
        assert _plain(flax_msgpack.unpackb(packed)) == msgpack.unpackb(packed, raw=False)
    with pytest.raises(ValueError, match="left after"):
        flax_msgpack.unpackb(msgpack.packb(1) + b"\x00")

    rng = np.random.default_rng(0)
    tree = {"dense": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                      "q": np.arange(-4, 4, dtype=np.int8)},
            "big": rng.normal(size=(7, 11)).astype(np.float32),
            "half": rng.normal(size=(4,)).astype(np.float16),
            "bf16": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
            "u64": np.arange(3, dtype=np.uint64), "mask": np.array([True, False]),
            "scalar": np.float32(2.5)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    chunked = msgpack.unpackb(blob, raw=False)["big"]
    assert chunked["__msgpack_chunked_array__"] is True and len(chunked["chunks"]) == 5
    (tmp_path / "t.msgpack").write_bytes(blob)
    got = flax_msgpack.load_msgpack(str(tmp_path / "t.msgpack"))
    ref = serialization.msgpack_restore(blob)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(jax.tree_util.tree_leaves(got)) == len(flat_ref)
    for path, want in flat_ref.items():
        node = got
        for k in path:
            node = node[k.key]
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:   # widened to f32, exactly
            assert node.dtype == np.float32
            want = want.astype(np.float32)
        assert node.dtype == want.dtype and node.shape == want.shape, path
        np.testing.assert_array_equal(node, want)


class _Captured(BaseException):
    pass


def test_video_clis_encode_through_t5(tmp_path, monkeypatch):
    """``sample_video --t5_dir`` samples with the prompt's T5 embedding (and
    zeros unconditioned); ``train_video --t5_dir`` on an mp4 root encodes the
    batch's captions (``labels/*.txt``) each step, as JAX's encoder does
    (``--ucg_rate 0``: no caption dropped). Both at ``--tiny`` (text 8 x 64),
    stopped at the first sampler call or train step."""
    from fluidnexus_torch.diffusion.video.engine import VideoEngine
    from fluidnexus_torch.pipelines import sample_video as tsv
    from fluidnexus_torch.pipelines import train_video as ttv
    from fluidnexus_tpu.data.video_dataset import SFTVideoDataset
    from tests.test_torch_video_files import sft_root

    from transformers import FlaxT5EncoderModel, T5Config

    d = str(tmp_path / "t5")
    FlaxT5EncoderModel(T5Config(vocab_size=64, d_model=64, d_kv=8, d_ff=96, num_layers=2,
                                num_heads=8, feed_forward_proj="gated-gelu"),
                       seed=5).save_pretrained(d)
    write_tokenizer(d)
    jenc = jcond.make_text_encoder(d, max_length=8, hidden=64)
    seen = {}

    def capture(name):
        def fn(self, *args, **kw):
            seen[name] = args
            raise _Captured
        return fn

    monkeypatch.setattr(VideoEngine, "sample", capture("sample"))
    with pytest.raises(_Captured):
        tsv.main(["--tiny", "--t5_dir", d, "--prompt", "the wind over a smoke plume",
                  "--out_folder", str(tmp_path / "out"), "--num_frames", "9", "--height", "32",
                  "--width", "48"], device="cpu")
    _, _, text_emb, uc = seen["sample"]
    held(text_emb.numpy(), jenc(["the wind over a smoke plume"]), "sample_video")
    assert not uc.any() and uc.shape == (1, 8, 64)

    root = sft_root(tmp_path / "clips")
    monkeypatch.setattr(ttv.VideoTrainer, "step", capture("step"))
    with pytest.raises(_Captured):
        ttv.main(["--data_root", str(root), "--tiny", "--t5_dir", d, "--iterations", "1",
                  "--num_frames", "9", "--height", "32", "--width", "48", "--lora_rank", "2",
                  "--ucg_rate", "0"], device="cpu", log=lambda *a: None)
    latents, txt, _ = seen["step"]
    _, captions = SFTVideoDataset(str(root), 9, 32, 48).sample_batch(
        2, np.random.default_rng(0))
    assert latents.shape == (2, 3, 16, 4, 6)
    held(txt.numpy(), jenc(captions), "train_video")


def test_drill_t5_matches_the_jax_drill(t5_dirs, capsys):
    """``python -m fluidnexus_torch port --t5 <dir>``'s encoder against the
    JAX package's drill: the same embedding (held to TOL) and the same
    printed shape and checksum (within TOL relative)."""
    from fluidnexus_torch.pipelines import port_drill as tdrill
    from fluidnexus_tpu.pipelines import port_drill as jdrill

    ref = jdrill.drill_t5(t5_dirs["gated"], max_length=16)
    ref_line = capsys.readouterr().out.split("forward checksum")
    got = tdrill.drill_t5(t5_dirs["gated"], max_length=16, device="cpu")
    line = capsys.readouterr().out.split("forward checksum")
    held(got.numpy(), ref, "drill_t5")
    assert line[0] == ref_line[0]
    assert abs(float(line[1]) - float(ref_line[1])) <= TOL * abs(float(ref_line[1]))
