"""The port's torch-checkpoint maps (``fluidnexus_torch/diffusion/port.py``)
and its ``port`` stage (``pipelines/port_drill.py``) against the JAX
package's on the CPU.

Each map gets one seeded, reference-named state dict: the SAT DiT's from
``tests.test_port_video_dit.make_state_dict``, the others from a tiny port
module drawn from a seed and written in the reference's layout by the
mirrors in ``tests/torch_helpers.py`` (the keys the map reads, every one of
them read). Both packages' maps must give the same tree bit for bit: keys,
shapes, dtypes and values. The drills run at tiny configs in both packages:
the same printed parameter counts, checksums within 1e-5 relative (both f32),
and the JAX drill's ``--out_dir`` tree (orbax here) read by the port's
``load_params`` equal leaf for leaf to the port drill's npz (``drill_t5`` is
held in ``tests/test_torch_t5.py``, beside its Flax directories).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import load_flax_params
from fluidnexus_torch.core.checkpoint import load_params
from fluidnexus_torch.diffusion import port as tp
from fluidnexus_torch.diffusion.ldm import autoencoder as ta
from fluidnexus_torch.diffusion.ldm import clip as tc
from fluidnexus_torch.diffusion.ldm import unet as tu
from fluidnexus_torch.diffusion.ldm.model import build_novel_view
from fluidnexus_torch.diffusion.video import dit as tdit
from fluidnexus_torch.diffusion.video import vae3d as tv
from fluidnexus_torch.pipelines import port_drill as tdrill
from fluidnexus_tpu.diffusion import port as jp
from fluidnexus_tpu.diffusion.ldm import autoencoder as ja
from fluidnexus_tpu.diffusion.ldm import clip as jc
from fluidnexus_tpu.diffusion.ldm import unet as ju
from fluidnexus_tpu.diffusion.video import dit as jdit
from fluidnexus_tpu.diffusion.video import vae3d as jv
from fluidnexus_tpu.pipelines import port_drill as jdrill
from tests.test_port_video_dit import make_state_dict
from tests.torch_helpers import (
    clip_reference_sd, kl_vae_reference_sd, seeded_fill_, unet_reference_sd,
    video_vae_reference_sd, zero123_reference_sd,
)

CHECKSUM_TOL = 1e-5
# 64 channels: two a GroupNorm group, so that the zero inputs of the drills'
# forwards (constant over space after the first conv) keep a nonzero variance
UNET = dict(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=4, context_dim=768)
VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
CLIP = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4, output_dim=768)
VAE3D = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
DIT = dict(hidden_size=64, num_layers=2, num_heads=4, text_hidden_size=32, text_length=4,
           latent_frames=3, latent_height=16, latent_width=16, in_channels=16, out_channels=16,
           ln_affine=True, time_embed_dim=None)


class Reads(dict):
    """A state dict that records which keys a map reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def numpy_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def assert_same_tree(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


def zero123_model(gen):
    return seeded_fill_(build_novel_view("cpu", unet_config=tu.UNetConfig(**UNET),
                                         vae_config=ta.KLVAEConfig(**VAE),
                                         clip_config=tc.CLIPVisionConfig(**CLIP)), gen)


def map_cases():
    """{name: (state dict, port map, JAX map)} over one seeded draw each."""
    gen = torch.Generator().manual_seed(0)
    model = zero123_model(gen)
    named = dict(model.named_parameters())
    ucfg, vcfg = model.unet_config, model.vae_config
    sub = lambda p: {k[len(p):]: v for k, v in named.items() if k.startswith(p)}  # noqa: E731
    vae3d_cfg = tv.VAE3DConfig(**VAE3D)
    vae3d = seeded_fill_(tv.VideoVAE(vae3d_cfg), gen)
    dcfg = tdit.VideoDiTConfig(**DIT, dtype=torch.float32)
    return {
        "unet": (numpy_sd(unet_reference_sd(sub("unet."), ucfg)),
                 lambda sd: tp.port_zero123_unet(sd, ucfg),
                 lambda sd: jp.port_zero123_unet(sd, ucfg)),
        "kl_vae": (numpy_sd(kl_vae_reference_sd(sub("vae."), vcfg)),
                   lambda sd: tp.port_kl_vae(sd, vcfg), lambda sd: jp.port_kl_vae(sd, vcfg)),
        "clip": (numpy_sd(clip_reference_sd(sub("clip."), 2)),
                 lambda sd: tp.port_openai_clip_visual(sd, 2),
                 lambda sd: jp.port_openai_clip_visual(sd, 2)),
        "zero123_checkpoint": (numpy_sd(zero123_reference_sd(model)),
                               lambda sd: tp.port_zero123_checkpoint(sd, ucfg, vcfg, 2),
                               lambda sd: jp.port_zero123_checkpoint(sd, ucfg, vcfg, 2)),
        "video_vae": (numpy_sd(video_vae_reference_sd(dict(vae3d.named_parameters()), vae3d_cfg)),
                      lambda sd: tp.port_video_vae(sd, vae3d_cfg),
                      lambda sd: jp.port_video_vae(sd, vae3d_cfg)),
        "video_dit": (make_state_dict(dcfg, np.random.default_rng(0)),
                      lambda sd: tp.port_video_dit(sd, dcfg),
                      lambda sd: jp.port_video_dit(sd, dcfg)),
    }


@pytest.fixture(scope="module")
def cases():
    return map_cases()


@pytest.mark.parametrize("name", ["unet", "kl_vae", "clip", "zero123_checkpoint", "video_vae",
                                  "video_dit"])
def test_map_gives_jax_tree_bit_for_bit(cases, name):
    sd, port_map, jax_map = cases[name]
    reads = Reads(sd)
    got = port_map(reads)
    if name != "zero123_checkpoint":   # it reads its parts through items()
        assert reads.read == set(sd), sorted(set(sd) - reads.read)[:5]
    assert_same_tree(got, jax_map(dict(sd)))


def test_the_tree_loads_back_into_the_module_it_was_written_from():
    gen = torch.Generator().manual_seed(1)
    model = zero123_model(gen)
    sd = numpy_sd(zero123_reference_sd(model, upstream_4ch=False))
    tree = tp.port_zero123_checkpoint(sd, model.unet_config, model.vae_config, 2)
    back = load_flax_params(build_novel_view("cpu", unet_config=model.unet_config,
                                             vae_config=model.vae_config,
                                             clip_config=model.clip_config), tree, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n


def test_input_conv_4to8_of_the_upstream_checkpoint(cases):
    sd = cases["zero123_checkpoint"][0]
    w4 = sd["model.diffusion_model.input_blocks.0.0.weight"]
    assert w4.shape[1] == 4
    tree = tp.port_zero123_checkpoint(sd, tu.UNetConfig(**UNET), ta.KLVAEConfig(**VAE), 2)
    k = tree["unet"]["conv_in"]["kernel"]                 # (kh, kw, 8, out)
    assert k.shape[2] == 8
    np.testing.assert_array_equal(k[:, :, :4], np.transpose(w4, (2, 3, 1, 0)))
    np.testing.assert_array_equal(k[:, :, 4:], 0)
    np.testing.assert_array_equal(tp.port_input_conv_4to8(w4), jp.port_input_conv_4to8(w4))
    # an 8-channel (finetuned) checkpoint's conv passes unchanged
    sd8 = dict(sd)
    sd8["model.diffusion_model.input_blocks.0.0.weight"] = np.concatenate([w4, w4], 1)
    assert_same_tree(tp.port_zero123_checkpoint(sd8, tu.UNetConfig(**UNET),
                                                ta.KLVAEConfig(**VAE), 2),
                     jp.port_zero123_checkpoint(sd8, ju.UNetConfig(**UNET),
                                                ja.KLVAEConfig(**VAE), 2))


def raw_lora(sd, rank, rng):
    """``sd`` with its attention linears in the raw SAT-lora2 layout."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith(("query_key_value.weight", "attention.dense.weight"))]:
        base, w = k[:-len(".weight")], out.pop(k)
        parts = 3 if base.endswith("query_key_value") else 1
        out[base + ".original.weight"] = w
        out[base + ".original.bias"] = out.pop(base + ".bias")
        for p in range(parts):
            out[f"{base}.matrix_A.{p}"] = rng.standard_normal((rank, w.shape[1])).astype(
                np.float32)
            out[f"{base}.matrix_B.{p}"] = rng.standard_normal(
                (w.shape[0] // parts, rank)).astype(np.float32)
    return out


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_merge_sat_lora_on_the_raw_layout(cases, alpha):
    raw = raw_lora(cases["video_dit"][0], 8, np.random.default_rng(2))
    got, ref = tp.merge_sat_lora(raw, alpha), jp.merge_sat_lora(raw, alpha)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype, k
    assert not any(".matrix_" in k or ".original." in k for k in got)
    # partitions in integer order, each scaled by alpha / r
    base = "transformer.layers.0.attention.query_key_value"
    want = raw[base + ".original.weight"].copy()
    rows = want.shape[0] // 3
    for p in range(3):
        want[p * rows:(p + 1) * rows] += (alpha / 8) * (raw[f"{base}.matrix_B.{p}"]
                                                        @ raw[f"{base}.matrix_A.{p}"])
    np.testing.assert_array_equal(got[base + ".weight"], want)
    # the map folds a raw finetune itself
    dcfg = tdit.VideoDiTConfig(**DIT, dtype=torch.float32)
    assert_same_tree(tp.port_video_dit(raw, dcfg), jp.port_video_dit(raw, dcfg))


def test_merge_sat_lora_asserts_partitions_cover_the_rows(cases):
    raw = raw_lora(cases["video_dit"][0], 4, np.random.default_rng(3))
    del raw["transformer.layers.1.attention.query_key_value.matrix_A.2"]
    del raw["transformer.layers.1.attention.query_key_value.matrix_B.2"]
    for merge in (tp.merge_sat_lora, jp.merge_sat_lora):
        with pytest.raises(AssertionError, match="cover"):
            merge(raw)


def test_model_diffusion_model_prefix(cases):
    sd = cases["video_dit"][0]
    dcfg = tdit.VideoDiTConfig(**DIT, dtype=torch.float32)
    pre = {"model.diffusion_model." + k: v for k, v in sd.items()}
    assert_same_tree(tp.port_video_dit(pre, dcfg), tp.port_video_dit(sd, dcfg))
    assert_same_tree(tp.port_video_dit(pre, dcfg), jp.port_video_dit(pre, dcfg))


@pytest.mark.parametrize("wrapper", ["state_dict", "module", "model", None])
def test_checkpoint_wrappers(tmp_path, wrapper):
    sd = {"a.weight": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "b.bias": torch.ones(3, dtype=torch.float64), "step": 7}
    obj = {wrapper: sd, "epoch": 3, "global_step": 11} if wrapper else sd
    path = tmp_path / "ckpt.pt"
    torch.save(obj, path)
    got, ref = tp.load_torch_state_dict(str(path)), jp.load_torch_state_dict(str(path))
    assert sorted(got) == sorted(ref) == ["a.weight", "b.bias"]
    for k in ref:
        assert np.array_equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype


def test_bf16_checkpoint_raises_in_both(tmp_path):
    """numpy has no bfloat16: both packages' loaders raise on a bf16 leaf
    (the released SAT 5B checkpoint is bf16)."""
    path = tmp_path / "bf16.pt"
    torch.save({"module": {"w": torch.ones(2, 2, dtype=torch.bfloat16)}}, path)
    for load in (tp.load_torch_state_dict, jp.load_torch_state_dict):
        with pytest.raises(TypeError, match="BFloat16"):
            load(str(path))


def test_graft_keeps_the_module_where_the_tree_lacks_a_key(cases):
    sd = cases["video_dit"][0]
    cfg = tdit.VideoDiTConfig(**DIT, dtype=torch.float32, lora_rank=4)
    dit = seeded_fill_(tdit.VideoDiT(cfg), torch.Generator().manual_seed(4))
    lora_b = dit.block_0.attn.qkv.lora_b.detach().clone()
    tp.graft_params_into(dit, tp.port_video_dit(sd, cfg))
    assert torch.equal(dit.block_0.attn.qkv.lora_b, lora_b)
    w = sd["transformer.layers.0.attention.query_key_value.weight"]
    assert torch.equal(dit.block_0.attn.qkv.weight, torch.as_tensor(w))
    bf = tdit.VideoDiT(dataclasses.replace(cfg, dtype=torch.bfloat16))
    tp.graft_params_into(bf, tp.port_video_dit(sd, cfg))
    assert bf.block_0.attn.qkv.weight.dtype == torch.bfloat16
    assert torch.equal(bf.block_0.attn.qkv.weight, torch.as_tensor(w).to(torch.bfloat16))
    with pytest.raises(ValueError, match="only in the tree"):
        tp.graft_params_into(bf, {"no_such_module": {"kernel": np.zeros((2, 2), np.float32)}})


def printed(out):
    """{name: (M params, checksum or None)} of the drill's [port] lines."""
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 4 and parts[0] == "[port]" and parts[3] == "params":
            rows[parts[1]] = (parts[2], float(parts[-1]) if "checksum" in line else None)
        elif len(parts) >= 2 and parts[0] == "[port]" and parts[1] == "t5":
            rows["t5"] = (None, float(parts[-1]))
    return rows


def assert_same_report(got, ref):
    assert sorted(got) == sorted(ref)
    for k, (n, chk) in ref.items():
        assert got[k][0] == n, (k, got[k], ref[k])
        if chk is not None:
            assert abs(got[k][1] - chk) <= CHECKSUM_TOL * abs(chk), (k, got[k], ref[k])


def jit_apply(monkeypatch, cls):
    """``cls.apply(variables, *args)`` under ``jax.jit``: the JAX drills run
    their forwards op by op, ~15-20 s at the tiny configs here."""
    from flax import linen as nn

    monkeypatch.setattr(cls, "apply", lambda self, v, *a: jax.jit(
        lambda v, *a: nn.Module.apply(self, v, *a))(v, *a))


def jitted_jax_zero123(monkeypatch):
    from fluidnexus_tpu.diffusion.ldm import model as jm

    cond = jm.NovelViewModel.conditioning
    monkeypatch.setattr(jm.NovelViewModel, "conditioning", lambda self, params, img, pose: jax.jit(
        lambda p, i, q: cond(self, p, i, q))(params, img, pose))
    jit_apply(monkeypatch, ju.UNet)


def test_drill_zero123_in_both_packages(tmp_path, capsys, cases, monkeypatch):
    jitted_jax_zero123(monkeypatch)
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in cases["zero123_checkpoint"][0]
                               .items()}, "global_step": 5}, path)
    # 16 px (8 x 8 latents): at the drill's 64 px the JAX UNet's own f32
    # forward on these zero inputs is 2.4e-3 of max|out| from a float64 run
    # (the port's 5.5e-5), beyond the checksums' 1e-5
    ref = jdrill.drill_zero123(str(path), unet_cfg=ju.UNetConfig(**UNET),
                               vae_cfg=ja.KLVAEConfig(**VAE), clip_cfg=jc.CLIPVisionConfig(**CLIP),
                               image_size=16)
    ref_out = capsys.readouterr().out
    got = tdrill.drill_zero123(str(path), str(tmp_path / "out"), tu.UNetConfig(**UNET),
                               ta.KLVAEConfig(**VAE), tc.CLIPVisionConfig(**CLIP), image_size=16,
                               device="cpu")
    out = capsys.readouterr().out
    assert_same_report(printed(out), printed(ref_out))
    assert set(printed(out)) == {"zero123.unet", "zero123.vae", "zero123.clip", "zero123.cc"}
    assert_same_tree(got, jax.tree.map(np.asarray, ref))
    assert_same_tree(load_params(str(tmp_path / "out" / "zero123")), got)


@pytest.mark.parametrize("quant,lora", [(False, 0), (True, 0), (False, 4)])
def test_drill_cogvideox_in_both_packages(tmp_path, capsys, cases, quant, lora, monkeypatch):
    """The JAX drill's --out_dir tree (orbax) read by the port's
    load_params equals the port drill's npz leaf for leaf; with LoRA
    adapters in the config, the checkpoint lacks them and both trees carry
    the template's zeros."""
    jit_apply(monkeypatch, jdit.VideoDiT)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.as_tensor(v) for k, v in cases["video_dit"][0].items()}},
               path)
    jdrill.drill_cogvideox(str(path), str(tmp_path / "jax"),
                           jdit.VideoDiTConfig(**DIT, dtype=jnp.float32, lora_rank=lora),
                           quant=quant)
    ref_out = capsys.readouterr().out
    got = tdrill.drill_cogvideox(str(path), str(tmp_path / "port"),
                                 tdit.VideoDiTConfig(**DIT, dtype=torch.float32, lora_rank=lora),
                                 quant=quant, device="cpu")
    out = capsys.readouterr().out
    assert_same_report(printed(out), printed(ref_out))
    assert ("quantized (int8 base)" in out) == quant == ("quantized (int8 base)" in ref_out)
    jax_saved = load_params(str(tmp_path / "jax" / "video_dit"))
    assert_same_tree(load_params(str(tmp_path / "port" / "video_dit")), jax_saved)
    assert_same_tree(got, jax_saved)
    if lora:
        assert not flat(got)["block_0/attn/qkv/lora_b"].any()


def test_drill_vae3d_in_both_packages(tmp_path, capsys, cases):
    path = tmp_path / "3d-vae.pt"
    torch.save({"state_dict": {"first_stage_model." + k: torch.as_tensor(v)
                               for k, v in cases["video_vae"][0].items()}}, path)
    ref = jdrill.drill_vae3d(str(path), vae_cfg=jv.VAE3DConfig(**VAE3D))
    ref_out = capsys.readouterr().out
    got = tdrill.drill_vae3d(str(path), vae_cfg=tv.VAE3DConfig(**VAE3D), device="cpu")
    assert_same_report(printed(capsys.readouterr().out), printed(ref_out))
    assert_same_tree(got, jax.tree.map(np.asarray, ref))


def test_drill_main_needs_a_checkpoint_and_a_card(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tdrill.main([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdrill.main(["--t5", str(tmp_path)])


def test_runner_lists_port_and_evaluate_adm(capsys):
    from fluidnexus_torch import __main__ as runner

    assert runner.STAGES["port"] == "fluidnexus_torch.pipelines.port_drill"
    assert runner.STAGES["evaluate_adm"] == "fluidnexus_torch.utils.adm_metrics"
    with pytest.raises(SystemExit) as e:
        runner.main(["--help"])
    assert e.value.code == 0
    listed = capsys.readouterr().out.split()
    assert "port" in listed and "evaluate_adm" in listed and "bench" not in listed
