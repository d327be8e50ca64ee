"""The port's CogVideoX YAML loader (fluidnexus_torch/diffusion/video/
config_yaml.py) against the JAX package's on a two-file config the test
writes (a base in the layout of cogvideox_5b_lora_prefixi2v.yaml, then an
sft override, merged in order): every field equal, the dtype as the
matching torch type. ``--base`` on ``sample_video`` and ``train_video``
sets the defaults JAX sets (explicit flags win; ``--t5_dir ""`` overrides a
YAML's T5 directory), and a ``--tiny --base`` LoRA run takes the YAML's
optimizer as JAX's does."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluidnexus_torch.convert import _flatten_flax
from fluidnexus_torch.diffusion.video import config_yaml as tcy
from fluidnexus_torch.pipelines import sample_video as tsv
from fluidnexus_torch.pipelines import train_video as ttv
from fluidnexus_tpu.diffusion.video import config_yaml as jcy
from fluidnexus_tpu.pipelines import sample_video as jsv
from fluidnexus_tpu.pipelines import train_video as jtv
from tests.test_torch_gen_presets import parsed_args
from tests.test_torch_t5 import T5Reached, t5_spy
from tests.test_torch_train_video import LR, Draws
from tests.test_torch_train_video_cli import _clip_folder, _tiny_ckpts
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

BASE = {
    "model": {
        "scale_factor": 0.7,
        "network_config": {
            "target": "dit_video_concat.DiffusionTransformer",
            "params": {
                "time_embed_dim": 512, "elementwise_affine": True, "num_frames": 81,
                "time_compressed_rate": 4, "latent_width": 90, "latent_height": 60,
                "num_layers": 42, "patch_size": 2, "in_channels": 16, "out_channels": 16,
                "hidden_size": 3072, "num_attention_heads": 48,
                "transformer_args": {"checkpoint_activations": True},
                "modules": {
                    "pos_embed_config": {"target": "Rotary3DPositionEmbeddingMixin",
                                         "params": {"text_length": 226}},
                    "patch_embed_config": {"target": "ImagePatchEmbeddingMixin",
                                           "params": {"text_hidden_size": 4096}},
                    "adaln_layer_config": {"target": "AdaLNMixin", "params": {}},
                    "lora_config": {"target": "TransformerLoRAMixin", "params": {"r": 128}},
                },
            },
        },
        "conditioner_config": {"params": {"emb_models": [
            {"target": "sgm.modules.encoders.modules.FrozenT5Embedder", "ucg_rate": 0.1,
             "params": {"model_dir": "t5-v1_1-xxl", "max_length": 226}}]}},
        "first_stage_config": {"params": {"encoder_config": {"params": {
            "double_z": True, "z_channels": 16, "in_channels": 3, "out_ch": 3, "ch": 128,
            "ch_mult": [1, 2, 2, 4], "num_res_blocks": 3}}}},
        "loss_fn_config": {"params": {"fixed_frames": 3}},
        "sampler_config": {"target": "VPSDEDPMPP2MSampler", "params": {
            "num_steps": 50, "verbose": True,
            "discretization_config": {"params": {"shift_scale": 1.0}},
            "guider_config": {"target": "sgm.modules.diffusionmodules.guiders.DynamicCFG",
                              "params": {"scale": 6, "exp": 5, "num_steps": 50}}}},
    },
}
OVERRIDE = {
    "args": {"experiment_name": "lora_cogvidx5b_smoke", "train_iters": 10000,
             "save_interval": 500, "log_interval": 20, "eval_interval": 1000,
             "train_data": ["clips/smoke"], "valid_data": ["clips/smoke_val"],
             "load": "ckpts/5b", "save": "runs/lora", "checkpoint_activations": True},
    "data": {"target": "data_video.SFTDataset", "params": {
        "video_size": [480, 720], "fps": 8, "max_num_frames": 49, "skip_frms_num": 3,
        "cam_str": "all", "paths_post": "20"}},
    "deepspeed": {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
                  "gradient_clipping": 0.1, "zero_optimization": {"stage": 2},
                  "bf16": {"enabled": True},
                  "optimizer": {"type": "sat.ops.FusedEmaAdam", "params": {
                      "lr": 0.001, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 1e-4}}},
    "model": {"sampler_config": {"params": {"num_steps": 40,
                                            "guider_config": {"params": {"scale": 5.5}}}}},
}


def write_yaml(path, tree):
    path.write_text(yaml.safe_dump(tree))
    return str(path)


def two_files(tmp_path, bf16=True, **args):
    over = dict(OVERRIDE, args=dict(OVERRIDE["args"], **args),
                deepspeed=dict(OVERRIDE["deepspeed"], bf16={"enabled": bf16}))
    return [write_yaml(tmp_path / "base.yaml", BASE), write_yaml(tmp_path / "sft.yaml", over)]


def as_dict(cfg):
    out = dataclasses.asdict(cfg)
    for part in ("dit", "vae"):
        out[part]["dtype"] = str(out[part]["dtype"]).replace("torch.", "").replace("jnp.", "")
    return out


@pytest.mark.parametrize("bf16", [True, False])
def test_load_cogvideox_yaml_matches_jax(tmp_path, bf16):
    paths = two_files(tmp_path, bf16=bf16)
    got, want = tcy.load_cogvideox_yaml(paths), jcy.load_cogvideox_yaml(paths)
    assert got.dit.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert want.dit.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    g, w = as_dict(got), as_dict(want)
    w["dit"]["dtype"] = np.dtype(want.dit.dtype).name
    w["vae"]["dtype"] = np.dtype(want.vae.dtype).name
    assert g == w
    # the override won where both files set a key; the data section's clip
    # length over the rope-skip num_frames
    assert (got.sampler.num_steps, got.sampler.scale, got.sampler.exp) == (40, 5.5, 5.0)
    assert got.dit.latent_frames == 13 and got.lora_rank == 128 and got.fixed_frames == 3
    assert got.train.betas == (0.9, 0.95) and got.t5_dir == "t5-v1_1-xxl"
    guider = got.sampler.make_guider()
    jguider = want.sampler.make_guider()
    for step in (0, 7, 40):
        assert guider(1.0, 3.0, step) == pytest.approx(float(jguider(1.0, 3.0, step)), rel=1e-6)
    over = {"model": {"loss_fn_config": {"params": {"fixed_frames": 1}}}}
    assert tcy.load_cogvideox_yaml(paths, over) == dataclasses.replace(got, fixed_frames=1)


def test_deep_merge_matches_jax():
    a = {"x": {"y": 1, "z": {"w": 2}}, "k": [1]}
    b = {"x": {"z": {"w": 3, "v": 4}}, "k": [2, 3], "n": None}
    assert tcy.deep_merge(a, b) == jcy.deep_merge(a, b) == {
        "x": {"y": 1, "z": {"w": 3, "v": 4}}, "k": [2, 3], "n": None}
    assert a == {"x": {"y": 1, "z": {"w": 2}}, "k": [1]}
    tree = {"m": {"params": {"a": 1}}, "n": {"b": 2}}
    for path in (("m",), ("n",), ("x",), ("n", "b")):
        assert tcy._params(tree, *path) == jcy._params(tree, *path)


def test_base_on_sample_video_sets_the_jax_defaults(tmp_path, monkeypatch):
    paths = two_files(tmp_path)
    argv = ["--prompt", "p", "--out_folder", "o", "--base", *paths, "--height", "240"]
    got = parsed_args(tsv.main, argv, monkeypatch)
    want = parsed_args(jsv.main, argv, monkeypatch)
    assert got == want
    assert (got["num_steps"], got["cfg_scale"], got["num_frames"], got["height"],
            got["width"], got["t5_dir"]) == (40, 5.5, 49, 240, 720, "t5-v1_1-xxl")
    assert parsed_args(tsv.main, argv + ["--t5_dir", ""], monkeypatch)["t5_dir"] == ""
    # the model the CLIs build from a run config: the YAMLs' geometry on the
    # clip's latent grid, as the JAX CLIs replace it (--tiny wins over it)
    run, jrun = tcy.load_cogvideox_yaml(paths), jcy.load_cogvideox_yaml(paths)
    dit, vae = tsv.configs(49, 240, 720, False, run)
    jdit = dataclasses.replace(jrun.dit, latent_frames=13, latent_height=30, latent_width=90)
    want = as_dict(dataclasses.replace(jrun, dit=jdit))
    want["dit"]["dtype"], want["vae"]["dtype"] = "bfloat16", "float32"
    assert as_dict(dataclasses.replace(run, dit=dit, vae=vae)) == want
    assert tsv.configs(9, 32, 48, True, run) == tsv.configs(9, 32, 48, True)


def test_base_on_train_video_sets_the_jax_defaults(tmp_path, monkeypatch):
    paths = two_files(tmp_path)
    for argv in (["--base", *paths], ["--base", *paths, "--lr", "0.5", "--data_root", "d"]):
        got = vars(ttv.apply_base_yaml(ttv.build_argparser(), argv))
        want = vars(jtv.apply_base_yaml(jtv.build_argparser(), argv))
        assert got.pop("run_cfg") == tcy.load_cogvideox_yaml(paths)
        want.pop("run_cfg")
        assert got.pop("encode_chunk") == 2 and want.pop("encode_chunk") == 0
        assert got == want
    assert (got["lr"], got["data_root"], got["iterations"], got["lora_rank"],
            got["save_every"]) == (0.5, "d", 10000, 128, 500)
    with pytest.raises(SystemExit):   # no --data_root and no train_data
        ttv.apply_base_yaml(ttv.build_argparser(), [])


def test_base_needs_pyyaml(tmp_path, monkeypatch):
    paths = two_files(tmp_path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        tcy.load_cogvideox_yaml(paths)
    with pytest.raises(ImportError, match="PyYAML"):
        tsv.main(["--prompt", "p", "--out_folder", str(tmp_path / "o"), "--base", *paths],
                 device="cpu")


def test_train_tiny_with_base_takes_the_yaml_optimizer_as_jax(tmp_path, monkeypatch):
    """``train_video.main --tiny --base`` for 2 LoRA iterations (rank 2 from
    the YAML, betas (0.9, 0.95), clip 0.1, batch 2, one clean latent, caption
    drops at 0.5, EMA 0.9) from the same npz checkpoints as the JAX ``train``
    with the port's draws replayed: the losses, the LoRA leaves and their EMA
    (at 2e-2 of lr, as tests/test_torch_train_video_cli.py holds them)."""
    _clip_folder(tmp_path)
    dit_ckpt, vae_ckpt = _tiny_ckpts(tmp_path, rank=2)
    base = dict(BASE, model=dict(BASE["model"], loss_fn_config={"params": {"fixed_frames": 1}},
                                 network_config={"params": dict(
                                     BASE["model"]["network_config"]["params"],
                                     modules={"lora_config": {"params": {"r": 2}}})}))
    base["model"]["conditioner_config"] = {"params": {"emb_models": [
        {"target": "FrozenT5Embedder", "ucg_rate": 0.5, "params": {"model_dir": "t5"}}]}}
    over = dict(OVERRIDE, args={"train_iters": 2, "log_interval": 1, "eval_interval": 0,
                                "train_data": [str(tmp_path)]},
                data={"params": {"video_size": [32, 48], "max_num_frames": 9}})
    paths = [write_yaml(tmp_path / "base.yaml", base), write_yaml(tmp_path / "sft.yaml", over)]
    argv = ["--base", *paths, "--tiny", "--t5_dir", "", "--ema_decay", "0.9",
            "--dit_ckpt", dit_ckpt, "--vae_ckpt", vae_ckpt]
    draws = Draws(monkeypatch)
    logs, jlogs = [], []
    dit, loss, ema = ttv.main(argv, device="cpu", log=logs.append)
    assert {k: len(v) for k, v in draws.seen.items()} == {"normal": 4, "bernoulli": 2, "randint": 2}
    its = draws.replay()
    with jax.disable_jit():
        jp, jloss, jema = jtv.train(jtv.apply_base_yaml(jtv.build_argparser(), argv),
                                    log=jlogs.append)
    assert all(next(it, None) is None for it in its.values())
    assert [ln.split(" (")[0] for ln in logs] == [ln.split(" (")[0] for ln in jlogs]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    jflat, jeflat = _flatten_flax(jp), _flatten_flax(jema)
    own = dict(dit.named_parameters())
    lora = [k for k in own if k.endswith(("lora_a", "lora_b"))]
    assert len(lora) == 16
    for k in lora:
        np.testing.assert_allclose(own[k].detach().numpy(), jflat[k], rtol=0, atol=2e-2 * LR,
                                   err_msg=k)
        np.testing.assert_allclose(ema[k].detach().numpy(), jeflat[k], rtol=0, atol=2e-2 * LR,
                                   err_msg=k)
    # without --t5_dir "" the YAML's T5 directory reaches the encoder
    seen = t5_spy(monkeypatch)
    with pytest.raises(T5Reached):
        ttv.main(argv[:4] + argv[6:], device="cpu", log=lambda *a: None)
    assert seen == ["t5"]
