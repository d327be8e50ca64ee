"""The port's ``train_video`` CLI against the JAX package's ``train`` on the
CPU at ``--tiny`` (from the same npz checkpoints, the port's draws replayed
into the un-jitted JAX code as in tests/test_torch_train_video.py), and the
port's resume round trip. Updated leaves at 2e-2 of lr: Adam divides by
sqrt(v) + 1e-8, which magnifies the last-bit differences of a gradient
element near 0."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnexus_torch.convert import _flatten_flax
from fluidnexus_torch.core.checkpoint import save_params
from fluidnexus_torch.pipelines import train_video as ttv
from fluidnexus_torch.pipelines.train_background import save_image
from fluidnexus_tpu.diffusion.video import dit as jdit
from fluidnexus_tpu.diffusion.video import vae3d as jv
from tests.test_torch_train_video import LR, Draws, nest, random_tree
from tests.test_torch_video_dit import random_flax_params


def _clip_folder(root, n=9, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_image(str(root / "videos" / "clip0" / f"frame_{i:06d}.png"), rng.uniform(0, 1, (3, h, w)))
    os.makedirs(root / "labels", exist_ok=True)
    (root / "labels" / "clip0.txt").write_text("a smoke plume")


def _tiny_ckpts(tmp_path, rank):
    """Random --tiny DiT (rank ``rank``) and VAE trees written as the JAX
    package's flat npz by the port's save_params."""
    jc = jdit.VideoDiTConfig(hidden_size=64, num_layers=2, num_heads=4, text_hidden_size=64,
                             text_length=8, latent_frames=3, latent_height=4, latent_width=6,
                             dtype=jnp.float32, lora_rank=rank)
    save_params(str(tmp_path / "dit"), random_tree(jc, seed=19))
    vae = jv.VideoVAE(jv.VAE3DConfig(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1))
    shapes = jax.eval_shape(lambda: vae.init({"params": jax.random.PRNGKey(1)},
                                             jnp.zeros((1, 5, 32, 48, 3))))
    save_params(str(tmp_path / "vae"), nest(_flatten_flax(random_flax_params(shapes["params"], 20))))
    return str(tmp_path / "dit"), str(tmp_path / "vae")


def test_train_cli_tiny_matches_jax(monkeypatch, tmp_path):
    """``train_video.main --tiny`` for 2 iterations of batch 2 (rank 2, one
    clean latent, caption drops at 0.5, EMA 0.9) from the same npz
    checkpoints as the JAX ``train`` with the port's draws replayed: the
    losses, the LoRA leaves and their EMA. The JAX side runs un-jitted."""
    from fluidnexus_tpu.pipelines import train_video as jtv

    _clip_folder(tmp_path)
    dit_ckpt, vae_ckpt = _tiny_ckpts(tmp_path, rank=2)
    argv = ["--data_root", str(tmp_path), "--iterations", "2", "--batch", "2", "--num_frames", "9",
            "--height", "32", "--width", "48", "--tiny", "--lora_rank", "2", "--log_every", "1",
            "--ema_decay", "0.9", "--fixed_frames", "1", "--ucg_rate", "0.5",
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


def test_resume_round_trip_is_exact(tmp_path):
    """4 iterations straight equal 2, a resume from the saved state, then 2
    more, bit for bit on the CPU: the weights, the EMA, the optimizer's
    moments and the last loss. The run also writes the eval fork's clip and
    caption, and both checkpoints in the JAX npz layout."""
    _clip_folder(tmp_path)
    base = ["--data_root", str(tmp_path), "--batch", "2", "--num_frames", "9", "--height", "32",
            "--width", "48", "--tiny", "--lora_rank", "2", "--log_every", "1", "--ema_decay", "0.9"]
    straight = ttv.main(base + ["--iterations", "4"], device="cpu", log=lambda *a: None)
    save = str(tmp_path / "run")
    ttv.main(base + ["--iterations", "2", "--save_dir", save, "--save_every", "1",
                     "--eval_interval", "2", "--eval_steps", "2"], device="cpu", log=lambda *a: None)
    assert {"iter_0000002.npz", "iter_0000002_ema.npz", "train_state_0000002.npz",
            "video", "video_texts"} <= set(os.listdir(save))
    assert open(os.path.join(save, "video_texts", "000002.txt")).read().strip() == "a smoke plume"
    assert os.listdir(os.path.join(save, "video", "samples_gs_000002"))
    logs = []
    resumed = ttv.main(base + ["--iterations", "4", "--resume_from", save], device="cpu",
                       log=logs.append)
    assert any("resumed training state at iter 2" in ln for ln in logs)
    assert [ln.split(" ")[1] for ln in logs if ln.startswith("iter")] == ["3/4", "4/4"]
    assert straight[1] == resumed[1]
    a, b = dict(straight[0].named_parameters()), dict(resumed[0].named_parameters())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in straight[2]:
        assert torch.equal(straight[2][k], resumed[2][k]), k


def test_train_refuses_quant_without_lora(tmp_path):
    _clip_folder(tmp_path)
    with pytest.raises(SystemExit, match="lora_rank"):
        ttv.main(["--data_root", str(tmp_path), "--tiny", "--lora_rank", "0", "--quant_base",
                  "--num_frames", "9", "--height", "32", "--width", "48"], device="cpu")
