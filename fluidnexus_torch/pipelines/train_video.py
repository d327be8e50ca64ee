"""LoRA finetuning of the video DiT, prefix image-to-video (counterpart of
``fluidnexus_tpu/pipelines/train_video.py``) on one card.

    python -m fluidnexus_torch.pipelines.train_video --data_root clips \
        --allow_fake_conditioning --iterations 100 --save_dir runs/lora

Each iteration samples a batch of clips (``data/video_dataset``), encodes it
with the causal VAE (a posterior sample), drops whole captions with the
``--ucg_rate``, and takes one step of ``engine.loss_fn``:
- rank > 0 (the reference recipe, r = 128): only the LoRA leaves require a
  gradient and the optimizer holds moments for them alone, so no gradient
  of the 5B base is made; the attention backward runs the CUDA ``dq`` and
  ``dkv`` kernels;
- rank 0, the full step: like the JAX package, which zeroes every gradient
  but the LoRA leaves' (``freeze_non_lora``) and so, with none, trains
  nothing: only AdamW's decoupled weight decay (lr 1e-4 of each weight a
  step) and the EMA move the weights. Like JAX, the step holds the
  trainables in f32 (the module computes with a ``cfg.dtype`` copy), which
  keeps the decay from being rounded away in bf16.
The optimizer is ``optax.chain(clip_by_global_norm(1.0), adamw(lr))``
(``core/optim.ClipAdamW``); an EMA of the trainables (``--ema_decay``) is
what the eval sample and the ``_ema`` checkpoint use. Checkpoints are the
JAX package's flat npz (``iter_XXXXXXX.npz``, its ``_ema`` sibling) beside a
resume sidecar ``train_state_XXXXXXX.npz`` with the JAX keys: ``step``,
``rng_key`` (here the torch.Generator's state), ``o_i`` (the optimizer's
count, moments) and ``e_i`` (the EMA).

Every draw (the VAE posterior, the caption drops, the timestep index and the
noise) comes from one ``torch.Generator`` seeded with ``--seed``, in the JAX
order; the clip choice from ``numpy.random.default_rng(--seed)``. Without
``--dit_ckpt``/``--vae_ckpt`` (the flat npz) the weights are drawn from a
seed, as the JAX CLI draws them; ``--dit_ckpt`` and ``--resume_from`` also
read the JAX package's orbax directories (``core/checkpoint``). The data
root is picked as JAX picks it (``data/video_dataset.make_video_dataset``):
webdataset tar shards, ``videos/*.mp4`` with ``labels/*.txt``, or folders of
PNG frames. The captions go through the T5 encoder of ``--t5_dir`` (a
Hugging Face Flax directory; it stays on the card, since every step encodes)
or the hash pseudo-encoder (``--allow_fake_conditioning``, implied by
``--tiny``). ``--base`` merges the reference's
CogVideoX YAML configs (``diffusion/video/config_yaml``, which needs PyYAML)
into the flags' defaults (``apply_base_yaml``; explicit flags win) and gives
the DiT and VAE geometry and the optimizer's clip, betas, eps and weight
decay, as in the JAX package.

Across ranks (``torchrun --nproc_per_node N``): ``--tp`` splits the DiT over
that many ranks (``dit.shard_dit_``) and the batch splits over dp =
gcd(batch, N // tp) 'data' ranks, which must use every rank. Every rank
samples, encodes and conditions the whole batch with the same draws, then
steps on its rows; gradients of the LoRA leaves are mean-reduced over
'data' (and summed over 'model' where a rank holds a partial sum), the
moments are ZeRO-sharded over 'data' (``parallel/mesh.zero_shard_opt_state``)
and the updated chunks all-gathered. Rank 0 alone writes and logs;
checkpoints keep the full layout.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import (
    _flatten_flax, _torch_layout, as_torch, flax_params_to_numpy, load_flax_params,
    vae3d_from_numpy, video_dit_from_numpy,
)
from fluidnexus_torch.core.checkpoint import load_params, save_params
from fluidnexus_torch.core.optim import ClipAdamW, sorted_names
from fluidnexus_torch.data.video_dataset import make_video_dataset
from fluidnexus_torch.diffusion.video.conditioner import apply_ucg, make_text_encoder
from fluidnexus_torch.diffusion.video.dit import (
    gather_dit_state, quantize_dit_params, shard_dit_, tp_partial_grad, tp_split,
)
from fluidnexus_torch.diffusion.video.engine import VideoEngine, lora_merge, lora_partition
from fluidnexus_torch.parallel import mesh as pm
from fluidnexus_torch.pipelines.sample_video import configs
from fluidnexus_torch.utils.profiling import StageTimer, annotate, trace
from fluidnexus_torch.utils.tb import TrainLogger
from fluidnexus_torch.utils.video_io import write_video


def _quiet(*_args, **_kwargs):
    """The log of a rank other than 0."""


def _has_float_block_kernels(params) -> bool:
    """True when a block projection still holds a float ``kernel`` (a tree
    from before ``quantize_dit_params``)."""
    def walk(tree, in_block):
        for k, v in tree.items():
            if hasattr(v, "items"):
                if walk(v, in_block or str(k).startswith("block_")):
                    return True
            elif k == "kernel" and in_block:
                return True
        return False

    return walk(params, False)


def _flat_save(path, step, rng: torch.Generator, trainer: "VideoTrainer"):
    """The resume sidecar: step, the generator's state, the optimizer's
    leaves (count, moments) and the EMA's, each name-sorted and whole."""
    flat = {"step": np.asarray(step), "rng_key": rng.get_state().numpy()}
    for i, leaf in enumerate(trainer.opt_leaves()):
        flat[f"o_{i}"] = leaf.detach().cpu().numpy()
    if trainer.ema is not None:
        ema = trainer.whole(trainer.ema)
        for i, n in enumerate(sorted_names(ema)):
            flat[f"e_{i}"] = ema[n].detach().cpu().numpy()
    if pm.is_main():
        np.savez(path, **flat)


def _flat_load(path, trainer: "VideoTrainer", log=print):
    """Restore the optimizer (and the EMA, in place) from a sidecar; returns
    (step, generator state, ema) with ema None when the run wants one and
    the sidecar has none (saved with --ema_decay 0)."""
    ema = trainer.ema
    with np.load(path) as z:
        step = int(z["step"])
        rng_state = torch.as_tensor(z["rng_key"])
        n_opt = sum(1 for f in z.files if f.startswith("o_"))
        trainer.load_opt_leaves([z[f"o_{i}"] for i in range(n_opt)])
        if ema is not None and "e_0" not in z.files:
            log("resume: checkpoint has no EMA state (saved with ema_decay=0); "
                "seeding a fresh EMA from the resumed params")
            return step, rng_state, None
        if ema is not None:
            with torch.no_grad():
                for i, n in enumerate(sorted_names(ema)):
                    ema[n].copy_(trainer.local(n, torch.as_tensor(z[f"e_{i}"])))
    return step, rng_state, ema


@contextlib.contextmanager
def _weights(dit: torch.nn.Module, named):
    """``dit`` computing with the tensors of ``named`` (a subset of its
    parameters' names, e.g. the EMA), restored on exit."""
    params = dict(dit.named_parameters())
    saved = {n: params[n].detach().clone() for n in named}
    with torch.no_grad():
        for n, x in named.items():
            params[n].copy_(x)
    try:
        yield dit
    finally:
        with torch.no_grad():
            for n, x in saved.items():
                params[n].copy_(x)


class VideoTrainer:
    """One training run's state: the DiT, its trainables (the LoRA leaves
    of the module at rank > 0; f32 masters of every weight for the full
    step), the optimizer and the EMA. ``step`` is one train step. With a
    ``mesh`` the DiT is this rank's tensor-parallel shard (``shard_dit_``
    before), the step takes this rank's rows of the batch and the moments
    are ZeRO-sharded over 'data'."""

    def __init__(self, engine: VideoEngine, dit: torch.nn.Module, lr: float, ema_decay: float,
                 is_i2v: bool = True, masters=None, opt=None, mesh=None):
        self.engine, self.dit, self.is_i2v, self.decay = engine, dit, is_i2v, ema_decay
        self.mesh = mesh
        self.lora = engine.dit_config.lora_rank > 0
        dit.requires_grad_(False)
        if self.lora:
            self.params = lora_partition(dit)[0]
            for p in self.params.values():
                p.requires_grad_(True)
        else:
            # f32 copies of every float weight (``masters``: a {name: f32
            # tensor} to start from, e.g. a checkpoint's values before the
            # module rounded them to its dtype)
            own = {n: p for n, p in dit.named_parameters() if p.is_floating_point()}
            src = masters if masters is not None else own
            self.params = {n: src[n].detach().to(own[n].device, torch.float32).clone()
                           for n in own}
            self._sync()
        self.opt = ClipAdamW(self.params, lr, **(opt or {}))
        if mesh is not None:
            pm.zero_shard_opt_state(self.opt, mesh, pm.param_shardings(self.params))
        self.ema = self.fresh_ema() if ema_decay > 0 else None

    def whole(self, named):
        """{name: full tensor} of {name: this rank's tensor-parallel shard}."""
        return gather_dit_state(self.dit, named)

    def local(self, name, full):
        """This rank's tensor-parallel shard of a full leaf."""
        return tp_split(name, full, pm.axis_rank(self.mesh, "model"),
                        pm.axis_size(self.mesh, "model"))

    def opt_leaves(self):
        """The optimizer's leaves (count, moments), each whole: the
        optimizer gathers its ZeRO chunks over 'data', this its tensor-
        parallel shards over 'model'."""
        names = sorted_names(self.params)
        leaves = self.opt.state_leaves()
        return leaves[:1] + [self.whole({n: x})[n] for n, x in zip(names * 2, leaves[1:])]

    def load_opt_leaves(self, leaves):
        """Restore the optimizer from whole leaves (``opt_leaves``)."""
        names = sorted_names(self.params)
        self.opt.load_state_leaves(
            leaves[:1] + [self.local(n, torch.as_tensor(np.asarray(x)))
                          for n, x in zip(names * 2, leaves[1:])])

    def fresh_ema(self):
        return {n: p.detach().clone() for n, p in self.params.items()}

    def _sync(self):
        if not self.lora:
            own = dict(self.dit.named_parameters())
            with torch.no_grad():
                for n, p in self.params.items():
                    own[n].copy_(p)

    def step(self, latents, text_emb, rng: torch.Generator):
        """One step of ``loss_fn`` on (B, T, C, H, W) latents (this rank's
        rows across ranks); returns the loss over the whole batch (a 0-d
        tensor on the latents' device)."""
        part = (pm.axis_rank(self.mesh, "data"), pm.axis_size(self.mesh, "data"))
        if self.lora:
            loss = self.engine.loss_fn(self.dit, latents, text_emb, rng, self.is_i2v, part)[0]
            grads = torch.autograd.grad(loss, list(self.params.values()))
            grads = dict(zip(self.params, grads))
            if self.mesh is not None:
                self._reduce(grads)
        else:
            with torch.no_grad():
                loss = self.engine.loss_fn(self.dit, latents, text_emb, rng, self.is_i2v, part)[0]
            # JAX's freeze_non_lora zeroes every gradient but the LoRA
            # leaves', and at rank 0 there are none: the step's gradient is 0
            grads = {n: torch.zeros_like(p) for n, p in self.params.items()}
        if self.mesh is not None:
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=pm.group(self.mesh, "data"))
            loss = loss / part[1]
        self.opt.step(grads)
        self._sync()
        if self.ema is not None:
            with torch.no_grad():
                for n, e in self.ema.items():
                    e.mul_(self.decay).add_((1.0 - self.decay) * self.params[n])
        return loss.detach()

    def _reduce(self, grads):
        """Gradients across ranks: summed over 'model' where this rank holds
        a partial sum (a replicated LoRA factor beside a split one), then
        the mean over 'data'."""
        mg, dg = pm.group(self.mesh, "model"), pm.group(self.mesh, "data")
        dp = pm.axis_size(self.mesh, "data")
        for k, g in grads.items():
            if pm.axis_size(self.mesh, "model") > 1 and tp_partial_grad(k):
                dist.all_reduce(g, group=mg)
            if dp > 1:
                dist.all_reduce(g, group=dg)
                g.div_(dp)

    def tree(self):
        """{name: tensor} of the weights as the JAX tree holds them (the
        masters for the full step), whole on every rank."""
        own = dict(self.dit.named_parameters()) if self.lora else self.params
        return self.whole(own)

    def ema_tree(self):
        """The tree with the EMA in place of the trainables, or None."""
        if self.ema is None:
            return None
        ema = self.whole(self.ema)
        return lora_merge(ema, self.tree()) if self.lora else ema

    def load_tree(self, tree):
        """Load a numpy param tree (a checkpoint) into the module and the
        trainables (this rank's shards of them across ranks)."""
        if self.mesh is not None:
            flat = _flat_torch_layout(tree)
            own = dict(self.dit.named_parameters())
            with torch.no_grad():
                for k, p in own.items():
                    p.copy_(self.local(k, as_torch(flat[k]).to(p.device, p.dtype)))
                for k, p in ({} if self.lora else self.params).items():
                    p.copy_(self.local(k, as_torch(flat[k]).to(p.device).float()))
            self._sync()
            return
        load_flax_params(self.dit, tree, next(self.dit.parameters()).device)
        if not self.lora:
            flat = _flat_torch_layout(tree)
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(as_torch(flat[n]).float())
            self._sync()


def _flat_torch_layout(params):
    """{parameter name: numpy array in the port's layout} of a flax tree."""
    return dict(_torch_layout(k, v) for k, v in _flatten_flax(params).items())


def train(args, log=print, device="cuda", timer: StageTimer = None):
    """The training loop of the JAX ``train``. Returns (the DiT, the last
    loss, the EMA tree {name: tensor} or None). ``timer`` (a StageTimer)
    collects the per-iteration times of the data, vae_encode and train_step
    stages."""
    if args.quant_base and args.lora_rank <= 0:
        raise SystemExit(
            "--quant_base requires --lora_rank > 0: the int8 base is frozen by construction; "
            "quantized training is LoRA-only, like the reference 5B finetune recipe")
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = pm.world_size()
    dp = math.gcd(args.batch, world // args.tp)   # the batch must divide over 'data'
    mesh = None
    if dp * args.tp > 1:
        mesh = pm.make_mesh(dp * args.tp, dp=dp, tp=args.tp, device_type=dev.type)
    main_rank = pm.is_main()
    log = log if main_rank else _quiet

    run_cfg = getattr(args, "run_cfg", None)
    dit_cfg, vae_cfg = configs(args.num_frames, args.height, args.width, args.tiny, run_cfg)
    dit_cfg = dataclasses.replace(dit_cfg, lora_rank=args.lora_rank, base_quant=args.quant_base)
    enc = make_text_encoder(args.t5_dir or None, max_length=dit_cfg.text_length,
                            hidden=dit_cfg.text_hidden_size,
                            allow_fake=args.allow_fake_conditioning or args.tiny, device=dev)
    engine = VideoEngine(dit_cfg, vae_cfg, fixed_frames=args.fixed_frames)
    masters = None
    if args.dit_ckpt:
        params = load_params(args.dit_ckpt)
        if args.quant_base and _has_float_block_kernels(params):
            params = quantize_dit_params(params)   # a float checkpoint into the int8 config
        dit = video_dit_from_numpy(params, dit_cfg, dev)
        if args.lora_rank <= 0:
            masters = {n: as_torch(x).float()
                       for n, x in _flat_torch_layout(params).items()}   # the f32 values
    else:
        dit = engine.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.vae_ckpt:
        vae = vae3d_from_numpy(load_params(args.vae_ckpt), vae_cfg, dev)
    else:
        vae = engine.init_vae_params(torch.Generator(device=dev).manual_seed(1))
    if mesh is not None:
        shard_dit_(dit, mesh)
        if masters is not None:
            r, n = pm.axis_rank(mesh, "model"), pm.axis_size(mesh, "model")
            masters = {k: tp_split(k, x, r, n) for k, x in masters.items()}
    opt = {}
    if run_cfg is not None:
        t = run_cfg.train
        opt = dict(max_norm=t.grad_clip, b1=t.betas[0], b2=t.betas[1], eps=t.eps,
                   weight_decay=t.weight_decay)
    trainer = VideoTrainer(engine, dit, args.lr, args.ema_decay, is_i2v=not args.t2v,
                           masters=masters, opt=opt, mesh=mesh)
    ds = make_video_dataset(args.data_root, args.num_frames, args.height, args.width)
    rng_np = np.random.default_rng(args.seed)
    tb = TrainLogger(args.save_dir if main_rank else "")

    def eval_sample(it, latents, captions):
        """The eval fork: a loss and a sampled clip with the EMA weights
        (the live ones without an EMA), both from a generator seeded with
        seed + it; the clip, its caption and the loss go under --save_dir."""
        with _weights(dit, trainer.ema or {}):
            emb, uc = enc([captions[0]], device=dev), enc([""], device=dev)
            with torch.no_grad():
                eloss = engine.loss_fn(dit, latents[:1], emb,
                                       torch.Generator(device=dev).manual_seed(args.seed + it),
                                       is_i2v=not args.t2v)[0]
            prefix = latents[:1, : args.fixed_frames] if (
                not args.t2v and args.fixed_frames > 0) else None
            z = engine.sample(dit, tuple(latents[:1].shape), emb, uc_text_emb=uc,
                              rng=torch.Generator(device=dev).manual_seed(args.seed + it),
                              num_steps=args.eval_steps, prefix_clean_frames=prefix)
            frames = engine.decode_first_stage(vae, z.permute(0, 1, 3, 4, 2))
        vid = np.clip((frames[0].float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)
        if args.save_dir and main_rank:
            root = os.path.join(args.save_dir, "video", f"samples_gs_{it:06d}")
            os.makedirs(root, exist_ok=True)
            path = write_video(os.path.join(root, "000000.mp4"), (vid * 255).astype(np.uint8), fps=8)
            tdir = os.path.join(args.save_dir, "video_texts")
            os.makedirs(tdir, exist_ok=True)
            with open(os.path.join(tdir, f"{it:06d}.txt"), "w") as f:
                f.write(str(captions[0]) + "\n")
            tb.add_scalar("eval/loss", float(eloss), it)
            stride = max(1, vid.shape[0] // 8)
            tb.image_grid("samples", list(vid[::stride][:8]), it)
            log(f"eval @ {it}: loss {float(eloss):.5f} sample -> {path}")
        return float(eloss), frames

    rng = torch.Generator(device=dev).manual_seed(args.seed)
    start_it = 1
    if args.resume_from:
        # <save_dir> with iter_XXXXXXX + train_state_XXXXXXX.npz pairs, or a
        # train_state path; the weights load from the matching iter file
        state_path = args.resume_from
        if os.path.isdir(state_path):
            states = sorted(f for f in os.listdir(state_path) if f.startswith("train_state_"))
            if not states:
                raise FileNotFoundError(f"no train_state_* under {state_path}")
            state_path = os.path.join(args.resume_from, states[-1])
        want_ema = trainer.ema is not None
        step, rng_state, trainer.ema = _flat_load(state_path, trainer, log=log)
        trainer.load_tree(load_params(os.path.join(os.path.dirname(state_path),
                                                   f"iter_{step:07d}")))
        if want_ema and trainer.ema is None:
            trainer.ema = trainer.fresh_ema()   # seeded from the resumed trainables
        rng.set_state(rng_state)
        start_it = step + 1
        log(f"resumed training state at iter {step} from {state_path}")

    timer = timer if timer is not None else StageTimer()
    t0 = time.time()
    loss = torch.tensor(float("nan"))   # stays NaN if the loop runs no iteration
    if start_it > args.iterations:
        log(f"nothing to do: resumed at iter {start_it - 1} >= --iterations {args.iterations}")
    with trace(args.profile_dir):
        for it in range(start_it, args.iterations + 1):
            with timer.stage("data"):
                frames, captions = ds.sample_batch(args.batch, rng_np)
            with timer.stage("vae_encode") as st, annotate("vae_encode"):
                z = engine.encode_first_stage(vae, torch.as_tensor(frames, device=dev), rng,
                                              chunk=args.encode_chunk)
                st.block_on = z
            latents = z.permute(0, 1, 4, 2, 3).clone()     # (B, T, C, H, W), out of inference mode
            txt = apply_ucg(enc(captions, device=dev), rng, args.ucg_rate)
            with timer.stage("train_step") as st, annotate("train_step"):
                loss = trainer.step(pm.data_shard(latents, mesh), pm.data_shard(txt, mesh), rng)
                st.block_on = loss
            if it % args.log_every == 0:
                ips = (it - start_it + 1) / max(time.time() - t0, 1e-9)
                log(f"iter {it}/{args.iterations} loss {float(loss):.5f} ({ips:.2f} it/s) "
                    f"[{timer.report()}]")
                tb.add_scalar("train/loss", float(loss), it)
            if args.eval_interval > 0 and it % args.eval_interval == 0:
                eval_sample(it, latents, captions)
            if args.save_dir and it % args.save_every == 0:
                tree, ema_tree = trainer.tree(), trainer.ema_tree()
                if main_rank:
                    save_params(os.path.join(args.save_dir, f"iter_{it:07d}"),
                                flax_params_to_numpy(tree))
                    if ema_tree is not None:
                        # the tree the generation CLIs prefer (load_params_prefer_ema)
                        save_params(os.path.join(args.save_dir, f"iter_{it:07d}_ema"),
                                    flax_params_to_numpy(ema_tree))
                _flat_save(os.path.join(args.save_dir, f"train_state_{it:07d}.npz"), it, rng,
                           trainer)
    return dit, float(loss), trainer.ema_tree()


def build_argparser():
    ap = argparse.ArgumentParser(description="LoRA finetune the video DiT (prefix-i2v)")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--save_dir", default="")
    ap.add_argument("--resume_from", default="",
                    help="save_dir (or train_state_*.npz) to resume the full training state "
                         "from: params, optimizer moments, EMA, generator, iteration")
    ap.add_argument("--base", nargs="+", default=[],
                    help="reference CogVideoX YAML config(s) (cogvideox_5b_lora_prefixi2v.yaml "
                         "sft_pi2v_<exp>.yaml), merged in order into the defaults (needs PyYAML)")
    ap.add_argument("--dit_ckpt", default="")
    ap.add_argument("--vae_ckpt", default="")
    ap.add_argument("--t5_dir", default="",
                    help="Hugging Face Flax T5 directory (t5-v1_1-xxl: config.json, "
                         "flax_model.msgpack or its index, the tokenizer)")
    ap.add_argument("--iterations", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lora_rank", type=int, default=128)
    ap.add_argument("--quant_base", action="store_true",
                    help="int8 frozen base weights (QLoRA style); float checkpoints are "
                         "converted on load")
    ap.add_argument("--ema_decay", type=float, default=0.9999,
                    help="EMA decay of the trainable weights; 0 disables")
    ap.add_argument("--fixed_frames", type=int, default=3)
    ap.add_argument("--t2v", action="store_true",
                    help="plain t2v loss instead of the prefix-i2v default")
    ap.add_argument("--ucg_rate", type=float, default=0.1)
    ap.add_argument("--eval_interval", type=int, default=0,
                    help="sample an eval clip every N iterations with the EMA weights; 0 "
                         "disables")
    ap.add_argument("--eval_steps", type=int, default=20, help="sampler steps for the eval clip")
    ap.add_argument("--num_frames", type=int, default=49)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--allow_fake_conditioning", action="store_true",
                    help="run with hash pseudo-embeddings (test/smoke only; implied by --tiny)")
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler trace of the run here (TensorBoard)")
    ap.add_argument("--encode_chunk", type=int, default=2,
                    help="encode clips in cache-carried temporal chunks of this many latent "
                         "frames (0 = whole clip; a batch of two 49 x 480 x 720 clips does "
                         "not fit on an 80 GB card whole)")
    return ap


def apply_base_yaml(ap, argv=None):
    """The two-pass parse: --base YAMLs set the defaults (the reference's
    sat config merge), explicit flags win. Returns the parsed args with a
    ``run_cfg`` attribute (a CogVideoXRunConfig, or None)."""
    pre, _ = ap.parse_known_args(argv)
    cfg = None
    if pre.base:
        from fluidnexus_torch.diffusion.video.config_yaml import load_cogvideox_yaml

        cfg = load_cogvideox_yaml(pre.base)
        t = cfg.train
        ap.set_defaults(
            iterations=t.train_iters, batch=t.micro_batch, lr=t.lr, lora_rank=cfg.lora_rank,
            fixed_frames=cfg.fixed_frames, ucg_rate=cfg.ucg_rate, num_frames=t.max_num_frames,
            height=t.video_size[0], width=t.video_size[1], log_every=t.log_interval,
            save_every=t.save_interval, save_dir=t.save, eval_interval=t.eval_interval,
            data_root=(t.train_data[0] if t.train_data else ""), t5_dir=cfg.t5_dir)
    args = ap.parse_args(argv)
    args.run_cfg = cfg
    if not args.data_root:
        ap.error("--data_root is required (directly or via --base train_data)")
    return args


def main(argv=None, device="cuda", log=print):
    return train(apply_base_yaml(build_argparser(), argv), log=log, device=device)


if __name__ == "__main__":
    main()
