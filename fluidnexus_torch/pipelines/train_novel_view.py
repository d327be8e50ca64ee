"""Finetuning the novel-view LDM on one capture (counterpart of
``fluidnexus_tpu/pipelines/train_novel_view.py``) on one card.

    python -m fluidnexus_torch train_novel_view --data_dir zero123 --save_dir runs/zero123

The dataset is (cond view, target view) pairs from the 5-camera rig with
``camera/{i:02d}.npy`` W2C matrices, as a folder (``ViewPairDataset``) or tar
shards (``ViewPairWebDataset``); both draw from ``numpy.random`` Generators
with the JAX package's calls, so they give the same pairs in the same order,
and decode PNGs with ``utils/png`` and PIL's 8-bit LANCZOS (``utils/lanczos``)
with no imaging library.

The step: the eps-prediction loss (``NovelViewModel.loss_fn``) and its
gradient for the UNet and ``cc`` only; the VAE and CLIP are frozen (optax's
``set_to_zero``: no update and no decay). The optimizer is optax's ``adamw``
(eps 1e-8, weight decay 1e-4; ``core/optim.ClipAdamW`` with no clipping) on
the LambdaLinearScheduler warm-up, ``cc`` at 10x the rate, the schedule read
at the update count before the update; ``--scale_lr`` multiplies the rate by
the batch. An EMA of the UNet and ``cc`` (``d = min(decay, (1 + n) / (10 +
n))``, n the updates so far) rides beside them. Checkpoints are the JAX
package's flat npz of the full tree (``iter_%07d``, its ``_ema`` sibling with
the EMA in place of the trainables; ``last``/``last_ema`` on a
KeyboardInterrupt). With a ``--save_dir``, the conditioning, the targets and
a CFG-3.0 DDIM sample of the live weights go to TensorBoard as grids at the
first iteration and every ``--sample_every``.

Every draw of the model comes from one ``torch.Generator`` seeded with
``--seed`` (the loss's four, then the log sample's); the pairs from
``numpy.random.default_rng(--seed)``. Without ``--ckpt`` the weights are
drawn from a seed (``init_novel_view``).

Across ranks (``torchrun --nproc_per_node N``) the batch splits over dp =
gcd(batch, N) 'data' ranks, which must use every rank: each rank samples the
whole batch and makes the whole batch's draws, steps on its rows, and the
gradients are mean-reduced over 'data' before one replicated AdamW step.
The EMA, the logs and the checkpoints stay on rank 0.
"""
from __future__ import annotations

import argparse
import glob
import math
import os
import tarfile
import time

import numpy as np
import torch
import torch.distributed as dist

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import flax_params_to_numpy, novel_view_from_numpy
from fluidnexus_torch.core.checkpoint import load_params, save_params
from fluidnexus_torch.core.optim import ClipAdamW
from fluidnexus_torch.diffusion.ldm.autoencoder import KLVAEConfig
from fluidnexus_torch.diffusion.ldm.clip import CLIPVisionConfig
from fluidnexus_torch.diffusion.ldm.model import (
    NovelViewModel, build_novel_view, get_pose_delta, init_novel_view,
)
from fluidnexus_torch.diffusion.ldm.unet import UNetConfig
from fluidnexus_torch.parallel import mesh as pm
from fluidnexus_torch.utils.lanczos import resize_u8
from fluidnexus_torch.utils.png import decode_png, read_png, to_rgb
from fluidnexus_torch.utils.profiling import annotate, trace
from fluidnexus_torch.utils.tb import TrainLogger, device_memory_stats

TINY_CONFIGS = dict(
    unet_config=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                           attention_resolutions=(2,), num_heads=4, context_dim=768),
    vae_config=KLVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1),
    clip_config=CLIPVisionConfig(image_size=28, patch_size=14, width=32, layers=1, heads=4,
                                 output_dim=768),
)


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 100,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0, cycle_length: float = 1e13):
    """LambdaLinearScheduler (Zero123/ldm/lr_scheduler.py:82-100 with the
    fluid_nexus_smoke.yaml values): a linear warm-up f_start -> f_max over
    warm_up_steps, then a linear glide toward f_min over cycle_length. The
    rate at ``step``, in f32 arithmetic as the JAX package computes it."""
    f32 = np.float32

    def schedule(step):
        step = f32(step)
        warm = f32((f_max - f_start) / max(warm_up_steps, 1)) * step + f32(f_start)
        tail = f32(f_min) + f32(f_max - f_min) * (f32(cycle_length) - step) / f32(cycle_length)
        return float(f32(base_lr) * (warm if step < warm_up_steps else tail))

    return schedule


def _image(png: np.ndarray, size: int) -> np.ndarray:
    """Decoded PNG samples -> (size, size, 3) f32 in [0, 1], as PIL's
    ``convert("RGB").resize((size, size), LANCZOS)`` and ``/ 255``."""
    return resize_u8(to_rgb(png), size, size).astype(np.float32) / 255.0


def _cameras(cam_dir):
    return {int(f[:2]): np.load(os.path.join(cam_dir, f))
            for f in os.listdir(cam_dir) if f.endswith(".npy")}


class ViewPairDataset:
    """frame_%03d/{cam:02d}.png + camera/{cam:02d}.npy (the layout
    DataProcessing/fluid_nexus_real/create_zero123_dataset.py writes, and
    ``convert original_to_zero123`` / ``zero123_cams``).

    cond_view/target_view: when BOTH are valid camera ids the pair is fixed
    (ldm/data/fluid_nexus.py:213-218); otherwise random without replacement
    (the FluidNexus finetune default)."""

    def __init__(self, root: str, image_size: int = 256,
                 cond_view: int = -1, target_view: int = -1):
        self.root = root
        self.image_size = image_size
        self.frames = sorted(d for d in os.listdir(root) if d.startswith("frame_"))
        self.cams = _cameras(os.path.join(root, "camera"))
        self.cam_ids = sorted(self.cams)
        self.fixed_pair = None
        if cond_view in self.cams and target_view in self.cams:
            self.fixed_pair = (target_view, cond_view)

    def _img(self, frame: str, cam: int):
        return _image(read_png(os.path.join(self.root, frame, f"{cam:02d}.png")),
                      self.image_size)

    def sample_batch(self, batch: int, rng: np.random.Generator):
        tgt, cond, dt = [], [], []
        for _ in range(batch):
            frame = self.frames[rng.integers(len(self.frames))]
            if self.fixed_pair is not None:
                a, b = self.fixed_pair
            else:
                a, b = rng.choice(self.cam_ids, 2, replace=False)
            tgt.append(self._img(frame, a))
            cond.append(self._img(frame, b))
            dt.append(get_pose_delta(self.cams[a], self.cams[b]))
        return np.stack(tgt), np.stack(cond), np.stack(dt)


class ViewPairWebDataset:
    """Tar-shard streaming variant of ``ViewPairDataset`` (the reference's
    webdataset-wrapped finetune loader, Zero123/ldm/data/fluid_nexus.py:79-82).
    Each tar sample is one frame: members ``<frame_key>.<cam:02d>.png`` (all
    captured views of that frame); poses come from ``<root>/camera/<cam:02d>.npy``
    as in the folder loader. Shards are rank-dealt, samples reservoir-shuffled
    raw (decoded on pop), and the stream restarts each pass from
    ``self.seed`` (so every pass gives the same order, and ``sample_batch``
    ignores its ``rng``, as the JAX package's does). Fails loudly if a full
    pass yields nothing."""

    def __init__(self, root: str, image_size: int = 256, cond_view: int = -1,
                 target_view: int = -1, seed: int = 1,
                 shuffle_buffer: int = 256, rank: int = 0, world: int = 1):
        self.root = root
        self.image_size = image_size
        shards = sorted(glob.glob(os.path.join(root, "**", "*.tar"), recursive=True)) \
            if os.path.isdir(root) else sorted(glob.glob(root))
        assert shards, f"no .tar shards under {root}"
        rng = np.random.default_rng(seed)
        self.shards = list(rng.permutation(shards))[rank::world]
        self.cams = _cameras(os.path.join(os.path.dirname(self.shards[0]) if not
                                          os.path.isdir(root) else root, "camera"))
        self.fixed_pair = None
        if cond_view in self.cams and target_view in self.cams:
            self.fixed_pair = (target_view, cond_view)
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self._stream = None

    def _iter_samples(self):
        for shard in self.shards:
            with tarfile.open(shard) as tf:
                cur_key, cur = None, {}
                for m in tf:
                    if not m.isfile():
                        continue
                    base = os.path.basename(m.name)
                    key, _, suffix = base.partition(".")
                    if cur_key is not None and key != cur_key and cur:
                        yield cur
                        cur = {}
                    cur_key = key
                    cur[suffix.lower()] = tf.extractfile(m).read()
                if cur:
                    yield cur

    def _decode(self, raw: dict, rng: np.random.Generator):
        avail = sorted(c for c in self.cams if f"{c:02d}.png" in raw)
        if self.fixed_pair is not None:
            a, b = self.fixed_pair
            if a not in avail or b not in avail:
                return None
        elif len(avail) >= 2:
            a, b = rng.choice(avail, 2, replace=False)
        else:
            return None

        def img(cam):
            name = f"{cam:02d}.png"
            return _image(decode_png(raw[name], name), self.image_size)

        return img(a), img(b), get_pose_delta(self.cams[a], self.cams[b])

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        buf = []
        for raw in self._iter_samples():
            buf.append(raw)
            if len(buf) >= self.shuffle_buffer:
                item = self._decode(buf.pop(int(rng.integers(len(buf)))), rng)
                if item is not None:
                    yield item
        rng.shuffle(buf)
        for raw in buf:
            item = self._decode(raw, rng)
            if item is not None:
                yield item

    def sample_batch(self, batch: int, rng: np.random.Generator):
        tgt, cond, dt = [], [], []
        retried = False
        while len(tgt) < batch:
            if self._stream is None:
                self._stream = iter(self)
            item = next(self._stream, None)
            if item is None:
                if retried and not tgt:
                    raise RuntimeError(
                        f"no usable frame samples in shards under {self.root}"
                        " (need >=2 views per sample matching camera/*.npy)")
                self._stream, retried = None, True
                continue
            retried = False
            tgt.append(item[0])
            cond.append(item[1])
            dt.append(item[2])
        return np.stack(tgt), np.stack(cond), np.stack(dt)


def make_pair_dataset(root: str, image_size: int = 256, cond_view: int = -1,
                      target_view: int = -1, seed: int = 1):
    """Folder layout -> ViewPairDataset; .tar shards -> ViewPairWebDataset."""
    if (not os.path.isdir(root)) or glob.glob(os.path.join(root, "**", "*.tar"), recursive=True):
        return ViewPairWebDataset(root, image_size, cond_view=cond_view,
                                  target_view=target_view, seed=seed)
    return ViewPairDataset(root, image_size, cond_view=cond_view, target_view=target_view)


class NovelViewTrainer:
    """The trainables (the UNet's and ``cc``'s parameters), their AdamW
    (``cc`` at 10x the rate) and their EMA; ``step`` is one train step."""

    def __init__(self, model: NovelViewModel, lr_fn, cc_lr_fn, ema_decay: float, mesh=None):
        self.model, self.decay, self.mesh = model, ema_decay, mesh
        model.vae.requires_grad_(False)
        model.clip.requires_grad_(False)
        named = dict(model.named_parameters())
        self.unet = {n: p for n, p in named.items() if n.startswith("unet.")}
        self.cc = {n: p for n, p in named.items() if n.startswith("cc.")}
        self.opts = (ClipAdamW(self.unet, lr_fn, max_norm=None),
                     ClipAdamW(self.cc, cc_lr_fn, max_norm=None))
        self.ema = ({n: p.detach().clone() for n, p in {**self.unet, **self.cc}.items()}
                    if ema_decay > 0 else None)
        self.updates = 0

    def step(self, tgt, cond, dt, rng: torch.Generator):
        """One step on (B, H, W, 3) target and cond images and (B, 4) pose
        deltas (this rank's rows across 'data' ranks); returns the loss over
        the whole batch (a 0-d tensor on the model's device). Across ranks
        the gradients are the mean over 'data'."""
        dp = pm.axis_size(self.mesh, "data")
        loss = self.model.loss_fn(tgt, cond, dt, rng, part=(pm.axis_rank(self.mesh, "data"), dp))
        grads = torch.autograd.grad(loss, [*self.unet.values(), *self.cc.values()])
        grads = dict(zip([*self.unet, *self.cc], grads))
        if dp > 1:
            dg = pm.group(self.mesh, "data")
            loss = loss.detach().clone()
            for g in [loss, *grads.values()]:
                dist.all_reduce(g, group=dg)
                g.div_(dp)
        for opt in self.opts:
            opt.step(grads)
        if self.ema is not None:
            f32 = np.float32
            n = f32(self.updates + 1)
            w = float(f32(1) - min(f32(self.decay), (f32(1) + n) / (f32(10) + n)))   # 1 - d
            named = {**self.unet, **self.cc}
            with torch.no_grad():
                for k, e in self.ema.items():
                    e.sub_(w * (e - named[k]))
        self.updates += 1
        return loss.detach()

    def tree(self):
        return flax_params_to_numpy(dict(self.model.named_parameters()))

    def ema_tree(self):
        """The full tree with the EMA in place of the UNet and ``cc``."""
        return flax_params_to_numpy({**dict(self.model.named_parameters()), **self.ema})


def train(args, log=print, device="cuda"):
    """The JAX ``train`` on one card. Returns (the model, the last loss, the
    EMA {name: tensor} or None)."""
    dev = resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = math.gcd(args.batch, pm.world_size())   # the batch must divide over 'data'
    mesh = pm.make_mesh(dp, dp=dp, device_type=dev.type) if dp > 1 else None
    main_rank = pm.is_main()
    log = log if main_rank else (lambda *_a, **_k: None)
    configs = TINY_CONFIGS if args.tiny else {}
    if args.ckpt:
        model = novel_view_from_numpy(load_params(args.ckpt), configs, dev)
    else:
        model = init_novel_view(build_novel_view(dev, **configs),
                                torch.Generator(device=dev).manual_seed(0))

    # per-group LR: cc_projection at 10x (ddpm.py:1628-1635); vae+clip frozen;
    # LambdaLinearScheduler warmup (configs/*.yaml scheduler_config)
    base_lr = args.lr * args.batch if args.scale_lr else args.lr
    lr_fn = lambda_linear_schedule(base_lr, warm_up_steps=args.warmup_steps)
    cc_lr_fn = lambda_linear_schedule(10 * base_lr, warm_up_steps=args.warmup_steps)
    # the EMA and the logs stay on rank 0
    trainer = NovelViewTrainer(model, lr_fn, cc_lr_fn, args.ema_decay if main_rank else 0.0,
                               mesh=mesh)

    ds = make_pair_dataset(args.data_dir, args.image_size, cond_view=args.cond_view,
                           target_view=args.target_view, seed=args.seed)
    rng_np = np.random.default_rng(args.seed)
    tb = TrainLogger(args.save_dir if main_rank else None)

    def log_images(it, tgt, cond, dt):
        """ImageLogger parity (Zero123/helpers/custom_callbacks.py:77-115):
        inputs, targets and CFG-3.0 samples of the live weights as grids,
        N capped like max_images."""
        n = min(args.batch, args.max_log_images)
        samples = model.ddim_sample(cond[:n], dt[:n], rng, num_steps=args.sample_steps,
                                    cfg_scale=3.0, image_size=args.image_size)
        tb.image_grid("train/conditioning", cond[:n].cpu().numpy(), it)
        tb.image_grid("train/targets", tgt[:n].cpu().numpy(), it)
        tb.image_grid("train/samples_cfg_scale_3.00", samples.cpu().numpy(), it)

    def save(name):
        save_params(os.path.join(args.save_dir, name), trainer.tree())
        if trainer.ema is not None:
            save_params(os.path.join(args.save_dir, name + "_ema"), trainer.ema_tree())

    rng = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    loss = torch.tensor(float("nan"))
    try:
        with trace(args.profile_dir):
            for it in range(1, args.iterations + 1):
                with annotate("fnx.data"):
                    tgt, cond, dt = ds.sample_batch(args.batch, rng_np)
                    tgt, cond = torch.as_tensor(tgt, device=dev), torch.as_tensor(cond, device=dev)
                    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
                with annotate("fnx.train_step"):
                    loss = trainer.step(pm.data_shard(tgt, mesh), pm.data_shard(cond, mesh),
                                        pm.data_shard(dt, mesh), rng)
                if it % args.log_every == 0:
                    ips = it / (time.time() - t0)
                    mem = device_memory_stats(dev)
                    mem_s = f" peak {mem['peak_mib']:.0f}MiB" if "peak_mib" in mem else ""
                    log(f"iter {it}/{args.iterations} loss {float(loss):.5f} "
                        f"({ips:.2f} it/s){mem_s}")
                    tb.scalar("train/loss", float(loss), it)
                    tb.scalar("train/lr_abs", lr_fn(it), it)
                    tb.scalar("perf/iters_per_sec", ips, it)
                    tb.scalars("perf", mem, it)
                # every rank samples, so that their generators stay in step
                if args.save_dir and args.sample_every and (
                        it == 1 or it % args.sample_every == 0):
                    with annotate("fnx.log_images"):
                        log_images(it, tgt, cond, dt)
                if args.save_dir and it % args.save_every == 0 and main_rank:
                    save(f"iter_{it:07d}")
    except KeyboardInterrupt:
        # melk parity (Zero123/main.py:254-260): a last checkpoint, then re-raise
        if args.save_dir and main_rank:
            save("last")
            log(f"interrupted: saved {os.path.join(args.save_dir, 'last')}")
        raise
    return model, float(loss), trainer.ema


def build_argparser():
    ap = argparse.ArgumentParser(description="finetune the novel-view LDM")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--save_dir", default="")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--iterations", type=int, default=52000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--scale_lr", action="store_true")
    ap.add_argument("--warmup_steps", type=int, default=100,
                    help="LambdaLinearScheduler warm_up_steps (yaml scheduler_config)")
    ap.add_argument("--cond_view", type=int, default=-1,
                    help="fix the conditioning camera (with --target_view); -1 = random pairs")
    ap.add_argument("--target_view", type=int, default=-1)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--ema_decay", type=float, default=0.9999,
                    help="LitEma decay on the trainable subtrees "
                         "(ddpm.py:111-113); 0 disables the shadow")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=1000)
    # ImageLogger parity: batch_frequency 1000, max_images 32, log_first_step
    # (configs/fluid_nexus_smoke.yaml:98-111); 0 disables
    ap.add_argument("--sample_every", type=int, default=1000)
    ap.add_argument("--max_log_images", type=int, default=32)
    ap.add_argument("--sample_steps", type=int, default=50)
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler trace of the run here (TensorBoard)")
    ap.add_argument("--tiny", action="store_true")
    return ap


def main(argv=None, device="cuda", log=print):
    return train(build_argparser().parse_args(argv), log=log, device=device)


if __name__ == "__main__":
    main()
