"""What each rank of the port's multi-rank CPU tests runs
(``tests/torch_dist_ranks.spawn`` calls these by name). Torch and the port
only: the tests that start the ranks hold the results against the JAX
package. Every function returns numpy or plain values."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from fluidnexus_torch.convert import video_dit_from_numpy
from fluidnexus_torch.parallel import mesh as pm

CPU = torch.device("cpu")


# ------------------------------- the mesh ------------------------------------

def mesh_shapes(shapes):
    """{(dp, tp, time) asked: the mesh's sizes by name}, and the assert's
    message for a shape that does not cover the world."""
    out = {}
    for dp, tp, time in shapes:
        m = pm.make_mesh(dp=dp, tp=tp, time=time, device_type="cpu")
        out[(dp, tp, time)] = {a: m.size(i) for i, a in enumerate(pm.AXES)}
    try:
        pm.make_mesh(dist.get_world_size(), dp=3, tp=2, device_type="cpu")
    except AssertionError as e:
        out["assert"] = str(e)
    m = pm.make_mesh(tp=2, device_type="cpu")
    full = torch.arange(24.0).reshape(2, 3, 4)
    out["replicated"] = pm.replicated(torch.full((3,), float(dist.get_rank()))).tolist()
    out["data_shard"] = pm.data_shard(full, m).tolist()
    out["logical"] = pm.shard_params_logical({"w": full, "b": full[0]}, m,
                                             {"w": (2, "model"), "b": None})
    out["logical"] = {k: v.tolist() for k, v in out["logical"].items()}
    out["coords"] = (pm.axis_rank(m, "data"), pm.axis_rank(m, "model"))
    return out


# ------------------------------ the video DiT --------------------------------

def _engine_and_dit(tree, cfg, dp, tp, fixed_frames=0):
    from fluidnexus_torch.diffusion.video.engine import VideoEngine

    engine = VideoEngine(cfg, fixed_frames=fixed_frames)
    dit = video_dit_from_numpy(tree, cfg, CPU)
    mesh = pm.make_mesh(dp * tp, dp=dp, tp=tp, device_type="cpu")
    return engine, dit, mesh


def sample(tree, cfg, text, shape, steps, dp, tp, seed=3):
    """``VideoEngine.sample`` after ``shard_for_generation`` over a (dp, tp)
    mesh: the latents, and this rank's share of the heads."""
    engine, dit, mesh = _engine_and_dit(tree, cfg, dp, tp)
    engine.shard_for_generation(dit, None, mesh)
    text = torch.as_tensor(text)
    lat = engine.sample(dit, shape, text, torch.zeros_like(text),
                        rng=torch.Generator().manual_seed(seed), num_steps=steps)
    qkv = dict(dit.named_parameters())["block_0.attn.qkv.weight"]
    return {"lat": lat.numpy(), "qkv_rows": qkv.shape[0]}


def train_steps(tree, cfg, x, txt, dp, tp, steps=2, lr=1e-3, decay=0.9):
    """``steps`` LoRA steps of ``VideoTrainer`` over a (dp, tp) mesh (each
    rank its rows of the batch, its shard of the DiT, its ZeRO chunk of the
    moments), generator i seeding step i: the losses, then the LoRA leaves,
    the EMA and the optimizer's leaves gathered whole."""
    from fluidnexus_torch.diffusion.video.dit import shard_dit_
    from fluidnexus_torch.pipelines.train_video import VideoTrainer

    engine, dit, mesh = _engine_and_dit(tree, cfg, dp, tp, fixed_frames=1)
    shard_dit_(dit, mesh)
    trainer = VideoTrainer(engine, dit, lr, decay, mesh=mesh)
    x, txt = pm.data_shard(torch.as_tensor(x), mesh), pm.data_shard(torch.as_tensor(txt), mesh)
    losses = [float(trainer.step(x, txt, torch.Generator().manual_seed(i))) for i in range(steps)]
    tree = trainer.tree()
    lora = {k: tree[k].detach().numpy() for k in trainer.params}
    ema = {k: v.detach().numpy() for k, v in trainer.ema_tree().items() if k in trainer.params}
    local = {k: (tuple(v.shape), tuple(trainer.opt.mu[k].shape)) for k, v in trainer.params.items()}
    return {"losses": losses, "lora": lora, "ema": ema, "local": local,
            "opt": [leaf.detach().numpy() for leaf in trainer.opt_leaves()]}


# --------------------------------- the CLIs ----------------------------------

def _argv_for_rank(argv, rank_dirs):
    """``argv`` with each flag of ``rank_dirs`` pointing at a folder of this
    rank's own (rank 0 keeps the given one)."""
    r = dist.get_rank()
    out = list(argv)
    for flag in rank_dirs:
        i = out.index(flag) + 1
        if r:
            out[i] = f"{out[i]}_rank{r}"
    return out


def cli(stage, argv, rank_dirs=()):
    """``main(argv, device="cpu")`` of a stage on every rank; the folders of
    ``rank_dirs`` are this rank's own, so a test sees what each rank wrote.
    Returns whatever the stage returns that is an array (else None)."""
    import importlib

    mod = importlib.import_module(f"fluidnexus_torch.pipelines.{stage}")
    out = mod.main(_argv_for_rank(argv, rank_dirs), device="cpu")
    if isinstance(out, torch.Tensor):
        return out.numpy()
    if stage == "train_video":
        dit, loss, _ = out
        return {"loss": loss}
    if stage == "train_novel_view":
        return {"loss": out[1]}
    return None


# ------------------------------ reconstruction -------------------------------

def recon_steps(kind, setup, sels, lr, dp):
    """Phase-A (``kind`` "a") or phase-C ("c") fit steps of the port at
    camera batches ``sels`` ([(indices, weights, 1/real count)]), over a
    'data' group of ``dp`` ranks: the positions, losses and aux after each
    step."""
    from fluidnexus_torch.core.optim import adam_init
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain

    grp = pm.group(pm.make_mesh(dp, dp=dp, device_type="cpu"), "data") if dp > 1 else None
    s = setup
    views, projs, fovs = s["cams"]
    out = []
    if kind == "a":
        step = ttrain.make_first_frame_step(None, s["raster"], s["w"], s["h"], *s["lambdas"], 3,
                                            group=grp)
        x, opt = s["x0"].clone(), adam_init({"xyz": s["x0"]})
        for sel, w, inv_w in sels:
            sel = torch.as_tensor(sel)
            x, opt, loss, l1 = step(x, s["alive"], s["attrs"], opt,
                                    (views[sel], projs[sel], fovs[sel]), s["gts"][sel], lr,
                                    torch.as_tensor(w), torch.as_tensor(inv_w))
            out.append({"x": x.numpy(), "loss": float(loss), "aux": {"l1": float(l1)}})
    else:
        step = ttrain.make_current_frame_step(None, s["raster"], s["w"], s["h"], s["params"],
                                              s["optim"], 3, group=grp)
        x, opt = s["x0"].clone(), adam_init({"nn": s["x0"]})
        for sel, w, inv_w in sels:
            sel = torch.as_tensor(sel)
            x, opt, loss, aux = step(x, opt, s["state"], s["visual"], s["attrs"],
                                     (views[sel], projs[sel], fovs[sel]), s["gts"][sel], lr,
                                     torch.as_tensor(w), torch.as_tensor(inv_w))
            out.append({"x": x.numpy(), "loss": float(loss),
                        "aux": {k: float(v) for k, v in aux.items()}})
    return out


def recon_fit_first_frame(cfg, scene):
    """``fit_first_frame`` with the config's ``pipe.dp`` (its own mesh)."""
    from fluidnexus_torch.pipelines import train_physical_particle as ttrain

    visual, _, losses = ttrain.fit_first_frame(cfg, scene, log=lambda *a: None, device="cpu")
    return {"xyz": visual.xyz.numpy(), "losses": losses.numpy()}


# ---------------------------- the VAE over time ------------------------------

def halo(x, kernel_t, n):
    """Each rank's ``halo_exchange_time`` of its shard of ``x`` over a time
    group of ``n``, gathered, and ``cp_causal_conv_time`` of a VALID-in-time
    mean filter."""
    from fluidnexus_torch.parallel.cp import (
        cp_causal_conv_time, cp_gather_time, cp_split_time, halo_exchange_time,
    )

    mesh = pm.make_mesh(n, dp=1, tp=1, time=n, device_type="cpu")
    xl = cp_split_time(torch.as_tensor(x), mesh)
    padded = halo_exchange_time(xl, kernel_t, pm.group(mesh, "time"))

    def conv(xp):
        return sum(xp[:, i:i + xp.shape[1] - kernel_t + 1] for i in range(kernel_t)) / kernel_t

    conv_out = cp_gather_time(cp_causal_conv_time(conv, mesh, kernel_t)(xl), mesh)
    return {"padded": padded.numpy(), "conv": conv_out.numpy()}


def vae_cp(tree, cfg, x, z, n):
    """``cp_vae_encode`` of ``x`` and ``cp_vae_decode`` of ``z`` over a time
    group of ``n``."""
    from fluidnexus_torch.convert import vae3d_from_numpy
    from fluidnexus_torch.parallel.cp import cp_vae_decode, cp_vae_encode

    mesh = pm.make_mesh(n, dp=1, tp=1, time=n, device_type="cpu")
    vae = vae3d_from_numpy(tree, cfg, CPU)
    with torch.no_grad():
        enc = cp_vae_encode(vae, torch.as_tensor(x), mesh)
        dec = cp_vae_decode(vae, torch.as_tensor(z), mesh)
    return {"enc": enc.numpy(), "dec": dec.numpy()}


def files_under(root):
    """Relative paths of every file under ``root`` (empty when absent)."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)
