"""Port drill (counterpart of ``fluidnexus_tpu/pipelines/port_drill.py``):
run the torch-checkpoint maps (``diffusion/port.py``) end to end over real
checkpoint files, load each tree into the port's module and print its
parameter count and a forward checksum computed on the card, so a ported
stack can be validated (and compared with the JAX package's drill) before
any training or generation run. With ``--out_dir`` it writes the trees in
the flat-npz format (``core/checkpoint.save_params``) that the port's
``--ckpt``/``--dit_ckpt``/``--vae_ckpt`` flags read.

    python -m fluidnexus_torch port --zero123 last.ckpt \
        --cogvideox mp_rank_00_model_states.pt --vae3d 3d-vae.pt \
        --t5 /path/t5-v1_1-xxl --out_dir ports/

Reference checkpoints being ported: Zero123 Lightning ckpt (main.py:98-128),
CogVideoX SAT ckpt + LoRA (sat load_checkpoint; gen_refine_pi2v_long.py:39),
CogVideoX 3D-VAE (vae yaml ckpt_path), HF t5-v1_1-xxl
(sgm/modules/encoders/modules.py:233).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.convert import flax_param_names, load_flax_params
from fluidnexus_torch.core.checkpoint import save_params
from fluidnexus_torch.diffusion.port import (
    graft_params_into, load_torch_state_dict, port_video_dit, port_video_vae,
    port_zero123_checkpoint,
)


def _checksum(x) -> float:
    return float(x.float().abs().sum())


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _n_params(tree) -> int:
    return sum(int(np.prod(np.shape(leaf))) for leaf in _leaves(tree))


def _report(name, tree, fwd=None):
    line = f"[port] {name:14s} {_n_params(tree) / 1e6:10.2f}M params"
    if fwd is not None:
        line += f"   forward checksum {fwd:.6g}"
    print(line)


def _save(out_dir, name, tree):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, name)
        save_params(path, tree)
        print(f"[port] {name:14s} saved -> {path}")


def _built(cls, cfg, dev):
    """``cls(cfg)`` on ``dev`` with every parameter 0 (the JAX drill's
    template of zeros)."""
    with torch.device(dev):
        module = cls(cfg)
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


def _grafted_tree(module, ported):
    """The tree the JAX package's graft returns: the ported leaves, the
    module's own (in the flax layout) where the tree lacks one, float leaves
    as f32 (the JAX template's parameter type)."""
    names = flax_param_names(ported)
    missing = {n: p for n, p in module.named_parameters() if n not in names}
    if not missing:
        tree = ported
    else:
        from fluidnexus_torch.convert import flax_params_to_numpy

        tree = _merged(ported, flax_params_to_numpy(missing))
    return _as_f32(tree)


def _merged(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merged(out[k], v) if k in out and isinstance(v, dict) else v
    return out


def _as_f32(tree):
    return {k: _as_f32(v) if isinstance(v, dict) else
            (np.asarray(v, np.float32) if np.issubdtype(np.asarray(v).dtype, np.floating) else v)
            for k, v in tree.items()}


def drill_zero123(path, out_dir="", unet_cfg=None, vae_cfg=None, clip_cfg=None, image_size=64,
                  device="cuda"):
    """Zero123/FluidNexus Lightning ckpt -> NovelViewModel tree (+ forward)."""
    from fluidnexus_torch.diffusion.ldm.model import build_novel_view

    dev = resolve_device(device)
    sd = load_torch_state_dict(path)
    model = build_novel_view(dev, unet_config=unet_cfg, vae_config=vae_cfg, clip_config=clip_cfg)
    params = port_zero123_checkpoint(sd, model.unet_config, model.vae_config,
                                     clip_layers=model.clip_config.layers)
    del sd
    load_flax_params(model, params, dev)
    size = model.clip_config.image_size
    lat = image_size // model.downsample_factor
    with torch.no_grad():
        ctx, concat = model.conditioning(torch.zeros((1, size, size, 3), device=dev),
                                         torch.zeros((1, 4), device=dev))
        eps = model.unet(torch.zeros((1, lat, lat, model.unet_config.in_channels), device=dev),
                         torch.zeros((1,), dtype=torch.int32, device=dev), ctx)
    _report("zero123.unet", params["unet"], _checksum(eps))
    _report("zero123.vae", params["vae"], _checksum(concat))
    _report("zero123.clip", params["clip"], _checksum(ctx))
    _report("zero123.cc", params["cc"])
    _save(out_dir, "zero123", params)
    return params


def drill_cogvideox(path, out_dir="", dit_cfg=None, quant=False, device="cuda"):
    """SAT DiT ckpt (base or LoRA finetune) -> VideoDiT tree (+ forward)."""
    from fluidnexus_torch.diffusion.video.dit import VideoDiT, VideoDiTConfig, quantize_dit_params

    dev = resolve_device(device)
    cfg = dit_cfg or VideoDiTConfig(latent_frames=2, latent_height=8, latent_width=8)
    sd = load_torch_state_dict(path)
    ported = port_video_dit(sd, cfg)
    del sd
    dit = graft_params_into(_built(VideoDiT, cfg, dev), ported)
    params = _grafted_tree(dit, ported)
    del ported
    with torch.no_grad():
        out = dit(torch.zeros((1, cfg.latent_frames, cfg.in_channels, cfg.latent_height,
                               cfg.latent_width), device=dev),
                  torch.zeros((1,), dtype=torch.int32, device=dev),
                  torch.zeros((1, cfg.text_length, cfg.text_hidden_size), device=dev))
    del dit
    _report("video.dit", params, _checksum(out))
    if quant:
        params = quantize_dit_params(params)
        print("[port] video.dit     quantized (int8 base)")
    _save(out_dir, "video_dit", params)
    return params


def drill_vae3d(path, out_dir="", vae_cfg=None, device="cuda"):
    """CogVideoX 3D-VAE ckpt -> VideoVAE tree (+ tiny encode checksum)."""
    from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig, VideoVAE

    dev = resolve_device(device)
    cfg = vae_cfg or VAE3DConfig()
    sd = load_torch_state_dict(path)
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = {k[len("first_stage_model."):]: v for k, v in sd.items()
              if k.startswith("first_stage_model.")}
    params = port_video_vae(sd, cfg)
    vae = load_flax_params(_built(VideoVAE, cfg, dev), params, dev)
    factor = 2 ** (len(cfg.ch_mult) - 1)
    with torch.no_grad():
        z, _ = vae.encode(torch.zeros((1, 5, factor * 8, factor * 8, 3), device=dev))
    _report("video.vae3d", params, _checksum(z))
    _save(out_dir, "video_vae", params)
    return params


def drill_t5(t5_dir, max_length=226, device="cuda"):
    """Real-weights T5 path (modules.py:233) — must NOT hash-fallback here."""
    from fluidnexus_torch.diffusion.video.conditioner import T5TextEncoder

    enc = T5TextEncoder(t5_dir, max_length=max_length, device=device)
    emb = enc(["a smoke plume rising"])
    print(f"[port] t5             embeds {tuple(emb.shape)}"
          f"   forward checksum {_checksum(emb):.6g}")
    return emb


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        description="run every torch-checkpoint port map over real checkpoints and print "
                    "forward checksums (optionally saving the ported trees for the pipeline "
                    "--ckpt flags)")
    ap.add_argument("--zero123", default="", help="Zero123 Lightning .ckpt")
    ap.add_argument("--cogvideox", default="",
                    help="SAT DiT ckpt (mp_rank_00_model_states.pt; raw LoRA "
                         "finetunes are merged automatically)")
    ap.add_argument("--vae3d", default="", help="CogVideoX 3D-VAE ckpt")
    ap.add_argument("--t5", default="", help="HF t5-v1_1-xxl directory")
    ap.add_argument("--out_dir", default="",
                    help="save ported trees here (zero123.npz, video_dit.npz, video_vae.npz)")
    ap.add_argument("--quant_base", action="store_true",
                    help="also int8-quantize the DiT base for the single-card LoRA recipe")
    args = ap.parse_args(argv)
    if not (args.zero123 or args.cogvideox or args.vae3d or args.t5):
        ap.error("nothing to do: pass at least one checkpoint flag")
    resolve_device(device)
    # f32 products and convolutions in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.zero123:
        drill_zero123(args.zero123, args.out_dir, device=device)
    if args.cogvideox:
        drill_cogvideox(args.cogvideox, args.out_dir, quant=args.quant_base, device=device)
    if args.vae3d:
        drill_vae3d(args.vae3d, args.out_dir, device=device)
    if args.t5:
        drill_t5(args.t5, device=device)
    print("[port] all requested port maps ran OK")


if __name__ == "__main__":
    main()
