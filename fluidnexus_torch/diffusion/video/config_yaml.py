"""The reference's CogVideoX SAT YAML configs as the port's dataclasses
(counterpart of ``fluidnexus_tpu/diffusion/video/config_yaml.py``).

The reference launches training and sampling with ``--base
cogvideox_5b_lora_prefixi2v.yaml sft_pi2v_<exp>.yaml`` and deep-merges the
files in order (sat's ``arguments.py`` config merge). This module performs
the same ordered deep-merge and maps the resulting ``target:``/``params:``
instantiation tree onto the port's dataclasses:

  model.network_config.params            -> VideoDiTConfig
  model.first_stage_config.*             -> VAE3DConfig (+ model.scale_factor)
  model.sampler_config.params            -> sampler/guider settings
  model.loss_fn_config.params            -> fixed_frames (prefix-i2v)
  args / data / deepspeed sections       -> TrainArgs

The deepspeed-only plumbing (fp16 loss-scale windows, bucket sizes, cpu
offload) is dropped; everything that changes the model's math or the
training recipe is kept.

``num_frames: 81`` in the 5B yaml is set above the real clip length only to
skip loading the checkpoint's rope sin/cos buffers; the token count comes
from the data section's ``max_num_frames`` (49 -> 13 latent frames), which
this loader prefers when present.

PyYAML is imported inside ``load_cogvideox_yaml``, so the package imports
without it; on a host without it ``--base`` raises ImportError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from fluidnexus_torch.diffusion.video.dit import VideoDiTConfig
from fluidnexus_torch.diffusion.video.sampling import DynamicCFG
from fluidnexus_torch.diffusion.video.vae3d import VAE3DConfig


def deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge, later files win (sat config merge order)."""
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _params(tree: Dict[str, Any], *path: str) -> Dict[str, Any]:
    """Follow `path` of keys, unwrapping a trailing 'params' if present."""
    node: Any = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return {}
        node = node[k]
    if isinstance(node, dict):
        return node.get("params", node) if "params" in node else node
    return {}


@dataclasses.dataclass(frozen=True)
class SamplerArgs:
    num_steps: int = 50
    guider: str = "DynamicCFG"
    scale: float = 6.0
    exp: float = 5.0
    shift_scale: float = 1.0

    def make_guider(self) -> DynamicCFG:
        return DynamicCFG(scale=self.scale, exp=self.exp, num_steps=self.num_steps)


@dataclasses.dataclass(frozen=True)
class TrainArgs:
    """The `args` + `data` + `deepspeed` sections that shape the run."""
    experiment_name: str = ""
    train_iters: int = 10000
    save_interval: int = 1000
    log_interval: int = 100
    eval_interval: int = 2000
    train_data: Tuple[str, ...] = ()
    valid_data: Tuple[str, ...] = ()
    load: str = ""
    save: str = ""
    summary_dir: str = ""
    checkpoint_activations: bool = True
    # data section (data_video.SFTDataset params)
    video_size: Tuple[int, int] = (480, 720)
    fps: int = 8
    max_num_frames: int = 49
    skip_frms_num: int = 0
    cam_str: str = "all"
    paths_post: str = ""
    # deepspeed section -> optimizer/batching recipe
    micro_batch: int = 2
    grad_accum: int = 1
    grad_clip: float = 0.1
    zero_stage: int = 2
    bf16: bool = True
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 1e-4


@dataclasses.dataclass(frozen=True)
class CogVideoXRunConfig:
    dit: VideoDiTConfig
    vae: VAE3DConfig
    sampler: SamplerArgs
    train: TrainArgs
    scale_factor: float = 0.7
    fixed_frames: int = 0
    ucg_rate: float = 0.1
    t5_dir: str = ""
    lora_rank: int = 0


def _latent_frames(num_frames: int, rate: int) -> int:
    return (num_frames - 1) // max(rate, 1) + 1


def load_cogvideox_yaml(paths: Sequence[str],
                        overrides: Optional[Dict[str, Any]] = None) -> CogVideoXRunConfig:
    """Merge the YAML files in order (reference --base semantics) and map to
    native configs. `overrides` deep-merges last (CLI wins)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("--base YAML configs need PyYAML, which is not installed") from e

    merged: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            merged = deep_merge(merged, yaml.safe_load(f) or {})
    if overrides:
        merged = deep_merge(merged, overrides)

    model = merged.get("model", {})
    net = _params(model, "network_config")
    modules = net.get("modules", {}) if isinstance(net.get("modules"), dict) else {}
    targs = net.get("transformer_args", {}) or {}
    pos = _params(modules, "pos_embed_config")
    patch = _params(modules, "patch_embed_config")
    lora = _params(modules, "lora_config")
    adaln = _params(modules, "adaln_layer_config")

    args = merged.get("args", {}) or {}
    data = _params(merged, "data")
    ds = merged.get("deepspeed", {}) or {}
    opt = _params(ds, "optimizer")
    zero = ds.get("zero_optimization", {}) or {}
    bf16 = bool((ds.get("bf16") or {}).get("enabled", True))

    rate = int(net.get("time_compressed_rate", 4))
    # prefer the data clip length over the checkpoint-load hack (see module doc)
    num_frames = int(data.get("max_num_frames", net.get("num_frames", 49)))
    lora_rank = int(lora.get("r", 0)) if lora else 0
    remat = bool(targs.get("checkpoint_activations",
                           args.get("checkpoint_activations", True)))

    dit = VideoDiTConfig(
        hidden_size=int(net.get("hidden_size", 3072)),
        num_layers=int(net.get("num_layers", 42)),
        num_heads=int(net.get("num_attention_heads", 48)),
        patch_size=int(net.get("patch_size", 2)),
        in_channels=int(net.get("in_channels", 16)),
        out_channels=int(net.get("out_channels", 16)),
        text_hidden_size=int(patch.get("text_hidden_size", 4096)),
        text_length=int(pos.get("text_length", 226)),
        latent_frames=_latent_frames(num_frames, rate),
        latent_height=int(net.get("latent_height", 60)),
        latent_width=int(net.get("latent_width", 90)),
        time_embed_dim=net.get("time_embed_dim"),
        lora_rank=lora_rank,
        dtype=torch.bfloat16 if bf16 else torch.float32,
        ln_affine=bool(net.get("elementwise_affine", True)),
        remat=remat,
    )

    enc = _params(model, "first_stage_config", "encoder_config")
    scale_factor = float(model.get("scale_factor", 0.7))
    vae = VAE3DConfig(
        ch=int(enc.get("ch", 128)),
        ch_mult=tuple(enc.get("ch_mult", (1, 2, 2, 4))),
        num_res_blocks=int(enc.get("num_res_blocks", 3)),
        in_channels=int(enc.get("in_channels", 3)),
        out_channels=int(enc.get("out_ch", 3)),
        z_channels=int(enc.get("z_channels", 16)),
        double_z=bool(enc.get("double_z", True)),
        scale_factor=scale_factor,
    )

    samp = _params(model, "sampler_config")
    guider = _params(samp, "guider_config") if samp else {}
    gtarget = ((model.get("sampler_config") or {}).get("params", {})
               .get("guider_config", {}).get("target", "")) if samp else ""
    disc = _params(samp, "discretization_config") if samp else {}
    sampler = SamplerArgs(
        num_steps=int(samp.get("num_steps", 50)) if samp else 50,
        guider="DynamicCFG" if "DynamicCFG" in str(gtarget) else "VanillaCFG",
        scale=float(guider.get("scale", 6.0)) if guider else 6.0,
        exp=float(guider.get("exp", 5.0)) if guider else 5.0,
        shift_scale=float(disc.get("shift_scale", 1.0)) if disc else 1.0,
    )

    loss = _params(model, "loss_fn_config")
    fixed_frames = int(loss.get("fixed_frames", 0)) if loss else 0

    cond = _params(model, "conditioner_config")
    ucg_rate, t5_dir = 0.1, ""
    for emb in cond.get("emb_models", []) or []:
        if "T5" in str(emb.get("target", "")):
            ucg_rate = float(emb.get("ucg_rate", 0.1))
            t5_dir = str(emb.get("params", {}).get("model_dir", ""))

    def _pair(v, default):
        return tuple(int(x) for x in v) if v is not None else default

    train = TrainArgs(
        experiment_name=str(args.get("experiment_name", "")),
        train_iters=int(args.get("train_iters", 10000)),
        save_interval=int(args.get("save_interval", 1000)),
        log_interval=int(args.get("log_interval", 100)),
        eval_interval=int(args.get("eval_interval", 2000)),
        train_data=tuple(args.get("train_data", []) or []),
        valid_data=tuple(args.get("valid_data", []) or []),
        load=str(args.get("load", "")),
        save=str(args.get("save", "")),
        summary_dir=str(args.get("summary_dir", "")),
        checkpoint_activations=remat,
        video_size=_pair(data.get("video_size"), (480, 720)),
        fps=int(data.get("fps", 8)),
        max_num_frames=num_frames,
        skip_frms_num=int(data.get("skip_frms_num", 0)),
        cam_str=str(data.get("cam_str", "all")),
        paths_post=str(data.get("paths_post", "")),
        micro_batch=int(ds.get("train_micro_batch_size_per_gpu", 2)),
        grad_accum=int(ds.get("gradient_accumulation_steps", 1)),
        grad_clip=float(ds.get("gradient_clipping", 0.1)),
        zero_stage=int(zero.get("stage", 2)),
        bf16=bf16,
        lr=float(opt.get("lr", 1e-3)) if opt else 1e-3,
        betas=tuple(float(b) for b in opt.get("betas", (0.9, 0.95))) if opt else (0.9, 0.95),
        eps=float(opt.get("eps", 1e-8)) if opt else 1e-8,
        weight_decay=float(opt.get("weight_decay", 1e-4)) if opt else 1e-4,
    )

    return CogVideoXRunConfig(
        dit=dit, vae=vae, sampler=sampler, train=train,
        scale_factor=scale_factor, fixed_frames=fixed_frames,
        ucg_rate=ucg_rate, t5_dir=t5_dir, lora_rank=lora_rank,
    )
