"""Torch checkpoint -> flax-named parameter trees (counterpart of
``fluidnexus_tpu/diffusion/port.py``).

A user of the reference arrives with torch checkpoints: the zero123-xl LDM
ckpt (Zero123/main.py:98-128, including its 4->8 input-channel port), the
CogVideoX SAT checkpoint + LoRA deltas, CLIP, and the VAEs. The maps here
give the same nested numpy trees, named as flax names them, as the JAX
package's maps, bit for bit; the port's loaders take those trees
(``convert.novel_view_from_numpy``, ``video_dit_from_numpy``,
``vae3d_from_numpy``, ``load_flax_params``), and ``graft_params_into`` loads
one into a built module. Everything but the graft is numpy.

Conventions (torch -> flax/NHWC):
  Linear  W (out,in)            -> kernel (in,out)
  Conv2d  W (out,in,kh,kw)      -> kernel (kh,kw,in,out)
  Conv3d  W (out,in,kt,kh,kw)   -> kernel (kt,kh,kw,in,out)
  Norm    weight/bias           -> scale/bias unchanged
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def t2f_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (1, 0)))


def t2f_conv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def t2f_conv3d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 4, 1, 0)))


def port_input_conv_4to8(conv_w: np.ndarray) -> np.ndarray:
    """The zero123 4->8 input-channel port (Zero123/main.py:109-128): the
    upstream UNet's first conv takes 4 latent channels; FluidNexus feeds 8
    (noisy latent + cond-image latent). New channels start at zero so the
    pretrained behavior is preserved at step 0.

    conv_w: torch layout (out, 4, kh, kw) -> (out, 8, kh, kw)."""
    out, cin, kh, kw = conv_w.shape
    assert cin == 4, conv_w.shape
    new = np.zeros((out, 8, kh, kw), conv_w.dtype)
    new[:, :4] = conv_w
    return new


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint to numpy. Handles Lightning ('state_dict') and
    SAT ('module') wrappers. The leaves are numpy views of the loaded
    tensors, so a bfloat16 leaf raises ``TypeError`` as it does in the JAX
    package (numpy has no bfloat16)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "module", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in ckpt.items() if hasattr(v, "shape")}


def merge_lora_into_dense(kernel: np.ndarray, lora_a: np.ndarray, lora_b: np.ndarray,
                          alpha: float = 1.0) -> np.ndarray:
    """Fold a trained LoRA pair into the base kernel (flax layout):
    W' = W + A @ B * alpha. Useful when exporting finetuned checkpoints for
    plain-Dense inference."""
    return kernel + (lora_a @ lora_b) * alpha


# ------------------------- Zero123 UNet name mapping --------------------------


def port_zero123_unet(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Map an openaimodel UNetModel state dict (Zero123's network,
    ldm/modules/diffusionmodules/openaimodel.py) onto
    fluidnexus_torch.diffusion.ldm.unet.UNet's parameter tree.

    The tree equals the JAX package's map's (tests/test_torch_port.py),
    which is held to the reference torch module. For the FluidNexus finetunes the checkpoint's
    UNet keys live under 'model.diffusion_model.' — strip that prefix first;
    apply port_input_conv_4to8 beforehand when porting the upstream
    4-channel zero123-xl checkpoint (Zero123/main.py:109-128)."""

    def gn(tp):
        return {"GroupNorm_0": {"scale": np.asarray(sd[tp + ".weight"]),
                                "bias": np.asarray(sd[tp + ".bias"])}}

    def ln(tp):
        return {"scale": np.asarray(sd[tp + ".weight"]), "bias": np.asarray(sd[tp + ".bias"])}

    def conv(tp):
        return {"kernel": t2f_conv2d(sd[tp + ".weight"]), "bias": np.asarray(sd[tp + ".bias"])}

    def dense(tp, bias=True):
        d = {"kernel": t2f_linear(sd[tp + ".weight"])}
        if bias:
            d["bias"] = np.asarray(sd[tp + ".bias"])
        return d

    def resblock(tp):
        r = {
            "GroupNorm32_0": gn(tp + ".in_layers.0"),
            "conv1": conv(tp + ".in_layers.2"),
            "emb_proj": dense(tp + ".emb_layers.1"),
            "GroupNorm32_1": gn(tp + ".out_layers.0"),
            "conv2": conv(tp + ".out_layers.3"),
        }
        if tp + ".skip_connection.weight" in sd:
            w = sd[tp + ".skip_connection.weight"]
            r["skip"] = {"kernel": t2f_conv2d(w), "bias": np.asarray(sd[tp + ".skip_connection.bias"])}
        return r

    def xattn(tp):
        return {"to_q": dense(tp + ".to_q", bias=False),
                "to_k": dense(tp + ".to_k", bias=False),
                "to_v": dense(tp + ".to_v", bias=False),
                "to_out": dense(tp + ".to_out.0")}

    def spatial(tp, depth):
        r = {"GroupNorm32_0": gn(tp + ".norm"),
             "proj_in": conv(tp + ".proj_in"),
             "proj_out": conv(tp + ".proj_out")}
        for i in range(depth):
            tb = f"{tp}.transformer_blocks.{i}"
            r[f"block_{i}"] = {
                "LayerNorm_0": ln(tb + ".norm1"), "attn1": xattn(tb + ".attn1"),
                "LayerNorm_1": ln(tb + ".norm2"), "attn2": xattn(tb + ".attn2"),
                "LayerNorm_2": ln(tb + ".norm3"),
                "ff_in": dense(tb + ".ff.net.0.proj"),
                "ff_out": dense(tb + ".ff.net.2"),
            }
        return r

    p: Dict = {
        "time_fc1": dense("time_embed.0"),
        "time_fc2": dense("time_embed.2"),
        "conv_in": conv("input_blocks.0.0"),
        "GroupNorm32_0": gn("out.0"),
        "conv_out": conv("out.2"),
    }
    attn_res = set(cfg.attention_resolutions)
    depth = cfg.transformer_depth

    k, ds = 1, 1
    for i in range(len(cfg.channel_mult)):
        for j in range(cfg.num_res_blocks):
            p[f"down_{i}_res_{j}"] = resblock(f"input_blocks.{k}.0")
            if ds in attn_res:
                p[f"down_{i}_attn_{j}"] = spatial(f"input_blocks.{k}.1", depth)
            k += 1
        if i != len(cfg.channel_mult) - 1:
            p[f"down_{i}_downsample"] = conv(f"input_blocks.{k}.0.op")
            k += 1
            ds *= 2

    p["mid_res_1"] = resblock("middle_block.0")
    p["mid_attn"] = spatial("middle_block.1", depth)
    p["mid_res_2"] = resblock("middle_block.2")

    k = 0
    for i in reversed(range(len(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            p[f"up_{i}_res_{j}"] = resblock(f"output_blocks.{k}.0")
            idx = 1
            if ds in attn_res:
                p[f"up_{i}_attn_{j}"] = spatial(f"output_blocks.{k}.{idx}", depth)
                idx += 1
            if i != 0 and j == cfg.num_res_blocks:
                p[f"up_{i}_upsample"] = conv(f"output_blocks.{k}.{idx}.conv")
                ds //= 2
            k += 1
    return p


# ------------------------- KL-VAE (SD f=8) name mapping -----------------------


def port_kl_vae(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Map an SD AutoencoderKL state dict (Zero123's first stage,
    ldm/modules/diffusionmodules/model.py Encoder/Decoder + quant convs) onto
    fluidnexus_torch.diffusion.ldm.autoencoder.AutoencoderKL's tree. Checkpoint
    keys typically live under 'first_stage_model.' — strip first."""

    def gn(tp):
        return {"scale": np.asarray(sd[tp + ".weight"]), "bias": np.asarray(sd[tp + ".bias"])}

    def conv(tp):
        return {"kernel": t2f_conv2d(sd[tp + ".weight"]), "bias": np.asarray(sd[tp + ".bias"])}

    def res(tp):
        r = {"GroupNorm_0": gn(tp + ".norm1"), "conv1": conv(tp + ".conv1"),
             "GroupNorm_1": gn(tp + ".norm2"), "conv2": conv(tp + ".conv2")}
        if tp + ".nin_shortcut.weight" in sd:
            r["nin_shortcut"] = conv(tp + ".nin_shortcut")
        return r

    def attn(tp):
        return {"GroupNorm_0": gn(tp + ".norm"),
                "q": conv(tp + ".q"), "k": conv(tp + ".k"), "v": conv(tp + ".v"),
                "proj_out": conv(tp + ".proj_out")}

    n_levels = len(cfg.ch_mult)
    enc: Dict = {"conv_in": conv("encoder.conv_in"),
                 "mid_block_1": res("encoder.mid.block_1"),
                 "mid_attn": attn("encoder.mid.attn_1"),
                 "mid_block_2": res("encoder.mid.block_2"),
                 "GroupNorm_0": gn("encoder.norm_out"),
                 "conv_out": conv("encoder.conv_out")}
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            enc[f"down_{i}_block_{j}"] = res(f"encoder.down.{i}.block.{j}")
        if i != n_levels - 1:
            enc[f"down_{i}_downsample"] = conv(f"encoder.down.{i}.downsample.conv")

    dec: Dict = {"conv_in": conv("decoder.conv_in"),
                 "mid_block_1": res("decoder.mid.block_1"),
                 "mid_attn": attn("decoder.mid.attn_1"),
                 "mid_block_2": res("decoder.mid.block_2"),
                 "GroupNorm_0": gn("decoder.norm_out"),
                 "conv_out": conv("decoder.conv_out")}
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks + 1):
            dec[f"up_{i}_block_{j}"] = res(f"decoder.up.{i}.block.{j}")
        if i != 0:
            dec[f"up_{i}_upsample"] = conv(f"decoder.up.{i}.upsample.conv")

    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv("quant_conv"),
            "post_quant_conv": conv("post_quant_conv")}


# --------------------- CogVideoX causal 3D VAE name mapping -------------------


def port_video_vae(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Map the CogVideoX context-parallel causal VAE state dict
    (vae_modules/cp_enc_dec.py ContextParallelEncoder3D:718 /
    ContextParallelDecoder3D:841) onto
    fluidnexus_torch.diffusion.video.vae3d.VideoVAE's tree. Checkpoint keys
    typically live under 'first_stage_model.' — strip first."""

    def cconv(tp):  # CausalConv3d -> {"conv": {...}}
        return {"conv": {"kernel": t2f_conv3d(sd[tp + ".conv.weight"]),
                         "bias": np.asarray(sd[tp + ".conv.bias"])}}

    def conv2d(tp):
        return {"conv": {"kernel": t2f_conv2d(sd[tp + ".weight"]),
                         "bias": np.asarray(sd[tp + ".bias"])}}

    def norm(tp, zq):
        if zq:  # SpatialNorm3D (cp_enc_dec.py:453)
            return {"scale": np.asarray(sd[tp + ".norm_layer.weight"]),
                    "bias": np.asarray(sd[tp + ".norm_layer.bias"]),
                    "conv_y": cconv(tp + ".conv_y"),
                    "conv_b": cconv(tp + ".conv_b")}
        return {"scale": np.asarray(sd[tp + ".weight"]),
                "bias": np.asarray(sd[tp + ".bias"])}

    def res(tp, zq):
        r = {"norm1": norm(tp + ".norm1", zq), "conv1": cconv(tp + ".conv1"),
             "norm2": norm(tp + ".norm2", zq), "conv2": cconv(tp + ".conv2")}
        if tp + ".nin_shortcut.weight" in sd:  # plain Conv3d 1x1x1 -> Dense
            w = np.asarray(sd[tp + ".nin_shortcut.weight"])[:, :, 0, 0, 0]
            r["nin_shortcut"] = {"kernel": t2f_linear(w),
                                 "bias": np.asarray(sd[tp + ".nin_shortcut.bias"])}
        return r

    n_levels = len(cfg.ch_mult)
    enc: Dict = {"conv_in": cconv("encoder.conv_in"),
                 "mid_block_1": res("encoder.mid.block_1", False),
                 "mid_block_2": res("encoder.mid.block_2", False),
                 "norm_out": norm("encoder.norm_out", False),
                 "conv_out": cconv("encoder.conv_out")}
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            enc[f"down_{i}_block_{j}"] = res(f"encoder.down.{i}.block.{j}", False)
        if i != n_levels - 1:
            enc[f"down_{i}_downsample"] = conv2d(f"encoder.down.{i}.downsample.conv")

    dec: Dict = {"conv_in": cconv("decoder.conv_in"),
                 "mid_block_1": res("decoder.mid.block_1", True),
                 "mid_block_2": res("decoder.mid.block_2", True),
                 "norm_out": norm("decoder.norm_out", True),
                 "conv_out": cconv("decoder.conv_out")}
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks + 1):
            dec[f"up_{i}_block_{j}"] = res(f"decoder.up.{i}.block.{j}", True)
        if i != 0:
            dec[f"up_{i}_upsample"] = conv2d(f"decoder.up.{i}.upsample.conv")

    return {"encoder": enc, "decoder": dec}


# ---------------------- OpenAI CLIP visual tower mapping ----------------------


def port_openai_clip_visual(sd: Dict[str, np.ndarray], layers: int) -> Dict:
    """Map an OpenAI CLIP `model.visual.*` state dict (the reference's
    FrozenCLIPImageEmbedder loads clip.load('ViT-L/14') —
    Zero123/ldm/modules/encoders/modules.py:343) onto
    fluidnexus_torch.diffusion.ldm.clip.CLIPVisionTower. Keys are relative to
    'visual.' (strip 'cond_stage_model.model.visual.' from the ckpt)."""

    def ln(tp):
        return {"scale": np.asarray(sd[tp + ".weight"]), "bias": np.asarray(sd[tp + ".bias"])}

    p: Dict = {
        "patch_embed": {"kernel": t2f_conv2d(sd["conv1.weight"])},
        "class_embedding": np.asarray(sd["class_embedding"]),
        "positional_embedding": np.asarray(sd["positional_embedding"]),
        "ln_pre": ln("ln_pre"),
        "ln_post": ln("ln_post"),
        "proj": np.asarray(sd["proj"]),
    }
    for i in range(layers):
        tb = f"transformer.resblocks.{i}"
        p[f"ln1_{i}"] = ln(tb + ".ln_1")
        p[f"ln2_{i}"] = ln(tb + ".ln_2")
        p[f"attn_{i}"] = {
            "qkv": {"kernel": t2f_linear(sd[tb + ".attn.in_proj_weight"]),
                    "bias": np.asarray(sd[tb + ".attn.in_proj_bias"])},
            "out": {"kernel": t2f_linear(sd[tb + ".attn.out_proj.weight"]),
                    "bias": np.asarray(sd[tb + ".attn.out_proj.bias"])},
        }
        p[f"mlp_fc_{i}"] = {"kernel": t2f_linear(sd[tb + ".mlp.c_fc.weight"]),
                            "bias": np.asarray(sd[tb + ".mlp.c_fc.bias"])}
        p[f"mlp_proj_{i}"] = {"kernel": t2f_linear(sd[tb + ".mlp.c_proj.weight"]),
                              "bias": np.asarray(sd[tb + ".mlp.c_proj.bias"])}
    return p


def port_zero123_checkpoint(sd: Dict[str, np.ndarray], unet_cfg, vae_cfg,
                            clip_layers: int = 24) -> Dict:
    """Assemble the full NovelViewModel param tree from a Zero123/FluidNexus
    Lightning checkpoint's flat state dict (ddpm.LatentDiffusion layout:
    model.diffusion_model.* / first_stage_model.* /
    cond_stage_model.model.visual.* / cc_projection.*)."""

    def sub(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}

    unet_sd = sub("model.diffusion_model.")
    w = unet_sd.get("input_blocks.0.0.weight")
    if w is not None and w.shape[1] == 4:  # upstream zero123-xl 4ch ckpt
        unet_sd["input_blocks.0.0.weight"] = port_input_conv_4to8(np.asarray(w))
    return {
        "unet": port_zero123_unet(unet_sd, unet_cfg),
        "vae": port_kl_vae(sub("first_stage_model."), vae_cfg),
        "clip": port_openai_clip_visual(sub("cond_stage_model.model.visual."), clip_layers),
        "cc": {"kernel": t2f_linear(sd["cc_projection.weight"]),
               "bias": np.asarray(sd["cc_projection.bias"])},
    }


# --------------------------- CogVideoX DiT (SAT) ------------------------------


def merge_sat_lora(sd: Dict[str, np.ndarray], lora_alpha: float = 1.0) -> Dict[str, np.ndarray]:
    """Fold a raw SAT-lora2 finetune state dict into plain dense weights.

    sat.model.finetune.lora2.LoraMixin (cogvideox_5b_lora_prefixi2v.yaml:56-59,
    r=128) replaces attention linears with LoraLinear: the wrapped base weight
    moves to ``<name>.original.weight`` and per-partition adapters appear as
    ``<name>.matrix_A.{p}`` (r, in) / ``<name>.matrix_B.{p}`` (out_p, r) —
    partition 3 for the fused query_key_value, 1 for the output dense. The
    merged weight is W_p += (alpha / r) * B_p @ A_p, partitions concatenated
    along the output dim. Returns a new dict with ``.original`` collapsed and
    matrix_A/B consumed; non-LoRA keys pass through unchanged."""
    out: Dict[str, np.ndarray] = {}
    bases = sorted({k[: -len(".original.weight")] for k in sd
                    if k.endswith(".original.weight")})
    consumed = set()
    for base in bases:
        w = np.asarray(sd[base + ".original.weight"]).copy()
        consumed.add(base + ".original.weight")
        parts = sorted(int(k.rsplit(".", 1)[1]) for k in sd
                       if k.startswith(base + ".matrix_A."))
        offset = 0
        for p in parts:
            a = np.asarray(sd[f"{base}.matrix_A.{p}"])   # (r, in)
            b = np.asarray(sd[f"{base}.matrix_B.{p}"])   # (out_p, r)
            consumed.add(f"{base}.matrix_A.{p}")
            consumed.add(f"{base}.matrix_B.{p}")
            r = a.shape[0]
            w[offset:offset + b.shape[0]] += (lora_alpha / r) * (b @ a)
            offset += b.shape[0]
        assert offset == w.shape[0], f"LoRA partitions of {base} cover {offset}/{w.shape[0]} rows"
        out[base + ".weight"] = w
        if base + ".original.bias" in sd:
            out[base + ".bias"] = np.asarray(sd[base + ".original.bias"])
            consumed.add(base + ".original.bias")
    for k, v in sd.items():
        if k not in consumed:
            out.setdefault(k, v)
    return out


def port_video_dit(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Map a SAT DiffusionTransformer state dict (CogVideoX
    dit_video_concat.py: base transformer layers + patch_embed / adaln_layer /
    final_layer mixins; key layout of sat's mp_rank_00_model_states.pt) onto
    the VideoDiT param tree. Requires cfg.ln_affine=True (the released 5B
    trains affine LayerNorms, configs/cogvideox_5b.yaml:26).

    Layout notes:
      - fused qkv: SAT query_key_value is [q;k;v] along the output dim,
        matching VideoDiT's torch.split of qkv into three.
      - patch conv (D,C,p,p) -> dense kernel indexed (py,px,C) fastest-C
        (VideoDiT flattens patches channel-fastest).
      - final linear rows are (c,p,q) in the reference (unpatchify
        'b (t h w) (c p q)', :359) but (p,q,c) here -> rows permuted.
      - RoPE freqs_sin/cos buffers are recomputed, not ported.
      - SAT-LoRA finetunes: merge matrix_A/B into the base weights first
        (sat lora2 merge) or fold with merge_lora_into_dense.
    """
    assert cfg.ln_affine, "the 5B checkpoint has affine LNs; set ln_affine=True"
    if any(k.endswith(".original.weight") for k in sd):
        sd = merge_sat_lora(sd)   # raw SAT-lora2 finetune: fold adapters first
    pre = ""
    if any(k.startswith("model.diffusion_model.") for k in sd):
        pre = "model.diffusion_model."

    def g(k):
        return np.asarray(sd[pre + k])

    def lin(k):
        return {"kernel": t2f_linear(g(k + ".weight")), "bias": g(k + ".bias")}

    def ln(k):
        return {"scale": g(k + ".weight"), "bias": g(k + ".bias")}

    p_sz = cfg.patch_size
    # conv (D,C,p,p) -> (p,p,C) rows, D cols
    w = g("mixins.patch_embed.proj.weight")
    d_out, c_in = w.shape[0], w.shape[1]
    patch_kernel = np.ascontiguousarray(
        w.transpose(2, 3, 1, 0).reshape(p_sz * p_sz * c_in, d_out))

    # final linear rows (c,p,q) -> (p,q,c)
    wf = t2f_linear(g("mixins.final_layer.linear.weight"))   # (D, C*p*q)
    bf = g("mixins.final_layer.linear.bias")
    c_out = cfg.out_channels
    wf = wf.reshape(-1, c_out, p_sz, p_sz).transpose(0, 2, 3, 1).reshape(wf.shape[0], -1)
    bf = bf.reshape(c_out, p_sz, p_sz).transpose(1, 2, 0).reshape(-1)

    params = {
        "patch_proj": {"kernel": patch_kernel, "bias": g("mixins.patch_embed.proj.bias")},
        "text_proj": lin("mixins.patch_embed.text_proj"),
        "time_fc1": lin("time_embed.0"),
        "time_fc2": lin("time_embed.2"),
        "final_ln": ln("transformer.final_layernorm"),
        "norm_final": ln("mixins.final_layer.norm_final"),
        "final_adaLN": lin("mixins.final_layer.adaLN_modulation.1"),
        "final_linear": {"kernel": np.ascontiguousarray(wf), "bias": np.ascontiguousarray(bf)},
    }
    for i in range(cfg.num_layers):
        t = f"transformer.layers.{i}"
        a = "mixins.adaln_layer"
        blk = {
            "adaLN": lin(f"{a}.adaLN_modulations.{i}.1"),
            "ln1": ln(f"{t}.input_layernorm"),
            "ln2": ln(f"{t}.post_attention_layernorm"),
            "attn": {
                "qkv": lin(f"{t}.attention.query_key_value"),
                "out": lin(f"{t}.attention.dense"),
                "q_ln_scale": g(f"{a}.query_layernorm_list.{i}.weight"),
                "q_ln_bias": g(f"{a}.query_layernorm_list.{i}.bias"),
                "k_ln_scale": g(f"{a}.key_layernorm_list.{i}.weight"),
                "k_ln_bias": g(f"{a}.key_layernorm_list.{i}.bias"),
            },
            "mlp": {
                "fc1": lin(f"{t}.mlp.dense_h_to_4h"),
                "fc2": lin(f"{t}.mlp.dense_4h_to_h"),
            },
        }
        params[f"block_{i}"] = blk
    return params


def graft_params_into(module, ported):
    """Load a ported tree into a built ``module`` (on the device its
    parameters are on), each leaf cast to the parameter's dtype. Parameters
    absent from ``ported`` (e.g. ``lora_a``/``lora_b``) keep the module's
    values, as the JAX package's graft keeps the template's. Returns the
    module."""
    from fluidnexus_torch.convert import load_flax_params

    return load_flax_params(module, ported, next(module.parameters()).device, keep_missing=True)
