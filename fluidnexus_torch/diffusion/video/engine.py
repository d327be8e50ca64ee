"""Video diffusion engine: DiT + causal VAE + v-denoiser + DPM++(2M) SDE
sampler + the training loss (counterpart of
``fluidnexus_tpu/diffusion/video/engine.py``).

The JAX engine's ``params`` and ``vae_params`` are the modules themselves
here (``VideoDiT``, ``VideoVAE``, weights on their device); ``init_params``
and ``init_vae_params`` draw them from a ``torch.Generator`` as the flax init
draws. Sampling, encoding and decoding run under ``torch.inference_mode()``.
The LoRA partition of a param tree is a split of the module's named
parameters: ``lora_partition`` gives the LoRA leaves (the only ones that
``train_video`` sets ``requires_grad`` on and hands to the optimizer) and the
rest, so no gradient of the base is ever made. The JAX ``freeze_non_lora``
has no counterpart: it zeroes every gradient but the LoRA leaves', and the
port computes no other (``train_video``'s full step, at rank 0, takes its
zero gradient directly).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from fluidnexus_torch.diffusion.video import sampling
from fluidnexus_torch.diffusion.schedules import append_dims
from fluidnexus_torch.diffusion.video.dit import (
    VideoDiT, VideoDiTConfig, init_video_dit, lora_param_filter,
)
from fluidnexus_torch.diffusion.video.sampling import (
    DynamicCFG, VDenoiser, sample_dpmpp2m_sde, zero_snr_alphas_sqrt,
)
from fluidnexus_torch.diffusion.video.vae3d import (
    VAE3DConfig, VideoVAE, chunked_decode, chunked_encode, init_vae,
)


@dataclasses.dataclass
class VideoEngine:
    dit_config: VideoDiTConfig
    vae_config: VAE3DConfig = dataclasses.field(default_factory=VAE3DConfig)
    num_timesteps: int = 1000
    fixed_frames: int = 0          # prefix-i2v clean frames
    cfg_scale: float = 6.0
    cfg_exp: float = 5.0

    def __post_init__(self):
        # the 1000-step zero-SNR ladder for training-time indexing, f32 as the
        # JAX engine holds it; index 0 is the noisiest
        ladder, t_ids = zero_snr_alphas_sqrt(self.num_timesteps, self.num_timesteps)
        self.alpha_sqrt_ladder = torch.as_tensor(ladder[:-1], dtype=torch.float32)
        self.ladder_t_ids = torch.as_tensor(t_ids[:-1], dtype=torch.int32)

    # --------------------------------- init ---------------------------------

    def init_params(self, generator: torch.Generator) -> VideoDiT:
        """The DiT on the generator's device; every adaLN projection starts
        at zero, as in the JAX init."""
        return init_video_dit(self.dit_config, generator)

    def init_vae_params(self, generator: torch.Generator) -> VideoVAE:
        return init_vae(self.vae_config, generator)

    def dit_apply(self, params: VideoDiT, x, t, cond):
        """One DiT forward: (B, T, C, H, W) latents, (B,) timesteps, (B, L,
        text_hidden) text -> the f32 v-prediction."""
        return params(x, t, cond)

    # ------------------------------ first stage ------------------------------

    @torch.inference_mode()
    def encode_first_stage(self, vae: VideoVAE, frames, rng=None, chunk: int = 0):
        """frames: (B, T, H, W, C) in [-1, 1] -> latents (B, T', H', W', Cz).
        ``chunk`` > 0 encodes in cache-carried temporal chunks of that many
        latent frames; 0 encodes the whole clip at once."""
        if chunk > 0:
            return chunked_encode(vae, frames, chunk=chunk, rng=rng, sample=rng is not None)
        return vae.encode(frames, rng)[0]

    @torch.inference_mode()
    def decode_first_stage(self, vae: VideoVAE, z, chunk: int = 2):
        """Chunked decode of (B, T, H, W, Cz) latents to frames (the JAX
        engine's ``spatial_tiles=1``)."""
        return chunked_decode(vae, z, chunk=chunk)

    # --------------------------------- loss ---------------------------------

    def loss_fn(self, params: VideoDiT, latents, text_emb, rng: torch.Generator,
                is_i2v: bool = True):
        """latents: (B, T, C, H, W) scaled x0. A timestep index and the noise
        are drawn from ``rng`` (in the JAX order: index, then noise); the
        first ``fixed_frames`` latents stay clean for prefix-i2v; the v-
        prediction's x0 against the latents, weighted 1/(1 - abar). Returns
        (scalar loss, {"idx", "per_sample"})."""
        b, dev = latents.shape[0], latents.device
        idx = _randint(self.num_timesteps, (b,), rng, dev)
        a = self.alpha_sqrt_ladder.to(dev)[idx]
        t_ids = self.ladder_t_ids.to(dev)[idx]
        noise = sampling._normal(latents.shape, rng, dev)

        a_d = append_dims(a, latents.dim())
        s_d = append_dims(torch.sqrt(1 - a**2), latents.dim())
        noised = latents * a_d + noise * s_d
        if is_i2v and self.fixed_frames > 0:
            noised = torch.cat([latents[:, : self.fixed_frames], noised[:, self.fixed_frames:]], 1)

        denoiser = VDenoiser(lambda x, t, c: self.dit_apply(params, x, t, c))
        denoised = denoiser(noised, a, t_ids, text_emb)
        w = append_dims(1.0 / torch.clamp(1 - a**2, min=1e-8), latents.dim())
        per_sample = torch.mean((w * (denoised - latents) ** 2).reshape(b, -1), -1)
        return per_sample.mean(), {"idx": idx, "per_sample": per_sample}

    # -------------------------------- sampling -------------------------------

    @torch.inference_mode()
    def sample(
        self,
        params: VideoDiT,
        shape,
        text_emb,
        uc_text_emb=None,
        rng: Optional[torch.Generator] = None,
        num_steps: int = 50,
        frames_z=None,
        sdedit_strength: Optional[float] = None,
        prefix_clean_frames=None,
        cfg_scale: Optional[float] = None,
    ):
        """The starting noise, then DPM++(2M) SDE with DynamicCFG; every draw
        from ``rng``, on its device."""
        if rng is None:
            raise ValueError("sample needs a torch.Generator (rng)")
        x = sampling._normal(shape, rng, rng.device)
        denoiser = VDenoiser(lambda xx, t, c: self.dit_apply(params, xx, t, c))
        guider = DynamicCFG(scale=cfg_scale or self.cfg_scale, exp=self.cfg_exp,
                            num_steps=num_steps)
        return sample_dpmpp2m_sde(
            denoiser, x, cond=text_emb, uc=uc_text_emb, num_steps=num_steps,
            guider=guider, rng=rng, num_timesteps=self.num_timesteps,
            frames_z=frames_z, sdedit_strength=sdedit_strength,
            prefix_clean_frames=prefix_clean_frames, fixed_frames=self.fixed_frames,
        )


def _randint(high, shape, generator, device):
    """The training timestep indices in [0, high) (the loss's only integer
    draw)."""
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)


def lora_partition(model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The module's named parameters split into (LoRA leaves, the rest)."""
    lora, base = {}, {}
    for name, p in model.named_parameters():
        (lora if lora_param_filter(name) else base)[name] = p
    return lora, base


def lora_merge(lora: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor]):
    """Inverse of ``lora_partition``: one {name: tensor} over both."""
    return {**base, **lora}

