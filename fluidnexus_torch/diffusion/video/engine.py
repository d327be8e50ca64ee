"""Video diffusion engine for sampling: DiT + causal VAE + v-denoiser +
DPM++(2M) SDE sampler (counterpart of
``fluidnexus_tpu/diffusion/video/engine.py``).

The JAX engine's ``params`` and ``vae_params`` are the modules themselves
here (``VideoDiT``, ``VideoVAE``, weights on their device); ``init_params``
and ``init_vae_params`` draw them from a ``torch.Generator`` as the flax init
draws. Sampling, encoding and decoding run under ``torch.inference_mode()``.
The training loss and the LoRA helpers come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fluidnexus_torch.diffusion.video import sampling
from fluidnexus_torch.diffusion.video.dit import VideoDiT, VideoDiTConfig, init_video_dit
from fluidnexus_torch.diffusion.video.sampling import DynamicCFG, VDenoiser, sample_dpmpp2m_sde
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
    def decode_first_stage(self, vae: VideoVAE, z, chunk: int = 2, first_latents=None):
        """Chunked decode of (B, T, H, W, Cz) latents to frames (the JAX
        engine's ``spatial_tiles=1``)."""
        return chunked_decode(vae, z, chunk=chunk, first_latents=first_latents)

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
