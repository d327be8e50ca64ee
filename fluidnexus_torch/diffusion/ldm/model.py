"""Novel-view latent diffusion model (Zero123 class): UNet + KL-VAE + CLIP
image conditioning + relative-pose projection, with the DDPM training loss
and DDIM sampling (counterpart of ``fluidnexus_tpu/diffusion/ldm/model.py``).

- conditioning: crossattn = cc_projection(concat(CLIP(cond image), dT)),
  a Linear(772 -> 768) that starts as the identity over the CLIP block and
  zero over the pose; concat = the cond image's VAE posterior mode, the
  UNet's other 4 input channels; CFG dropout 5 % prompt only, 5 % image
  only, 5 % both, on the CLIP embedding before the projection and on the
  concat latent;
- eps-prediction on the linear-sqrt beta schedule;
- DDIM with classifier-free guidance, cond and uncond in one batch-2B UNet
  pass a step, the uncond half zeros of the projected context and zeros
  concat.

``NovelViewModel`` is one module holding ``unet``, ``vae``, ``clip`` and
``cc``: its parameter names are the JAX package's param tree's (the
``{"unet", "vae", "clip", "cc"}`` dict), so ``convert.novel_view_from_numpy``
loads one and ``convert.flax_params_to_numpy`` writes one. Images are
channel-last (B, H, W, 3) in [0, 1], as in the JAX package.

Every draw comes from an explicit ``torch.Generator`` through ``_normal``,
``_uniform`` and ``_randint`` (the only sources of randomness here, so a test
can record them): the loss draws the posterior noise, the dropout uniform,
the timesteps and the eps noise, in that order; the sampler its start noise,
then one normal a step.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fluidnexus_torch.diffusion.ldm.autoencoder import AutoencoderKL, KLVAEConfig
from fluidnexus_torch.diffusion.ldm.clip import CLIPVisionConfig, CLIPVisionTower
from fluidnexus_torch.diffusion.ldm.unet import GroupNorm, LayerNorm, UNet, UNetConfig
from fluidnexus_torch.diffusion.schedules import DiffusionSchedule
from fluidnexus_torch.diffusion.video.dit import lecun_normal_


def cartesian_to_spherical(xyz):
    xy = xyz[..., 0] ** 2 + xyz[..., 1] ** 2
    z = np.sqrt(xy + xyz[..., 2] ** 2)
    theta = np.arctan2(np.sqrt(xy), xyz[..., 2])
    azimuth = np.arctan2(xyz[..., 1], xyz[..., 0])
    return theta, azimuth, z


def get_pose_delta(target_rt: np.ndarray, cond_rt: np.ndarray) -> np.ndarray:
    """[d_theta, sin d_az, cos d_az, d_radius] (camera_utils.get_T:17-32).
    target_rt/cond_rt: (3,4) world->cam [R|T]."""
    r, t = target_rt[:3, :3], target_rt[:, -1]
    t_target = -r.T @ t
    r, t = cond_rt[:3, :3], cond_rt[:, -1]
    t_cond = -r.T @ t
    th_c, az_c, z_c = cartesian_to_spherical(t_cond[None])
    th_t, az_t, z_t = cartesian_to_spherical(t_target[None])
    d_theta = float(np.asarray(th_t - th_c).reshape(()))
    d_az = float(np.asarray((az_t - az_c) % (2 * math.pi)).reshape(()))
    d_z = float(np.asarray(z_t - z_c).reshape(()))
    return np.array([d_theta, math.sin(d_az), math.cos(d_az), d_z], np.float32)


def _normal(shape, generator, device):
    return torch.randn(tuple(shape), generator=generator, device=device)


def _uniform(shape, generator, device):
    return torch.rand(tuple(shape), generator=generator, device=device)


def _randint(high, shape, generator, device):
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)


def _rows(x, part):
    """Rows r B .. (r + 1) B of a draw over n B rows, part = (r, n)."""
    r, n = part
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _f32(x):
    """A scalar rounded to f32, as the JAX package holds its ladders."""
    return float(np.float32(x))


class NovelViewModel(nn.Module):
    def __init__(self, unet_config: UNetConfig = None, vae_config: KLVAEConfig = None,
                 clip_config: CLIPVisionConfig = None, num_timesteps: int = 1000,
                 linear_start: float = 0.00085, linear_end: float = 0.012):
        super().__init__()
        self.unet_config = unet_config or UNetConfig()
        self.vae_config = vae_config or KLVAEConfig()
        self.clip_config = clip_config or CLIPVisionConfig()
        self.num_timesteps = num_timesteps
        self.unet = UNet(self.unet_config)
        self.vae = AutoencoderKL(self.vae_config)
        self.clip = CLIPVisionTower(self.clip_config)
        # Linear(772 -> 768) (ddpm.py:564-567); trained at 10x the LR
        self.cc = nn.Linear(772, 768)
        self.schedule = DiffusionSchedule.create(num_timesteps, linear_start, linear_end)

    @property
    def downsample_factor(self):
        return 2 ** (len(self.vae_config.ch_mult) - 1)

    def _ladder(self, name, device):
        """The schedule's sqrt(abar) ("ac") or sqrt(1 - abar) ("1mac") in f32."""
        s = self.schedule
        x = s.sqrt_alphas_cumprod() if name == "ac" else s.sqrt_one_minus_alphas_cumprod()
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    # --------------------------- conditioning --------------------------------

    def conditioning(self, cond_image, pose_delta, rng=None, cfg_dropout=False, part=(0, 1)):
        """cond_image (B, H, W, 3) in [0, 1]; pose_delta (B, 4). Returns
        (context (B, 1, 768), concat latent (B, h, w, 4)). With
        ``cfg_dropout`` (and ``rng``), the 5/5/5 scheme (ddpm.py:813-827);
        ``part`` as in ``loss_fn``."""
        clip_emb = self.clip(cond_image)
        concat = self.vae.encode(cond_image * 2 - 1)
        if cfg_dropout and rng is not None:
            r = _rows(_uniform((part[1] * cond_image.shape[0],), rng, cond_image.device), part)
            drop_prompt = r < 0.10                     # 5 % prompt only + 5 % both
            drop_image = (r >= 0.05) & (r < 0.15)      # 5 % image only + 5 % both
            clip_emb = torch.where(drop_prompt[:, None], 0.0, clip_emb)
            concat = torch.where(drop_image[:, None, None, None], 0.0, concat)
        ctx = self.cc(torch.cat([clip_emb[:, None, :], pose_delta[:, None, :]], -1))
        return ctx, concat

    # ------------------------------- loss ------------------------------------

    def loss_fn(self, target_image, cond_image, pose_delta, rng: torch.Generator, part=(0, 1)):
        """The eps-prediction MSE (LatentDiffusion.p_losses); target and cond
        images (B, H, W, 3) in [0, 1]. The target's latent is a posterior
        sample. ``part`` = (r, n): the images are rows r B .. (r + 1) B of
        an n B batch, whose draws are made whole and cut (data-parallel
        ranks draw what one rank would)."""
        dev = target_image.device
        lat = target_image.shape[1] // self.downsample_factor
        b = target_image.shape[0]
        nb = part[1] * b
        enc_noise = _rows(_normal((nb, lat, lat, self.vae_config.z_channels), rng, dev), part)
        z = self.vae.encode(target_image * 2 - 1, noise=enc_noise)
        ctx, concat = self.conditioning(cond_image, pose_delta, rng, cfg_dropout=True, part=part)
        t = _rows(_randint(self.num_timesteps, (nb,), rng, dev), part)
        noise = _rows(_normal((nb,) + tuple(z.shape[1:]), rng, dev), part)
        z_t = (self._ladder("ac", dev)[t][:, None, None, None] * z
               + self._ladder("1mac", dev)[t][:, None, None, None] * noise)
        eps = self.unet(torch.cat([z_t, concat], -1), t, ctx)
        return torch.mean((eps - noise) ** 2)

    # ------------------------------ sampling ---------------------------------

    def _sampler_setup(self, cond_image, pose_delta, num_steps, eta, cfg_scale, image_size,
                       rng):
        """The doubled CFG conditioning, the timestep/alpha ladder (float64,
        then f32), the batched cond + uncond eps function and the start
        noise: (model_eps, ladder dict, x0)."""
        b, dev = cond_image.shape[0], cond_image.device
        lat = image_size // self.downsample_factor
        ctx, concat = self.conditioning(cond_image, pose_delta)
        ctx2 = torch.cat([ctx, torch.zeros_like(ctx)], 0)
        concat2 = torch.cat([concat, torch.zeros_like(concat)], 0)

        times = np.linspace(0, self.num_timesteps - 1, num_steps).astype(int)[::-1].copy()
        ac = np.asarray(self.schedule.alphas_cumprod, np.float64)
        a_t = ac[times]
        a_prev = np.concatenate([ac[times[1:]], [1.0]])
        sigma = eta * np.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        dir_coef = np.sqrt(np.maximum(1 - a_prev - sigma**2, 0.0))
        ladder = dict(times=times, a_t=a_t, a_prev=a_prev, sigma=sigma, dir_coef=dir_coef)

        def model_eps(x, t):
            tv = torch.full((2 * b,), int(t), dtype=torch.int32, device=dev)
            x2 = torch.cat([x, x], 0)
            eps2 = self.unet(torch.cat([x2, concat2], -1), tv, ctx2)
            eps_c, eps_u = torch.chunk(eps2, 2, 0)
            return eps_u + cfg_scale * (eps_c - eps_u)

        x0 = _normal((b, lat, lat, self.unet_config.out_channels), rng, dev)
        return model_eps, ladder, x0

    def _decode_unit(self, x):
        return torch.clamp((self.vae.decode(x) + 1) / 2, 0.0, 1.0)

    @torch.no_grad()
    def ddim_sample(self, cond_image, pose_delta, rng: torch.Generator, num_steps=50,
                    cfg_scale=3.0, eta=1.0, image_size=256):
        """DDIMSampler.sample with CFG (helpers/test_helpers.py:38-66: S = 50,
        scale 3.0, eta 1.0). Returns decoded images (B, H, W, 3) in [0, 1]."""
        model_eps, lad, x = self._sampler_setup(cond_image, pose_delta, num_steps, eta,
                                                cfg_scale, image_size, rng)
        for i in range(num_steps):
            at, ap = np.float32(lad["a_t"][i]), np.float32(lad["a_prev"][i])
            eps = model_eps(x, lad["times"][i])
            pred_x0 = (x - _f32(np.sqrt(np.float32(1) - at)) * eps) / _f32(np.sqrt(at))
            noise = _f32(lad["sigma"][i]) * _normal(x.shape, rng, x.device)
            x = _f32(np.sqrt(ap)) * pred_x0 + _f32(lad["dir_coef"][i]) * eps + noise
        return self._decode_unit(x)


def init_novel_view(model: NovelViewModel, generator: torch.Generator) -> NovelViewModel:
    """``model``'s weights drawn in place as the flax init draws them: Dense
    and Conv kernels lecun-normal, biases 0, norm scales 1 and biases 0; the
    UNet's ResBlock ``conv2``, SpatialTransformer ``proj_out`` and
    ``conv_out`` 0 (unet.py:63, 120, 177); ``cc`` the identity over the CLIP
    block (model.py:264-267); CLIP's class and positional embeddings and
    ``proj`` normal(0.02)."""
    zero = ("conv2", "proj_out", "conv_out")
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                if name.startswith("unet.") and name.split(".")[-1] in zero:
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (GroupNorm, LayerNorm)):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        model.cc.weight.zero_()
        model.cc.weight[:, :768].copy_(torch.eye(768, device=model.cc.weight.device))
        for p in (model.clip.class_embedding, model.clip.positional_embedding, model.clip.proj):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
    return model


def build_novel_view(device="cuda", **configs) -> NovelViewModel:
    """A ``NovelViewModel`` with uninitialised storage on ``device`` (no
    torch default init runs); fill it with ``init_novel_view`` or
    ``convert.load_flax_params``."""
    with torch.device("meta"):
        model = NovelViewModel(**configs)
    return model.to_empty(device=device)
