"""Score-distillation guidance: the SDS and DDS image gradients.

Counterpart of `gaussianeditor_tpu/guidance/score.py` (`LatentModel`,
`DDIMSchedule`, `cfg_combine3`, `cfg_combine2`, `ScoreConfig`,
`SDSGuidance`, `DDSGuidance`):

  * SDS (`threestudio/models/guidance/instructpix2pix_guidance.py:209-297`):
    encode the render to latents, noise them at t ~ U[min_step,
    max_step], one 3-way classifier-free-guided UNet evaluation (text /
    image / uncond), grad = w(t) * (noise_pred - noise) with w(t) = 1 -
    alpha_bar_t, nan_to_num and clamp to `grad_clip`; the image gradient
    is the encoder's vector-Jacobian product of grad / B, the gradient of
    0.5 * mse(latents, stopgrad(latents - grad)).
  * The step range and the clip follow C() schedules (`update_step`,
    :305-315).
  * DDS (the Edit system's second guidance, GassuianEditorEdit.py:15-28,
    113-131): the render's and the origin's latents noised with the SAME
    noise at the same t, grad = w(t) * (eps(z_t, target) - eps(zs_t,
    source)), each eps a 2-way CFG.

The math runs in torch on the latent model's device (`model.device`);
the encoder's VJP is `torch.autograd.grad` through `model.encode`, what
`jax.vjp` computes there. t and the noise are drawn from a
`torch.Generator` on that device, seeded from `step` when none is given;
`t=` and `noise=` inject them instead (the JAX package draws
`jax.random`, so parity tests hand both packages the same draws).

A call takes the editing loop's score slot: `(renders, origins,
prompt(s), step=) -> (g_image [B, H, W, 3], info)`. Numpy images (the
slot's host boundary, as the JAX slot has it) give a numpy gradient;
tensors give a tensor on the model's device. Images and latents are
channels-last.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Union

import numpy as np
import torch

from gaussianeditor_tpu_torch.config.config import C

ScheduleLike = Union[float, Sequence[float]]


class LatentModel(Protocol):
    """The latent-diffusion surface the score losses need."""

    device: torch.device

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> latents [B, h, w, c]; differentiable."""
        ...

    def unet(
        self,
        latents_noisy: torch.Tensor,
        t: torch.Tensor,
        prompt: str,
        cond_latents: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Predict noise. `cond_latents` carries the ip2p image condition."""
        ...


class DDIMSchedule:
    """Stable Diffusion's noise schedule (scaled_linear betas, diffusers'
    DDIMScheduler defaults for SD1.5): alpha_bar, add_noise and w(t) =
    1 - alpha_bar. alphas_cumprod is computed in float64 numpy and cast
    to float32, as the JAX schedule is, so both hold the same bits."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        self.num_train_timesteps = num_train_timesteps
        betas = (
            np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
        )
        self.alphas_cumprod = torch.from_numpy(
            np.cumprod(1.0 - betas).astype(np.float32))
        self._on_device = {}

    def _alphas(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = self.alphas_cumprod.to(device)
        return self._on_device[device]

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        a = self._alphas(latents.device)[t]
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """SDS weighting w(t) = 1 - alpha_bar_t (ip2p guidance :237)."""
        return 1.0 - self._alphas(t.device)[t]


def cfg_combine3(n_text, n_image, n_uncond, guidance_scale: float,
                 condition_scale: float):
    """ip2p 3-way CFG (instructpix2pix_guidance.py:230-235)."""
    return (n_uncond
            + guidance_scale * (n_text - n_image)
            + condition_scale * (n_image - n_uncond))


def cfg_combine2(n_cond, n_uncond, guidance_scale: float):
    """2-way CFG (controlnet_guidance.py edit loop)."""
    return n_uncond + guidance_scale * (n_cond - n_uncond)


@dataclasses.dataclass
class ScoreConfig:
    """Annealable knobs (C()-schedulable, as update_step :305-315)."""

    guidance_scale: float = 7.5
    condition_scale: float = 1.5       # ip2p image-guidance scale
    min_step_percent: ScheduleLike = 0.02
    max_step_percent: ScheduleLike = 0.98
    grad_clip: Optional[ScheduleLike] = None


def _steps_at(cfg: ScoreConfig, num_train: int, step: int):
    lo = int(num_train * C(cfg.min_step_percent, step))
    hi = int(num_train * C(cfg.max_step_percent, step))
    return max(0, lo), min(num_train - 1, max(hi, lo))


def _postprocess_grad(grad: torch.Tensor,
                      clip: Optional[float]) -> torch.Tensor:
    grad = torch.nan_to_num(grad)
    if clip is not None:
        grad = torch.clamp(grad, -clip, clip)
    return grad


def _batch(images, device) -> torch.Tensor:
    """[B, H, W, 3] (or [H, W, 3]) float32 images on `device`."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    x = images.to(device=device, dtype=torch.float32)
    return x[None] if x.dim() == 3 else x


def _draws(model, sched: DDIMSchedule, cfg: ScoreConfig, step: int, B: int,
           latent_shape, generator, t, noise):
    """(lo, hi, t [B] int64, noise) on the model's device: t ~ U[lo, hi]
    and standard normal noise from `generator` (seeded from `step` when
    None), each replaced by its injected value when given."""
    dev = model.device
    lo, hi = _steps_at(cfg, sched.num_train_timesteps, step)
    if generator is None and (t is None or noise is None):
        generator = torch.Generator(device=dev).manual_seed(int(step))
    if t is None:
        t = torch.randint(lo, hi + 1, (B,), generator=generator, device=dev)
    else:
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        t = t.to(dev, torch.int64).reshape(B)
    if noise is None:
        noise = torch.randn(tuple(latent_shape), generator=generator,
                            device=dev)
    else:
        noise = _batch(noise, dev)
    return lo, hi, t, noise


def _encode_vjp(model, images: torch.Tensor):
    """(latents, vjp): the encoder's output and its vector-Jacobian
    product with respect to `images`."""
    x = images.detach().requires_grad_(True)
    with torch.enable_grad():
        latents = model.encode(x)

    def vjp(cot: torch.Tensor) -> torch.Tensor:
        (g,) = torch.autograd.grad(latents, x, grad_outputs=cot)
        return g

    return latents.detach(), vjp


class SDSGuidance:
    """SDS over an ip2p-style latent model.

    __call__(rgb, cond_rgb, prompt, step=0, generator=None, t=None,
    noise=None) -> (g_image, info): g_image is dL/d(rgb) for L =
    0.5 * ||latents - stopgrad(latents - grad)||^2 / B; the train step
    injects it as sum(rgb * stopgrad(g_image))."""

    def __init__(self, model: LatentModel, config: ScoreConfig = None,
                 schedule: Optional[DDIMSchedule] = None):
        self.model = model
        self.cfg = config or ScoreConfig()
        self.sched = schedule or DDIMSchedule()

    def __call__(self, rgb, cond_rgb, prompt: str, step: int = 0,
                 generator: Optional[torch.Generator] = None, t=None,
                 noise=None):
        cfg, sched, model = self.cfg, self.sched, self.model
        as_numpy = not isinstance(rgb, torch.Tensor)
        rgb = _batch(rgb, model.device)
        cond = _batch(cond_rgb, model.device)
        B = rgb.shape[0]
        latents, enc_vjp = _encode_vjp(model, rgb)
        lo, hi, t, noise = _draws(model, sched, cfg, step, B, latents.shape,
                                  generator, t, noise)
        with torch.no_grad():
            cond_latents = (model.unet_cond(cond) if hasattr(
                model, "unet_cond") else model.encode(cond))
            tb = t[:, None, None, None]
            noisy = sched.add_noise(latents, noise, tb)
            n_text = model.unet(noisy, t, prompt, cond_latents)
            n_image = model.unet(noisy, t, "", cond_latents)
            n_uncond = model.unet(noisy, t, "",
                                  torch.zeros_like(cond_latents))
            noise_pred = cfg_combine3(n_text, n_image, n_uncond,
                                      cfg.guidance_scale,
                                      cfg.condition_scale)
            clip = None if cfg.grad_clip is None else C(cfg.grad_clip, step)
            grad = _postprocess_grad(sched.w(tb) * (noise_pred - noise), clip)
        g_image = enc_vjp(grad / B)
        info = {
            "grad_norm": torch.linalg.norm(grad),
            "min_step": lo,
            "max_step": hi,
            # proxy value of 0.5*mse(latents, latents-grad)/B for logging
            "loss_sds": 0.5 * torch.sum(grad * grad) / B,
        }
        return (g_image.cpu().numpy() if as_numpy else g_image), info


class DDSGuidance:
    """Delta Denoising Score between the current render and the origin
    image under (target_prompt, source_prompt): the Edit system's second
    guidance (GassuianEditorEdit.py:113-131)."""

    def __init__(self, model: LatentModel, config: ScoreConfig = None,
                 schedule: Optional[DDIMSchedule] = None):
        self.model = model
        self.cfg = config or ScoreConfig(guidance_scale=7.5)
        self.sched = schedule or DDIMSchedule()

    def __call__(self, rgb, origin_rgb, target_prompt: str,
                 source_prompt: str, step: int = 0,
                 generator: Optional[torch.Generator] = None, t=None,
                 noise=None):
        cfg, sched, model = self.cfg, self.sched, self.model
        as_numpy = not isinstance(rgb, torch.Tensor)
        rgb = _batch(rgb, model.device)
        origin = _batch(origin_rgb, model.device)
        B = rgb.shape[0]
        latents, enc_vjp = _encode_vjp(model, rgb)
        lo, hi, t, noise = _draws(model, sched, cfg, step, B, latents.shape,
                                  generator, t, noise)

        def eps(noisy, prompt):
            n_c = model.unet(noisy, t, prompt)
            n_u = model.unet(noisy, t, "")
            return cfg_combine2(n_c, n_u, cfg.guidance_scale)

        with torch.no_grad():
            src_latents = model.encode(origin)
            # the SAME noise on both branches: the defining property of DDS
            tb = t[:, None, None, None]
            z_t = sched.add_noise(latents, noise, tb)
            zs_t = sched.add_noise(src_latents, noise, tb)
            delta = eps(z_t, target_prompt) - eps(zs_t, source_prompt)
            clip = None if cfg.grad_clip is None else C(cfg.grad_clip, step)
            grad = _postprocess_grad(sched.w(tb) * delta, clip)
        g_image = enc_vjp(grad / B)
        info = {
            "grad_norm": torch.linalg.norm(grad),
            "loss_dds": 0.5 * torch.sum(grad * grad) / B,
        }
        return (g_image.cpu().numpy() if as_numpy else g_image), info
