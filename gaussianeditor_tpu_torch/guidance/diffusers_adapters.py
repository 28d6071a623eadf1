"""Diffusion guidance, inpainting and segmentation adapters
(diffusers-backed, import-gated).

Counterpart of `gaussianeditor_tpu/guidance/diffusers_adapters.py`
(`InstructPix2PixGuidance` with `sds_image_grad`, `ControlNetGuidance`,
`ControlNetInpainter`, `SDXLInpainter`, `LangSAMSegmentor`). They mirror
the reference guidance modules' inference:

  * InstructPix2PixGuidance (`threestudio/models/guidance/
    instructpix2pix_guidance.py`): encode render and origin to latents,
    noise at t ~ U[min_step, max_step] (:277-283), `diffusion_steps` DDIM
    steps with 3-way classifier-free guidance (text 7.5 / image 1.5 /
    uncond; :166-207), decode to the edited target (the iterative
    dataset update of Instruct-NeRF2NeRF).
  * ControlNetGuidance (`controlnet_guidance.py`): control type p2p,
    inpaint, canny or normal selects the checkpoint (:69-76); 2-way CFG
    (:231-279).
  * ControlNetInpainter and SDXLInpainter: Delete's per-view inpainting
    (GassuianEditorDel.py:68-129: SD1.5 and control_v11p_sd15_inpaint,
    seed 0, 20 steps) and Add's SDXL inpainting (GassuianEditorAdd.py:
    81-110).

The models are frozen inference in torch on `device` (the scene's, by
default "cuda"), called outside the train step on host (numpy) images,
and keep the port's `GuidanceOutput`, `Segmentor` and `Inpainter`
protocols (`guidance/base.py`). Without `diffusers` (or, for LangSAM,
`lang-segment-anything`) construction raises the JAX module's
ImportError; `guidance.fake` holds the deterministic stand-ins. A
`pipe=` argument injects a pipeline: tests use stand-ins, and the CLI
the port's own InstructPix2Pix (`guidance/sd15.py`), from whose
`generator` the adapter draws t and the noise. Spans `ip2p.vae`,
`ip2p.unet` and `ip2p.ddim` and the counter `unet_evals` mark the edit's
parts (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussianeditor_tpu_torch.guidance.base import GuidanceOutput
from gaussianeditor_tpu_torch.utils.profiling import count, span, sync

_INSTALL_MSG = (
    "diffusers is not available in this environment. Install `diffusers` "
    "and `transformers` with the corresponding checkpoints to use real "
    "2D diffusion guidance, or use gaussianeditor_tpu_torch.guidance.fake.* "
    "for deterministic stand-ins."
)


def _require_diffusers():
    try:
        import diffusers  # noqa: F401
    except ImportError as e:
        raise ImportError(_INSTALL_MSG) from e


class InstructPix2PixGuidance:
    """3-way-CFG ip2p editing (instructpix2pix_guidance.py:18-315)."""

    def __init__(
        self,
        model_id: str = "timbrooks/instruct-pix2pix",
        guidance_scale: float = 7.5,
        image_guidance_scale: float = 1.5,
        diffusion_steps: int = 20,
        min_step_percent: float = 0.02,
        max_step_percent: float = 0.98,
        device: str = "cuda",
        pipe=None,
    ):
        self.guidance_scale = guidance_scale
        self.image_guidance_scale = image_guidance_scale
        self.diffusion_steps = diffusion_steps
        self.min_step_percent = min_step_percent
        self.max_step_percent = max_step_percent
        self.device = device
        if pipe is not None:
            # dependency injection: lets the latent/CFG plumbing be
            # exercised with a mock pipe where no checkpoints exist
            # (tests/test_adapter_plumbing.py)
            self.pipe = pipe
            self.num_train_timesteps = int(
                pipe.scheduler.config.num_train_timesteps
            )
            return
        _require_diffusers()
        from diffusers import (
            DDIMScheduler,
            StableDiffusionInstructPix2PixPipeline,
        )

        self.pipe = StableDiffusionInstructPix2PixPipeline.from_pretrained(
            model_id, torch_dtype=torch.float16
        ).to(device)
        self.pipe.scheduler = DDIMScheduler.from_config(
            self.pipe.scheduler.config
        )
        self.num_train_timesteps = int(
            self.pipe.scheduler.config.num_train_timesteps
        )

    def _generator(self) -> Optional[torch.Generator]:
        """The pipeline's generator (the native pipeline's), or None for
        torch's global one."""
        return getattr(self.pipe, "generator", None)

    def _draw_t(self, min_t: int, max_t: int) -> int:
        gen = self._generator()
        if gen is None:
            return int(torch.randint(min_t, max_t + 1, (1,)).item())
        with sync("ddim_t"):
            return int(torch.randint(min_t, max_t + 1, (1,), generator=gen,
                                     device=gen.device).item())

    def _noise(self, like: torch.Tensor) -> torch.Tensor:
        gen = self._generator()
        if gen is None:
            return torch.randn_like(like)
        return torch.randn(like.shape, generator=gen, dtype=torch.float32,
                           device=like.device).to(like.dtype)

    def __call__(self, rgb, cond_rgb, prompt: str) -> GuidanceOutput:
        # sample t against the TRUE training range captured at init: the
        # per-call num_train_timesteps override below must not leak into
        # the next call's range (caught by tests/test_adapter_plumbing.py)
        num_train = self.num_train_timesteps
        min_t = int(num_train * self.min_step_percent)
        max_t = int(num_train * self.max_step_percent)
        t = self._draw_t(min_t, max_t)
        vae, sched = self.pipe.vae, self.pipe.scheduler
        unet_dtype = getattr(self.pipe.unet, "dtype", vae.dtype)

        def to_t(img):
            x = torch.from_numpy(np.asarray(img, np.float32)).permute(2, 0, 1)
            return x[None].to(self.device, dtype=vae.dtype)

        with torch.no_grad():
            # latents in float32 between the UNet's calls, as threestudio
            # holds them (`encode_images` returns the input's dtype)
            with span("ip2p.vae"):
                latents = (vae.encode(to_t(rgb) * 2 - 1).latent_dist.sample()
                           * vae.config.scaling_factor).float()
            with span("ip2p.vae"):
                cond_latents = vae.encode(
                    to_t(cond_rgb) * 2 - 1).latent_dist.mode().float()

            text_emb = self.pipe._encode_prompt(
                prompt, self.device, 1, True, ""
            )
            # DDIM from the SAMPLED noise level, not from t=num_train:
            # override BEFORE set_timesteps so timesteps = linspace(t-1,0)
            # (instructpix2pix_guidance.py:171-178). Restore in `finally`
            # — an exception mid-denoise (e.g. OOM) must not leave the
            # scheduler's training range clobbered at the sampled t for
            # every subsequent call.
            try:
                sched.config.num_train_timesteps = t
                with span("ip2p.ddim"):
                    sched.set_timesteps(self.diffusion_steps)
                    latents = sched.add_noise(latents, self._noise(latents),
                                              sched.timesteps[0:1])
                    image_cond = torch.cat([cond_latents, cond_latents,
                                            torch.zeros_like(cond_latents)])
                for i, step_t in enumerate(sched.timesteps):
                    with span("ip2p.unet", rid=i):
                        latent_in = torch.cat(
                            [torch.cat([latents] * 3), image_cond], dim=1)
                        noise_pred = self.pipe.unet(
                            latent_in.to(unet_dtype), step_t,
                            encoder_hidden_states=text_emb
                        ).sample.float()
                    count("unet_evals")
                    with span("ip2p.ddim"):
                        n_text, n_img, n_unc = noise_pred.chunk(3)
                        noise_pred = (
                            n_unc
                            + self.guidance_scale * (n_text - n_img)
                            + self.image_guidance_scale * (n_img - n_unc)
                        )
                        latents = sched.step(
                            noise_pred, step_t, latents
                        ).prev_sample
                with span("ip2p.vae"):
                    img = vae.decode(
                        latents / vae.config.scaling_factor
                    ).sample
            finally:
                sched.config.num_train_timesteps = num_train
            img = (img / 2 + 0.5).clamp(0, 1)[0].permute(1, 2, 0).float()
            with sync("edit_image", img.numel() * img.element_size()):
                out = img.cpu().numpy()
        return GuidanceOutput(edit_image=out)

    def sds_image_grad(self, rgb, cond_rgb, prompt: str, step: int = 0,
                       grad_clip: Optional[float] = None):
        """SDS gradient w.r.t. the input image — the reference's use_sds
        branch (instructpix2pix_guidance.py:209-297): one UNet pass at a
        random t, 3-way CFG, grad = (1-alpha_bar_t)*(noise_pred - noise),
        backpropagated through the VAE encoder so the result plugs into
        the train step's injected gradient (same math as
        loss_sds = 0.5*mse(latents, stopgrad(latents-grad))).

        Returns (g_image [H, W, 3] float32 numpy, info dict)."""
        sched = self.pipe.scheduler
        num_train = self.num_train_timesteps
        min_t = int(num_train * self.min_step_percent)
        max_t = int(num_train * self.max_step_percent)
        gen = self._generator()
        t = torch.randint(min_t, max_t + 1, (1,), generator=gen,
                          device=self.device if gen is None else gen.device)

        img_t = (
            torch.from_numpy(np.asarray(rgb, np.float32))
            .permute(2, 0, 1)[None].to(self.device)
            .requires_grad_(True)
        )
        cond_t = (
            torch.from_numpy(np.asarray(cond_rgb, np.float32))
            .permute(2, 0, 1)[None].to(self.device, self.pipe.vae.dtype)
        )
        latents = self.pipe.vae.encode(
            (img_t * 2 - 1).to(self.pipe.vae.dtype)
        ).latent_dist.sample() * self.pipe.vae.config.scaling_factor
        with torch.no_grad():
            cond_latents = self.pipe.vae.encode(
                cond_t * 2 - 1
            ).latent_dist.mode()
            text_emb = self.pipe._encode_prompt(
                prompt, self.device, 1, True, ""
            )
            noise = self._noise(latents)
            noisy = sched.add_noise(latents.detach(), noise, t)
            latent_in = torch.cat([noisy] * 3)
            latent_in = torch.cat(
                [latent_in, torch.cat([cond_latents, cond_latents,
                                       torch.zeros_like(cond_latents)])],
                dim=1,
            )
            noise_pred = self.pipe.unet(
                latent_in, t, encoder_hidden_states=text_emb
            ).sample
            n_text, n_img, n_unc = noise_pred.chunk(3)
            noise_pred = (
                n_unc
                + self.guidance_scale * (n_text - n_img)
                + self.image_guidance_scale * (n_img - n_unc)
            )
            alphas = sched.alphas_cumprod.to(self.device)
            w = (1 - alphas[t]).view(-1, 1, 1, 1)
            grad = torch.nan_to_num(w * (noise_pred - noise))
            if grad_clip is not None:
                grad = grad.clamp(-grad_clip, grad_clip)
        latents.backward(gradient=grad.to(latents.dtype))
        g = img_t.grad[0].permute(1, 2, 0).float().cpu().numpy()
        return g, {"grad_norm": float(grad.norm()),
                   "min_step": min_t, "max_step": max_t}


class ControlNetGuidance:
    """ControlNet editing (controlnet_guidance.py:20-311); control_type in
    {p2p, inpaint, canny, normal}."""

    CHECKPOINTS = {
        "p2p": "lllyasviel/control_v11e_sd15_ip2p",
        "inpaint": "lllyasviel/control_v11p_sd15_inpaint",
        "canny": "lllyasviel/control_v11p_sd15_canny",
        "normal": "lllyasviel/control_v11p_sd15_normalbae",
    }

    def __init__(self, control_type: str = "p2p",
                 guidance_scale: float = 7.5, diffusion_steps: int = 20,
                 device: str = "cuda", pipe=None):
        if pipe is not None:
            self.pipe = pipe
            self.control_type = control_type
            self.guidance_scale = guidance_scale
            self.diffusion_steps = diffusion_steps
            self.device = device
            return
        _require_diffusers()
        from diffusers import (
            ControlNetModel,
            DDIMScheduler,
            StableDiffusionControlNetPipeline,
        )

        controlnet = ControlNetModel.from_pretrained(
            self.CHECKPOINTS[control_type], torch_dtype=torch.float16
        )
        self.pipe = StableDiffusionControlNetPipeline.from_pretrained(
            "runwayml/stable-diffusion-v1-5", controlnet=controlnet,
            torch_dtype=torch.float16,
        ).to(device)
        self.pipe.scheduler = DDIMScheduler.from_config(
            self.pipe.scheduler.config
        )
        self.control_type = control_type
        self.guidance_scale = guidance_scale
        self.diffusion_steps = diffusion_steps
        self.device = device

    def __call__(self, rgb, cond_rgb, prompt: str,
                 depth=None) -> GuidanceOutput:
        import PIL.Image

        from gaussianeditor_tpu_torch.guidance.image_cond import (
            prepare_image_cond,
        )

        # per-control-type conditioning image (canny edge map, normal
        # map, or RGB pass-through — controlnet_guidance.py:281-311)
        cond = prepare_image_cond(
            self.control_type, cond_rgb, depth=depth,
            normal_detector=getattr(self, "normal_detector", None),
        )
        img = PIL.Image.fromarray(
            (np.clip(cond, 0, 1) * 255).astype(np.uint8)
        )
        out = self.pipe(
            prompt, image=img, num_inference_steps=self.diffusion_steps,
            guidance_scale=self.guidance_scale,
        ).images[0]
        return GuidanceOutput(
            edit_image=np.asarray(out, np.float32) / 255.0
        )


class ControlNetInpainter:
    """Per-view hole inpainting for Delete (GassuianEditorDel.py:68-129)."""

    def __init__(self, diffusion_steps: int = 20, seed: int = 0,
                 device: str = "cuda", pipe=None):
        if pipe is not None:
            self.pipe = pipe
            self.steps = diffusion_steps
            self.seed = seed
            return
        _require_diffusers()
        from diffusers import (
            ControlNetModel,
            StableDiffusionControlNetInpaintPipeline,
        )

        controlnet = ControlNetModel.from_pretrained(
            "lllyasviel/control_v11p_sd15_inpaint", torch_dtype=torch.float16
        )
        self.pipe = StableDiffusionControlNetInpaintPipeline.from_pretrained(
            "runwayml/stable-diffusion-v1-5", controlnet=controlnet,
            torch_dtype=torch.float16,
        ).to(device)
        self.steps = diffusion_steps
        self.seed = seed

    def __call__(self, image, mask, prompt: str):
        import PIL.Image

        im = PIL.Image.fromarray(
            (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        )
        mk = PIL.Image.fromarray(
            (np.asarray(mask) > 0.5).astype(np.uint8) * 255
        )
        gen = torch.Generator().manual_seed(self.seed)
        out = self.pipe(
            prompt or "background", image=im, mask_image=mk,
            control_image=im, num_inference_steps=self.steps, generator=gen,
        ).images[0]
        return np.asarray(out, np.float32) / 255.0


class SDXLInpainter:
    """bbox inpainting for Add (GassuianEditorAdd.py:81-110)."""

    def __init__(self, diffusion_steps: int = 20, device: str = "cuda",
                 pipe=None):
        self.steps = diffusion_steps
        if pipe is not None:
            self.pipe = pipe
            return
        _require_diffusers()
        from diffusers import StableDiffusionXLInpaintPipeline

        self.pipe = StableDiffusionXLInpaintPipeline.from_pretrained(
            "diffusers/stable-diffusion-xl-1.0-inpainting-0.1",
            torch_dtype=torch.float16,
        ).to(device)

    def __call__(self, image, mask, prompt: str):
        import PIL.Image

        im = PIL.Image.fromarray(
            (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        )
        mk = PIL.Image.fromarray(
            (np.asarray(mask) > 0.5).astype(np.uint8) * 255
        )
        out = self.pipe(prompt, image=im, mask_image=mk,
                        num_inference_steps=self.steps).images[0]
        return np.asarray(out, np.float32) / 255.0


class LangSAMSegmentor:
    """Text-prompted segmentation (threestudio/utils/sam.py:14-36)."""

    def __init__(self, device: str = "cuda", model=None):
        if model is not None:
            self.model = model
            return
        try:
            from lang_sam import LangSAM
        except ImportError as e:
            raise ImportError(
                "lang-segment-anything is not available; use "
                "guidance.fake.FakeSegmentor for hermetic runs."
            ) from e
        self.model = LangSAM()

    def __call__(self, image, prompt: str):
        import PIL.Image

        im = PIL.Image.fromarray(
            (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        )
        masks, *_ = self.model.predict(im, prompt)
        if len(masks) == 0:
            return np.zeros(np.asarray(image).shape[:2], np.float32)
        return np.asarray(masks[0], np.float32)
