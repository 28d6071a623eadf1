"""Deterministic fakes for guidance, segmentation and inpainting.

Counterpart of `gaussianeditor_tpu/guidance/fake.py` (`FakeGuidance`,
`FakeSegmentor`, `FakePointSegmentor`, `FakeInpainter`,
`FakeObjectGenerator`), copied: they are numpy, so both packages give
bitwise equal outputs on the same inputs; and `FakeLatentModel`, the
score paths' latent model, in torch on an explicit device.
They make the editing loop testable without checkpoints or network: the
fake guidance applies a fixed prompt-derived linear color transform to
the origin render, a consistent and reachable multi-view target.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.guidance.base import GuidanceOutput


def _prompt_matrix(prompt: str):
    """Stable 3x3 color mixing matrix and bias derived from the prompt."""
    h = hashlib.sha256(prompt.encode()).digest()
    vals = np.frombuffer(h[:16], dtype=np.uint8).astype(np.float32) / 255.0
    m = 0.6 * np.eye(3, dtype=np.float32)
    m += 0.25 * vals[:9].reshape(3, 3)
    bias = 0.3 * vals[9:12]
    return m, bias


class FakeGuidance:
    """edited = clip(origin @ M(prompt) + b(prompt))."""

    def __init__(self, strength: float = 1.0):
        self.strength = strength

    def __call__(self, rgb, cond_rgb, prompt: str) -> GuidanceOutput:
        m, b = _prompt_matrix(prompt)
        origin = np.asarray(cond_rgb, np.float32)
        edited = np.clip(origin @ m.T + b, 0.0, 1.0)
        out = origin + self.strength * (edited - origin)
        return GuidanceOutput(edit_image=out.astype(np.float32))


class FakeSegmentor:
    """Thresholds the color distance to a reference color (given, or
    derived from the prompt)."""

    def __init__(self, ref_color=None, radius: float = 0.35):
        self.ref_color = ref_color
        self.radius = radius

    def __call__(self, image, prompt: str) -> np.ndarray:
        img = np.asarray(image, np.float32)
        if self.ref_color is None:
            h = hashlib.sha256(prompt.encode()).digest()
            ref = np.frombuffer(h[:3], dtype=np.uint8).astype(np.float32) / 255.0
        else:
            ref = np.asarray(self.ref_color, np.float32)
        d = np.linalg.norm(img - ref[None, None], axis=-1)
        return (d < self.radius).astype(np.float32)


class FakePointSegmentor:
    """Point-prompted segmentation stand-in: selects pixels whose color is
    close to the color under the first click point."""

    def __init__(self, radius: float = 0.25):
        self.radius = radius

    def __call__(self, image, points) -> np.ndarray:
        img = np.asarray(image, np.float32)
        p = np.asarray(points)
        x = int(np.clip(p[0, 0], 0, img.shape[1] - 1))
        y = int(np.clip(p[0, 1], 0, img.shape[0] - 1))
        ref = img[y, x]
        d = np.linalg.norm(img - ref[None, None], axis=-1)
        return (d < self.radius).astype(np.float32)


class FakeLatentModel:
    """Deterministic `LatentModel` for the SDS and DDS score paths
    (guidance/score.py), on `device`: encode is an 8x8 average pool
    through a fixed 3->4-channel projection drawn from
    `np.random.RandomState(seed)` as the JAX model draws it (so both
    packages hold the same matrix), differentiable, so autograd gives
    the encoder's backward as it does through a VAE; unet is a smooth
    function of (latents, t, prompt hash), a * tanh(z) + b * t / 1000
    plus 0.1 * tanh(cond), so that different prompts predict different
    noise and the CFG combinations do not collapse. Images and latents
    are channels-last, [B, H, W, 3] and [B, H / 8, W / 8, 4]."""

    latent_channels = 4
    down = 8

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        self.proj = torch.from_numpy(
            rng.randn(3, self.latent_channels).astype(np.float32)
        ).to(self.device)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        d = self.down
        x = images.reshape(B, H // d, d, W // d, d, 3).mean(dim=(2, 4))
        return x @ self.proj

    def unet(self, latents_noisy, t, prompt: str, cond_latents=None):
        h = hashlib.sha256(prompt.encode()).digest()
        a = 0.5 + h[0] / 255.0
        b = h[1] / 255.0 - 0.5
        tt = torch.as_tensor(t, dtype=torch.float32,
                             device=latents_noisy.device).reshape(
                                 -1, 1, 1, 1) / 1000.0
        out = a * torch.tanh(latents_noisy) + b * tt
        if cond_latents is not None:
            out = out + 0.1 * torch.tanh(cond_latents)
        return out


class FakeObjectGenerator:
    """Deterministic `ObjectGenerator`: a Gaussian blob of `n_points`
    points tinted with the input image's mean colour, built on `device`
    at SH degree 0; the stand-in for the Wonder3D pipeline
    (edit/wonder3d_adapter.py)."""

    def __init__(self, n_points: int = 2000, seed: int = 0, device="cuda"):
        self.n_points = n_points
        self.seed = seed
        self.device = device

    def __call__(self, image, prompt: str):
        from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

        rng = np.random.RandomState(self.seed)
        pts = rng.normal(0, 0.3, (self.n_points, 3)).astype(np.float32)
        img = np.asarray(image, np.float32)
        color = img[..., :3].reshape(-1, 3).mean(0)
        return GaussianScene.from_points(
            pts, np.tile(color, (self.n_points, 1)), max_sh_degree=0,
            device=self.device)


class FakeInpainter:
    """Fills the masked region with the mean color of the unmasked region."""

    def __call__(self, image, mask, prompt: str) -> np.ndarray:
        img = np.asarray(image, np.float32).copy()
        m = np.asarray(mask) > 0.5
        if (~m).any():
            fill = img[~m].mean(axis=0)
        else:
            fill = np.array([0.5, 0.5, 0.5], np.float32)
        img[m] = fill
        return img
