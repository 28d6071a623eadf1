"""Deterministic fakes for guidance, segmentation and inpainting.

Counterpart of `gaussianeditor_tpu/guidance/fake.py` (`FakeGuidance`,
`FakeSegmentor`, `FakePointSegmentor`, `FakeInpainter`,
`FakeObjectGenerator`), copied: they are numpy, so both packages give
bitwise equal outputs on the same inputs.
They make the editing loop testable without checkpoints or network: the
fake guidance applies a fixed prompt-derived linear color transform to
the origin render, a consistent and reachable multi-view target.
(`FakeLatentModel` comes with the score slice.)
"""

from __future__ import annotations

import hashlib

import numpy as np

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
