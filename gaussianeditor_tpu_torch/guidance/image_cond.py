"""ControlNet conditioning-image preparation.

Counterpart of `gaussianeditor_tpu/guidance/image_cond.py`, copied
(`canny_cond`, `normal_from_depth`, `NormalBaeCond`,
`prepare_image_cond`): host numpy, so both packages give the same
images. The reference is
`threestudio/models/guidance/controlnet_guidance.py:281-311`
(`prepare_image_cond`) with the canonical bounds (:50-51):

  * canny  — 5x5 box blur, then Canny(50, 100), replicated to 3 channels
  * normal — NormalBae monocular normal prediction (import-gated, like
    the reference's controlnet_aux NormalBaeDetector); first-party
    fallback derives a normal map from a rendered depth image, which the
    renderer produces with every frame (RenderOutput.depth)
  * p2p / inpaint — the RGB image itself

All functions take/return float32 HxWx3 images in [0, 1] (the numpy
host-side format the guidance adapters use)."""

from __future__ import annotations

from typing import Optional

import numpy as np

CANNY_LOWER = 50
CANNY_UPPER = 100


def canny_cond(rgb: np.ndarray, lower: int = CANNY_LOWER,
               upper: int = CANNY_UPPER) -> np.ndarray:
    """controlnet_guidance.py:292-306: blur(5x5) -> Canny -> 3-channel."""
    import cv2

    img = (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8)
    blurred = cv2.blur(img, ksize=(5, 5))
    edges = cv2.Canny(blurred, lower, upper)
    return np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 255.0


def normal_from_depth(depth: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> np.ndarray:
    """First-party normal map from a rendered depth image: central
    differences -> n = normalize(-dz/dx, -dz/dy, 1), encoded to [0, 1]
    RGB like NormalBae outputs. Background (mask=0 or depth<=0) maps to
    the flat-facing color (0.5, 0.5, 1)."""
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    gy, gx = np.gradient(d)
    n = np.stack([-gx, -gy, np.ones_like(d)], axis=-1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    valid = d > 0
    if mask is not None:
        valid &= np.asarray(mask) > 0.5
    flat = np.array([0.0, 0.0, 1.0], np.float32)
    n = np.where(valid[..., None], n, flat[None, None])
    return (n * 0.5 + 0.5).astype(np.float32)


class NormalBaeCond:
    """Import-gated NormalBae detector (controlnet_guidance.py:133-136).
    Falls back to `normal_from_depth` when unavailable and a depth image
    is supplied."""

    def __init__(self, device: str = "cuda"):
        try:
            from controlnet_aux import NormalBaeDetector
        except ImportError as e:
            raise ImportError(
                "controlnet_aux is not available; use normal_from_depth "
                "on a rendered depth image instead."
            ) from e
        self.det = NormalBaeDetector.from_pretrained("lllyasviel/Annotators")
        self.det.model.to(device)

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        img = (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8)
        out = self.det(img)
        return np.asarray(out, np.float32) / 255.0


def prepare_image_cond(control_type: str, rgb: np.ndarray,
                       depth: Optional[np.ndarray] = None,
                       normal_detector=None) -> np.ndarray:
    """Dispatch matching controlnet_guidance.py:281-311."""
    if control_type == "canny":
        return canny_cond(rgb)
    if control_type == "normal":
        if normal_detector is not None:
            return normal_detector(rgb)
        if depth is None:
            raise ValueError(
                "normal conditioning needs a NormalBae detector or a "
                "rendered depth image"
            )
        return normal_from_depth(depth)
    if control_type in ("p2p", "inpaint"):
        return np.asarray(rgb, np.float32)
    raise ValueError(f"unknown control_type {control_type!r}")
