"""Guidance and segmentation protocols.

Counterpart of `gaussianeditor_tpu/guidance/base.py` (`GuidanceOutput`,
`Guidance`, `Segmentor`, `Inpainter`). The editing loop sees guidance
only through `Guidance(render, origin, prompt) -> edited image`, over
host (numpy) images: diffusion backends run outside the train step and
are called once per refreshed view, every `per_editing_step` steps.
`guidance/fake.py` holds deterministic stand-ins for tests and for the
card run.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass
class GuidanceOutput:
    edit_image: np.ndarray  # [H, W, 3] float in [0, 1]


@runtime_checkable
class Guidance(Protocol):
    """Produce an edited target for one view from the current render, the
    cached origin render and the instruction prompt."""

    def __call__(
        self,
        rgb: np.ndarray,        # current render [H, W, 3]
        cond_rgb: np.ndarray,   # origin render [H, W, 3]
        prompt: str,
    ) -> GuidanceOutput:
        ...


@runtime_checkable
class Segmentor(Protocol):
    """Text-prompted 2D segmentation."""

    def __call__(self, image: np.ndarray, prompt: str) -> np.ndarray:
        """[H, W, 3] image -> [H, W] float mask in [0, 1]."""
        ...


@runtime_checkable
class Inpainter(Protocol):
    """Masked image inpainting."""

    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 prompt: str) -> np.ndarray:
        ...
