"""2D mask morphology helpers.

Counterpart of `gaussianeditor_tpu/utils/masks.py`, copied: `dilate_mask`
(a max-pool), `erode_mask` (1 - dilate(1 - m)) and `fill_closed_areas`
(scipy's binary hole fill), as `threestudio/utils/misc.py:16-32` defines
them. Host-side numpy and scipy; they run once per edit set-up, not in
the train step.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dilate_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    m = np.asarray(mask) > 0.5
    if iterations <= 0:
        return m.astype(np.float32)
    out = ndimage.binary_dilation(m, iterations=int(iterations))
    return out.astype(np.float32)


def erode_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    m = np.asarray(mask) > 0.5
    if iterations <= 0:
        return m.astype(np.float32)
    out = ndimage.binary_erosion(m, iterations=int(iterations))
    return out.astype(np.float32)


def fill_closed_areas(mask: np.ndarray) -> np.ndarray:
    m = np.asarray(mask) > 0.5
    return ndimage.binary_fill_holes(m).astype(np.float32)
