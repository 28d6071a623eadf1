"""Carry a scene and a camera across from numpy arrays.

The JAX package's `GaussianScene` and `Camera` (`gaussianeditor_tpu/
models/gaussians.py`, `gaussianeditor_tpu/core/cameras.py`) hand their
fields over as numpy arrays (`np.asarray` on the JAX side); these
functions rebuild the port's objects from them. The port never sees a
JAX array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES, GaussianScene


def scene_from_numpy(fields: Dict[str, np.ndarray], max_sh_degree: int,
                     device="cuda") -> GaussianScene:
    """`fields` holds `params.<name>` and `anchor.<name>` for the six
    parameters, plus `alive`, `mask`, `generation`, `anchor_weights`,
    `n_generations` and `active_sh_degree`."""
    device = resolve_device(device)

    def t(key, dtype):
        return torch.as_tensor(np.array(fields[key], dtype=dtype),
                               device=device)

    return GaussianScene(
        {k: t("params." + k, np.float32) for k in PARAM_NAMES},
        max_sh_degree=max_sh_degree,
        alive=t("alive", bool),
        mask=t("mask", bool),
        generation=t("generation", np.int32),
        anchor={k: t("anchor." + k, np.float32) for k in PARAM_NAMES},
        anchor_weights=t("anchor_weights", np.float32),
        n_generations=t("n_generations", np.int32),
        active_sh_degree=t("active_sh_degree", np.int32),
    )


def camera_from_numpy(world_view, full_proj, cam_pos, tan_fovx, tan_fovy,
                      height: int, width: int, device="cuda") -> Camera:
    """A Camera holding exactly the given float32 fields."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return Camera(world_view=f32(world_view), full_proj=f32(full_proj),
                  cam_pos=f32(cam_pos), tan_fovx=f32(tan_fovx),
                  tan_fovy=f32(tan_fovy), height=int(height),
                  width=int(width))
