"""Carry a scene, a camera and the training state across from numpy.

The JAX package's `GaussianScene`, `Camera`, `AdamState` and
`DensifyStats` (`gaussianeditor_tpu/models/gaussians.py`,
`core/cameras.py`, `train/optim.py`, `train/densify.py`) hand their
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
from gaussianeditor_tpu_torch.train.densify import DensifyStats
from gaussianeditor_tpu_torch.train.optim import AdamState


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


def adam_state_from_numpy(fields: Dict[str, np.ndarray],
                          device="cuda") -> AdamState:
    """`fields` holds `mu.<name>` and `nu.<name>` for the six parameters,
    and `count`."""
    device = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.array(fields[key], dtype=np.float32),
                               device=device)

    return AdamState(mu={k: t("mu." + k) for k in PARAM_NAMES},
                     nu={k: t("nu." + k) for k in PARAM_NAMES},
                     count=int(fields["count"]))


def densify_stats_from_numpy(xyz_gradient_accum, denom, max_radii2d,
                             device="cuda") -> DensifyStats:
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return DensifyStats(xyz_gradient_accum=t(xyz_gradient_accum),
                        denom=t(denom), max_radii2d=t(max_radii2d))
