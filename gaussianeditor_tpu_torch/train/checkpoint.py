"""Checkpoint and resume of the full train state.

Counterpart of `gaussianeditor_tpu/train/checkpoint.py`
(`save_train_state`, `load_train_state`): the scene, the Adam moments,
the densify statistics and the step in one npz, with the JAX package's
keys and dtypes, so that a checkpoint written by either package loads
into the other. `models/ply.py` remains the interchange format of the
scene alone.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussianeditor_tpu_torch.models.convert import (
    adam_state_from_numpy,
    densify_stats_from_numpy,
    scene_from_numpy,
)
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES
from gaussianeditor_tpu_torch.train.trainer import TrainState


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_train_state(path: str, state: TrainState) -> None:
    s = state.scene
    payload = {}
    for prefix, group in (("params", s.params()), ("anchor", s.anchor()),
                          ("mu", state.opt_state.mu),
                          ("nu", state.opt_state.nu)):
        for k in PARAM_NAMES:
            payload[f"{prefix}.{k}"] = _host(group[k])
    payload.update({
        "alive": _host(s.alive),
        "generation": _host(s.generation),
        "mask": _host(s.mask),
        "anchor_weights": _host(s.anchor_weights),
        "n_generations": _host(s.n_generations),
        "active_sh_degree": _host(s.active_sh_degree),
        "max_sh_degree": np.asarray(s.max_sh_degree),
        "opt_count": np.asarray(state.opt_state.count, np.int32),
        "stats.accum": _host(state.stats.xyz_gradient_accum),
        "stats.denom": _host(state.stats.denom),
        "stats.radii": _host(state.stats.max_radii2d),
        "step": np.asarray(state.step, np.int32),
    })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **payload)


def load_train_state(path: str, device="cuda") -> TrainState:
    """The state saved at `path` (".npz" may be left off), on `device`."""
    d = np.load(path if path.endswith(".npz") else path + ".npz")
    scene = scene_from_numpy(d, int(d["max_sh_degree"]), device=device)
    opt = adam_state_from_numpy(
        {**{f"{m}.{k}": d[f"{m}.{k}"] for m in ("mu", "nu")
            for k in PARAM_NAMES},
         "count": d["opt_count"]}, device=device)
    stats = densify_stats_from_numpy(d["stats.accum"], d["stats.denom"],
                                     d["stats.radii"], device=device)
    return TrainState(scene=scene, opt_state=opt, stats=stats,
                      step=int(d["step"]))
