"""GaussianScene: the fixed-capacity Gaussian cloud as an `nn.Module`.

Counterpart of `gaussianeditor_tpu/models/gaussians.py` (`GaussianScene`,
`GaussianParams`, the activations). The six trainable arrays are
`nn.Parameter`s; the bookkeeping state (`alive`, `mask`, `generation`,
the anchor snapshot, `anchor_weights`, `n_generations`,
`active_sh_degree`) lives in buffers. Capacity is fixed and `alive`
marks the occupied slots, as in the JAX package, so densification
(`train/densify.py`) writes into dead slots instead of resizing tensors.
Dead slots carry zeros in every parameter.

Where the JAX scene returns a new pytree (`update_anchor`, `set_mask`,
`one_up_sh_degree`), the port updates its buffers in place and returns
the scene; `localized` returns a view that shares the parameters.
`compact` and `concat_scenes` change the capacity, so they return new
scenes and leave their inputs as they were.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.core import sh as sh_utils
from gaussianeditor_tpu_torch.core.transforms import quat_normalize

MAX_ANCHOR_WEIGHT = 10.0
MAX_GENERATIONS = 64

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity_raw",
               "log_scales", "quats")


def scaling_activation(x):
    return torch.exp(x)


def scaling_inverse_activation(x):
    return torch.log(x)


def opacity_activation(x):
    return torch.sigmoid(x)


def opacity_inverse_activation(x, eps: float = 1e-7):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class GaussianScene(nn.Module):
    """Parameters: xyz [C,3], features_dc [C,1,3], features_rest [C,K-1,3],
    opacity_raw [C,1] (pre-sigmoid), log_scales [C,3], quats [C,4]
    (w,x,y,z, unnormalized). Buffers: alive/mask [C] bool, generation [C]
    int32, anchor_<param> copies, anchor_weights [MAX_GENERATIONS] f32,
    n_generations and active_sh_degree int32 scalars."""

    def __init__(self, params: Dict[str, torch.Tensor], *, max_sh_degree: int,
                 alive: torch.Tensor, mask: torch.Tensor,
                 generation: torch.Tensor, anchor: Dict[str, torch.Tensor],
                 anchor_weights: torch.Tensor, n_generations: torch.Tensor,
                 active_sh_degree: torch.Tensor):
        super().__init__()
        self.max_sh_degree = int(max_sh_degree)
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(params[name]))
        self.register_buffer("alive", alive)
        self.register_buffer("mask", mask)
        self.register_buffer("generation", generation)
        for name in PARAM_NAMES:
            self.register_buffer("anchor_" + name, anchor[name])
        self.register_buffer("anchor_weights", anchor_weights)
        self.register_buffer("n_generations", n_generations)
        self.register_buffer("active_sh_degree", active_sh_degree)

    # ---- derived quantities (activated parameter views) ----

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))

    @property
    def get_scaling(self) -> torch.Tensor:
        return scaling_activation(self.log_scales)

    @property
    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.quats)

    @property
    def get_opacity(self) -> torch.Tensor:
        """[C, 1] sigmoid opacity, zeroed on dead slots."""
        op = opacity_activation(self.opacity_raw)
        return op * self.alive[:, None].to(op.dtype)

    @property
    def get_features(self) -> torch.Tensor:
        """[C, K, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def anchor(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, "anchor_" + name) for name in PARAM_NAMES}

    # ---- state updates (the JAX scene's `replace` methods) ----

    @torch.no_grad()
    def one_up_sh_degree(self) -> "GaussianScene":
        """Raise the active SH degree by one, up to `max_sh_degree`."""
        self.active_sh_degree.copy_(torch.clamp(self.active_sh_degree + 1,
                                                max=self.max_sh_degree))
        return self

    @torch.no_grad()
    def update_anchor(self) -> "GaussianScene":
        """Snapshot the current parameters as the anchor."""
        for name in PARAM_NAMES:
            getattr(self, "anchor_" + name).copy_(getattr(self, name))
        return self

    @torch.no_grad()
    def set_mask(self, mask: torch.Tensor) -> "GaussianScene":
        self.mask.copy_(mask.to(torch.bool))
        return self

    def localized(self) -> "GaussianScene":
        """The scene restricted to the semantic mask (`alive & mask`): a
        shallow view that shares the parameters, so gradients taken
        through it reach this scene's parameters."""
        view = copy.copy(self)
        view._buffers = dict(self._buffers)
        view._buffers["alive"] = self.alive & self.mask
        return view

    # ---- construction ----

    @classmethod
    def create(
        cls,
        params: Dict[str, torch.Tensor],
        max_sh_degree: int,
        anchor_weight_init_g0: float = 0.05,
        active_sh_degree: Optional[int] = None,
        alive=None,
    ) -> "GaussianScene":
        """Scene over `params` (tensors on one device); `alive` defaults
        to all slots, `mask` to `alive`, the anchor to a copy of params."""
        device = params["xyz"].device
        C = params["xyz"].shape[0]
        if alive is None:
            alive = np.ones((C,), dtype=bool)
        alive = torch.as_tensor(np.asarray(alive, dtype=bool), device=device)
        weights = np.zeros((MAX_GENERATIONS,), np.float32)
        weights[0] = anchor_weight_init_g0
        if active_sh_degree is None:
            active_sh_degree = 0
        return cls(
            {k: params[k].detach() for k in PARAM_NAMES},
            max_sh_degree=max_sh_degree,
            alive=alive,
            mask=alive.clone(),  # "all updatable" == all alive slots
            generation=torch.zeros((C,), dtype=torch.int32, device=device),
            anchor={k: params[k].detach().clone() for k in PARAM_NAMES},
            anchor_weights=torch.as_tensor(weights, device=device),
            n_generations=torch.tensor(1, dtype=torch.int32, device=device),
            active_sh_degree=torch.tensor(int(active_sh_degree),
                                          dtype=torch.int32, device=device),
        )

    @classmethod
    def from_points(
        cls,
        points: np.ndarray,
        colors: np.ndarray,
        max_sh_degree: int = 3,
        capacity: Optional[int] = None,
        anchor_weight_init_g0: float = 0.05,
        device="cuda",
    ) -> "GaussianScene":
        """Initialize from a colored point cloud: log-scales from the
        mean squared distance to the 3 nearest neighbours, identity
        quats, raw opacity 1.0, DC features = RGB2SH(color)."""
        from gaussianeditor_tpu_torch.ops.knn import mean_sq_dist_to_3nn

        device = resolve_device(device)
        points = np.asarray(points, dtype=np.float32)
        colors = np.asarray(colors, dtype=np.float32)
        n = points.shape[0]
        if capacity is None:
            capacity = n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} points")

        dist2 = np.maximum(mean_sq_dist_to_3nn(points), 1e-7)
        log_scales = np.repeat(
            np.log(np.sqrt(dist2))[:, None], 3, axis=1
        ).astype(np.float32)

        k = sh_utils.num_sh_bases(max_sh_degree)
        f_dc = np.asarray(sh_utils.rgb2sh(colors))[:, None, :]
        f_rest = np.zeros((n, k - 1, 3), np.float32)
        quats = np.zeros((n, 4), np.float32)
        quats[:, 0] = 1.0
        opacity_raw = np.ones((n, 1), np.float32)

        def pad(x):
            out = np.zeros((capacity,) + x.shape[1:], np.float32)
            out[:n] = x
            return torch.as_tensor(out, device=device)

        params = dict(
            xyz=pad(points),
            features_dc=pad(f_dc),
            features_rest=pad(f_rest),
            opacity_raw=pad(opacity_raw),
            log_scales=pad(log_scales),
            quats=pad(quats),
        )
        return cls.create(params, max_sh_degree=max_sh_degree,
                          anchor_weight_init_g0=anchor_weight_init_g0,
                          alive=np.arange(capacity) < n)

    def pad_to_capacity(self, capacity: int) -> "GaussianScene":
        """A copy grown to `capacity` slots; the new slots are dead and
        hold zeros."""
        cur = self.capacity
        if capacity < cur:
            raise ValueError(f"capacity {capacity} < current {cur}")

        def pad(x):
            out = x.new_zeros((capacity,) + tuple(x.shape[1:]))
            out[:cur] = x.detach()
            return out

        return GaussianScene(
            {k: pad(v) for k, v in self.params().items()},
            max_sh_degree=self.max_sh_degree,
            alive=pad(self.alive),
            mask=pad(self.mask),
            generation=pad(self.generation),
            anchor={k: pad(v) for k, v in self.anchor().items()},
            anchor_weights=self.anchor_weights.clone(),
            n_generations=self.n_generations.clone(),
            active_sh_degree=self.active_sh_degree.clone(),
        )

    @torch.no_grad()
    def compact(self) -> "GaussianScene":
        """A new scene of the alive slots only, in slot order, every
        parameter and buffer kept (one host read of the alive count)."""
        keep = self.alive

        def take(x):
            return x[keep].clone()

        return GaussianScene(
            {k: take(v) for k, v in self.params().items()},
            max_sh_degree=self.max_sh_degree,
            alive=take(self.alive),
            mask=take(self.mask),
            generation=take(self.generation),
            anchor={k: take(v) for k, v in self.anchor().items()},
            anchor_weights=self.anchor_weights.clone(),
            n_generations=self.n_generations.clone(),
            active_sh_degree=self.active_sh_degree.clone(),
        )


@torch.no_grad()
def concat_scenes(base: GaussianScene, obj: GaussianScene) -> GaussianScene:
    """Merge an added object into a scene: a new scene holding the alive
    slots of `base`, then those of `obj` (the reference's
    `concat_gaussians`, gaussian_model.py:900-923). The object's SH rest
    is padded with zeros or cut to the base's degree; the scene is
    created with the base's first anchor weight and active SH degree
    (generations reset), its mask marks only the object, so training
    refines the insertion without disturbing the scene, and the anchor
    is the merged parameters. Both scenes must be on one device."""
    if base.device != obj.device:
        raise ValueError(f"concat_scenes: the base scene is on {base.device} "
                         f"and the object on {obj.device}; move one first")
    base = base.compact()
    obj = obj.compact()
    kb = sh_utils.num_sh_bases(base.max_sh_degree)
    ko = sh_utils.num_sh_bases(obj.max_sh_degree)
    obj_rest = obj.features_rest
    if ko < kb:  # pad the object's SH up to the scene's degree
        obj_rest = torch.nn.functional.pad(obj_rest, (0, 0, 0, kb - ko))
    elif ko > kb:
        obj_rest = obj_rest[:, : kb - 1]
    params = {k: torch.cat([getattr(base, k), getattr(obj, k)], dim=0)
              for k in PARAM_NAMES if k != "features_rest"}
    params["features_rest"] = torch.cat([base.features_rest, obj_rest], dim=0)
    nb, no = base.capacity, obj.capacity
    merged = GaussianScene.create(
        params,
        max_sh_degree=base.max_sh_degree,
        anchor_weight_init_g0=float(base.anchor_weights[0]),
        active_sh_degree=int(base.active_sh_degree),
    )
    mask = torch.cat([torch.zeros((nb,), dtype=torch.bool, device=base.device),
                      torch.ones((no,), dtype=torch.bool, device=base.device)])
    return merged.set_mask(mask).update_anchor()
