"""Densification and pruning within a fixed capacity.

Counterpart of `gaussianeditor_tpu/train/densify.py` (`DensifyConfig`,
`DensifyStats`, `add_densification_stats`, `densify_and_prune`,
`reset_opacity`), with the reference behaviours it keeps: gradients
zeroed outside the semantic mask, the top-percent quantile gate, clone
below and split above percent_dense * extent, split children at scale
/ 1.6, the accumulators reset before the prune, the prune restricted to
masked slots, then the anchor snapshot and schedule growth.

A clone copies its row to a free (dead) slot; a split overwrites the
original with child A and writes child B to a free slot. Free slots are
handed out lowest index first; requests beyond them are dropped and
counted. The scene is updated in place. Each scatter to a free slot
writes that slot at most once (`dest` is injective on the requests that
got a slot) and drops the rest. The split noise comes from an explicit
`torch.Generator`, or is injected as `noise=(eps_a, eps_b)`, two [C, 3]
standard-normal draws, so that tests can hand both packages the same
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from gaussianeditor_tpu_torch.core.transforms import quat_to_rotmat
from gaussianeditor_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianScene,
    opacity_activation,
    opacity_inverse_activation,
)
from gaussianeditor_tpu_torch.train.anchors import update_anchor_loss_schedule
from gaussianeditor_tpu_torch.utils.profiling import sync


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    max_grad: float = 0.01              # densify_grad_threshold
    max_densify_percent: float = 0.01
    min_opacity: float = 0.005
    max_screen_size: float = 5.0        # 0 disables the screen-space prune
    percent_dense: float = 0.01


@dataclasses.dataclass
class DensifyStats:
    xyz_gradient_accum: torch.Tensor  # [C]
    denom: torch.Tensor               # [C]
    max_radii2d: torch.Tensor         # [C] float32

    def clone(self) -> "DensifyStats":
        return DensifyStats(*(t.clone() for t in dataclasses.astuple(self)))


def init_densify_stats(capacity: int, device) -> DensifyStats:
    def z():
        return torch.zeros((capacity,), dtype=torch.float32, device=device)

    return DensifyStats(xyz_gradient_accum=z(), denom=z(), max_radii2d=z())


def add_densification_stats(stats: DensifyStats,
                            viewspace_grad_norm: torch.Tensor,
                            radii: torch.Tensor,
                            update_filter: torch.Tensor) -> DensifyStats:
    """Accumulate the viewspace gradient norm [C] and a visit where
    `update_filter` [C] is set, and keep the running max of `radii` [C]."""
    upd = update_filter.to(torch.float32)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + viewspace_grad_norm * upd,
        denom=stats.denom + upd,
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  radii.to(torch.float32)))


class DensifyResult(NamedTuple):
    scene: GaussianScene
    stats: DensifyStats
    reset_mask: torch.Tensor   # [C] slots whose Adam moments are zeroed
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor    # requests lost to a full capacity


def _masked_quantile(values: torch.Tensor, valid: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """`torch.quantile(values[valid], q)` with linear interpolation, over
    the fixed shape (invalid entries sorted to +inf)."""
    C = values.shape[0]
    n = torch.sum(valid.to(torch.int32))
    s = torch.sort(torch.where(valid, values,
                               torch.full_like(values, float("inf"))))[0]
    pos = torch.clamp(q, 0.0, 1.0) * torch.clamp_min(n - 1, 0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    lo = torch.clamp(lo, 0, C - 1)
    hi = torch.clamp(hi, 0, C - 1)
    return s[lo] * (1.0 - frac) + s[hi] * frac


@torch.no_grad()
def densify_and_prune(
    scene: GaussianScene,
    stats: DensifyStats,
    config: DensifyConfig,
    cameras_extent: float,
    anchor_weight_init: float,
    anchor_weight_multiplier: float,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> DensifyResult:
    """Clone, split and prune `scene` in place; see the module notes."""
    C = scene.capacity
    dev = scene.device
    alive = scene.alive.clone()
    mask = scene.mask.clone()
    p = {k: getattr(scene, k).detach() for k in PARAM_NAMES}

    # --- gradient gating ---
    grads = stats.xyz_gradient_accum / torch.clamp_min(stats.denom, 1e-12)
    grads = torch.where(torch.isnan(grads), 0.0, grads)
    grads = torch.where(mask & alive, grads, 0.0)
    if config.max_densify_percent < 1.0:
        n_alive = torch.sum(alive.to(torch.float32))
        nnz = torch.sum((grads != 0.0).to(torch.float32))
        valid_percent = (nnz * config.max_densify_percent
                         / torch.clamp_min(n_alive, 1.0))
        thres = _masked_quantile(grads, alive, 1.0 - valid_percent)
        grads = torch.where(grads < thres, 0.0, grads)

    # --- selection ---
    max_scale = torch.max(torch.exp(p["log_scales"]), dim=-1).values
    dense_lim = config.percent_dense * cameras_extent
    hot = (grads >= config.max_grad) & alive
    clone_sel = hot & (max_scale <= dense_lim)
    split_sel = hot & (max_scale > dense_lim)

    # --- free-slot allocation: one free slot per clone or split ---
    req = clone_sel | split_sel
    n_free = torch.sum((~alive).to(torch.int32))
    ar = torch.arange(C, device=dev)
    free_sorted = torch.argsort(torch.where(~alive, ar, C + ar))
    rank = torch.cumsum(req.to(torch.int64), 0) - 1
    can_alloc = req & (rank < n_free)
    dest = torch.where(can_alloc, free_sorted[torch.clamp(rank, 0, C - 1)],
                       torch.full_like(ar, C))
    n_dropped = torch.sum((req & ~can_alloc).to(torch.int32))
    clone_do = clone_sel & can_alloc
    split_do = split_sel & can_alloc

    # --- split resampling: child xyz = R (eps * scales) + xyz ---
    if noise is None:
        noise = tuple(torch.randn((C, 3), generator=generator, device=dev)
                      for _ in range(2))
    eps_a, eps_b = noise
    scales = torch.exp(p["log_scales"])
    R = quat_to_rotmat(p["quats"])

    def sample_child(eps):
        return torch.einsum("nij,nj->ni", R, eps.to(dev) * scales) + p["xyz"]

    child_a_xyz = sample_child(eps_a)   # overwrites the split original
    child_b_xyz = sample_child(eps_b)   # goes to the free slot
    child_log_scales = torch.log(scales / (0.8 * 2.0))
    gen_new = scene.n_generations.to(torch.int32)

    # --- rows for the allocated slots; each free slot written once ---
    with sync("densify"):       # nonzero reads its count on the host
        src = torch.nonzero(dest < C).squeeze(1)
    dst = dest[src]
    new_rows = dict(p)
    new_rows["xyz"] = torch.where(split_do[:, None], child_b_xyz, p["xyz"])
    new_rows["log_scales"] = torch.where(split_do[:, None], child_log_scales,
                                         p["log_scales"])
    out = {k: v.clone() for k, v in p.items()}
    for k in PARAM_NAMES:
        out[k][dst] = new_rows[k][src]
    # split originals become child A
    out["xyz"] = torch.where(split_do[:, None], child_a_xyz, out["xyz"])
    out["log_scales"] = torch.where(split_do[:, None], child_log_scales,
                                    out["log_scales"])

    new_alive = alive.clone()
    new_alive[dst] = True
    new_mask = mask.clone()
    new_mask[dst] = mask[src]
    new_generation = scene.generation.clone()
    new_generation[dst] = gen_new
    new_generation = torch.where(split_do, gen_new, new_generation)

    # the accumulators and max radii reset before the prune, so the
    # screen-space prune never fires (as in the reference)
    stats = init_densify_stats(C, dev)

    # --- prune ---
    opacity = opacity_activation(out["opacity_raw"])[:, 0]
    prune = opacity < config.min_opacity
    if config.max_screen_size:
        big_vs = stats.max_radii2d > config.max_screen_size
        big_ws = (torch.max(torch.exp(out["log_scales"]), dim=-1).values
                  > 0.1 * cameras_extent)
        prune = prune | big_vs | big_ws
    prune = prune & new_mask & new_alive
    new_alive = new_alive & ~prune

    for k in PARAM_NAMES:
        getattr(scene, k).copy_(out[k])
    scene.alive.copy_(new_alive)
    scene.mask.copy_(new_mask & new_alive)
    scene.generation.copy_(new_generation)
    scene.update_anchor()
    update_anchor_loss_schedule(scene, anchor_weight_init,
                                anchor_weight_multiplier)

    reset_mask = torch.zeros((C,), dtype=torch.bool, device=dev)
    reset_mask[dst] = True
    reset_mask = reset_mask | split_do | prune
    return DensifyResult(
        scene=scene, stats=stats, reset_mask=reset_mask,
        n_cloned=torch.sum(clone_do.to(torch.int32)),
        n_split=torch.sum(split_do.to(torch.int32)),
        n_pruned=torch.sum(prune.to(torch.int32)),
        n_dropped=n_dropped)


@torch.no_grad()
def reset_opacity(scene: GaussianScene) -> GaussianScene:
    """Clamp the activated opacity to <= 0.01, in place. The caller also
    zeroes the opacity moments (`GaussianAdam.replace_param`)."""
    scene.opacity_raw.copy_(opacity_inverse_activation(
        torch.clamp_max(opacity_activation(scene.opacity_raw), 0.01)))
    return scene
