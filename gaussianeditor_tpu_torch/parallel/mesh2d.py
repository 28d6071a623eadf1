"""The 2-D sharded train step: views x tile-row strips on one mesh.

Counterpart of `gaussianeditor_tpu/parallel/mesh2d.py::
make_2d_train_step`. The batch is sharded over the mesh's `view` axis as
in `parallel/sharded_step.py`, and within each view every rank renders
only its strip of tile rows (`parallel/tile_sharded.py::render_strip`)
against its strip of the target. Parameters stay replicated. The loss
is the JAX step's: the strips' L1 sums over B * n_tile; a perceptual
term, when given, on the whole images reassembled on every rank by
`parallel/halo.py::gather_rows` (exact gradients; the loss divided by
n_tile so that the sum over the tile axis counts each view once); the
anchor terms over n_view * n_tile. The gradients, the viewspace
gradient and the loss terms are summed, and the radii, visibility and
`overflow` maxed, over both axes at once (the world group), with the
reductions of `sharded_step.reduce_step`; then the densify statistics and
`GaussianAdam.step` run in place on every rank, which stay bitwise
equal.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES
from gaussianeditor_tpu_torch.ops.preprocess import TILE
from gaussianeditor_tpu_torch.ops.render import default_max_instances
from gaussianeditor_tpu_torch.parallel.halo import gather_rows
from gaussianeditor_tpu_torch.parallel.mesh import axis_index, axis_size
from gaussianeditor_tpu_torch.parallel.sharded_step import (
    anchor_total,
    reduce_step,
)
from gaussianeditor_tpu_torch.parallel.tile_sharded import render_strip
from gaussianeditor_tpu_torch.train.densify import add_densification_stats
from gaussianeditor_tpu_torch.train.losses import l1_loss
from gaussianeditor_tpu_torch.train.optim import GaussianAdam
from gaussianeditor_tpu_torch.train.trainer import LossWeights, TrainState


def make_2d_train_step(optim: GaussianAdam, weights: LossWeights,
                       mesh: DeviceMesh, *, view_axis: str = "view",
                       tile_axis: str = "tile", impl: Optional[str] = None,
                       max_instances: Optional[int] = None,
                       perceptual: Optional[Callable] = None):
    """Build the (view x tile)-sharded train step.

    step(state, cameras [B], targets [B, H, W, 3]) -> (state, metrics),
    `state` updated in place; every rank passes the whole batch and takes
    its views and its strip rows of the targets. The view axis's size
    must divide B, and H must split into the tile axis's size of equal
    strips of whole tiles. perceptual: (pred [H, W, 3], target) ->
    scalar on the whole image. Metrics: loss, loss_l1, loss_p, overflow
    and the anchor terms. The mesh must span every rank."""
    n_view = axis_size(mesh, view_axis)
    n_tile = axis_size(mesh, tile_axis)
    if n_view * n_tile != dist.get_world_size():
        raise ValueError("the 2-D mesh must span every rank")
    tile_group = mesh.get_group(tile_axis)
    strip_impl = "pallas" if impl is None else impl

    def step(state: TrainState, cameras: Sequence[Camera],
             targets: torch.Tensor
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        scene = state.scene
        C = scene.capacity
        dev = scene.device
        B, H = targets.shape[0], targets.shape[1]
        gy = (H + TILE - 1) // TILE
        if B % n_view:
            raise ValueError(f"batch {B} not divisible by {n_view} view "
                             "ranks")
        if gy % n_tile or H != gy * TILE:
            raise ValueError(f"{H} rows do not split into {n_tile} strips of "
                             "whole tiles")
        b_local, gy_local = B // n_view, gy // n_tile
        hs = gy_local * TILE
        v, t = axis_index(mesh, view_axis), axis_index(mesh, tile_axis)
        ty0 = t * gy_local
        views = range(v * b_local, (v + 1) * b_local)
        budget = (default_max_instances(C) if max_instances is None
                  else max_instances)
        params = [getattr(scene, k) for k in PARAM_NAMES]
        offsets = torch.zeros((b_local, C, 2), dtype=torch.float32,
                              device=dev, requires_grad=True)

        radii_max = torch.zeros((C,), dtype=torch.int32, device=dev)
        vis_any = torch.zeros((C,), dtype=torch.bool, device=dev)
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        l1 = torch.zeros((), dtype=torch.float32, device=dev)
        lp = torch.zeros((), dtype=torch.float32, device=dev)
        for j, b in enumerate(views):
            out = render_strip(scene, cameras[b], ty0, gy_local,
                               max_instances=budget, impl=strip_impl,
                               mean2d_offset_ndc=offsets[j])
            tgt = targets[b, ty0 * TILE:ty0 * TILE + hs]
            l1 = l1 + l1_loss(out.color, tgt)
            if perceptual is not None:
                lp = lp + perceptual(gather_rows(out.color, tile_group),
                                     gather_rows(tgt, tile_group))
            radii_max = torch.maximum(radii_max, out.radii)
            vis_any = vis_any | out.visible
            ovf = ovf | out.overflow
        local = (weights.lambda_l1 * l1 / (B * n_tile)
                 + weights.lambda_p * lp / (B * n_tile))
        anchor_sum, anchors = anchor_total(scene, weights)
        if anchors:
            local = local + anchor_sum / (n_view * n_tile)
        *g_params, g_off = torch.autograd.grad(local, params + [offsets])

        with torch.no_grad():
            grads, vgrad, (total, l1_all, lp_all), radii, flags = \
                reduce_step(dict(zip(PARAM_NAMES, g_params)), g_off,
                            (local, l1, lp), radii_max,
                            torch.cat([vis_any, ovf[None]]), None)
            vnorm = torch.linalg.vector_norm(vgrad, dim=-1)
            state.stats = add_densification_stats(state.stats, vnorm, radii,
                                                  flags[:C])
            optim.step(scene.params(), grads, state.opt_state,
                       grad_mask=scene.mask, step_override=state.step)
        state.step += 1
        norm = B * n_tile
        metrics = {"loss": total, "loss_l1": l1_all / norm,
                   "loss_p": lp_all / norm, "overflow": flags[C],
                   **{k: v.detach() for k, v in anchors.items()}}
        return state, metrics

    return step
