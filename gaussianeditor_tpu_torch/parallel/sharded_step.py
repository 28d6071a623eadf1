"""The view-sharded (data-parallel) edit train step.

Counterpart of `gaussianeditor_tpu/parallel/sharded_step.py::
make_sharded_train_step`. Every rank holds the whole scene and the whole
batch; rank r of the mesh's `axis` renders and differentiates its own
views [r*B/n, (r+1)*B/n). The loss terms are the JAX step's: the L1 and
perceptual sums over the local views divided by the global batch, the
anchor terms divided by n (each rank holds the same copy). Then, over
the axis's group:
  * one `all_reduce(SUM)` of a flat float32 buffer: the parameter
    gradients, the summed viewspace-probe gradient [C, 2], the local
    total and the L1 and perceptual sums;
  * one `all_reduce(MAX)` of an int32 buffer: the radii and visibility
    (NCCL has no bool).
`add_densification_stats` and `GaussianAdam.step` then run on every rank
on the same reduced values, in place as in `train/trainer.py::
make_train_step`, so the ranks' parameters stay bitwise equal and need no
broadcast; densification decisions do not depend on the rank count.

Under gloo on CUDA tensors the two reductions go through the host (the
backend's transport): at 4M slots the float buffer is about 0.94 GB.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.parallel.mesh import axis_index, axis_size
from gaussianeditor_tpu_torch.train.anchors import anchor_loss
from gaussianeditor_tpu_torch.train.densify import add_densification_stats
from gaussianeditor_tpu_torch.train.losses import l1_loss
from gaussianeditor_tpu_torch.train.optim import GaussianAdam
from gaussianeditor_tpu_torch.train.trainer import (
    _ANCHOR_WEIGHTS,
    LossWeights,
    TrainState,
)


def anchor_total(scene, weights: LossWeights):
    """(the weighted sum of the four anchor terms, the terms by metric
    name); (0, {}) when the four weights are 0, as `make_train_step`
    skips them."""
    ws = [getattr(weights, f) for f in _ANCHOR_WEIGHTS]
    if not any(w != 0.0 for w in ws):
        return 0.0, {}
    anchors = anchor_loss(scene)
    total = sum(w * anchors["loss_" + f[len("lambda_"):]]
                for w, f in zip(ws, _ANCHOR_WEIGHTS))
    return total, anchors


def reduce_step(g: Dict[str, torch.Tensor], g_off: torch.Tensor,
                scalars: Sequence[torch.Tensor], radii: torch.Tensor,
                flags: torch.Tensor, group):
    """The step's two reductions over `group`: SUM of the gradients, of
    the viewspace gradient summed over the local views and of `scalars`
    (one flat float32 buffer), MAX of the radii [C] and OR of the bool
    `flags` (visibility, and what else the caller ORs; one int32
    buffer). Returns (gradients, viewspace gradient [C, 2], scalars,
    radii, flags)."""
    C = radii.shape[0]
    parts = [g[k].reshape(-1) for k in PARAM_NAMES]
    parts += [g_off.sum(dim=0).reshape(-1),
              torch.stack([s.detach().reshape(()) for s in scalars])]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    out, o = {}, 0
    for k in PARAM_NAMES:
        n = g[k].numel()
        out[k] = flat[o:o + n].view_as(g[k])
        o += n
    vgrad = flat[o:o + 2 * C].view(C, 2)
    sums = flat[o + 2 * C:]
    imax = torch.cat([radii.to(torch.int32), flags.to(torch.int32)])
    dist.all_reduce(imax, op=dist.ReduceOp.MAX, group=group)
    return out, vgrad, list(sums), imax[:C], imax[C:] > 0


def make_sharded_train_step(optim: GaussianAdam, weights: LossWeights,
                            mesh: DeviceMesh, *, axis: str = "data",
                            perceptual: Optional[Callable] = None,
                            impl: Optional[str] = None,
                            max_instances: Optional[int] = None,
                            tile_cap: int = 1024, chunk: int = 128):
    """Build the view-sharded train step.

    step(state, cameras [B], targets [B, H, W, 3]) -> (state, metrics),
    `state` updated in place; every rank passes the whole batch, and the
    mesh's `axis` size must divide B. Metrics: loss, loss_l1, loss_p and
    the anchor terms (0-dim tensors, the same on every rank). impl, the
    render route; tile_cap and chunk are accepted and ignored, as
    `render` ignores them."""
    n_dev = axis_size(mesh, axis)
    group = mesh.get_group(axis)

    def step(state: TrainState, cameras: Sequence[Camera],
             targets: torch.Tensor
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        scene = state.scene
        C = scene.capacity
        dev = scene.device
        B = targets.shape[0]
        if B % n_dev:
            raise ValueError(f"batch {B} not divisible by {n_dev} ranks")
        b_local = B // n_dev
        r = axis_index(mesh, axis)
        views = range(r * b_local, (r + 1) * b_local)
        params = [getattr(scene, k) for k in PARAM_NAMES]
        offsets = torch.zeros((b_local, C, 2), dtype=torch.float32,
                              device=dev, requires_grad=True)
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)

        radii_max = torch.zeros((C,), dtype=torch.int32, device=dev)
        vis_any = torch.zeros((C,), dtype=torch.bool, device=dev)
        l1 = torch.zeros((), dtype=torch.float32, device=dev)
        lp = torch.zeros((), dtype=torch.float32, device=dev)
        for j, b in enumerate(views):
            out = render(scene, cameras[b], bg, mean2d_offset_ndc=offsets[j],
                         impl=impl, max_instances=max_instances)
            l1 = l1 + l1_loss(out.color, targets[b])
            if perceptual is not None:
                lp = lp + perceptual(out.color, targets[b])
            radii_max = torch.maximum(radii_max, out.radii)
            vis_any = vis_any | out.visible
        local = (weights.lambda_l1 * l1 + weights.lambda_p * lp) / B
        anchor_sum, anchors = anchor_total(scene, weights)
        if anchors:
            local = local + anchor_sum / n_dev
        *g_params, g_off = torch.autograd.grad(local, params + [offsets])

        with torch.no_grad():
            grads, vgrad, (total, l1_all, lp_all), radii, vis = reduce_step(
                dict(zip(PARAM_NAMES, g_params)), g_off, (local, l1, lp),
                radii_max, vis_any, group)
            vnorm = torch.linalg.vector_norm(vgrad, dim=-1)
            state.stats = add_densification_stats(state.stats, vnorm, radii,
                                                  vis)
            optim.step(scene.params(), grads, state.opt_state,
                       grad_mask=scene.mask, step_override=state.step)
        state.step += 1
        metrics = {"loss": total, "loss_l1": l1_all / B, "loss_p": lp_all / B,
                   **{k: v.detach() for k, v in anchors.items()}}
        return state, metrics

    return step
