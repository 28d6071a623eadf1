"""The edit train step and the densify step.

Counterpart of `gaussianeditor_tpu/train/trainer.py` (`LossWeights`,
`TrainState`, `init_train_state`, `make_train_step`, `make_densify_step`).
One train step renders each view of the batch (views unrolled, as the
JAX step does), takes the photometric, perceptual and anchor losses and
an optional injected score gradient, differentiates them with autograd,
accumulates the viewspace gradient statistics for densification, and
applies `GaussianAdam` with the semantic mask. The viewspace gradient is
the gradient of a zero [B, C, 2] NDC offset that requires grad.

The state is updated in place: parameters and moments by the optimizer,
the statistics and the step counter by the step; `TrainState.clone()`
copies it. The host waits for the device several times a view: each
render reads `num_rendered` and copies two scalars to the device, and
LPIPS copies its constants (`utils/profiling.py`'s `host_syncs` counts
each wait by site). The JAX package's burst dispatcher
(`make_multi_train_step`) and its `batched=True` route have no
counterpart here.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES, GaussianScene
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.train.anchors import anchor_loss
from gaussianeditor_tpu_torch.train.densify import (
    DensifyConfig,
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    init_densify_stats,
)
from gaussianeditor_tpu_torch.train.losses import l1_loss
from gaussianeditor_tpu_torch.train.optim import AdamState, GaussianAdam
from gaussianeditor_tpu_torch.utils.profiling import add_h2d_bytes, span


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The reference's loss block (configs/edit.yaml)."""

    lambda_l1: float = 10.0
    lambda_p: float = 10.0
    lambda_anchor_color: float = 5.0
    lambda_anchor_geo: float = 50.0
    lambda_anchor_scale: float = 50.0
    lambda_anchor_opacity: float = 50.0
    # score-distillation weights; nonzero values go with `with_inject`
    lambda_sds: float = 0.0
    lambda_dds: float = 0.0


@dataclasses.dataclass
class TrainState:
    scene: GaussianScene
    opt_state: AdamState
    stats: DensifyStats
    step: int

    def clone(self) -> "TrainState":
        return TrainState(scene=copy.deepcopy(self.scene),
                          opt_state=self.opt_state.clone(),
                          stats=self.stats.clone(), step=self.step)


def init_train_state(scene: GaussianScene, optim: GaussianAdam) -> TrainState:
    return TrainState(scene=scene, opt_state=optim.init(scene.params()),
                      stats=init_densify_stats(scene.capacity, scene.device),
                      step=0)


def upload_images(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host images onto `device`; onto a card from pinned memory without
    waiting for the device (the caching host allocator keeps the pinned
    buffer until the copy has run)."""
    t = torch.from_numpy(images)
    add_h2d_bytes(t.numel() * t.element_size())
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_ANCHOR_WEIGHTS = ("lambda_anchor_color", "lambda_anchor_geo",
                   "lambda_anchor_scale", "lambda_anchor_opacity")


def make_train_step(optim: GaussianAdam, weights: LossWeights, *,
                    perceptual: Optional[Callable] = None,
                    local_edit: bool = False, with_inject: bool = False,
                    impl: Optional[str] = None,
                    max_instances: Optional[int] = None):
    """Build the edit train step.

    train_step(state, cameras [B], targets [B, H, W, 3], weights=...,
    inject_grad=None) -> (state, metrics), `state` updated in place and
    the metrics 0-dim device tensors. perceptual: (pred [H,W,3], target
    [H,W,3]) -> scalar. with_inject: `inject_grad` [B, H, W, 3] is a
    precomputed score-distillation image gradient, already weighted; the
    step adds sum(render * inject_grad) to the loss, so its gradient
    flows into the parameters. impl: the render route (`render`'s `impl`).
    When the four anchor weights of a call are all 0 (reconstruction, the
    mesh fit), the step skips the anchor terms and their metrics.
    grads: when a dict is passed, it receives the step's parameter
    gradients (before the mask)."""

    def train_step(state: TrainState, cameras: Sequence[Camera],
                   targets: torch.Tensor, weights: LossWeights = weights,
                   inject_grad: Optional[torch.Tensor] = None,
                   grads: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        scene = state.scene
        C = scene.capacity
        B = targets.shape[0]
        dev = scene.device
        s = scene.localized() if local_edit else scene
        params = [getattr(scene, k) for k in PARAM_NAMES]
        offsets = torch.zeros((B, C, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)

        radii_max = torch.zeros((C,), dtype=torch.int32, device=dev)
        vis_any = torch.zeros((C,), dtype=torch.bool, device=dev)
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        l1s, lps, injs = [], [], []
        for b in range(B):
            out = render(s, cameras[b], bg, mean2d_offset_ndc=offsets[b],
                         impl=impl, max_instances=max_instances)
            with span("train.loss"):
                l1s.append(l1_loss(out.color, targets[b]))
                if perceptual is not None:
                    lps.append(perceptual(out.color, targets[b]))
                if with_inject:
                    injs.append(torch.sum(out.color
                                          * inject_grad[b].detach()))
            radii_max = torch.maximum(radii_max, out.radii)
            vis_any = vis_any | out.visible
            ovf = ovf | out.overflow
        loss_l1 = torch.mean(torch.stack(l1s))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss_p = torch.mean(torch.stack(lps)) if lps else zero
        loss_inject = torch.sum(torch.stack(injs)) if injs else zero

        total = weights.lambda_l1 * loss_l1 + weights.lambda_p * loss_p
        anchors = {}
        if any(getattr(weights, f) != 0.0 for f in _ANCHOR_WEIGHTS):
            with span("train.anchors"):
                anchors = anchor_loss(s)
                for f in _ANCHOR_WEIGHTS:
                    total = total + getattr(weights, f) * anchors[
                        "loss_" + f[len("lambda_"):]]
        total = total + loss_inject
        with span("train.backward"):
            *g_params, g_off = torch.autograd.grad(total,
                                                   params + [offsets])
        g = dict(zip(PARAM_NAMES, g_params))
        if grads is not None:
            grads.update(g)

        with torch.no_grad(), span("train.optim"):
            # viewspace gradient: summed over the views, then its xy norm
            vnorm = torch.linalg.vector_norm(g_off.sum(dim=0), dim=-1)
            state.stats = add_densification_stats(state.stats, vnorm,
                                                  radii_max, vis_any)
            optim.step(scene.params(), g, state.opt_state,
                       grad_mask=scene.mask, step_override=state.step)
        state.step += 1
        metrics = {
            "loss": total.detach(),
            "loss_l1": loss_l1.detach(),
            "loss_p": loss_p.detach(),
            "loss_inject": loss_inject.detach(),
            # the budget's overflow: the caller re-renders at a larger
            # max_instances (see ops/render.render_safe)
            "overflow": ovf,
            **{k: v.detach() for k, v in anchors.items()},
        }
        return state, metrics

    return train_step


def make_densify_step(optim: GaussianAdam, config: DensifyConfig,
                      cameras_extent: float, anchor_weight_init: float,
                      anchor_weight_multiplier: float):
    """densify_step(state, generator=None, noise=None) -> (state, info):
    densify and prune in place, then zero the moments of every slot that
    was written or pruned."""

    def densify_step(state: TrainState,
                     generator: Optional[torch.Generator] = None,
                     noise=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        res = densify_and_prune(state.scene, state.stats, config,
                                cameras_extent, anchor_weight_init,
                                anchor_weight_multiplier,
                                generator=generator, noise=noise)
        optim.reset_slots(state.opt_state, res.reset_mask)
        state.stats = res.stats
        info = {"n_cloned": res.n_cloned, "n_split": res.n_split,
                "n_pruned": res.n_pruned, "n_dropped": res.n_dropped}
        return state, info

    return densify_step
