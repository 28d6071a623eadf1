"""Hierarchical Gaussian Splatting: the anchor (elastic) loss and its
per-generation schedule.

Counterpart of `gaussianeditor_tpu/train/anchors.py`. The schedule lives
in the scene's `anchor_weights` [MAX_GENERATIONS] and `n_generations`
buffers, which `update_anchor_loss_schedule` updates in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from gaussianeditor_tpu_torch.models.gaussians import (
    MAX_ANCHOR_WEIGHT,
    MAX_GENERATIONS,
    GaussianScene,
)


@torch.no_grad()
def update_anchor_loss_schedule(scene: GaussianScene,
                                anchor_weight_init: float,
                                anchor_weight_multiplier: float
                                ) -> GaussianScene:
    """Grow the weights of the existing generations by the multiplier
    (capped at MAX_ANCHOR_WEIGHT), start the previous firstborn at the
    init weight, exempt the new firstborn; in place."""
    n = scene.n_generations
    idx = torch.arange(MAX_GENERATIONS, device=n.device)
    w = scene.anchor_weights
    w = torch.where(idx < n, torch.clamp_max(anchor_weight_multiplier * w,
                                             MAX_ANCHOR_WEIGHT), w)
    w = torch.where((idx == n - 1) & (n > 1),
                    torch.full_like(w, anchor_weight_init), w)
    w = torch.where(idx == n, torch.zeros_like(w), w)
    scene.anchor_weights.copy_(w)
    scene.n_generations.copy_(torch.clamp_max(n + 1, MAX_GENERATIONS - 1))
    return scene


def anchor_loss(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    """Per-element squared distance of the raw parameters from the anchor
    snapshot, weighted by each slot's generation weight, over masked
    alive slots; grouped into color, geo, opacity and scale terms."""
    sel = (scene.mask & scene.alive).to(torch.float32)
    gen = torch.clamp(scene.generation, 0, MAX_GENERATIONS - 1).to(torch.int64)
    w = scene.anchor_weights[gen] * sel
    n_sel = torch.clamp_min(torch.sum(sel), 1.0)

    def term(name):
        cur, ref = getattr(scene, name), getattr(scene, "anchor_" + name)
        feat = 1
        for s in cur.shape[1:]:
            feat *= s
        if feat == 0:  # features_rest at SH degree 0
            return torch.zeros((), dtype=torch.float32, device=cur.device)
        d = (cur - ref) ** 2
        per_row = torch.sum(d.reshape(d.shape[0], -1), dim=-1)
        return torch.sum(per_row * w) / (n_sel * feat)

    return {
        "loss_anchor_color": term("features_dc") + term("features_rest"),
        "loss_anchor_geo": term("xyz") + term("quats"),
        "loss_anchor_opacity": term("opacity_raw"),
        "loss_anchor_scale": term("log_scales"),
    }
