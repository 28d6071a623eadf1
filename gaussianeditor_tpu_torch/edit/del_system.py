"""Delete system: remove a traced object and inpaint the hole.

Counterpart of `gaussianeditor_tpu/edit/del_system.py` (`DelConfig`,
`near_gaussians_by_mask`, `DelSystem`; the reference's
`threestudio/systems/GassuianEditorDel.py`). `on_fit_start` traces the
object, finds the shell of surviving Gaussians near it
(`near_gaussians_by_mask`, gaussian_model.py:865-898), prunes the object
and re-targets the mask to the shell (`prune_with_mask`, :206-214),
renders each view's hole mask (dilated and filled, :131-157), inpaints
each view once, and the fit trains the shell against the inpainted
targets with the L1, perceptual and anchor losses (:159-210).

The port's scene changes in place, so every step of the pruning acts on
the system's own copy (the tracing's, as in `EditSystem.update_mask`):
the caller's scene stays as it was. Renders go through the 'tiled'
route, as in the JAX system; the mask render has one channel, so it runs
kernels B1 and B2.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.edit.edit_system import EditConfig, EditSystem
from gaussianeditor_tpu_torch.guidance.base import Inpainter, Segmentor
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.knn import k_nearest_neighbors
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.train.optim import OptimConfig
from gaussianeditor_tpu_torch.train.trainer import init_train_state
from gaussianeditor_tpu_torch.utils.masks import dilate_mask, fill_closed_areas


@dataclasses.dataclass
class DelConfig(EditConfig):
    """GassuianEditorDel.Config (:17-21)."""

    fix_holes: bool = True
    mask_dilate: int = 5
    inpaint_scale: float = 0.25
    inpaint_prompt: str = ""


def near_gaussians_by_mask(
    xyz: np.ndarray, mask: np.ndarray, alive: np.ndarray, dist_thresh: float
) -> np.ndarray:
    """Full-capacity boolean mask of the unmasked alive Gaussians within
    `dist_thresh` of the masked object, restricted to the object's
    3%..97%-quantile bbox expanded 1.3x (gaussian_model.py:865-898).
    Host-side numpy and scipy."""
    mask = np.asarray(mask) & np.asarray(alive)
    remaining = (~mask) & np.asarray(alive)
    obj = xyz[mask]
    out = np.zeros(xyz.shape[0], dtype=bool)
    if obj.shape[0] == 0 or remaining.sum() == 0:
        return out
    lo = np.quantile(obj, 0.03, axis=0)
    hi = np.quantile(obj, 0.97, axis=0)
    mid, scale = (hi + lo) / 2, (hi - lo) * 1.3
    lo, hi = mid - scale / 2, mid + scale / 2
    rem_idx = np.nonzero(remaining)[0]
    rem_xyz = xyz[rem_idx]
    in_bbox = np.all((rem_xyz >= lo) & (rem_xyz <= hi), axis=1)
    cand_idx = rem_idx[in_bbox]
    if cand_idx.size == 0:
        return out
    dists, _ = k_nearest_neighbors(obj, xyz[cand_idx], k=1)
    out[cand_idx[dists[:, 0] <= dist_thresh]] = True
    return out


class DelSystem(EditSystem):
    def __init__(
        self,
        scene: GaussianScene,
        cameras: Sequence[Camera],
        config: DelConfig,
        inpainter: Inpainter,
        segmentor: Segmentor,
        perceptual="auto",
    ):
        super().__init__(scene, cameras, config, guidance=None,
                         segmentor=segmentor, perceptual=perceptual)
        self.inpainter = inpainter

    @torch.no_grad()
    def _mask_render(self, scene, cam: Camera) -> torch.Tensor:
        """The semantic mask rendered as a 1-channel image [H, W]."""
        dev = scene.device
        return render(
            scene, cam, torch.zeros(1, device=dev),
            override_color=scene.mask[:, None].to(torch.float32),
            impl="tiled", max_instances=self.cfg.max_instances,
        ).color[..., 0]

    def render_view_masks(self) -> Dict[int, np.ndarray]:
        """Each view's hole mask from the pruned scene: the shell's render
        thresholded at 0.5, dilated, and filled (render_all_view_with_mask,
        GassuianEditorDel.py:131-157)."""
        out = {}
        for i, cam in enumerate(self.cameras):
            m = self._mask_render(self.scene, cam).cpu().numpy()
            m = (m > 0.5).astype(np.float32)
            m = dilate_mask(m, self.cfg.mask_dilate)
            if self.cfg.fix_holes:
                m = fill_closed_areas(m)
            out[i] = m
        return out

    def on_fit_start(self) -> None:
        if not self.cfg.seg_prompt:
            raise ValueError("Delete requires system.seg_prompt")
        self.render_all_views()
        self.update_mask()   # self.scene is now the system's own copy

        # the shell: surviving Gaussians near the object
        # (GassuianEditorDel.py:45-56)
        dist_thres = (self.cfg.inpaint_scale * self.cfg.cameras_extent
                      * OptimConfig().percent_dense)
        scene = self.scene
        shell = near_gaussians_by_mask(
            scene.xyz.detach().cpu().numpy(), scene.mask.cpu().numpy(),
            scene.alive.cpu().numpy(), dist_thres)
        # prune_with_mask(new_mask=shell) (gaussian_model.py:206-214):
        # delete the object, re-target the mask, refresh the anchor
        with torch.no_grad():
            scene.alive &= ~scene.mask
            scene.set_mask(torch.as_tensor(shell, device=scene.device)
                           & scene.alive)
        scene.update_anchor()

        # per-view inpainting, once (GassuianEditorDel.py:68-129)
        view_masks = self.render_view_masks()
        self.origin_frames = {}
        self.render_all_views()  # the pruned scene's renders
        for i in range(len(self.cameras)):
            self.edit_frames[i] = np.asarray(
                self.inpainter(self.origin_frames[i], view_masks[i],
                               self.cfg.inpaint_prompt),
                np.float32)
        self.state = init_train_state(copy.deepcopy(scene), self.optim)

    def _refresh_targets(self, view_ids, step) -> None:
        # the inpainted targets are fixed after on_fit_start
        pass
