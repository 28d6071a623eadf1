"""Add system: insert a generated object into the scene.

Counterpart of `gaussianeditor_tpu/edit/add_system.py` (the reference's
`threestudio/systems/GassuianEditorAdd.py:43-281`): render an anchor
view, inpaint the target bbox, make an object from the inpainted crop
(the reference shells out to Wonder3D, NeuS and train_from_mesh; here an
`ObjectGenerator` adapter), place it at a depth aligned against the
rendered scene depth (a*depth + b by least squares over non-object
pixels, :197-230), rigidly in world coordinates (:239-276), and merge it
with `concat_scenes` (the mask marks only the object). A refinement is
then `fit` with a guidance set on the system, as the JAX CLI runs it.

`run()` builds a new merged scene; the caller's scene is not changed.
The geometry (depth alignment, placement) is host numpy, as in the JAX
package; the placed parameters are written back on the object's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.core.transforms import (
    default_model_rotation,
    quat_multiply,
    rotmat_to_quat,
)
from gaussianeditor_tpu_torch.edit.edit_system import EditConfig, EditSystem
from gaussianeditor_tpu_torch.guidance.base import Inpainter
from gaussianeditor_tpu_torch.models.gaussians import (
    GaussianScene,
    concat_scenes,
)
from gaussianeditor_tpu_torch.ops.render import render


@runtime_checkable
class ObjectGenerator(Protocol):
    """image (RGBA or RGB) -> object GaussianScene in its canonical frame.

    Stands in for the reference's three subprocesses (Wonder3D ->
    instant-nsr-pl -> train_from_mesh; GassuianEditorAdd.py:121-157)."""

    def __call__(self, image: np.ndarray, prompt: str) -> GaussianScene:
        ...


@runtime_checkable
class DepthEstimator(Protocol):
    """Monocular depth (the reference's DPT, utils/dpt.py)."""

    def __call__(self, image: np.ndarray) -> np.ndarray:
        ...


@dataclasses.dataclass
class AddConfig(EditConfig):
    inpaint_prompt: str = ""
    refine_steps: int = 0       # post-concat refinement of the new object
    bbox: Tuple[int, int, int, int] = (0, 0, 0, 0)  # x0, y0, x1, y1 pixels
    anchor_view_id: int = 0


def align_depth_scale(
    est_depth: np.ndarray,       # [H, W] monocular estimate
    rendered_depth: np.ndarray,  # [H, W] scene depth from the renderer
    object_mask: np.ndarray,     # [H, W] bool: pixels of the new object
) -> Tuple[float, float]:
    """(a, b) of est * a + b ~= rendered, by float64 least squares over
    the non-object pixels with a rendered depth, restricted to the depth
    band around the object (GassuianEditorAdd.py:197-230)."""
    obj = object_mask > 0.5
    bgm = (~obj) & (rendered_depth > 0)
    if obj.any():
        lo, hi = np.quantile(est_depth[obj], [0.05, 0.95])
        band = (est_depth >= lo - (hi - lo)) & (est_depth <= hi + (hi - lo))
        bgm = bgm & band
    x = est_depth[bgm].astype(np.float64)
    y = rendered_depth[bgm].astype(np.float64)
    if x.size < 2:
        return 1.0, 0.0
    A = np.stack([x, np.ones_like(x)], axis=1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(sol[0]), float(sol[1])


@torch.no_grad()
def place_object_in_scene(
    obj: GaussianScene,
    camera: Camera,
    bbox: Tuple[int, int, int, int],
    depth: float,
) -> GaussianScene:
    """Place a canonical-frame object, in place, so that it lands in the
    camera's bbox at camera-space `depth` (GassuianEditorAdd.py:239-276):
    centre it, rotate it by the canonical-to-scene rotation and the
    camera's, scale it to the bbox * depth / focal, and move it to the
    bbox centre unprojected at `depth`. Returns `obj`."""
    xyz = obj.xyz.cpu().numpy()
    center = xyz.mean(axis=0)
    xyz = xyz - center

    R_default = default_model_rotation()
    W = camera.world_view.cpu().numpy()
    R_c2w = np.linalg.inv(W)[:3, :3]
    R = R_c2w @ R_default

    x0, y0, x1, y1 = bbox
    fx = float(camera.focal_x)
    fy = float(camera.focal_y)
    extent = max(abs(xyz).max(), 1e-6)
    target_size = 0.5 * ((x1 - x0) / fx + (y1 - y0) / fy) * depth
    s = target_size / (2.0 * extent)

    # the bbox centre unprojected at `depth`
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    ndc_x = (2.0 * cx + 1.0) / camera.width - 1.0
    ndc_y = (2.0 * cy + 1.0) / camera.height - 1.0
    cam_pt = np.array(
        [ndc_x * float(camera.tan_fovx) * depth,
         ndc_y * float(camera.tan_fovy) * depth,
         depth, 1.0])
    world_pt = (np.linalg.inv(W) @ cam_pt)[:3]

    dev = obj.device
    new_xyz = (s * (xyz @ R.T)) + world_pt
    new_log_scales = obj.log_scales.cpu().numpy() + np.log(s)
    rot_quat = torch.as_tensor(rotmat_to_quat(R), device=dev)
    obj.xyz.copy_(torch.as_tensor(np.asarray(new_xyz, np.float32),
                                  device=dev))
    obj.log_scales.copy_(torch.as_tensor(
        np.asarray(new_log_scales, np.float32), device=dev))
    obj.quats.copy_(quat_multiply(rot_quat[None], obj.quats))
    return obj


class AddSystem(EditSystem):
    def __init__(
        self,
        scene: GaussianScene,
        cameras: Sequence[Camera],
        config: AddConfig,
        inpainter: Inpainter,
        object_generator: ObjectGenerator,
        depth_estimator: Optional[DepthEstimator] = None,
        perceptual=None,
    ):
        super().__init__(scene, cameras, config, guidance=None,
                         perceptual=perceptual)
        self.inpainter = inpainter
        self.object_generator = object_generator
        self.depth_estimator = depth_estimator

    def run(self) -> GaussianScene:
        """The one-shot Add pipeline; returns the merged scene, which
        becomes `self.scene` (a new scene: the caller's is unchanged)."""
        cfg: AddConfig = self.cfg
        cam = self.cameras[cfg.anchor_view_id]
        dev = self.scene.device
        with torch.no_grad():
            out = render(self.scene, cam, torch.zeros(3, device=dev),
                         impl="tiled", max_instances=cfg.max_instances)
        rgb = out.color.cpu().numpy()
        rendered_depth = out.depth.cpu().numpy()

        x0, y0, x1, y1 = cfg.bbox
        bbox_mask = np.zeros(rgb.shape[:2], np.float32)
        bbox_mask[y0:y1, x0:x1] = 1.0
        inpainted = self.inpainter(rgb, bbox_mask, cfg.inpaint_prompt)

        obj = self.object_generator(inpainted[y0:y1, x0:x1],
                                    cfg.inpaint_prompt)

        # the object's depth: the monocular estimate aligned to the scene
        # depth, else the median scene depth in the bbox
        if self.depth_estimator is not None:
            est = self.depth_estimator(inpainted)
            a, b = align_depth_scale(est, rendered_depth, bbox_mask > 0.5)
            obj_depth = float(np.median(est[y0:y1, x0:x1]) * a + b)
        else:
            region = rendered_depth[y0:y1, x0:x1]
            valid = region[region > 0]
            obj_depth = float(np.median(valid)) if valid.size else 1.0

        placed = place_object_in_scene(obj, cam, cfg.bbox, obj_depth)
        self.scene = concat_scenes(self.scene, placed)
        return self.scene
