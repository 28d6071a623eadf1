"""Semantic tracing: lift 2D segmentation masks to per-Gaussian labels.

Counterpart of `gaussianeditor_tpu/edit/tracing.py`
(`accumulate_view_weights`, `update_mask_from_views`, `trace_from_click`):
per view, the 2D mask is splatted onto per-Gaussian weight and count
accumulators with `ops.apply_weights`, normalised by the count,
thresholded, and installed as the scene's semantic mask (which gates
gradients and densification).

The port's only overflow is the instance budget's, so a view that
overflows is run again at double `max_instances` (the JAX package
doubles its tile cap). `update_mask_from_views` writes the mask into the
scene it is given, in place, as the port's `set_mask` does; a caller that
must keep its scene passes a copy. `trace_from_click` (the viewer's click
prompt) lifts one click to a 3D point through the rendered depth and
seeds a point-prompted segmentor in every view that sees it.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.ops.apply_weights import apply_weights
from gaussianeditor_tpu_torch.ops.render import default_max_instances, render
from gaussianeditor_tpu_torch.utils.camera_math import project, unproject


def accumulate_view_weights(
    scene,
    cameras: Sequence[Camera],
    masks: Sequence,  # each [H, W] (or [H, W, 1]) in [0, 1], numpy or torch
    *,
    max_instances: Optional[int] = None,
    tile_cap: int = 1024,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the apply_weights accumulation over a set of views, on the
    scene's device. Returns (weights [C, 1], counts [C] int32).

    A view whose budget overflows is run again at double max_instances
    (at most three times), so no contributor is lost silently."""
    C = scene.capacity
    dev = scene.device
    if max_instances is None:
        max_instances = default_max_instances(C)
    weights = torch.zeros((C, 1), dtype=torch.float32, device=dev)
    cnt = torch.zeros((C,), dtype=torch.int32, device=dev)
    for cam, mask in zip(cameras, masks):
        m = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        if m.dim() == 2:
            m = m[..., None]
        budget = max_instances
        for attempt in range(4):
            w2, c2, over = apply_weights(scene, cam, m, weights, cnt,
                                         max_instances=budget,
                                         tile_cap=tile_cap, chunk=chunk)
            if not bool(over) or attempt == 3:
                if attempt == 3:
                    warnings.warn("apply_weights overflow persisted after "
                                  "retries; mask lifting may be incomplete")
                weights, cnt = w2, c2
                break
            warnings.warn(
                f"apply_weights instance overflow at max_instances={budget}; "
                "retrying at doubled capacity"
            )
            budget *= 2
    return weights, cnt


def update_mask_from_views(
    scene,
    cameras: Sequence[Camera],
    masks: Sequence,
    mask_thres: float = 0.5,
    *,
    max_instances: Optional[int] = None,
    tile_cap: int = 1024,
    chunk: int = 128,
):
    """Accumulate, normalise, threshold and install the mask:
    selected = weights / (cnt + 1e-7) > mask_thres on alive slots. The
    mask is written into `scene` in place.
    Returns (scene, normalized_weights [C])."""
    weights, cnt = accumulate_view_weights(
        scene, cameras, masks, max_instances=max_instances,
        tile_cap=tile_cap, chunk=chunk,
    )
    norm = weights[:, 0] / (cnt.to(torch.float32) + 1e-7)
    selected = (norm > mask_thres) & scene.alive
    scene.set_mask(selected)
    return scene, norm


def trace_from_click(
    scene,
    cameras: Sequence[Camera],
    click_view: int,
    click_xy,
    point_segmentor: Callable,
    mask_thres: float = 0.5,
    *,
    render_fn: Optional[Callable] = None,
    max_instances: Optional[int] = None,
    tile_cap: int = 1024,
    chunk: int = 128,
):
    """Click-prompt tracing (the reference's webui.py:890-958): unproject
    the click (x, y) through the rendered depth of view `click_view`,
    project the 3D point into every view, run the point-prompted
    segmentor on each view that sees it (in front of the camera and
    inside the image; the others get an empty mask), and lift the masks
    with `update_mask_from_views`.

    point_segmentor: (image [H, W, 3], points [N, 2]) -> [H, W] mask, the
    SAM point-predictor protocol. render_fn: (scene, camera) ->
    RenderOutput; by default `render` through the default route on the
    scene's device. The mask is written into `scene` in place; a caller
    that must keep its scene passes a copy.
    Returns (scene, normalized_weights [C])."""
    if render_fn is None:
        def render_fn(s, c):
            with torch.no_grad():
                return render(s, c, max_instances=max_instances)

    clicked = render_fn(scene, cameras[click_view])
    pt3d = unproject(cameras[click_view], np.asarray([click_xy], np.float32),
                     clicked.depth.detach().cpu().numpy())

    masks = []
    for i, cam in enumerate(cameras):
        pix, z = project(cam, pt3d)
        in_view = (0 <= pix[0, 0] < cam.width and 0 <= pix[0, 1] < cam.height
                   and z[0] > 0)
        if in_view:
            out = clicked if i == click_view else render_fn(scene, cam)
            masks.append(point_segmentor(out.color.detach().cpu().numpy(),
                                         pix))
        else:
            masks.append(np.zeros((cam.height, cam.width), np.float32))
    return update_mask_from_views(scene, cameras, masks, mask_thres,
                                  max_instances=max_instances,
                                  tile_cap=tile_cap, chunk=chunk)
