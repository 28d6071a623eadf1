"""Project and unproject points for click-prompt tracing.

Counterpart of `gaussianeditor_tpu/utils/camera_math.py` (`project`,
`unproject`; the reference's `threestudio/utils/camera.py:71-150`): a 2D
click and the rendered depth lift to a 3D point, which is projected into
the other views to seed their point prompts. Host-side numpy over the
port's `Camera`, whose tensors are read with `.cpu().numpy()`; the
arithmetic is the JAX package's, in float32 with its `+ 1e-7` on w.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gaussianeditor_tpu_torch.core.cameras import Camera


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def project(camera: Camera, points: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 3] world points -> ([N, 2] pixel coords (x, y), [N] depth)."""
    points = np.asarray(points, np.float32)
    ones = np.ones((points.shape[0], 1), np.float32)
    p_hom = np.concatenate([points, ones], axis=1) @ _host(camera.full_proj).T
    w = p_hom[:, 3:4] + 1e-7
    ndc = p_hom[:, :2] / w
    x = ((ndc[:, 0] + 1) * camera.width - 1) * 0.5
    y = ((ndc[:, 1] + 1) * camera.height - 1) * 0.5
    world_view = _host(camera.world_view)
    depth = points @ world_view[2, :3] + float(world_view[2, 3])
    return np.stack([x, y], axis=1), depth


def unproject(camera: Camera, pixels: np.ndarray,
              depth_map: np.ndarray) -> np.ndarray:
    """[N, 2] pixel coords and a rendered depth map [H, W] -> [N, 3] world
    points at the rendered depth. The depth is read at the integer pixel
    (a pixel no Gaussian covers has depth 0, so its point lands at the
    camera, as in the JAX package)."""
    pixels = np.asarray(pixels)
    px = np.clip(pixels[:, 0].astype(int), 0, camera.width - 1)
    py = np.clip(pixels[:, 1].astype(int), 0, camera.height - 1)
    z = np.asarray(depth_map)[py, px]

    ndc_x = (2.0 * pixels[:, 0] + 1.0) / camera.width - 1.0
    ndc_y = (2.0 * pixels[:, 1] + 1.0) / camera.height - 1.0
    cam_pts = np.stack(
        [
            ndc_x * float(camera.tan_fovx) * z,
            ndc_y * float(camera.tan_fovy) * z,
            z,
            np.ones_like(z),
        ],
        axis=1,
    )
    c2w = np.linalg.inv(_host(camera.world_view))
    return (cam_pts @ c2w.T)[:, :3]
