"""CamScene: every training camera of a COLMAP workspace.

Counterpart of `gaussianeditor_tpu/data/camera_scene.py::CamScene`:
every COLMAP image becomes a Camera at the requested (h, w), with the
field of view refit to the target aspect, and `cameras_extent` is the
NeRF++ radius (1.1 x the largest distance from the mean camera center).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.core.cameras import Camera, focal2fov
from gaussianeditor_tpu_torch.data.colmap import read_colmap_model, read_points3d


def _nerfpp_norm(c2w_centers: np.ndarray):
    center = c2w_centers.mean(axis=0)
    dists = np.linalg.norm(c2w_centers - center, axis=1)
    diagonal = dists.max() if len(dists) else 1.0
    radius = diagonal * 1.1
    return center, float(radius)


class CamScene:
    def __init__(
        self,
        source_dir: str,
        h: int = 512,
        w: int = 512,
        sparse_subdir: Optional[str] = None,
        device="cuda",
    ):
        device = resolve_device(device)
        if sparse_subdir is None:
            for cand in ("sparse/0", "sparse"):
                if os.path.isdir(os.path.join(source_dir, cand)):
                    sparse_subdir = cand
                    break
        if sparse_subdir is None:
            raise FileNotFoundError(f"no sparse model under {source_dir}")
        sparse_dir = os.path.join(source_dir, sparse_subdir)
        self.sparse_dir = sparse_dir

        cams, imgs = read_colmap_model(sparse_dir)
        self.cameras: List[Camera] = []
        self.image_names: List[str] = []
        centers = []
        for iid in sorted(imgs.keys()):
            im = imgs[iid]
            intr = cams[im.camera_id]
            fx, fy = intr.focal
            fovx = focal2fov(fx, intr.width)
            fovy = focal2fov(fy, intr.height)
            if h > 0 and w > 0:
                # fit to aspect: keep the vertical FoV, refit the
                # horizontal to the target aspect via the focal
                focal = intr.height / (2.0 * math.tan(fovy / 2.0))
                scale = h / intr.height
                focal = focal * scale
                fovx = focal2fov(focal, w)
                fovy = focal2fov(focal, h)
                hh, ww = h, w
            else:
                hh, ww = intr.height, intr.width
            R = im.rotmat().transpose()  # stored C2W-rot convention
            T = im.tvec
            self.cameras.append(
                Camera.from_Rt(R, T, fovx, fovy, hh, ww, znear=0.01,
                               zfar=100.0, device=device)
            )
            self.image_names.append(im.name)
            w2c = np.eye(4)
            w2c[:3, :3] = im.rotmat()
            w2c[:3, 3] = im.tvec
            centers.append(np.linalg.inv(w2c)[:3, 3])

        _, self.cameras_extent = _nerfpp_norm(np.asarray(centers))

    def __len__(self) -> int:
        return len(self.cameras)

    def load_points(self):
        return read_points3d(self.sparse_dir)
