"""Camera model and projection math.

Counterpart of `gaussianeditor_tpu/core/cameras.py` (`Camera`,
`Camera.rescale`, `fov2focal`, `focal2fov`, `get_world2view`,
`get_projection_matrix`, `lookat_camera`, `orbit_cameras`). Matrices
are in math (column-vector) convention, `p_cam = world_view @ [p; 1]`;
the projection maps z into [0, 1]. They are built in numpy float64
and cast to float32 exactly as the JAX package does, then placed on
the requested device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def get_world2view(
    R: np.ndarray,
    t: np.ndarray,
    translate: Optional[np.ndarray] = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-camera 4x4 from R (cam-to-world rotation) and t
    (world-to-cam translation); float32."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def get_projection_matrix(znear: float, zfar: float, fovx: float,
                          fovy: float) -> np.ndarray:
    """Perspective projection with z in [0, 1]; float32."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass
class Camera:
    """A pinhole camera: float32 tensors on one device plus the image size."""

    world_view: torch.Tensor  # [4,4]  p_cam  = world_view @ p_world
    full_proj: torch.Tensor   # [4,4]  p_clip = full_proj  @ p_world
    cam_pos: torch.Tensor     # [3]    camera center in world coords
    tan_fovx: torch.Tensor    # scalar
    tan_fovy: torch.Tensor    # scalar
    height: int = 512
    width: int = 512

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)

    def rescale(self, height: int, width: int) -> "Camera":
        """The same pose at another image size (the field of view is
        kept, so the focal lengths follow the size)."""
        return dataclasses.replace(self, height=int(height), width=int(width))

    def to(self, device) -> "Camera":
        device = resolve_device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self,
            world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            cam_pos=self.cam_pos.to(device),
            tan_fovx=self.tan_fovx.to(device),
            tan_fovy=self.tan_fovy.to(device),
        )

    @classmethod
    def from_Rt(
        cls,
        R: np.ndarray,
        t: np.ndarray,
        fovx: float,
        fovy: float,
        height: int,
        width: int,
        znear: float = 0.01,
        zfar: float = 100.0,
        translate: Optional[np.ndarray] = None,
        scale: float = 1.0,
        device="cuda",
    ) -> "Camera":
        """COLMAP-style constructor (R = C2W rotation, t = W2C translation)."""
        device = resolve_device(device)
        world_view = get_world2view(np.asarray(R), np.asarray(t), translate,
                                    scale)
        proj = get_projection_matrix(znear, zfar, fovx, fovy)
        full_proj = (proj @ world_view).astype(np.float32)
        cam_pos = np.linalg.inv(world_view)[:3, 3].astype(np.float32)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            world_view=f32(world_view),
            full_proj=f32(full_proj),
            cam_pos=f32(cam_pos),
            tan_fovx=f32(math.tan(fovx / 2.0)),
            tan_fovy=f32(math.tan(fovy / 2.0)),
            height=int(height),
            width=int(width),
        )

    @classmethod
    def from_c2w(
        cls,
        c2w: np.ndarray,
        fovx: float,
        fovy: float,
        height: int,
        width: int,
        znear: float = 0.01,
        zfar: float = 100.0,
        device="cuda",
    ) -> "Camera":
        """Construct from a camera-to-world 4x4."""
        c2w = np.asarray(c2w, dtype=np.float64)
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].transpose()
        t = w2c[:3, 3]
        return cls.from_Rt(R, t, fovx, fovy, height, width, znear, zfar,
                           device=device)


def lookat_c2w(eye, target, up) -> np.ndarray:
    """Camera-to-world 4x4 of a camera at `eye` looking at `target`
    (camera +z towards the target, OpenCV convention)."""
    eye = np.asarray(eye, dtype=np.float64)
    forward = np.asarray(target, dtype=np.float64) - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def lookat_camera(eye, target, up, fovx: float, fovy: float, height: int,
                  width: int, device="cuda") -> Camera:
    return Camera.from_c2w(lookat_c2w(eye, target, up), fovx, fovy, height,
                           width, device=device)


def orbit_cameras(
    n: int,
    radius: float,
    fovx: float,
    fovy: float,
    height: int,
    width: int,
    center: Optional[np.ndarray] = None,
    elevation: float = 0.0,
    device="cuda",
) -> list:
    """Ring of n cameras orbiting `center`."""
    if center is None:
        center = np.zeros(3)
    cams = []
    for i in range(n):
        theta = 2.0 * math.pi * i / n
        eye = center + radius * np.array(
            [math.cos(theta) * math.cos(elevation),
             math.sin(elevation),
             math.sin(theta) * math.cos(elevation)]
        )
        cams.append(lookat_camera(eye, center, np.array([0.0, 1.0, 0.0]),
                                  fovx, fovy, height, width, device=device))
    return cams
