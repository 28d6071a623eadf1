"""Quaternion and covariance math, and rigid transforms of Gaussians.

Counterpart of `gaussianeditor_tpu/core/transforms.py`: the reference's
`general_utils.py:64-110` (`build_rotation`, `build_scaling_rotation`,
`strip_symmetric`) and `threestudio/utils/transform.py:6-33` (scale,
rotate and translate Gaussians). Quaternions are stored (w, x, y, z) and
are not assumed normalized; they are normalized where they are used.
Torch functions keep their inputs' device and dtype; `rotmat_to_quat`
and `default_model_rotation` are host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """`q * rsqrt(max(|q|^2, eps))`: finite for the zero quaternions that
    dead capacity slots carry (and gradient-safe at q == 0)."""
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp_min(norm2, eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternion, normalized first -> [..., 3, 3]."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(scales: torch.Tensor,
                           quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s) (the reference's `build_scaling_rotation`)."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scale_modifier: float = 1.0) -> torch.Tensor:
    """The full symmetric 3D covariance [..., 3, 3], L L^T with
    L = R diag(scale_modifier * s)."""
    L = build_scaling_rotation(scales * scale_modifier, quats)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6] upper triangle (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def unstrip_symmetric(c6: torch.Tensor) -> torch.Tensor:
    """Inverse of `strip_symmetric`."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, broadcastable."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> (w, x, y, z) unit quaternion (host-side numpy)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return (q / np.linalg.norm(q)).astype(np.float32)


# --- rigid transforms of whole Gaussian clouds (reference transform.py) ---

def translate_xyz(xyz: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return xyz + offset


def scale_gaussians(xyz: torch.Tensor, log_scales: torch.Tensor,
                    factor: float, origin: torch.Tensor):
    """Uniform scale about `origin`; the log-scales shift by log(factor)."""
    new_xyz = (xyz - origin) * factor + origin
    new_log_scales = log_scales + math.log(factor)
    return new_xyz, new_log_scales


def rotate_gaussians(xyz: torch.Tensor, quats: torch.Tensor, R: torch.Tensor,
                     rot_quat: torch.Tensor, origin: torch.Tensor):
    """Rotate positions about `origin` by R and compose the quaternions
    (q' = rot_quat * q)."""
    new_xyz = (xyz - origin) @ R.T + origin
    new_quats = quat_multiply(rot_quat, quats)
    return new_xyz, new_quats


def default_model_rotation() -> np.ndarray:
    """-90 degrees about x: the generated object's frame -> the scene's
    (the reference transform.py's `default_model_mtx`)."""
    c, s = 0.0, -1.0
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)
