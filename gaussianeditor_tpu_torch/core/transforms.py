"""Quaternion math used by the models.

Counterpart of `gaussianeditor_tpu/core/transforms.py`; only what
`models/` and `train/densify.py` need is ported so far (`quat_normalize`,
`quat_to_rotmat`). Quaternions are
stored (w, x, y, z) and are not assumed normalized.
"""

from __future__ import annotations

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
