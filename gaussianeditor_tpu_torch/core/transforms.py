"""Quaternion math used by the models.

Counterpart of `gaussianeditor_tpu/core/transforms.py`; only what
`models/` needs is ported so far (`quat_normalize`). Quaternions are
stored (w, x, y, z) and are not assumed normalized.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """`q * rsqrt(max(|q|^2, eps))`: finite for the zero quaternions that
    dead capacity slots carry (and gradient-safe at q == 0)."""
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp_min(norm2, eps))
