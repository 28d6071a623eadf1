"""The perceptual term used when no LPIPS weights exist.

Counterpart of `gaussianeditor_tpu/train/perceptual.py::
multiscale_gradient_loss`: L1 on the image gradients of the difference
image over a 2x average-pooled pyramid. The LPIPS network is
`train/lpips.py`; its `make_perceptual` falls back to this term when no
weights exist.
"""

from __future__ import annotations

import torch

from gaussianeditor_tpu_torch.train.losses import abs_jax


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x average-pool of [H, W, C], cropping an odd remainder."""
    h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
    return x[:h, :w].reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3))


def _grad_l1(d: torch.Tensor) -> torch.Tensor:
    """Mean |image gradient| of a difference image [H, W, C] (the
    wrapped row and column of the roll are masked out)."""
    H, W, C = d.shape
    dx = torch.roll(d, -1, dims=1) - d
    dy = torch.roll(d, -1, dims=0) - d
    mx = (torch.arange(W, device=d.device) < W - 1).to(d.dtype)[None, :, None]
    my = (torch.arange(H, device=d.device) < H - 1).to(d.dtype)[:, None, None]
    return (torch.sum(abs_jax(dx) * mx) / (H * (W - 1) * C)
            + torch.sum(abs_jax(dy) * my) / ((H - 1) * W * C))


def multiscale_gradient_loss(pred: torch.Tensor, target: torch.Tensor,
                             levels: int = 3) -> torch.Tensor:
    """Edge-structure distance over an image pyramid of [H, W, C] inputs.
    Pooling and differencing are linear, so the pyramid runs on the one
    difference image pred - target."""
    loss = 0.0
    d = pred - target
    for _ in range(levels):
        loss = loss + _grad_l1(d)
        if min(d.shape[0], d.shape[1]) < 8:
            break
        d = _down2(d)
    return loss
