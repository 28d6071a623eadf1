"""Image losses: L1, SSIM, PSNR.

Counterpart of `gaussianeditor_tpu/train/losses.py` (L1, the 11x11
Gaussian-window SSIM with C1 = 0.01^2, C2 = 0.03^2, PSNR). Images are
channels-last, [..., H, W, C]. The SSIM map's halo-row mode (`rows=
"VALID"`, for the JAX package's tile-sharded path) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def abs_jax(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's gradient at 0: +1 (torch's `abs` gives 0 there,
    which background pixels with pred == target hit)."""
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype).detach()
    return d * sign


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(abs_jax(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM of an [H, W, C] or [B, H, W, C] pair: separable
    Gaussian window, zero padding ("SAME")."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    w = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    pad = window_size // 2

    def blur(x):
        b, h, wd, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, wd)
        x = F.conv2d(x, w.view(1, 1, -1, 1), padding=(pad, 0))
        x = F.conv2d(x, w.view(1, 1, 1, -1), padding=(0, pad))
        return x.reshape(b, c, h, wd).permute(0, 2, 3, 1)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] (or [B, H, W, C]) image pair."""
    return torch.mean(ssim_map(img1, img2, window_size))
