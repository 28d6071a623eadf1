"""Image losses: L1, SSIM, PSNR.

Counterpart of `gaussianeditor_tpu/train/losses.py` (L1, the 11x11
Gaussian-window SSIM with C1 = 0.01^2, C2 = 0.03^2, PSNR). Images are
channels-last, [..., H, W, C]. The SSIM map's halo-row mode (`rows=
"VALID"`) serves the strip-sharded SSIM of `parallel/halo.py`.

SSIM's blurs are `F.conv2d`, run forward and backward in full float32
with cuDNN's deterministic algorithms whatever the process-wide cuDNN
flags say (`exact_conv_flags`, `_Blur`): a plain call reads those flags
(PyTorch's default `torch.backends.cudnn.allow_tf32` is True), which
would let cuDNN choose a TF32 or a nondeterministic algorithm, so SSIM
and its gradient would hang on a global switch.
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


def exact_conv_flags():
    """cuDNN flags for a convolution that is full float32 and repeats
    bitwise: TF32 off, deterministic algorithms, no autotuning. The flags
    are read when a convolution runs, so a backward needs them too."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


class _Blur(torch.autograd.Function):
    """The separable Gaussian blur of [N, 1, H, W], forward and backward
    under `exact_conv_flags`. W always has zero padding ("SAME"); H has
    zero padding under `rows="SAME"` and none under `rows="VALID"` (the
    input carries window // 2 halo rows on each side, and the output is
    that many rows shorter at each end). The window is symmetric, so the
    backward is the same blur of the cotangent, with H padded by
    window - 1 under "VALID" (the full correlation, which restores the
    halo rows)."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(w)
        ctx.rows = rows
        return _blur2d(x, w, rows)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        back = "FULL" if ctx.rows == "VALID" else ctx.rows
        return _blur2d(g.contiguous(), w, back), None, None


_ROW_PAD = {"SAME": lambda k: k // 2, "VALID": lambda k: 0,
            "FULL": lambda k: k - 1}


def _blur2d(x: torch.Tensor, w: torch.Tensor, rows: str = "SAME"
            ) -> torch.Tensor:
    k = w.shape[0]
    with exact_conv_flags():
        x = F.conv2d(x, w.view(1, 1, -1, 1), padding=(_ROW_PAD[rows](k), 0))
        return F.conv2d(x, w.view(1, 1, 1, -1), padding=(0, k // 2))


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11, rows: str = "SAME") -> torch.Tensor:
    """Per-pixel SSIM of an [H, W, C] or [B, H, W, C] pair: separable
    Gaussian window, zero padding.

    rows: the H axis's padding. "SAME" is the whole image's (zero
    padding). "VALID": the inputs carry window_size // 2 rows of halo on
    each side, already filled (`parallel/halo.py`), and the map comes
    back without them, [B, H - window_size + 1, W, C]. W is always
    "SAME"."""
    if rows not in ("SAME", "VALID"):
        raise ValueError(f"rows must be 'SAME' or 'VALID', got {rows!r}")
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    w = torch.as_tensor(_gaussian_window(window_size), device=img1.device,
                        dtype=img1.dtype)

    def blur(x):
        b, h, wd, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, wd)
        x = _Blur.apply(x, w, rows)
        return x.reshape(b, c, -1, wd).permute(0, 2, 3, 1)

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
