"""The reference (oracle) rasterizer: dense, one Gaussian at a time.

Counterpart of `gaussianeditor_tpu/ops/refimpl.py::composite_dense`, the
`"ref"` route of `render`. A direct transliteration of the CUDA per-pixel
loop with no tiling and no chunking: the Gaussians are sorted by depth
over the whole image (invisible ones last) and folded front to back over
every pixel with the exact (T, done) recurrence, each one only into the
pixels of the tiles inside its rect (the CUDA footprint is
tile-quantised, and that is observable: exp(-0.5 * 3^2) = 0.011 is above
alpha_min = 1/255).

Plain torch, differentiable by autograd, on the inputs' device and in
their dtype: a float64 `ProcessedGaussians` gives a float64 walk, the
arbiter of float32 ties between the kernels and the JAX package. It
costs O(P x H x W) operations and, under autograd, as much memory: for
tests and small scenes. Invisible Gaussians composite nothing, so the
fold skips them (the JAX scan walks them and adds zeros).
"""

from __future__ import annotations

import torch

from gaussianeditor_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_MIN
from gaussianeditor_tpu_torch.ops.preprocess import TILE, ProcessedGaussians


def composite_dense(proc: ProcessedGaussians, height: int, width: int,
                    bg: torch.Tensor):
    """Sequential front-to-back compositing over all Gaussians and every
    pixel: (color [H, W, ch], depth [H, W], final_T [H, W]), color with
    `bg` added by the final transmittance."""
    dev = proc.mean2d.device
    dt = proc.mean2d.dtype
    key = torch.where(proc.visible, proc.depth,
                      torch.full_like(proc.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    order = order[:int(proc.visible.sum())]
    xy = proc.mean2d[order]
    conic = proc.conic[order]
    opacity = proc.opacity[order]
    color = proc.color[order]
    depth = proc.depth[order]
    rect_min = proc.rect_min[order]
    rect_max = proc.rect_max[order]

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = xs.reshape(-1).to(dt)
    py = ys.reshape(-1).to(dt)
    tx = torch.div(xs.reshape(-1), TILE, rounding_mode="floor")
    ty = torch.div(ys.reshape(-1), TILE, rounding_mode="floor")
    n_px = height * width
    ch = color.shape[-1]
    zero = torch.zeros((), dtype=dt, device=dev)
    alpha_max = torch.full((), ALPHA_MAX, dtype=dt, device=dev)

    T = torch.ones((n_px,), dtype=dt, device=dev)
    done = torch.zeros((n_px,), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((n_px, ch), dtype=dt, device=dev)
    acc_d = torch.zeros((n_px,), dtype=dt, device=dev)
    for i in range(order.shape[0]):
        dx = xy[i, 0] - px
        dy = xy[i, 1] - py
        a, b, c = conic[i, 0], conic[i, 1], conic[i, 2]
        power = -0.5 * (a * dx ** 2 + c * dy ** 2) - b * dx * dy
        alpha = torch.minimum(
            alpha_max, opacity[i] * torch.exp(torch.minimum(power, zero)))
        in_rect = ((tx >= rect_min[i, 0]) & (tx < rect_max[i, 0])
                   & (ty >= rect_min[i, 1]) & (ty < rect_max[i, 1]))
        skipped = (power > 0.0) | (alpha < ALPHA_MIN) | ~in_rect
        test_T = T * (1.0 - alpha)
        crossing = ~skipped & (test_T < T_MIN)
        contributes = ~done & ~skipped & ~crossing
        w = torch.where(contributes, alpha * T, zero)
        acc_c = acc_c + w[:, None] * color[i][None, :]
        acc_d = acc_d + w * depth[i]
        T = torch.where(contributes, test_T, T)
        done = done | crossing
    out_color = acc_c + T[:, None] * bg.to(device=dev)[None, :]
    return (out_color.reshape(height, width, ch),
            acc_d.reshape(height, width),
            T.reshape(height, width))
