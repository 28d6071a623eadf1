"""Forward tile compositor over the sorted binning.

Counterpart of the forward of
`gaussianeditor_tpu/ops/pallas_composite.py::make_pallas_compositor_sorted`
(`run_forward`) and of its Pallas kernel `make_forward_tile`, which
kernel B2 (`csrc/forward_tile.cu`) replaces. One 16x16 tile per block,
one pixel per thread, front to back over the tile's depth-sorted rows;
an empty tile gives color and depth 0, final_T 1 and n_contrib 0.

Forward only: the backward (kernels B3 and B4) comes with the training
slice, so `ops/render.py` refuses to run under autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_sorted import SortedBinning
from gaussianeditor_tpu_torch.ops.composite import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_MIN,
    TileImages,
)
from gaussianeditor_tpu_torch.ops.preprocess import TILE

PX = TILE * TILE
KERNEL_CHANNELS = (1, 3)  # forward_tile.cu's instances: the mask and RGB


def _pixel_coords(num_tiles: int, grid_x: int, device):
    """[num_tiles, PX] float pixel coordinates (pixel centers at ints)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(PX, device=device)[None, :]
    px = (t % grid_x) * TILE + p % TILE
    py = (t // grid_x) * TILE + p // TILE
    return px.to(torch.float32), py.to(torch.float32)


def forward_tiles_plain(tile_bounds: torch.Tensor, payload: torch.Tensor,
                        grid_x: int, ch: int
                        ) -> Tuple[TileImages, torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel B2, with the kernel's arithmetic: the
    same per-pixel recurrence, one sorted row position at a time for all
    tiles at once. Also returns, per pixel, how many rows it evaluated
    before it was done and how many of them contributed ([num_tiles, PX]
    int64 each): the work the kernel must do on these inputs."""
    dev = payload.device
    T = tile_bounds.shape[0] - 1
    n = payload.shape[1]
    start = tile_bounds[:-1].to(torch.int64)
    cnt = (tile_bounds[1:] - tile_bounds[:-1]).to(torch.int64)
    px, py = _pixel_coords(T, grid_x, dev)

    trans = torch.ones((T, PX), dtype=torch.float32, device=dev)
    acc = torch.zeros((T, PX, ch), dtype=torch.float32, device=dev)
    dsum = torch.zeros((T, PX), dtype=torch.float32, device=dev)
    last = torch.zeros((T, PX), dtype=torch.int32, device=dev)
    done = torch.zeros((T, PX), dtype=torch.bool, device=dev)
    evaluated = torch.zeros((T, PX), dtype=torch.int64, device=dev)
    contributed = torch.zeros((T, PX), dtype=torch.int64, device=dev)
    max_cnt = int(cnt.max()) if T > 0 else 0
    for i in range(max_cnt):
        valid = (cnt > i)[:, None]
        r = payload[:, torch.clamp(start + i, max=n - 1)]   # [P, T]
        xs, ys, ca, cb, cc, op, dep = (r[k][:, None] for k in range(7))
        feat = r[7:7 + ch].T[:, None, :]                      # [T, 1, ch]
        dx = xs - px
        dy = ys - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        active = valid & ~done
        evaluated += active
        active &= ~((power > 0.0) | (alpha < ALPHA_MIN))
        test_T = trans * (1.0 - alpha)
        cross = active & (test_T < T_MIN)
        contrib = active & ~cross
        contributed += contrib
        w = torch.where(contrib, alpha * trans, 0.0)
        acc = acc + w[..., None] * feat
        dsum = dsum + w * dep
        trans = torch.where(contrib, test_T, trans)
        last = torch.where(contrib, i + 1, last)
        done |= cross
    return (TileImages(color=acc, depth=dsum, final_T=trans, n_contrib=last),
            evaluated, contributed)


def forward_tiles(sb: SortedBinning, grid_x: int, ch: int) -> TileImages:
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    payload, bounds = sb.payload, sb.tile_bounds
    dev = payload.device
    if dev.type == "cpu":
        return forward_tiles_plain(bounds, payload, grid_x, ch)[0]
    if dev.type != "cuda":
        raise ValueError(f"forward_tiles: unsupported device {dev}")
    if ch not in KERNEL_CHANNELS:
        raise ValueError(f"forward_tile kernel takes {KERNEL_CHANNELS} "
                         f"channels, got {ch}")
    T = bounds.shape[0] - 1
    n = payload.shape[1]
    payload = _kernels.check_cuda_tensor(payload, "payload", torch.float32,
                                         dev, (7 + ch, n))
    bounds = _kernels.check_cuda_tensor(bounds, "tile_bounds", torch.int32,
                                        dev, (T + 1,))
    color = torch.empty((T, PX, ch), dtype=torch.float32, device=dev)
    depth = torch.empty((T, PX), dtype=torch.float32, device=dev)
    final_T = torch.empty((T, PX), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, PX), dtype=torch.int32, device=dev)
    _kernels.launch("forward_tile", dev, bounds, payload, n, T, grid_x, ch,
                    color, depth, final_T, n_contrib)
    return TileImages(color=color, depth=depth, final_T=final_T,
                      n_contrib=n_contrib)
