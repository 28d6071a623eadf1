"""Tile compositor over the sorted binning, forward and backward.

Counterpart of `gaussianeditor_tpu/ops/pallas_composite.py::
make_pallas_compositor_sorted` and its custom VJP. The forward is kernel
B2 (`csrc/forward_tile.cu`, replacing the Pallas `make_forward_tile`):
one 16x16 tile per block, one pixel per thread, front to back over the
tile's depth-sorted rows; an empty tile gives color and depth 0, final_T
1 and n_contrib 0. The backward is kernel B3 (`csrc/backward_tile.cu`,
replacing `make_backward_tile`), which writes one gradient row per
sorted row to that row's pre-sort rank, followed by kernel B4
(`ops/binning_sorted.py::rank_segment_sum`), which sums each Gaussian's
ranks. `TileComposite` wires them into autograd; the payload is built
under `no_grad` and never enters the graph, so the gradients reach the
five per-Gaussian inputs only through B3 and B4, in a fixed order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    SortedBinning,
    rank_segment_sum,
)
from gaussianeditor_tpu_torch.ops.composite import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_MIN,
    TileImages,
)
from gaussianeditor_tpu_torch.ops.preprocess import TILE

PX = TILE * TILE
KERNEL_CHANNELS = (1, 2, 3)  # forward_tile.cu's and backward_tile.cu's
                             # instances; wider renders take the dense route


def _pixel_coords(num_tiles: int, grid_x: int, device):
    """[num_tiles, PX] float pixel coordinates (pixel centers at ints)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(PX, device=device)[None, :]
    px = (t % grid_x) * TILE + p % TILE
    py = (t // grid_x) * TILE + p // TILE
    return px.to(torch.float32), py.to(torch.float32)


def composite_rows_plain(start: torch.Tensor, cnt: torch.Tensor,
                         payload: torch.Tensor, grid_x: int, ch: int
                         ) -> Tuple[TileImages, torch.Tensor, torch.Tensor]:
    """The forward recurrence of kernels B2 and B5 in plain torch: tile t
    composites the depth-sorted rows [start[t], start[t] + cnt[t]) of the
    field-major payload [7 + ch, n], one row position at a time for all
    tiles at once; a pixel's n_contrib is the tile-local position of its
    last contributing row, plus one. Also returns, per pixel, how many
    rows it evaluated before it was done and how many of them contributed
    ([num_tiles, PX] int64 each): the work the kernel must do."""
    dev = payload.device
    T = start.shape[0]
    n = payload.shape[1]
    start = start.to(torch.int64)
    cnt = cnt.to(torch.int64)
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


def forward_tiles_plain(tile_bounds: torch.Tensor, payload: torch.Tensor,
                        grid_x: int, ch: int
                        ) -> Tuple[TileImages, torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel B2: `composite_rows_plain` over each
    tile's sorted rows [tile_bounds[t], tile_bounds[t+1])."""
    return composite_rows_plain(tile_bounds[:-1],
                                tile_bounds[1:] - tile_bounds[:-1], payload,
                                grid_x, ch)


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


def backward_rows_plain(start: torch.Tensor, cnt: torch.Tensor,
                        payload: torch.Tensor, out_col: Optional[torch.Tensor],
                        tiles: TileImages, g_color: torch.Tensor,
                        g_depth: torch.Tensor, g_T: torch.Tensor, grid_x: int,
                        ch: int) -> torch.Tensor:
    """The backward recurrence of kernels B3 and B6 in plain torch: the
    gradient rows [7 + ch, n] (d mean2d x y, d conic a b c, d opacity,
    d color, d depth) of the rows `composite_rows_plain` composited for
    (start, cnt), row r written to column out_col[r] (to column r when
    `out_col` is None). One row position at a time for all tiles at once;
    rows past a tile's largest n_contrib, and columns no row maps to,
    stay zero. It computes in the payload's dtype (float64 gives a
    reference for float32 evaluations)."""
    dev = payload.device
    dt = payload.dtype
    T = start.shape[0]
    n = payload.shape[1]
    G = 7 + ch
    rows = torch.zeros((G, n), dtype=dt, device=dev)
    if n == 0 or T == 0:
        return rows
    start = start.to(torch.int64)
    cnt = cnt.to(torch.int64)
    px, py = _pixel_coords(T, grid_x, dev)
    nc = tiles.n_contrib.to(torch.int64)
    S = g_T * tiles.final_T
    for c in range(ch):
        S = S + g_color[..., c] * tiles.color[..., c]
    S = S + g_depth * tiles.depth

    trans = torch.ones((T, PX), dtype=dt, device=dev)
    prefix = torch.zeros((T, PX), dtype=dt, device=dev)
    limit = torch.minimum(cnt, nc.max(dim=1).values)
    for i in range(int(limit.max())):
        r = payload[:, torch.clamp(start + i, max=n - 1)]   # [P, T]
        xs, ys, ca, cb, cc, op, dep = (r[k][:, None] for k in range(7))
        feat = r[7:7 + ch].T[:, None, :]                      # [T, 1, ch]
        dx = xs - px
        dy = ys - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = op * torch.exp(power)
        alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
        on = ((cnt > i)[:, None] & (i < nc) & ~(power > 0.0)
              & ~(alpha < ALPHA_MIN))
        w = torch.where(on, alpha * trans, 0.0)
        c_hat = g_depth * dep
        for c in range(ch):
            c_hat = c_hat + g_color[..., c] * feat[..., c]
        prefix = prefix + w * c_hat
        f = 1.0 - alpha
        amc = torch.where(alpha_raw < ALPHA_MAX, alpha, 0.0)
        dpower = torch.where(on, amc * (trans * c_hat - (S - prefix) / f), 0.0)
        part = torch.stack(
            [-dpower * (ca * dx + cb * dy), -dpower * (cc * dy + cb * dx),
             -0.5 * dpower * dx * dx, -dpower * dx * dy,
             -0.5 * dpower * dy * dy, dpower]
            + [g_color[..., c] * w for c in range(ch)] + [g_depth * w],
            dim=-1)                                           # [T, PX, G]
        sums = part.sum(dim=1)                                # [T, G]
        sums[:, 5] = sums[:, 5] * torch.where(op[:, 0] > 0.0, 1.0 / op[:, 0],
                                              0.0)
        trans = torch.where(on, trans * (1.0 - alpha), trans)
        sel = cnt > i
        src = start[sel] + i
        rows[:, src if out_col is None else out_col[src]] = sums[sel].T
    return rows


def backward_tiles_plain(tile_bounds: torch.Tensor, payload: torch.Tensor,
                         rank: torch.Tensor, tiles: TileImages,
                         g_color: torch.Tensor, g_depth: torch.Tensor,
                         g_T: torch.Tensor, grid_x: int, ch: int
                         ) -> torch.Tensor:
    """Plain torch version of kernel B3: `backward_rows_plain` over each
    tile's sorted rows, every row written to its pre-sort rank."""
    return backward_rows_plain(tile_bounds[:-1],
                               tile_bounds[1:] - tile_bounds[:-1], payload,
                               rank, tiles, g_color, g_depth, g_T, grid_x, ch)


def backward_tiles(tile_bounds: torch.Tensor, payload: torch.Tensor,
                   rank: torch.Tensor, tiles: TileImages,
                   g_color: torch.Tensor, g_depth: torch.Tensor,
                   g_T: torch.Tensor, grid_x: int, ch: int) -> torch.Tensor:
    """Kernel B3 on CUDA tensors, its plain version on CPU tensors."""
    dev = payload.device
    if dev.type == "cpu":
        return backward_tiles_plain(tile_bounds, payload, rank, tiles,
                                    g_color, g_depth, g_T, grid_x, ch)
    if dev.type != "cuda":
        raise ValueError(f"backward_tiles: unsupported device {dev}")
    if ch not in KERNEL_CHANNELS:
        raise ValueError(f"backward_tile kernel takes {KERNEL_CHANNELS} "
                         f"channels, got {ch}")
    T = tile_bounds.shape[0] - 1
    n = payload.shape[1]
    # the kernel writes only the rows it walks: the rest stay these zeros
    out = torch.zeros((7 + ch, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    chk = _kernels.check_cuda_tensor
    f32 = torch.float32
    args = (
        chk(tile_bounds, "tile_bounds", torch.int32, dev, (T + 1,)),
        chk(payload, "payload", f32, dev, (7 + ch, n)),
        chk(rank, "rank", torch.int64, dev, (n,)),
        n, T, grid_x, ch,
        chk(g_color, "g_color", f32, dev, (T, PX, ch)),
        chk(g_depth, "g_depth", f32, dev, (T, PX)),
        chk(g_T, "g_final_T", f32, dev, (T, PX)),
        chk(tiles.color, "color", f32, dev, (T, PX, ch)),
        chk(tiles.depth, "depth", f32, dev, (T, PX)),
        chk(tiles.final_T, "final_T", f32, dev, (T, PX)),
        chk(tiles.n_contrib, "n_contrib", torch.int32, dev, (T, PX)),
    )
    _kernels.launch("backward_tile", dev, *args, out)
    return out


class TileComposite(torch.autograd.Function):
    """Differentiable tile compositor (the custom VJP of
    `make_pallas_compositor_sorted`, pallas_composite.py:1252-1330).

    apply(mean2d [C,2], conic [C,3], opacity [C], color [C,ch], depth [C],
    sb, tiles_touched [C], grid_x) -> (color [T,PX,ch], depth [T,PX],
    final_T [T,PX], n_contrib [T,PX]). The values composited are those of
    `sb.payload`, a detached copy of the five inputs; the backward returns
    their gradients: B3's rows reduced per Gaussian by B4."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, sb: SortedBinning,
                tiles_touched, grid_x: int):
        ch = color.shape[-1]
        tiles = forward_tiles(sb, grid_x, ch)
        ctx.grid_x, ctx.ch, ctx.C = grid_x, ch, color.shape[0]
        ctx.save_for_backward(sb.payload, sb.rank, sb.tile_bounds, sb.b_incl,
                              tiles_touched, tiles.color, tiles.depth,
                              tiles.final_T, tiles.n_contrib)
        ctx.mark_non_differentiable(tiles.n_contrib)
        return tiles.color, tiles.depth, tiles.final_T, tiles.n_contrib

    @staticmethod
    def backward(ctx, g_color, g_depth, g_T, _g_nc):
        (payload, rank, bounds, b_incl, tiles_touched, color, depth, final_T,
         n_contrib) = ctx.saved_tensors
        ch = ctx.ch
        tiles = TileImages(color=color, depth=depth, final_T=final_T,
                           n_contrib=n_contrib)
        rows = backward_tiles(bounds, payload, rank, tiles,
                              g_color.contiguous(), g_depth.contiguous(),
                              g_T.contiguous(), ctx.grid_x, ch)
        d = rank_segment_sum(rows, b_incl, tiles_touched, ctx.C)
        return (d[:, 0:2], d[:, 2:5], d[:, 5], d[:, 6:6 + ch], d[:, 6 + ch],
                None, None, None)
