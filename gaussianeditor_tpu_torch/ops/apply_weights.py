"""apply_weights: splat per-pixel weights back onto per-Gaussian
accumulators, the core of lifting a 2D mask onto the Gaussians.

Counterpart of `gaussianeditor_tpu/ops/apply_weights.py` (`image_to_tiles`,
`apply_weights`). Every pixel walks its tile's depth-sorted list front to
back with the render's (T, done) semantics, and every contributing
Gaussian gains the pixel's weight in `weights[g, c]` and 1 per channel
in `counts[g]`. The contribution predicate is the JAX one, evaluated a
chunk of rows at a time for every tile at once, with T and `done`
carried from chunk to chunk: the cumulative product of (1 - alpha)
within the chunk, skips where power > 0, where alpha < 1/255, past the
tile's end and on pixels outside the image, and a contribution only
while T times that product stays >= T_MIN.

Binning is `sorted_bin` (kernel B1) with the depth key cut at
32 - tile_bits bits, the cut of the JAX tracing's `bin_and_sort`, so that
both packages order the rows alike on grids of any size.

Differences from the JAX function:
  * It walks every tile whole. The number of chunk steps comes from the
    longest tile, after one host read; the port's render has no tile cap
    either. So `overflow` is the budget's overflow (num_rendered > the
    budget rounded up to 128), and `tile_cap` is accepted and ignored. At
    512x512 the longest tile of `chip_smoke.py`'s scene holds 2,235 rows,
    which the JAX function would run at three caps (1024, 2048, 4096);
    here it runs once.
  * The sums are deterministic on the card. JAX adds each chunk's rows
    into the accumulators with a scatter-add; CUDA's `index_add_` would
    add them with atomics. Here each sorted row's sums (its weight per
    channel and its count, as float32) are written to the row's
    pre-sort rank, a permutation, and kernel B4 (`rank_segment_sum`, GF
    = ch + 1) adds each Gaussian's ranks in rank order in double. The
    count column is exact: a Gaussian gains at most 256 * ch *
    tiles_touched < 2^24 a view. A row's weight sum over its tile's
    pixels is a float32 reduction (the JAX route takes a float32 matmul).
Forward only: no gradient flows through it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    rank_segment_sum,
    sorted_bin,
    tiled_depth_bits,
)
from gaussianeditor_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_MIN
from gaussianeditor_tpu_torch.ops.preprocess import TILE, preprocess
from gaussianeditor_tpu_torch.ops.render import default_max_instances
from gaussianeditor_tpu_torch.ops.tile_composite import PX, _pixel_coords


def image_to_tiles(img: torch.Tensor, grid_x: int, grid_y: int
                   ) -> torch.Tensor:
    """[H, W, ...] -> [num_tiles, TILE*TILE, ...] with zero padding."""
    H, W = img.shape[:2]
    trailing = tuple(img.shape[2:])
    out = img.new_zeros((grid_y * TILE, grid_x * TILE) + trailing)
    out[:H, :W] = img
    out = out.reshape((grid_y, TILE, grid_x, TILE) + trailing)
    out = torch.movedim(out, 1, 2)
    return out.reshape((grid_y * grid_x, PX) + trailing)


@torch.no_grad()
def apply_weights(
    scene,
    camera: Camera,
    image_weights: torch.Tensor,  # [H, W, ch] per-pixel weights
    weights: torch.Tensor,        # [C, ch] running accumulator
    weights_cnt: torch.Tensor,    # [C] int32 running contribution counter
    *,
    max_instances: Optional[int] = None,
    tile_cap: int = 1024,
    chunk: int = 128,
    rows: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One view's accumulation pass on the scene's device; call it per
    view and normalise with `weights / (weights_cnt + 1e-7)`.

    Returns (weights, counts, overflow): overflow is True when the
    instance budget truncated the list (the caller re-runs the view at a
    larger budget). `tile_cap` is ignored (every tile is walked whole).
    rows: when a dict is passed, it receives what B4 sums: the per-rank
    rows [ch + 1, n] (`rows`), `b_incl` and `tiles_touched`."""
    dev = scene.device
    camera = camera.to(dev)
    H, W = camera.height, camera.width
    image_weights = torch.as_tensor(image_weights, dtype=torch.float32,
                                    device=dev)
    ch = image_weights.shape[-1]
    Cap = scene.capacity

    proc = preprocess(
        scene.xyz, scene.log_scales, scene.quats, scene.get_opacity[:, 0],
        None, camera, alive=scene.alive,
        override_color=torch.zeros((Cap, 1), dtype=torch.float32,
                                   device=dev),  # features unused here
    )
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    num_tiles = grid_x * grid_y
    if max_instances is None:
        max_instances = default_max_instances(Cap)
    sb = sorted_bin(proc, grid_x, grid_y, max_instances,
                    depth_bits=tiled_depth_bits(num_tiles))
    n = sb.rank.shape[0]
    if n == 0:
        return weights, weights_cnt, sb.overflow

    img_tiles = image_to_tiles(image_weights, grid_x, grid_y)  # [T, px, ch]
    px, py = _pixel_coords(num_tiles, grid_x, dev)
    # out-of-image pixels never contribute
    px_valid = (px < W) & (py < H)                              # [T, px]
    start = sb.tile_bounds[:-1].to(torch.int64)
    end = sb.tile_bounds[1:].to(torch.int64)
    longest = int((end - start).max())     # the one host read of the walk

    # per-rank sums: the ch weight columns, then the count; column n
    # takes the writes of rows past a tile's end and is dropped
    by_rank = torch.zeros((ch + 1, n + 1), dtype=torch.float32, device=dev)
    T = torch.ones((num_tiles, PX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PX), dtype=torch.bool, device=dev)
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    for i in range(-(-longest // chunk)):
        pos = start[:, None] + i * chunk + lane[None, :]        # [T, chunk]
        in_range = pos < end[:, None]
        row = torch.clamp(pos, max=n - 1)
        r = sb.payload[:6, row]                                 # [6, T, chunk]
        xs, ys, ca, cb, cc, op = (r[k][:, None, :] for k in range(6))
        dx = xs - px[..., None]                                 # [T, px, chunk]
        dy = ys - py[..., None]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(torch.clamp_max(power, 0.0)),
                                ALPHA_MAX)
        skipped = ((power > 0.0) | (alpha < ALPHA_MIN)
                   | ~in_range[:, None, :] | ~px_valid[..., None])
        f = torch.where(skipped, 1.0, 1.0 - alpha)
        TP = T[..., None] * torch.cumprod(f, dim=-1)
        contributes = (~done[..., None]) & (~skipped) & (TP >= T_MIN)
        done = done | torch.any((~skipped) & (TP < T_MIN), dim=-1)
        T = T * torch.prod(torch.where(contributes, f, 1.0), dim=-1)

        cf = contributes.to(torch.float32)
        sums = [torch.sum(cf * img_tiles[:, :, c, None], dim=1)
                for c in range(ch)]                             # [T, chunk]
        sums.append(torch.sum(cf, dim=1) * ch)  # count += 1 per channel
        dest = torch.where(in_range, sb.rank[row], n)
        by_rank[:, dest.reshape(-1)] = torch.stack(sums).reshape(ch + 1, -1)

    by_rank = by_rank[:, :n].contiguous()
    if rows is not None:
        rows.update(rows=by_rank, b_incl=sb.b_incl,
                    tiles_touched=proc.tiles_touched)
    per_g = rank_segment_sum(by_rank, sb.b_incl, proc.tiles_touched,
                             Cap)                               # [C, ch + 1]
    weights = weights + per_g[:, :ch]
    weights_cnt = weights_cnt + per_g[:, ch].to(torch.int32)
    return weights, weights_cnt, sb.overflow
