"""Sorted binning: per-instance keys, one stable sort, per-tile bounds.

Counterpart of `gaussianeditor_tpu/ops/binning_sorted.py::sorted_bin` and
`SortedBinning`. Every visible Gaussian g owns the instance ranks
[b_incl[g] - tiles_touched[g], b_incl[g]), one per tile of its rect.
Kernel B1 (`csrc/binning_key.cu`, replacing the Pallas `_make_key_kernel`)
writes each rank's [tile | 24-bit depth] key and gathers its compositing
payload; `torch.sort(stable=True)` orders the ranks (it stands in for
`lax.sort`, which was never Pallas), the payload follows the permutation,
and `torch.searchsorted` gives the first sorted row of every tile.

Differences from the JAX route, none of which changes an output:
  * Keys are int64, with 2^32 - 1 for a dead rank; they sort exactly as
    the JAX uint32 keys do.
  * Integers stay integers. The JAX route carries them through f32 and so
    caps the budget at 2^24; here every budget takes this route.
  * Buffers hold min(num_rendered, R) ranks, after one host read of
    num_rendered: ranks >= R are dropped either way and ranks >= total
    are dead, so the sorted live rows, `tile_bounds` and `overflow` are
    those of the JAX route (the CUDA reference resizes the same way,
    rasterizer_impl.cu:236-244).
The depth key keeps the JAX cut: min(32 - tile_bits, 24) bits of the f32
depth's bit pattern (visible depths are > 0.2, so the pattern is that of
a non-negative int).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.preprocess import ProcessedGaussians

CHUNK = 128  # the budget rounds to a multiple of this, as in the JAX route
DEAD_KEY = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class SortedBinning(NamedTuple):
    """Depth-sorted instance payload and per-tile tables.

    payload rows: mean2d x, y | conic a, b, c | opacity | depth | color..
    (the rows of the JAX `blocks` payload, without its padding)."""

    payload: torch.Tensor       # [7+ch, n] f32, n = min(num_rendered, R)
    rank: torch.Tensor          # [n] int64 pre-sort rank of each sorted row
    tile_nonempty: torch.Tensor  # [num_tiles] bool
    tile_bounds: torch.Tensor   # [num_tiles+1] i32 first sorted row per tile
    b_incl: torch.Tensor        # [C] i32 inclusive cumsum of tiles_touched
    num_rendered: torch.Tensor  # scalar i32
    overflow: torch.Tensor      # scalar bool: num_rendered > R


def key_depth_bits(num_tiles: int) -> int:
    """Depth bits of the [tile | depth] key: what the tile id leaves of
    32 bits, at most 24."""
    tile_bits = max((num_tiles + 1).bit_length(), 1)
    return min(32 - tile_bits, 24)


def _key_inputs(proc: ProcessedGaussians):
    return (proc.tiles_touched, proc.rect_min, proc.rect_max, proc.mean2d,
            proc.conic, proc.opacity, proc.depth, proc.color)


def binning_key_plain(b_incl, tiles_touched, rect_min, rect_max, mean2d,
                      conic, opacity, depth, color, n: int, total: int,
                      grid_x: int, depth_bits: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel B1: (key [n] int64, payload [7+ch, n])."""
    dev = b_incl.device
    C = b_incl.shape[0]
    q = torch.arange(n, dtype=torch.int32, device=dev)
    g = torch.searchsorted(b_incl, q, right=True).clamp_(max=max(C - 1, 0))
    tt = tiles_touched[g]
    j = q - (b_incl[g] - tt)
    live = (q < total) & (j >= 0) & (j < tt)
    rx = rect_min[g, 0]
    ry = rect_min[g, 1]
    w = torch.clamp_min(rect_max[g, 0] - rx, 1)
    jy = torch.div(j, w, rounding_mode="trunc")
    jx = j - jy * w
    tile = (ry + jy).to(torch.int64) * grid_x + (rx + jx)
    dg = depth[g]
    dk = (dg.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) >> (32 - depth_bits)
    key = torch.where(live, (tile << depth_bits) | dk,
                      torch.full_like(tile, DEAD_KEY))
    payload = torch.cat([mean2d[g].T, conic[g].T, opacity[g][None], dg[None],
                         color[g].T], dim=0)
    return key, payload


def binning_key(proc: ProcessedGaussians, b_incl: torch.Tensor, n: int,
                total: int, grid_x: int, depth_bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors."""
    dev = b_incl.device
    if dev.type == "cpu":
        return binning_key_plain(b_incl, *_key_inputs(proc), n, total,
                                 grid_x, depth_bits)
    if dev.type != "cuda":
        raise ValueError(f"binning_key: unsupported device {dev}")
    C = b_incl.shape[0]
    ch = proc.color.shape[-1]
    key = torch.empty((n,), dtype=torch.int64, device=dev)
    payload = torch.empty((7 + ch, n), dtype=torch.float32, device=dev)
    if n == 0:
        return key, payload
    chk = _kernels.check_cuda_tensor
    i32, f32 = torch.int32, torch.float32
    args = (
        chk(b_incl, "b_incl", i32, dev, (C,)),
        chk(proc.tiles_touched, "tiles_touched", i32, dev, (C,)),
        chk(proc.rect_min, "rect_min", i32, dev, (C, 2)),
        chk(proc.rect_max, "rect_max", i32, dev, (C, 2)),
        chk(proc.mean2d, "mean2d", f32, dev, (C, 2)),
        chk(proc.conic, "conic", f32, dev, (C, 3)),
        chk(proc.opacity, "opacity", f32, dev, (C,)),
        chk(proc.depth, "depth", f32, dev, (C,)),
        chk(proc.color, "color", f32, dev, (C, ch)),
    )
    _kernels.launch("binning_key", dev, *args, C, ch, n, total, grid_x,
                    depth_bits, key, payload)
    return key, payload


def sorted_bin(proc: ProcessedGaussians, grid_x: int, grid_y: int,
               max_instances: int) -> SortedBinning:
    """Bin every visible Gaussian into the tiles of its rect and sort the
    instances by [tile | depth], keeping at most R = max_instances rounded
    up to CHUNK; `overflow` reports a truncated list."""
    num_tiles = grid_x * grid_y
    C = proc.tiles_touched.shape[0]
    dev = proc.tiles_touched.device
    R = _round_up(max_instances, CHUNK)
    kdb = key_depth_bits(num_tiles)

    b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
    total = int(b_incl[-1]) if C > 0 else 0   # the one host read
    n = min(total, R)
    key, payload = binning_key(proc, b_incl, n, total, grid_x, kdb)

    skey, rank = torch.sort(key, stable=True)
    payload = payload[:, rank]
    stile = skey >> kdb
    bounds = torch.searchsorted(
        stile, torch.arange(num_tiles + 1, dtype=torch.int64, device=dev),
        side="left").to(torch.int32)
    return SortedBinning(
        payload=payload,
        rank=rank,
        tile_nonempty=bounds[1:] > bounds[:-1],
        tile_bounds=bounds,
        b_incl=b_incl,
        num_rendered=torch.tensor(total, dtype=torch.int32, device=dev),
        overflow=torch.tensor(total > R, device=dev),
    )
