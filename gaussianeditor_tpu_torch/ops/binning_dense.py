"""Dense (chunk-aligned) binning: the instance list of the 'pallas4' route.

Counterpart of `gaussianeditor_tpu/ops/binning_dense.py` (`CHUNK`,
`DenseBinning`, `dense_capacities`, `dense_bin`). Every visible Gaussian g
owns the instance ranks [b_incl[g] - tiles_touched[g], b_incl[g]), one
per tile of its rect, walked in y-major order. One stable sort by
[tile | depth] orders the ranks; each tile's run of sorted rows is then
padded to a multiple of CHUNK, so that no 128-row chunk straddles two
tiles, and every chunk gets its metadata: owning tile, first-of-tile
flag, live rows and row offset within the tile. `a_by_rank` maps each
pre-sort rank to its aligned position, which the backward uses to bring
the gradient rows back into rank order.

Plain torch, built under `no_grad`; it has no kernel (the JAX function
is XLA, not Pallas). Differences from the JAX function, none of which
changes a live value:
  * Buffers are sized after one host read of `num_rendered`, as
    `sorted_bin` sizes its own: R_eff = round_up(min(total, R), CHUNK)
    ranks (at least CHUNK) and R2 = R_eff + CHUNK (T + 1) aligned slots
    (NC = R2 / CHUNK chunks), where the JAX function holds
    R = max_instances rounded up and R + CHUNK (T + 1).
    Ranks past min(total, R) are dead either way, so the live sorted
    rows, their aligned positions and the metadata of every live chunk
    are the JAX function's; its chunks past the port's NC are dead.
    `num_rendered` and `overflow` (total > R) are unchanged.
  * Keys are int64, with 2^32 - 1 for a dead rank; they sort exactly as
    the JAX uint32 keys do. The depth keeps 32 - tile_bits bits of the
    f32 bit pattern, with no 24-bit cap (the sorted route's cap, see
    `binning_sorted.key_depth_bits`; the two agree at 1024 tiles).
  * A rank's Gaussian comes from a binary search on `b_incl` and its
    tile from an integer division (the JAX function uses a boundary
    scatter with `cummax` and an exact f32 reciprocal); each sorted
    row's tile run comes from binary searches on the sorted tiles, where
    the JAX function scans with `cummax` and `cummin`; `a_by_rank` is
    the inverse permutation by one indexed store, not a second sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianeditor_tpu_torch.ops.binning_sorted import (
    DEAD_KEY,
    tiled_depth_bits,
)
from gaussianeditor_tpu_torch.ops.preprocess import ProcessedGaussians

CHUNK = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DenseBinning(NamedTuple):
    """The chunk-aligned instance list. R_eff ranks, NC = R2 // CHUNK
    chunks, C Gaussian slots, T tiles."""

    sorted_g: torch.Tensor      # [R_eff] int64 Gaussian of each sorted row
    a_by_rank: torch.Tensor     # [R_eff] int64 aligned position of rank q
    b_incl: torch.Tensor        # [C] int32 inclusive cumsum of tiles_touched
    chunk_p0: torch.Tensor      # [NC] int64 sorted row of each chunk's lane 0
    chunk_tile: torch.Tensor    # [NC] int32 owning tile (dead chunk: 0)
    chunk_first: torch.Tensor   # [NC] int32 1 iff the first chunk of its tile
    chunk_nvalid: torch.Tensor  # [NC] int32 live rows in the chunk
    chunk_offset: torch.Tensor  # [NC] int32 row offset within the tile
    tile_nonempty: torch.Tensor  # [T] bool
    num_rendered: torch.Tensor  # scalar int32
    overflow: torch.Tensor      # scalar bool: num_rendered > R


def dense_capacities(max_instances: int, num_tiles: int):
    """(R, R2, NC) of the JAX function for an instance budget and a tile
    grid: the budget rounded up to CHUNK, the aligned capacity and its
    chunk count. `dense_bin` sizes its buffers below these."""
    R = _round_up(max_instances, CHUNK)
    R2 = R + CHUNK * (num_tiles + 1)
    return R, R2, R2 // CHUNK


def dense_bin(proc: ProcessedGaussians, grid_x: int, grid_y: int,
              max_instances: int) -> DenseBinning:
    """Bin every visible Gaussian into the tiles of its rect, sort the
    instances by [tile | depth] and lay them out in tile-aligned chunks,
    keeping at most R = max_instances rounded up to CHUNK ranks;
    `overflow` reports a truncated list."""
    T = grid_x * grid_y
    C = proc.tiles_touched.shape[0]
    dev = proc.tiles_touched.device
    i64 = torch.int64
    R = _round_up(max_instances, CHUNK)
    db = tiled_depth_bits(T)

    tt = proc.tiles_touched
    b_incl = torch.cumsum(tt, 0, dtype=torch.int32)
    total = int(b_incl[-1]) if C > 0 else 0   # the one host read
    R_eff = max(_round_up(min(total, R), CHUNK), CHUNK)
    NC = R_eff // CHUNK + T + 1

    # --- rank -> Gaussian, rank -> tile, key ---
    q = torch.arange(R_eff, dtype=i64, device=dev)
    g = torch.searchsorted(b_incl.to(i64), q, right=True).clamp_(
        max=max(C - 1, 0))
    tt_g = tt[g].to(i64)
    j = q - (b_incl[g].to(i64) - tt_g)
    live = (q < total) & (j >= 0) & (j < tt_g)
    rx = proc.rect_min[g, 0].to(i64)
    ry = proc.rect_min[g, 1].to(i64)
    w = torch.clamp_min(proc.rect_max[g, 0].to(i64) - rx, 1)
    jy = torch.div(j, w, rounding_mode="floor")
    tile = (ry + jy) * grid_x + rx + (j - jy * w)
    depth = proc.depth.detach().to(torch.float32)
    dkey = (depth.view(torch.int32).to(i64) & 0xFFFFFFFF) >> (32 - db)
    key = torch.where(live, (tile << db) | dkey[g],
                      torch.full_like(tile, DEAD_KEY))

    skey, srank = torch.sort(key, stable=True)
    sorted_g = g[srank]
    stile = skey >> db   # a dead row's marker is > every tile id

    # --- alignment: each tile's run padded to a multiple of CHUNK ---
    # the sorted rows [tstart[p], tend[p]) share row p's tile (binary
    # searches: a 1-D cummax or cummin runs in one CUDA block)
    p = q
    tstart = torch.searchsorted(stile, stile)
    tend = torch.searchsorted(stile, stile, right=True)
    is_b = tstart == p
    tprev = torch.zeros_like(tstart)
    tprev[1:] = tstart[:-1]
    # padded length of the run that ends at each boundary
    u = torch.where(is_b & (p > 0), _round_up_t(p - tprev), 0)
    astart = torch.cumsum(u, 0)     # aligned start of p's run
    a = astart + (p - tstart)       # aligned position of sorted row p

    # --- chunk metadata ---
    cpos = torch.arange(NC, dtype=i64, device=dev) * CHUNK
    p0 = torch.searchsorted(a, cpos, side="left")
    p0c = torch.clamp_max(p0, R_eff - 1)
    st0 = stile[p0c]
    as0 = astart[p0c]
    rlen0 = tend[p0c] - tstart[p0c]

    alive = (p0 < R_eff) & (as0 <= cpos) & (st0 < T)
    offset = torch.where(alive, cpos - as0, 0)
    nvalid = torch.where(alive, torch.clamp(rlen0 - offset, 0, CHUNK), 0)
    first = alive & (offset == 0) & (nvalid > 0)
    ctile = torch.where(alive, torch.clamp(st0, 0, max(T - 1, 0)), 0)
    tile_nonempty = torch.zeros((T,), dtype=torch.int32, device=dev)
    tile_nonempty.scatter_reduce_(0, ctile, alive.to(torch.int32), "amax")

    # --- backward map: the aligned position of each pre-sort rank ---
    a_by_rank = torch.empty_like(a)
    a_by_rank[srank] = a

    i32 = torch.int32
    return DenseBinning(
        sorted_g=sorted_g,
        a_by_rank=a_by_rank,
        b_incl=b_incl,
        chunk_p0=p0c,
        chunk_tile=ctile.to(i32),
        chunk_first=first.to(i32),
        chunk_nvalid=nvalid.to(i32),
        chunk_offset=offset.to(i32),
        tile_nonempty=tile_nonempty.to(torch.bool),
        num_rendered=torch.tensor(total, dtype=i32, device=dev),
        overflow=torch.tensor(total > R, device=dev),
    )


def _round_up_t(x: torch.Tensor) -> torch.Tensor:
    return torch.div(x + CHUNK - 1, CHUNK, rounding_mode="floor") * CHUNK
