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
  * Keys are the JAX uint32 keys biased by 2^31 (their top bit flipped)
    and stored as int32, since torch sorts no uint32: signed order on
    the biased keys is unsigned order on the JAX keys, a dead rank's
    2^32 - 1 becomes INT32_MAX and still sorts last, and the sort takes
    the passes of a 32-bit key, not a 64-bit one.
  * Integers stay integers. The JAX route carries them through f32 and so
    caps the budget at 2^24; here every budget takes this route.
  * Buffers hold min(num_rendered, R) ranks, after one host read of
    num_rendered: ranks >= R are dropped either way and ranks >= total
    are dead, so the sorted live rows, `tile_bounds` and `overflow` are
    those of the JAX route (the CUDA reference resizes the same way,
    rasterizer_impl.cu:236-244).
The depth key keeps the JAX cut: min(32 - tile_bits, 24) bits of the f32
depth's bit pattern (visible depths are > 0.2, so the pattern is that of
a non-negative int). `depth_bits` takes another cut: semantic tracing
passes 32 - tile_bits, the cut of the JAX `ops/binning.py::bin_and_sort`
that the JAX tracing sorts with (the same as the default at 128 tiles or
more).

`rank_segment_sum` is the backward's per-Gaussian reduction. Kernel B3
writes each sorted row's gradient straight to its pre-sort rank (`rank`
is a permutation), so Gaussian g's rows sit at the contiguous ranks
[b_incl[g] - tiles_touched[g], b_incl[g]); kernel B4
(`csrc/rank_segment_sum.cu`) sums each segment in rank order, in
double, rounded once, one block per range of slots. It takes the place
of the JAX route's rank-keyed stable sort, its Pallas
`_make_assembly_kernel` restack and `rank_space_reduce_blocked`'s
mean-centred prefix differences.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.preprocess import ProcessedGaussians
from gaussianeditor_tpu_torch.utils.profiling import span, sync

CHUNK = 128  # the budget rounds to a multiple of this, as in the JAX route
DEAD_KEY = 0xFFFFFFFF               # a dead rank's unbiased 32-bit key
KEY_BIAS = 1 << 31                  # B1's int32 key: the JAX key - 2^31
DEAD_KEY_BIASED = DEAD_KEY - KEY_BIAS   # INT32_MAX


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


def tiled_depth_bits(num_tiles: int) -> int:
    """What the tile id leaves of a 32-bit [tile | depth] key: the depth
    cut of the JAX `ops/binning.py::bin_and_sort`, which its 'tiled'
    render and its tracing sort with."""
    return 32 - max((num_tiles + 1).bit_length(), 1)


def key_depth_bits(num_tiles: int) -> int:
    """Depth bits of the [tile | depth] key: `tiled_depth_bits`, at most
    24."""
    return min(tiled_depth_bits(num_tiles), 24)


def _key_inputs(proc: ProcessedGaussians):
    return (proc.tiles_touched, proc.rect_min, proc.rect_max, proc.mean2d,
            proc.conic, proc.opacity, proc.depth, proc.color)


def binning_key_plain(b_incl, tiles_touched, rect_min, rect_max, mean2d,
                      conic, opacity, depth, color, n: int, total: int,
                      grid_x: int, depth_bits: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel B1: (key [n] int32, payload [7+ch, n]),
    the key biased: the JAX uint32 key (DEAD_KEY for a dead rank) minus
    KEY_BIAS."""
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
    # the low 32 bits, as the kernel's unsigned arithmetic keeps them
    key = ((key & DEAD_KEY) - KEY_BIAS).to(torch.int32)
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
    key = torch.empty((n,), dtype=torch.int32, device=dev)
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


def ranks_kept(total: int, max_instances: int) -> int:
    """The ranks `sorted_bin` keys, sorts and keeps: num_rendered, at most
    the budget rounded up to CHUNK."""
    return min(total, _round_up(max_instances, CHUNK))


def tile_bounds_of(skey: torch.Tensor, num_tiles: int, depth_bits: int
                   ) -> torch.Tensor:
    """[num_tiles + 1] int32: the first row of each tile in the sorted
    biased keys `skey`, and the count of live rows last. Tile t's keys
    start at the biased boundary (t << depth_bits) - KEY_BIAS, which lies
    in int32 below DEAD_KEY_BIASED for t <= num_tiles (since num_tiles + 1
    < 2^(32 - depth_bits)); one int32 arange makes them."""
    step = 1 << depth_bits
    edges = torch.arange(-KEY_BIAS, (num_tiles + 1) * step - KEY_BIAS, step,
                         dtype=torch.int32, device=skey.device)
    return torch.searchsorted(skey, edges, side="left", out_int32=True)


def sorted_bin(proc: ProcessedGaussians, grid_x: int, grid_y: int,
               max_instances: int, depth_bits: Optional[int] = None
               ) -> SortedBinning:
    """Bin every visible Gaussian into the tiles of its rect and sort the
    instances by [tile | depth], keeping at most R = max_instances rounded
    up to CHUNK; `overflow` reports a truncated list. depth_bits: the
    depth key's bits, `key_depth_bits(num_tiles)` by default; at most
    32 - tile_bits, so that every live key stays below the dead one."""
    num_tiles = grid_x * grid_y
    C = proc.tiles_touched.shape[0]
    dev = proc.tiles_touched.device
    R = _round_up(max_instances, CHUNK)
    kdb = key_depth_bits(num_tiles) if depth_bits is None else int(depth_bits)
    if not 1 <= kdb <= tiled_depth_bits(num_tiles):
        raise ValueError(f"depth_bits {kdb} outside "
                         f"[1, {tiled_depth_bits(num_tiles)}] for "
                         f"{num_tiles} tiles")

    with span("bin.key"):
        b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
        with sync("num_rendered", 4):      # the one host read
            total = int(b_incl[-1]) if C > 0 else 0
        n = ranks_kept(total, max_instances)
        key, payload = binning_key(proc, b_incl, n, total, grid_x, kdb)
    with span("bin.sort"):
        skey, rank = torch.sort(key, stable=True)
    with span("bin.gather"):
        payload = payload[:, rank]
        bounds = tile_bounds_of(skey, num_tiles, kdb)
        # two host scalars copied to the device: the copy waits for the
        # stream
        with sync("bin_scalars"):
            num_rendered = torch.tensor(total, dtype=torch.int32, device=dev)
            overflow = torch.tensor(total > R, device=dev)
    return SortedBinning(
        payload=payload,
        rank=rank,
        tile_nonempty=bounds[1:] > bounds[:-1],
        tile_bounds=bounds,
        b_incl=b_incl,
        num_rendered=num_rendered,
        overflow=overflow,
    )


def rank_segment_sum_plain(rows_rank: torch.Tensor, b_incl: torch.Tensor,
                           tiles_touched: torch.Tensor, C: int) -> torch.Tensor:
    """Plain torch version of kernel B4: [C, GF], row g the sum of
    `rows_rank[:, r]` over g's ranks [b_incl[g] - tiles_touched[g],
    b_incl[g]) within [0, n), taken in float64 and rounded to float32 (a
    deterministic sum on the CPU). b_incl must be the inclusive cumsum of
    tiles_touched, as `rank_segment_sum` requires."""
    GF, n = rows_rank.shape
    dev = rows_rank.device
    out = torch.zeros((C, GF), dtype=torch.float64, device=dev)
    if n == 0 or C == 0:
        return out.to(torch.float32)
    # rank q belongs to the first Gaussian whose inclusive bound passes
    # it; ranks past the last bound (q >= num_rendered) to none
    q = torch.arange(n, dtype=b_incl.dtype, device=dev)
    g = torch.searchsorted(b_incl, q, right=True)
    live = g < C
    out.index_add_(0, g[live], rows_rank.to(torch.float64).T[live])
    return out.to(torch.float32)


def rank_segment_sum(rows_rank: torch.Tensor, b_incl: torch.Tensor,
                     tiles_touched: torch.Tensor, C: int) -> torch.Tensor:
    """Kernel B4 on CUDA tensors, its plain version on CPU tensors.

    `rows_rank` is [GF, n], column q the row of rank q. b_incl must be the
    inclusive cumsum of tiles_touched (as `sorted_bin` and `dense_bin`
    build it), so that Gaussian g's ranks are [b_incl[g] -
    tiles_touched[g], b_incl[g]) and the ranks of consecutive slots are
    one contiguous run: the kernel takes a block's ranks from its first
    slot's first to its last slot's last, and a segment of another shape
    would lose ranks without an error."""
    dev = rows_rank.device
    if dev.type == "cpu":
        return rank_segment_sum_plain(rows_rank, b_incl, tiles_touched, C)
    if dev.type != "cuda":
        raise ValueError(f"rank_segment_sum: unsupported device {dev}")
    GF, n = rows_rank.shape
    chk = _kernels.check_cuda_tensor
    rows_rank = chk(rows_rank, "rows_rank", torch.float32, dev, (GF, n))
    b_incl = chk(b_incl, "b_incl", torch.int32, dev, (C,))
    tiles_touched = chk(tiles_touched, "tiles_touched", torch.int32, dev, (C,))
    out = torch.empty((C, GF), dtype=torch.float32, device=dev)
    if C == 0:
        return out
    _kernels.launch("rank_segment_sum", dev, rows_rank, b_incl, tiles_touched,
                    GF, n, C, out)
    return out
