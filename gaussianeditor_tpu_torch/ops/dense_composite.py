"""Compositor over the dense (chunk-aligned) binning, forward and backward.

Counterpart of `gaussianeditor_tpu/ops/pallas_composite.py::
make_pallas_compositor_dense` and its custom VJP: the 'pallas4' route,
which takes renders of any width (the sorted route's kernels take at most
3 channels). `pack_instances` gathers each chunk's rows into the
instance matrix [NC, 7 + ch, 128] (mean2d x y, conic a b c, opacity,
depth, color[ch]; the JAX layout without its padding to 8 rows). The
forward is kernel B5 (`csrc/forward_chunk.cu`, replacing the Pallas
`make_forward`) and the backward kernel B6 (`csrc/backward_chunk.cu`,
replacing `make_backward`), which writes a gradient row per aligned
slot. `DenseComposite` gathers those rows into pre-sort rank order with
`a_by_rank` and sums each Gaussian's contiguous ranks with kernel B4
(`binning_sorted.rank_segment_sum`), in double and in rank order; that
replaces the JAX route's mean-centred prefix sums (`rank_space_reduce`).
The instance matrix is built under `no_grad` and never enters the graph,
so the gradients reach the five per-Gaussian inputs only through B6 and
B4, in a fixed order.

Both kernels walk a tile's chunks in order inside one block: the wrapper
hands them each tile's chunk range, `tile_chunk_bounds`. On CPU tensors
the wrappers run the plain versions, which share the per-pixel
recurrences of the sorted route's (`tile_composite.composite_rows_plain`,
`backward_rows_plain`) over the same rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_dense import CHUNK, DenseBinning
from gaussianeditor_tpu_torch.ops.binning_sorted import rank_segment_sum
from gaussianeditor_tpu_torch.ops.composite import TileImages
from gaussianeditor_tpu_torch.ops.tile_composite import (
    PX,
    backward_rows_plain,
    composite_rows_plain,
)
from gaussianeditor_tpu_torch.utils.profiling import span

MAX_CHANNELS = 32  # the widest instance of forward_chunk.cu and backward_chunk.cu


def pack_instances(mean2d, conic, opacity, color, depth,
                   db: DenseBinning) -> torch.Tensor:
    """[NC, 7 + ch, CHUNK]: lane l of chunk c holds sorted row
    chunk_p0[c] + l while l < chunk_nvalid[c], else zeros (opacity 0, so
    a padding lane is never composited)."""
    with torch.no_grad():
        g = torch.cat([mean2d, conic, opacity[:, None], depth[:, None], color],
                      dim=1).to(torch.float32)
        C = g.shape[0]
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])    # zero row C
        sg = torch.cat([db.sorted_g, db.sorted_g.new_full((1,), C)])
        lane = torch.arange(CHUNK, device=g.device)
        src = torch.where(lane < db.chunk_nvalid[:, None].to(torch.int64),
                          db.chunk_p0[:, None] + lane, sg.shape[0] - 1)
        return g[sg[src]].transpose(1, 2).contiguous()


def tile_chunk_bounds(db: DenseBinning) -> torch.Tensor:
    """[T + 1] int32: tile t's chunks are [bounds[t], bounds[t+1]). A
    tile's live chunks are contiguous, in tile order, and dead chunks
    (chunk_nvalid 0) trail them all."""
    num_tiles = db.tile_nonempty.shape[0]
    key = torch.where(db.chunk_nvalid > 0, db.chunk_tile.to(torch.int64),
                      num_tiles)
    return torch.searchsorted(
        key, torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=key.device)).to(torch.int32)


def _tile_rows(db: DenseBinning, bounds: torch.Tensor):
    """(start, cnt): tile t's live rows are the aligned slots [start[t],
    start[t] + cnt[t]); all its chunks are full but the last."""
    b = bounds.to(torch.int64)
    n_ch = b[1:] - b[:-1]
    last_nv = db.chunk_nvalid.to(torch.int64)[torch.clamp_min(b[1:] - 1, 0)]
    cnt = torch.where(n_ch > 0, (n_ch - 1) * CHUNK + last_nv, 0)
    return b[:-1] * CHUNK, cnt


def _aligned_rows(inst: torch.Tensor) -> torch.Tensor:
    """[NC, F, CHUNK] -> field-major [F, NC * CHUNK] (aligned slot order)."""
    return inst.permute(1, 0, 2).reshape(inst.shape[1], -1)


def forward_chunks_plain(inst: torch.Tensor, db: DenseBinning, grid_x: int
                         ) -> Tuple[TileImages, torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel B5; also returns each pixel's
    evaluated and contributing rows, as `forward_tiles_plain` does."""
    ch = inst.shape[1] - 7
    start, cnt = _tile_rows(db, tile_chunk_bounds(db))
    return composite_rows_plain(start, cnt, _aligned_rows(inst), grid_x, ch)


def forward_chunks(inst: torch.Tensor, db: DenseBinning,
                   grid_x: int) -> TileImages:
    """Kernel B5 on CUDA tensors, its plain version on CPU tensors."""
    dev = inst.device
    if dev.type == "cpu":
        return forward_chunks_plain(inst, db, grid_x)[0]
    if dev.type != "cuda":
        raise ValueError(f"forward_chunks: unsupported device {dev}")
    NC, F, _ = inst.shape
    ch = F - 7
    if not 1 <= ch <= MAX_CHANNELS:
        raise ValueError(f"forward_chunk kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got {ch}")
    T = db.tile_nonempty.shape[0]
    chk = _kernels.check_cuda_tensor
    i32 = torch.int32
    args = (
        chk(tile_chunk_bounds(db), "bounds", i32, dev, (T + 1,)),
        chk(db.chunk_nvalid, "chunk_nvalid", i32, dev, (NC,)),
        chk(db.chunk_offset, "chunk_offset", i32, dev, (NC,)),
        chk(inst, "inst", torch.float32, dev, (NC, F, CHUNK)),
    )
    color = torch.empty((T, PX, ch), dtype=torch.float32, device=dev)
    depth = torch.empty((T, PX), dtype=torch.float32, device=dev)
    final_T = torch.empty((T, PX), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, PX), dtype=i32, device=dev)
    _kernels.launch("forward_chunk", dev, *args, T, grid_x, ch, color, depth,
                    final_T, n_contrib)
    return TileImages(color=color, depth=depth, final_T=final_T,
                      n_contrib=n_contrib)


def backward_chunks_plain(inst: torch.Tensor, db: DenseBinning,
                          tiles: TileImages, g_color: torch.Tensor,
                          g_depth: torch.Tensor, g_T: torch.Tensor,
                          grid_x: int) -> torch.Tensor:
    """Plain torch version of kernel B6: the gradient rows [NC, 7 + ch,
    CHUNK] of every aligned slot (zeros for padding lanes, dead chunks and
    rows past the tile's largest n_contrib)."""
    NC, F, _ = inst.shape
    start, cnt = _tile_rows(db, tile_chunk_bounds(db))
    rows = backward_rows_plain(start, cnt, _aligned_rows(inst), None, tiles,
                               g_color, g_depth, g_T, grid_x, F - 7)
    return rows.reshape(F, NC, CHUNK).permute(1, 0, 2).contiguous()


def backward_chunks(inst: torch.Tensor, db: DenseBinning, tiles: TileImages,
                    g_color: torch.Tensor, g_depth: torch.Tensor,
                    g_T: torch.Tensor, grid_x: int) -> torch.Tensor:
    """Kernel B6 on CUDA tensors, its plain version on CPU tensors."""
    dev = inst.device
    if dev.type == "cpu":
        return backward_chunks_plain(inst, db, tiles, g_color, g_depth, g_T,
                                     grid_x)
    if dev.type != "cuda":
        raise ValueError(f"backward_chunks: unsupported device {dev}")
    NC, F, _ = inst.shape
    ch = F - 7
    if not 1 <= ch <= MAX_CHANNELS:
        raise ValueError(f"backward_chunk kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got {ch}")
    T = db.tile_nonempty.shape[0]
    chk = _kernels.check_cuda_tensor
    i32, f32 = torch.int32, torch.float32
    args = (
        chk(tile_chunk_bounds(db), "bounds", i32, dev, (T + 1,)),
        chk(db.chunk_nvalid, "chunk_nvalid", i32, dev, (NC,)),
        chk(db.chunk_offset, "chunk_offset", i32, dev, (NC,)),
        chk(inst, "inst", f32, dev, (NC, F, CHUNK)),
        NC, T, grid_x, ch,
        chk(g_color, "g_color", f32, dev, (T, PX, ch)),
        chk(g_depth, "g_depth", f32, dev, (T, PX)),
        chk(g_T, "g_final_T", f32, dev, (T, PX)),
        chk(tiles.color, "color", f32, dev, (T, PX, ch)),
        chk(tiles.depth, "depth", f32, dev, (T, PX)),
        chk(tiles.final_T, "final_T", f32, dev, (T, PX)),
        chk(tiles.n_contrib, "n_contrib", i32, dev, (T, PX)),
    )
    out = torch.empty((NC, F, CHUNK), dtype=f32, device=dev)
    _kernels.launch("backward_chunk", dev, *args, out)
    return out


def rows_by_rank(grows: torch.Tensor, a_by_rank: torch.Tensor) -> torch.Tensor:
    """B6's aligned rows [NC, G, CHUNK] gathered into pre-sort rank order,
    [G, R_eff]: column q is the row of aligned slot a_by_rank[q]."""
    return _aligned_rows(grows).index_select(1, a_by_rank)


class DenseComposite(torch.autograd.Function):
    """Differentiable dense compositor (the custom VJP of
    `make_pallas_compositor_dense`, pallas_composite.py:1170-1210).

    apply(mean2d [C,2], conic [C,3], opacity [C], color [C,ch], depth [C],
    db, tiles_touched [C], grid_x) -> (color [T,PX,ch], depth
    [T,PX], final_T [T,PX], n_contrib [T,PX]). The values composited are a
    detached copy of the five inputs, packed by `pack_instances`; the
    backward returns their gradients: B6's rows gathered into rank order
    and summed per Gaussian by B4."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, db: DenseBinning,
                tiles_touched, grid_x: int):
        inst = pack_instances(mean2d, conic, opacity, color, depth, db)
        tiles = forward_chunks(inst, db, grid_x)
        ctx.grid_x = grid_x
        ctx.C = color.shape[0]
        ctx.save_for_backward(inst, tiles_touched, *tiles, *db)
        ctx.mark_non_differentiable(tiles.n_contrib)
        return tuple(tiles)

    @staticmethod
    def backward(ctx, g_color, g_depth, g_T, _g_nc):
        inst, tiles_touched, *rest = ctx.saved_tensors
        tiles = TileImages(*rest[:4])
        db = DenseBinning(*rest[4:])
        ch = inst.shape[1] - 7
        with span("composite.backward"):
            grows = backward_chunks(inst, db, tiles, g_color.contiguous(),
                                    g_depth.contiguous(), g_T.contiguous(),
                                    ctx.grid_x)
        with span("composite.reduce"):
            d = rank_segment_sum(rows_by_rank(grows, db.a_by_rank),
                                 db.b_incl, tiles_touched, ctx.C)
        return (d[:, 0:2], d[:, 2:5], d[:, 5], d[:, 6:6 + ch], d[:, 6 + ch],
                None, None, None)
