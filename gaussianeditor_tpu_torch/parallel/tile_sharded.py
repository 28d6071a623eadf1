"""Tile-row strips: one render split across ranks by rows of tiles.

Counterpart of `gaussianeditor_tpu/parallel/tile_sharded.py`
(`StripRender`, `render_strip`, `make_tile_sharded_render`). Each strip
runs the sorted route on its own grid: `preprocess` with
`tile_row_range` keeps the strip's tile rows in strip-local coordinates
(so a strip bins about 1/D of the instances), `mean2d`'s y is shifted by
the strip's first pixel row, `sorted_bin` (kernel B1) bins it on a grid
of grid_x x gy_local tiles, and `TileComposite` composites it (B2
forward; B3 then B4 under autograd). A strip's gradients are exact
partials for the Gaussians it sees, so the sum over strips is the whole
image's gradient; `make_tile_sharded_render` joins the strips with a
differentiable all-gather (`parallel/halo.py::gather_rows`).

A strip keeps the whole image's depth cut: its [tile | depth] keys hold
the depth bits that the whole image's grid leaves
(`binning_sorted.key_depth_bits` of grid_x x gy tiles), so the
instances of a tile sort as they do in the whole render, ties of
quantised depth included. The JAX strips cut at the strip's own grid,
which keeps more bits (23 for a 256-tile strip of a 512x512 image, 21
for the whole image): there ties order otherwise, and at 1M Gaussians
the joined strips part from the whole render by up to 0.07 in color.
A strip is still not bitwise the whole render (the y shift rounds for
Gaussians above the strip): strips are held to the image bounds and
normalised gradient tolerances.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    key_depth_bits,
    sorted_bin,
    tiled_depth_bits,
)
from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
from gaussianeditor_tpu_torch.ops.preprocess import TILE
from gaussianeditor_tpu_torch.ops.render import preprocess_scene
from gaussianeditor_tpu_torch.ops.tile_composite import TileComposite
from gaussianeditor_tpu_torch.parallel.halo import gather_rows
from gaussianeditor_tpu_torch.parallel.mesh import axis_index, axis_size

STRIP_IMPLS = ("pallas", "tiled")


class StripRender:
    """One tile-row strip's render: color [hs, W, ch] and final_T [hs, W]
    (before the background), `overflow`, and the strip's `radii` and
    `visible` (a Gaussian is visible iff it touches this strip; the max
    and the OR over strips give the whole image's). Iterates as (color,
    final_T, overflow), as the JAX class does."""

    def __init__(self, color, final_T, overflow, radii, visible):
        self.color = color
        self.final_T = final_T
        self.overflow = overflow
        self.radii = radii
        self.visible = visible

    def __iter__(self):
        return iter((self.color, self.final_T, self.overflow))


def preprocess_strip(scene, camera: Camera, ty0: int, gy_local: int, *,
                     mean2d_offset_ndc: Optional[torch.Tensor] = None):
    """`preprocess` of the tile rows [ty0, ty0 + gy_local) in strip-local
    coordinates: rects clipped to the strip and `mean2d`'s y shifted by
    the strip's first pixel row."""
    ty0 = int(ty0)
    proc = preprocess_scene(scene, camera.to(scene.device),
                            mean2d_offset_ndc=mean2d_offset_ndc,
                            tile_row_range=(ty0, ty0 + gy_local))
    shift = torch.tensor([0.0, float(ty0 * TILE)], dtype=proc.mean2d.dtype,
                         device=scene.device)
    return proc._replace(mean2d=proc.mean2d - shift)


def render_strip(scene, camera: Camera, ty0: int, gy_local: int, *,
                 max_instances: int, impl: str = "pallas",
                 mean2d_offset_ndc: Optional[torch.Tensor] = None
                 ) -> StripRender:
    """Render the tile rows [ty0, ty0 + gy_local) of `camera`'s image,
    gy_local * 16 pixel rows (past the image's last row they are
    padding), at the whole image's depth cut. impl: 'pallas' (the sorted
    route) or 'tiled' (the same at the JAX 'tiled' route's depth cut,
    32 - tile_bits bits)."""
    if impl not in STRIP_IMPLS:
        raise ValueError(f"strip impl must be one of {STRIP_IMPLS}, got "
                         f"{impl!r}")
    W = camera.width
    grid_x = (W + TILE - 1) // TILE
    image_tiles = grid_x * ((camera.height + TILE - 1) // TILE)
    depth_bits = (tiled_depth_bits(image_tiles) if impl == "tiled"
                  else key_depth_bits(image_tiles))
    proc = preprocess_strip(scene, camera, ty0, gy_local,
                            mean2d_offset_ndc=mean2d_offset_ndc)
    with torch.no_grad():
        sb = sorted_bin(proc, grid_x, gy_local, max_instances,
                        depth_bits=depth_bits)
    t_color, _, t_final_T, _ = TileComposite.apply(
        proc.mean2d, proc.conic, proc.opacity, proc.color, proc.depth, sb,
        proc.tiles_touched, grid_x)
    hs = gy_local * TILE
    color = tiles_to_image(t_color, grid_x, gy_local, hs, W)
    final_T = tiles_to_image(t_final_T, grid_x, gy_local, hs, W)
    return StripRender(color, final_T, sb.overflow, proc.radius, proc.visible)


def make_tile_sharded_render(mesh: DeviceMesh, scene_capacity: int,
                             camera: Camera, *, axis: str = "tile",
                             max_instances_per_shard: int,
                             impl: str = "pallas"):
    """render(scene, bg) -> (color [H, W, ch], overflow): the whole
    image on every rank of the mesh's `axis`, each rank rendering its
    strip of gy / D tile rows (bg added by its final transmittance); the
    strips are joined by all-gather and `overflow` is the OR over ranks.
    Differentiable. `scene_capacity` is accepted for the JAX signature."""
    D = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    H = camera.height
    gy = (H + TILE - 1) // TILE
    if gy % D:
        raise ValueError(f"tile rows {gy} not divisible by {D} shards")
    gy_local = gy // D

    def render(scene, bg: torch.Tensor):
        ty0 = axis_index(mesh, axis) * gy_local
        out = render_strip(scene, camera, ty0, gy_local,
                           max_instances=max_instances_per_shard, impl=impl)
        color = out.color + out.final_T[..., None] * bg.to(scene.device)
        full = gather_rows(color, group)[:H]
        ovf = out.overflow.to(torch.int32).reshape(1)
        dist.all_reduce(ovf, op=dist.ReduceOp.MAX, group=group)
        return full, ovf[0] > 0

    return render
