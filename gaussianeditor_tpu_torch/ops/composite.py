"""Compositing constants and the tile-to-image relayout.

Counterpart of `gaussianeditor_tpu/ops/composite.py` (`ALPHA_MAX`,
`ALPHA_MIN`, `T_MIN`, `TileImages`, `tiles_to_image`). The JAX scan
compositor `composite_tiles` has no counterpart: the port composites
with the tile kernel of `ops/tile_composite.py`, and on the CPU with
that kernel's plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianeditor_tpu_torch.ops.preprocess import TILE

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4


class TileImages(NamedTuple):
    color: torch.Tensor     # [num_tiles, TILE*TILE, ch] composited (pre-bg)
    depth: torch.Tensor     # [num_tiles, TILE*TILE]
    final_T: torch.Tensor   # [num_tiles, TILE*TILE]
    n_contrib: torch.Tensor  # [num_tiles, TILE*TILE] int32


def tiles_to_image(tile_buf: torch.Tensor, grid_x: int, grid_y: int,
                   height: int, width: int) -> torch.Tensor:
    """[num_tiles, TILE*TILE, ...] -> [H, W, ...], cropping the padding
    of sizes that are not a multiple of TILE."""
    trailing = tuple(tile_buf.shape[2:])
    img = tile_buf.reshape((grid_y, grid_x, TILE, TILE) + trailing)
    img = torch.movedim(img, 2, 1)  # [gy, TILE, gx, TILE, ...]
    img = img.reshape((grid_y * TILE, grid_x * TILE) + trailing)
    return img[:height, :width]
