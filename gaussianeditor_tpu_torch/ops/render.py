"""Render a GaussianScene: preprocess -> binning -> tile compositor.

Counterpart of `gaussianeditor_tpu/ops/render.py` (`RenderOutput`,
`render`, `render_safe`, `default_max_instances`). Images are
channels-last, [H, W, C], as in the JAX package; `bg` is added after
compositing, weighted by the final transmittance.

Four routes, chosen by `impl` as in the JAX package:
  * 'pallas' (the default, also `None`): sorted binning and the tile
    compositor, kernels B1 and B2 forward (`csrc/binning_key.cu`,
    `csrc/forward_tile.cu`) and B3 and B4 backward
    (`csrc/backward_tile.cu`, `csrc/rank_segment_sum.cu`). Its kernels
    take 1 to 3 channels; a wider render takes the dense route, as the
    JAX package routes it.
  * 'tiled': the same kernels, with the depth key of the JAX 'tiled'
    route, 32 - tile_bits bits (`ops/binning.py:82-84`) where 'pallas'
    keeps at most 24. The JAX route composites with its plain-XLA scan
    (`composite_tiles`), which truncates each tile at `tile_cap`
    instances and then sets `overflow`; the port walks every tile whole,
    so its 'tiled' render is what the JAX `render_safe(impl="tiled")`
    returns once its retries have raised the cap past the longest tile,
    and `overflow` is the budget's alone.
  * 'pallas4': dense (chunk-aligned) binning and the chunk compositor,
    kernels B5 forward (`csrc/forward_chunk.cu`) and B6 then B4 backward
    (`csrc/backward_chunk.cu`), for 1 to 32 channels. Its depth key keeps
    32 - tile_bits bits too.
On CPU tensors each kernel's plain version runs instead. The JAX
package also sends budgets above 2^24 to 'pallas4', because its sorted
route carries ints through f32; here ints stay int32 and the keys
32-bit integers, so every budget takes the route `impl` names.
`tile_cap` and `chunk` (the JAX scan compositor's knobs) are accepted on
every route and ignored.
  * 'ref': the dense oracle (`ops/refimpl.py::composite_dense`), plain
    torch in the scene's dtype, O(P x H x W): for tests and small scenes.
    No binning and no kernel; `num_rendered` is the sum of
    `tiles_touched`, `overflow` False and `n_contrib` None.

Differentiable: under autograd the preprocess is differentiated as
plain torch and the compositor through `TileComposite` or
`DenseComposite`. The binning is built under `no_grad`.
`mean2d_offset_ndc`, an all-zero [C, 2] tensor that requires grad, is
the densification probe: its gradient is the viewspace gradient of the
reference's `screenspace_points`.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    sorted_bin,
    tiled_depth_bits,
)
from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
from gaussianeditor_tpu_torch.ops.dense_composite import DenseComposite
from gaussianeditor_tpu_torch.ops.preprocess import TILE, preprocess
from gaussianeditor_tpu_torch.ops.refimpl import composite_dense
from gaussianeditor_tpu_torch.ops.tile_composite import (
    KERNEL_CHANNELS,
    TileComposite,
)
from gaussianeditor_tpu_torch.utils.profiling import span

IMPLS = (None, "pallas", "pallas4", "tiled", "ref")


class RenderOutput(NamedTuple):
    color: torch.Tensor        # [H, W, ch]
    depth: torch.Tensor        # [H, W]
    alpha: torch.Tensor        # [H, W] = 1 - final_T
    final_T: torch.Tensor      # [H, W]
    radii: torch.Tensor        # [C] int32
    visible: torch.Tensor      # [C] bool
    num_rendered: torch.Tensor  # scalar int32
    overflow: torch.Tensor     # scalar bool
    n_contrib: Optional[torch.Tensor]  # [H, W] int32 last-contributor
                                       # position; None on 'ref'


def point_cloud_render(
    xyz: torch.Tensor,
    camera: Camera,
    *,
    point_scale: float = 0.01,
    color: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
    **kwargs,
) -> RenderOutput:
    """Render raw points [N, 3] as opaque Gaussians of a fixed size
    (`point_scale`), white unless `color` [N, ch] is given, at SH degree
    0 on the points' device: the reference's `point_cloud_render` debug
    view (gaussian_renderer/__init__.py:156-250). `kwargs` go to
    `render`. No gradient flows: the scene is built from a copy of the
    points."""
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    dev = xyz.device
    n = xyz.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    quats = torch.zeros((n, 4), **f32)
    quats[:, 0] = 1.0
    params = dict(
        xyz=xyz,
        features_dc=torch.zeros((n, 1, 3), **f32),
        features_rest=torch.zeros((n, 0, 3), **f32),
        opacity_raw=torch.full((n, 1), 10.0, **f32),  # about opaque
        log_scales=torch.full((n, 3), math.log(point_scale), **f32),
        quats=quats,
    )
    scene = GaussianScene.create(params, max_sh_degree=0)
    if color is None:
        color = torch.ones((n, 3), **f32)
    with torch.no_grad():
        return render(scene, camera, bg, override_color=color, **kwargs)


def default_max_instances(capacity: int) -> int:
    """Instance budget heuristic: ~32 tile instances per Gaussian,
    rounded up to a multiple of 1024."""
    r = max(capacity * 32, 65536)
    return -(-r // 1024) * 1024


def preprocess_scene(scene, camera: Camera, *, scale_modifier: float = 1.0,
                     override_color: Optional[torch.Tensor] = None,
                     mean2d_offset_ndc: Optional[torch.Tensor] = None,
                     tile_row_range=None):
    """`preprocess` of every slot of `scene` (dead slots stay invisible);
    `tile_row_range` keeps a strip of tile rows (see `preprocess`)."""
    sh = None if override_color is not None else scene.get_features
    return preprocess(
        scene.xyz,
        scene.log_scales,
        scene.quats,
        scene.get_opacity[:, 0],
        sh,
        camera,
        alive=scene.alive,
        active_sh_degree=scene.active_sh_degree,
        max_sh_degree=scene.max_sh_degree,
        scale_modifier=scale_modifier,
        override_color=override_color,
        mean2d_offset_ndc=mean2d_offset_ndc,
        tile_row_range=tile_row_range,
    )


def render(
    scene,
    camera: Camera,
    bg: Optional[torch.Tensor] = None,
    *,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset_ndc: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    max_instances: Optional[int] = None,
    tile_cap: int = 1024,
    chunk: int = 128,
) -> RenderOutput:
    """Render `scene` through `camera` on the scene's device.

    impl: None or 'pallas' (sorted route; renders of more than 3 channels
    take the dense route), 'tiled' (the sorted route at the JAX 'tiled'
    route's depth cut), 'pallas4' (dense route) or 'ref' (the dense
    oracle).
    max_instances: total tile-instance budget; exceeding it sets
    `overflow` (see `render_safe`). tile_cap, chunk: accepted and ignored
    (every tile is walked whole)."""
    if impl not in IMPLS:
        raise ValueError(f"render impl must be one of {IMPLS}, got {impl!r}")
    with span("render"):
        dev = scene.device
        camera = camera.to(dev)
        H, W = camera.height, camera.width
        if bg is None:
            bg = torch.zeros((3 if override_color is None
                              else override_color.shape[-1],),
                             dtype=torch.float32, device=dev)
        bg = bg.to(dev)

        with span("render.preprocess"):
            proc = preprocess_scene(scene, camera,
                                    scale_modifier=scale_modifier,
                                    override_color=override_color,
                                    mean2d_offset_ndc=mean2d_offset_ndc)

        if impl == "ref":
            with span("render.composite"):
                color, depth, final_T = composite_dense(proc, H, W, bg)
            return RenderOutput(
                color=color,
                depth=depth,
                alpha=1.0 - final_T,
                final_T=final_T,
                radii=proc.radius,
                visible=proc.visible,
                num_rendered=torch.sum(proc.tiles_touched),
                overflow=torch.zeros((), dtype=torch.bool, device=dev),
                n_contrib=None,
            )

        grid_x = (W + TILE - 1) // TILE
        grid_y = (H + TILE - 1) // TILE
        if max_instances is None:
            max_instances = default_max_instances(scene.capacity)
        comp_args = (proc.mean2d, proc.conic, proc.opacity, proc.color,
                     proc.depth)
        dense = (impl == "pallas4"
                 or proc.color.shape[-1] > max(KERNEL_CHANNELS))
        with span("render.bin"), torch.no_grad():
            if dense:
                binning = dense_bin(proc, grid_x, grid_y, max_instances)
            else:
                binning = sorted_bin(
                    proc, grid_x, grid_y, max_instances,
                    depth_bits=(tiled_depth_bits(grid_x * grid_y)
                                if impl == "tiled" else None))
        with span("render.composite"):
            composite = DenseComposite if dense else TileComposite
            t_color, t_depth, t_final_T, t_nc = composite.apply(
                *comp_args, binning, proc.tiles_touched, grid_x)
            color = tiles_to_image(t_color, grid_x, grid_y, H, W)
            depth = tiles_to_image(t_depth, grid_x, grid_y, H, W)
            final_T = tiles_to_image(t_final_T, grid_x, grid_y, H, W)
            n_contrib = tiles_to_image(t_nc, grid_x, grid_y, H, W)
            color = color + final_T[..., None] * bg[None, None, :]

        return RenderOutput(
            color=color,
            depth=depth,
            alpha=1.0 - final_T,
            final_T=final_T,
            radii=proc.radius,
            visible=proc.visible,
            num_rendered=binning.num_rendered,
            overflow=binning.overflow,
            n_contrib=n_contrib,
        )


def render_safe(scene, camera: Camera, bg=None, *, max_retries: int = 3,
                max_instances: Optional[int] = None, **kwargs) -> RenderOutput:
    """`render`, re-rendered at double the budget while it overflows (at
    most `max_retries` times). Only `max_instances` doubles: the port has
    no tile cap to raise."""
    if max_instances is None:
        max_instances = default_max_instances(scene.capacity)
    for attempt in range(max_retries + 1):
        out = render(scene, camera, bg, max_instances=max_instances, **kwargs)
        if not bool(out.overflow):
            return out
        if attempt < max_retries:
            warnings.warn(
                f"render overflow (num_rendered={int(out.num_rendered)}, "
                f"max_instances={max_instances}); retrying at doubled "
                "capacity")
            max_instances *= 2
    warnings.warn("render overflow persisted after retries; output may "
                  "drop contributors")
    return out
