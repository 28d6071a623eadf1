"""Render a GaussianScene: preprocess -> sorted binning -> tile compositor.

Counterpart of `gaussianeditor_tpu/ops/render.py` (`RenderOutput`,
`render`, `render_safe`, `default_max_instances`). Images are
channels-last, [H, W, C], as in the JAX package; `bg` is added after
compositing, weighted by the final transmittance.

One route. The JAX package picks among 'pallas' (sorted), 'pallas4',
'tiled' and 'ref'; its sorted route carries ints through f32 and hands
budgets above 2^24 (the viewer's default at 1M Gaussians and 4x capacity
is 128M) and renders with more than 3 channels to 'pallas4'. Here ints
stay int32 and every budget takes the sorted route: on CUDA tensors
through kernels B1 and B2 (`csrc/binning_key.cu`, `csrc/forward_tile.cu`),
on CPU tensors through their plain versions. On CUDA the compositor
takes 1 channel (the viewer's mask overlay) or 3 (RGB); other widths
wait for the 'pallas4' kernels.

Forward only: the backward kernels come with the training slice, so a
render that autograd would have to differentiate raises
NotImplementedError instead of returning zero gradients. Call it under
`torch.no_grad()` or on parameters that do not require grad.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
from gaussianeditor_tpu_torch.ops.preprocess import TILE, preprocess
from gaussianeditor_tpu_torch.ops.tile_composite import forward_tiles


class RenderOutput(NamedTuple):
    color: torch.Tensor        # [H, W, ch]
    depth: torch.Tensor        # [H, W]
    alpha: torch.Tensor        # [H, W] = 1 - final_T
    final_T: torch.Tensor      # [H, W]
    radii: torch.Tensor        # [C] int32
    visible: torch.Tensor      # [C] bool
    num_rendered: torch.Tensor  # scalar int32
    overflow: torch.Tensor     # scalar bool
    n_contrib: torch.Tensor    # [H, W] int32 last-contributor position


def default_max_instances(capacity: int) -> int:
    """Instance budget heuristic: ~32 tile instances per Gaussian,
    rounded up to a multiple of 1024."""
    r = max(capacity * 32, 65536)
    return -(-r // 1024) * 1024


def preprocess_scene(scene, camera: Camera, *, scale_modifier: float = 1.0,
                     override_color: Optional[torch.Tensor] = None):
    """`preprocess` of every slot of `scene` (dead slots stay invisible)."""
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
    )


def render(
    scene,
    camera: Camera,
    bg: Optional[torch.Tensor] = None,
    *,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    max_instances: Optional[int] = None,
) -> RenderOutput:
    """Render `scene` through `camera` on the scene's device.

    max_instances: total tile-instance budget; exceeding it sets
    `overflow` (see `render_safe`)."""
    inputs = [scene.xyz, scene.log_scales, scene.quats, scene.opacity_raw,
              scene.features_dc, scene.features_rest]
    if override_color is not None:
        inputs.append(override_color)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "render has no backward yet (it comes with the training "
            "slice); call it under torch.no_grad()")

    dev = scene.device
    camera = camera.to(dev)
    H, W = camera.height, camera.width
    if bg is None:
        bg = torch.zeros((3 if override_color is None
                          else override_color.shape[-1],),
                         dtype=torch.float32, device=dev)
    bg = bg.to(dev)

    proc = preprocess_scene(scene, camera, scale_modifier=scale_modifier,
                            override_color=override_color)

    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    if max_instances is None:
        max_instances = default_max_instances(scene.capacity)
    ch = proc.color.shape[-1]
    sb = sorted_bin(proc, grid_x, grid_y, max_instances)
    tiles = forward_tiles(sb, grid_x, ch)

    color = tiles_to_image(tiles.color, grid_x, grid_y, H, W)
    depth = tiles_to_image(tiles.depth, grid_x, grid_y, H, W)
    final_T = tiles_to_image(tiles.final_T, grid_x, grid_y, H, W)
    n_contrib = tiles_to_image(tiles.n_contrib, grid_x, grid_y, H, W)
    color = color + final_T[..., None] * bg[None, None, :]

    return RenderOutput(
        color=color,
        depth=depth,
        alpha=1.0 - final_T,
        final_T=final_T,
        radii=proc.radius,
        visible=proc.visible,
        num_rendered=sb.num_rendered,
        overflow=sb.overflow,
        n_contrib=n_contrib,
    )


def render_safe(scene, camera: Camera, bg=None, *, max_retries: int = 3,
                max_instances: Optional[int] = None, **kwargs) -> RenderOutput:
    """`render`, re-rendered at double the budget while it overflows (at
    most `max_retries` times)."""
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
