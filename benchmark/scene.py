"""Inputs of a cell, made from the seed on the device: the scene's
parameters, the cameras, the targets and the LPIPS weights.

Both sides get the same inputs: the program through its own
constructors (`workload.py`), the reference (`reference.py`) as plain tensors
and camera poses. Every draw comes from a `torch.Generator` on the
device, seeded from (seed, stream), in a few large calls, so the same
seed gives the same inputs and a second call regenerates them bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SH_BASES = {0: 1, 1: 4, 2: 9, 3: 16}
# VGG16 `features` (torchvision cfg "D") as LPIPS uses it: (out channels,
# max-pool before) per 3x3 convolution, and the channels of its five taps
VGG_PLAN = [(64, False), (64, False), (128, True), (128, False),
            (256, True), (256, False), (256, False), (512, True),
            (512, False), (512, False), (512, True), (512, False),
            (512, False)]
VGG_TAPS = (1, 3, 6, 9, 12)
STAGE_CH = (64, 128, 256, 512, 512)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of draws of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 62))
    return g


def scene_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The scene's six parameter arrays at full capacity, alive slots
    first, dead slots zero.

    Frozen copy of `chip_smoke.py::bench_scene_arrays` (itself
    `bench.py`'s scene): uniform xyz in the box, unit random quaternions,
    DC features N(0, 0.3^2), zero rest features, raw opacity U(-1, 1),
    log-scales of U(size / 3, 5 size / 3) with size = 0.012 (1e5 / n)^(1/3)
    for the unit cube's volume of 8, scaled by the box's volume. Drawn
    with a generator on the device instead of numpy's."""
    n, cap = int(cfg["n_gaussians"]), int(cfg["capacity"])
    k = SH_BASES[int(cfg["sh_degree"])]
    lo = torch.tensor(cfg["lo"], dtype=torch.float32, device=device)
    hi = torch.tensor(cfg["hi"], dtype=torch.float32, device=device)
    vol = float(torch.prod(hi - lo))
    size = 0.012 * (100_000 * vol / 8.0 / n) ** (1 / 3)
    g = generator(seed, 0, device)
    f32 = dict(dtype=torch.float32, device=device)
    quats = torch.randn((n, 4), generator=g, **f32)
    quats = quats / torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    u = torch.rand((n, 7), generator=g, **f32)
    xyz = lo + (hi - lo) * u[:, :3]
    out = dict(
        xyz=xyz,
        features_dc=0.3 * torch.randn((n, 1, 3), generator=g, **f32),
        features_rest=torch.zeros((n, k - 1, 3), **f32),
        opacity_raw=2.0 * u[:, 3:4] - 1.0,
        log_scales=torch.log(size / 3 + (size * 4 / 3) * u[:, 4:7]),
        quats=quats,
    )
    for name, v in out.items():
        full = torch.zeros((cap,) + tuple(v.shape[1:]), **f32)
        full[:n] = v
        out[name] = full
    return out


def camera_poses(cfg: dict) -> List[dict]:
    """The cells' cameras: rings around `center`, each camera at
    `radius` and `elevation` looking at the center, +y up."""
    center = np.asarray(cfg.get("center", [0.0, 0.0, 0.0]), np.float64)
    out = []
    for ring in cfg["rings"]:
        for i in range(int(ring["count"])):
            th = 2 * math.pi * i / int(ring["count"]) + float(
                ring.get("phase", 0.0))
            el = float(ring["elevation"])
            eye = center + float(ring["radius"]) * np.array(
                [math.cos(th) * math.cos(el), math.sin(el),
                 math.sin(th) * math.cos(el)])
            out.append(dict(eye=eye, target=center,
                            up=np.array([0.0, 1.0, 0.0]),
                            fovx=float(cfg["fovx"]), fovy=float(cfg["fovy"]),
                            height=int(cfg["height"]),
                            width=int(cfg["width"])))
    return out


def smooth_images(n: int, height: int, width: int, grid: int, seed: int,
                  stream: int, device) -> torch.Tensor:
    """Images [n, H, W, 3] in (0, 1): a seeded `grid` x `grid` field per
    view and channel, bicubic up to H x W, squashed by 0.5 + 0.45 tanh."""
    g = generator(seed, stream, device)
    coarse = torch.randn((n, 3, grid, grid), generator=g,
                         dtype=torch.float32, device=device)
    img = torch.nn.functional.interpolate(
        coarse, size=(height, width), mode="bicubic", align_corners=True)
    return (0.5 + 0.45 * torch.tanh(img)).permute(0, 2, 3, 1).contiguous()


def lpips_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Random VGG16-LPIPS weights with the published shapes: He-scaled
    3x3 convolutions (OIHW, zero biases) and nonnegative 1x1 heads, the
    layout `train/lpips.py::torch_weights` gives. One normal draw for all
    14.7M convolution weights, one uniform draw for the heads."""
    sizes, cin = [], 3
    for cout, _ in VGG_PLAN:
        sizes.append((cout, cin))
        cin = cout
    g = generator(seed, 7, device)
    flat = torch.randn((sum(o * i * 9 for o, i in sizes),), generator=g,
                       dtype=torch.float32, device=device)
    heads = torch.rand((sum(STAGE_CH),), generator=g, dtype=torch.float32,
                       device=device)
    w, off = {}, 0
    for j, (cout, cin) in enumerate(sizes):
        m = cout * cin * 9
        w[f"conv{j}_w"] = (flat[off:off + m].view(cout, cin, 3, 3)
                           * math.sqrt(2.0 / (9 * cin)))
        w[f"conv{j}_b"] = torch.zeros((cout,), dtype=torch.float32,
                                      device=device)
        off += m
    off = 0
    for j, c in enumerate(STAGE_CH):
        w[f"lin{j}_w"] = heads[off:off + c] / c
        off += c
    return w
