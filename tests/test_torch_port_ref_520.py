"""Port vs JAX at 520x530, gradient misses decided by the float64 oracle.

`random_scene(150, seed)` through `make_camera(520, 530)` (1,122 tiles),
a unit-normal cotangent on the color, seeds 0-3: the port's sorted route
(B2, B3 and B4 through their plain versions) against JAX
`render(impl="pallas")` (the Pallas kernels in interpret mode) at the
gradient tolerance of `tests/test_pallas.py:87`. An entry that misses it
is decided by the float64 `render(impl="ref")` gradient (the "oracle"):
the port must be within the tolerance of it, or nearer to it than JAX.

Where neither holds, the entry must be a float32 tie of the preprocess,
as at seed 0 (ROADMAP C): there the port's float32 conic of Gaussian 106
and JAX's lie on either side of the float64 one (about 7e-7 relative
each), and at one pixel the port's alpha is 7.7e-7 relative above 1/255
while the float64 alpha is 3.0e-6 below it; JAX's rounding fell on the
float64 side. The test then holds that (a) the port is within the
tolerance of the float64 compositing of its own float32 preprocess (the
compositor and its backward are the float64 walk's), and (b) every
(pixel, Gaussian) pair of that Gaussian whose alpha test the two
preprocess outputs decide otherwise lies within `TIE_REL` of 1/255 in
float64: a float32 tie, the class of `chip_smoke.py::replay_nc_flips`.

The oracle's autograd keeps O(P x H x W) values, gigabytes at this size
in float64, so its gradient is summed over strips of one tile row: each
strip is preprocessed as a strip render preprocesses it
(`tile_sharded.preprocess_strip`: rects clipped to the strip and made
strip-local, `mean2d` shifted into the strip). The fold is per pixel,
so the strips are independent.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu_torch.ops.composite import ALPHA_MIN
from gaussianeditor_tpu_torch.ops.preprocess import TILE
from gaussianeditor_tpu_torch.ops.refimpl import composite_dense
from gaussianeditor_tpu_torch.ops.render import preprocess_scene, render
from gaussianeditor_tpu_torch.parallel.tile_sharded import preprocess_strip
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = dict(atol=1e-3, rtol=1e-2)   # tests/test_pallas.py:87
PARAMS = ("xyz", "features_dc", "opacity_raw", "log_scales", "quats")
H, W, N, MI = 520, 530, 150, 2 ** 19
# ROADMAP C: the seed-0 entries that miss, all of Gaussian 106
SEED0_MISSES = {("log_scales", (106, 1)), ("quats", (106, 2)),
                ("quats", (106, 3))}
TIE_REL = 1e-5   # an alpha this near 1/255 (relative) in float64 is a tie


@functools.lru_cache(maxsize=None)
def _jax_grad():
    cam = make_camera(H, W)

    def loss(params, scene, probe):
        out = jrender(scene.replace(params=params), cam, jnp.zeros(3),
                      impl="pallas", max_instances=MI)
        return jnp.sum(out.color * probe)

    return jax.jit(jax.grad(loss))


def _port_grad(js, probe):
    scene = port_scene(js)
    out = render(scene, port_camera(make_camera(H, W)), torch.zeros(3),
                 max_instances=MI)
    g = torch.autograd.grad(torch.sum(out.color * torch.from_numpy(probe)),
                            [getattr(scene, k) for k in PARAMS])
    return {k: v.numpy() for k, v in zip(PARAMS, g)}


def oracle_grad(js, probe, dtype=torch.float64):
    """The `"ref"` gradient of sum(color * probe), summed over strips of
    one tile row, the preprocess run in `dtype` and the compositing in
    float64: dtype float64 is the float64 oracle; float32, the float64
    compositing of the port's own float32 preprocess."""
    scene = port_scene(js).to(dtype)
    cam = port_camera(make_camera(H, W))
    params = [getattr(scene, k) for k in PARAMS]
    total = [torch.zeros_like(p, dtype=torch.float64) for p in params]
    probe64 = torch.from_numpy(probe).to(torch.float64)
    bg = torch.zeros(3, dtype=torch.float64)
    for ty in range((H + TILE - 1) // TILE):
        proc = preprocess_strip(scene, cam, ty, 1)
        proc = proc._replace(
            mean2d=proc.mean2d.double(), conic=proc.conic.double(),
            opacity=proc.opacity.double(), color=proc.color.double(),
            depth=proc.depth.double())
        color, _, _ = composite_dense(proc, TILE, W, bg)
        rows = min(H, (ty + 1) * TILE) - ty * TILE
        loss = torch.sum(color[:rows] * probe64[ty * TILE:ty * TILE + rows])
        if not loss.requires_grad:      # no Gaussian touches the strip
            continue
        for acc, g in zip(total, torch.autograd.grad(loss, params,
                                                     allow_unused=True)):
            if g is not None:
                acc += g
    return {k: v.numpy() for k, v in zip(PARAMS, total)}


def alpha_test_flips(js, g: int):
    """The pixels of Gaussian g's rect where the alpha test (power > 0 or
    alpha < 1/255) of the port's float32 preprocess, evaluated in
    float64, differs from that of the float64 preprocess; returns each
    one's float64 alpha relative to 1/255, minus 1."""
    cam = port_camera(make_camera(H, W))
    skips, rel = [], None
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            proc = preprocess_scene(port_scene(js).to(dtype), cam)
        m, c = proc.mean2d[g].double(), proc.conic[g].double()
        op = proc.opacity[g].double()
        x0, y0 = proc.rect_min[g].tolist()
        x1, y1 = proc.rect_max[g].tolist()
        ys, xs = torch.meshgrid(
            torch.arange(y0 * TILE, min(y1 * TILE, H), dtype=torch.float64),
            torch.arange(x0 * TILE, min(x1 * TILE, W), dtype=torch.float64),
            indexing="ij")
        dx, dy = m[0] - xs, m[1] - ys
        power = -0.5 * (c[0] * dx * dx + c[2] * dy * dy) - c[1] * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), 0.99)
        skips.append((power > 0) | (alpha < ALPHA_MIN))
        rel = alpha / ALPHA_MIN - 1.0
    return rel[skips[0] != skips[1]].tolist()


def _misses(got, want):
    out = set()
    for k in PARAMS:
        bad = ~(np.abs(got[k] - want[k])
                <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want[k]))
        out |= {(k, tuple(int(i) for i in idx)) for idx in np.argwhere(bad)}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gradients_at_520x530_decided_by_float64_oracle(seed):
    js = random_scene(N, seed=seed)
    probe = np.random.RandomState(seed).randn(H, W, 3).astype(np.float32)
    want = {k: np.asarray(v) for k, v in
            zip(PARAMS, (getattr(_jax_grad()(js.params, js,
                                             jnp.asarray(probe)), k)
                         for k in PARAMS))}
    got = _port_grad(js, probe)
    misses = _misses(got, want)
    if seed == 0:
        assert SEED0_MISSES <= misses, sorted(misses)
    if not misses:
        return
    oracle = oracle_grad(js, probe)
    own = None
    for k, idx in sorted(misses):
        p, j, o = got[k][idx], want[k][idx], oracle[k][idx]
        if (abs(p - o) <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * abs(o)
                or abs(p - o) < abs(j - o)):
            continue
        # a float32 tie of the preprocess: the compositor is the float64
        # walk's over the port's own preprocess, and the alpha tests the
        # two preprocess outputs decide otherwise are ties
        if own is None:
            own = oracle_grad(js, probe, dtype=torch.float32)
        q = own[k][idx]
        assert abs(p - q) <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * abs(q), (
            f"{k}{idx}: port {p!r}, JAX {j!r}, float64 oracle {o!r}, "
            f"float64 compositing of the port's preprocess {q!r}")
        flips = alpha_test_flips(js, idx[0])
        assert flips and all(abs(r) < TIE_REL for r in flips), (
            f"{k}{idx}: port {p!r}, JAX {j!r}, float64 oracle {o!r}; alpha "
            f"test flips {flips}")
