"""Port vs JAX: `ops/preprocess.py::preprocess` on the same scene and camera.

Integers (radius, rects, tiles_touched, visible) must match exactly;
floats to rtol/atol 1e-5 (elementwise f32 in the same operation order).

Then, without JAX, on slots built on every branch and tie of the
backward (`testing.tie_scene`): the ties are exact in float32 and
float64, `sh` as the pair gives what one [C, K, 3] tensor gives, and
autograd gives exact zeros where the upstream gradient is zero."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.core.sh import C0
from gaussianeditor_tpu_torch.ops.preprocess import (
    ProcessedGaussians,
    preprocess,
    preprocess_plain,
)
from gaussianeditor_tpu_torch.testing import (
    TIE_COLOR,
    TIE_QUAT,
    TIE_SLOTS,
    TIE_X,
    TIE_Y,
    tie_camera,
    tie_scene,
)
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INT_FIELDS = ("radius", "visible", "rect_min", "rect_max", "tiles_touched")
FLOAT_FIELDS = ("mean2d", "depth", "conic", "color", "opacity")


@functools.lru_cache(maxsize=None)
def _jit_preprocess(with_override):
    def f(scene, cam, oc):
        return jpreprocess(
            scene.params.xyz, scene.params.log_scales, scene.params.quats,
            scene.get_opacity[:, 0],
            None if with_override else scene.get_features, cam,
            alive=scene.alive, active_sh_degree=scene.active_sh_degree,
            max_sh_degree=scene.max_sh_degree, override_color=oc)

    return jax.jit(f)


@pytest.mark.parametrize("sh_degree,override", [(0, False), (3, False),
                                                (3, True)])
def test_preprocess_matches(sh_degree, override):
    js = random_scene(150, seed=sh_degree + 10, max_sh_degree=sh_degree,
                      capacity=192)
    jc = make_camera(40, 72)
    oc = None
    if override:  # the viewer's 1-channel mask render
        oc = (np.arange(192) % 3 == 0).astype(np.float32)[:, None]
    want = _jit_preprocess(override)(js, jc,
                                     None if oc is None else jnp.asarray(oc))
    ts = port_scene(js)
    got = preprocess(
        ts.xyz, ts.log_scales, ts.quats, ts.get_opacity[:, 0],
        None if override else ts.get_features, port_camera(jc),
        alive=ts.alive, active_sh_degree=ts.active_sh_degree,
        max_sh_degree=ts.max_sh_degree,
        override_color=None if oc is None else torch.from_numpy(oc))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    vis = np.asarray(want.visible)
    assert vis.sum() > 50 and not vis[150:].any()  # dead slots never show
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


# ---- the Function against the plain version, no JAX -------------------

C_SLOTS = TIE_SLOTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_sh_degree", [0, 3])
def test_tie_scene_hits_every_tie(dtype, max_sh_degree):
    """Each tied slot of `tie_scene` lies exactly on its tie under the
    plain version's arithmetic, so that the card's test of the backward
    kernel there tests the tie rules."""
    xyz, ls, q, op, dc, rest, alive = tie_scene(max_sh_degree, dtype)
    cam = tie_camera()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    # the clamp's limits are the camera's float32 products
    assert (x / z)[TIE_X] == (1.3 * cam.tan_fovx).to(dtype)
    assert (y / z)[TIE_Y] == -(1.3 * cam.tan_fovy).to(dtype)
    qn2 = q[:, 0] ** 2 + q[:, 1] ** 2 + q[:, 2] ** 2 + q[:, 3] ** 2
    assert qn2[TIE_QUAT] == torch.tensor(1e-24, dtype=dtype)
    out = preprocess_plain(xyz, ls, q, op, (dc, rest), cam, alive=alive,
                           max_sh_degree=max_sh_degree)
    assert out.color[TIE_COLOR, 1] == 0
    assert (C0 * dc[TIE_COLOR, 0, 1] + 0.5) == 0
    assert bool(out.visible[[TIE_X, TIE_Y, TIE_COLOR, TIE_QUAT]].all())


# (max SH degree, active degree, override channels, offset,
#  tile_row_range, scale_modifier)
CASES = {
    "sh0": (0, None, None, True, None, 1.0),
    "sh1": (1, None, None, True, None, 1.0),
    "sh2": (2, None, None, True, None, 1.0),
    "sh3": (3, None, None, True, None, 1.0),
    "sh4": (4, None, None, True, None, 1.0),
    "sh3-active1": (3, 1, None, True, None, 1.0),
    "sh4-active-tensor2": (4, "t2", None, True, None, 1.0),
    "sh3-active0": (3, 0, None, True, None, 1.0),
    "override-ch1": (3, None, 1, True, None, 1.0),
    "override-ch3": (3, None, 3, True, None, 1.0),
    "override-ch8": (3, None, 8, True, None, 1.0),
    "strip-scale-no-offset": (3, None, None, False, (1, 2), 1.3),
}


def _case_inputs(name, dtype):
    D, active, oc_ch, with_offset, rows, smod = CASES[name]
    xyz, ls, q, op, dc, rest, alive = tie_scene(D, dtype)
    if active == "t2":
        active = torch.tensor(2, dtype=torch.int32)
    rng = np.random.RandomState(1)
    oc = (None if oc_ch is None
          else torch.tensor(rng.rand(C_SLOTS, oc_ch), dtype=dtype))
    off = torch.zeros((C_SLOTS, 2), dtype=dtype) if with_offset else None
    kw = dict(alive=alive, active_sh_degree=active, max_sh_degree=D,
              scale_modifier=smod, override_color=oc, tile_row_range=rows)
    return (xyz, ls, q, op, dc, rest, off), kw


@pytest.mark.parametrize("name", list(CASES))
def test_function_forward_bitwise_equals_plain(name):
    """`preprocess` on CPU tensors, `sh` as the pair, is
    `preprocess_plain` on one [C, K, 3] tensor, field for field, bit for
    bit."""
    (xyz, ls, q, op, dc, rest, off), kw = _case_inputs(name, torch.float32)
    got = preprocess(xyz, ls, q, op, (dc, rest), tie_camera(),
                     mean2d_offset_ndc=off, **kw)
    want = preprocess_plain(xyz, ls, q, op, torch.cat([dc, rest], 1),
                            tie_camera(), mean2d_offset_ndc=off, **kw)
    for f in ProcessedGaussians._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == torch.float32:       # bit patterns: NaN == NaN
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert got.visible.sum() > 30


def _cotangents(dtype, seed, shapes, zero_where=None):
    rng = np.random.RandomState(seed)
    out = {k: torch.tensor(rng.randn(*s) * (1e-2 if k == "conic" else 1.0),
                           dtype=dtype) for k, s in shapes.items()}
    if zero_where is not None:
        for v in out.values():
            v[zero_where] = 0
    return out


@pytest.mark.parametrize("name", ["sh0", "sh3", "sh4-active-tensor2",
                                  "override-ch3"])
def test_zero_upstream_gives_exact_zero_gradient(name):
    """On every slot whose upstream gradients are all zero (here every
    invisible one, as the compositor leaves them), autograd of the plain
    version gives exactly zero: the kernel's backward may skip them."""
    (xyz, ls, q, op, dc, rest, off), kw = _case_inputs(name, torch.float32)
    cam = tie_camera()
    leaves = [t.clone().requires_grad_(True) for t in (xyz, ls, q, dc, rest,
                                                       off)]
    out = preprocess_plain(leaves[0], leaves[1], leaves[2], op,
                           (leaves[3], leaves[4]), cam,
                           mean2d_offset_ndc=leaves[5], **kw)
    skip = ~out.visible
    assert skip.sum() >= 20
    shapes = dict(mean2d=(C_SLOTS, 2), depth=(C_SLOTS,), conic=(C_SLOTS, 3))
    if kw["override_color"] is None:
        shapes["color"] = (C_SLOTS, 3)
    cot = _cotangents(torch.float32, 3, shapes, zero_where=skip)
    grads = torch.autograd.grad([getattr(out, k) for k in shapes], leaves,
                                [cot[k] for k in shapes], allow_unused=True)
    for g in grads:
        if g is not None and g.numel():
            assert torch.equal(g[skip], torch.zeros_like(g[skip]))
