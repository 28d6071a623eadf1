"""Port vs JAX: `ops/preprocess.py::preprocess` on the same scene and camera.

Integers (radius, rects, tiles_touched, visible) must match exactly;
floats to rtol/atol 1e-5 (elementwise f32 in the same operation order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.ops.preprocess import preprocess
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
