"""Port vs JAX: the dense oracle, `render(impl="ref")`.

At the cases of `tests/test_render.py:165-204`: the forward at 64 and 80
px and the 40x72 crop against JAX's `render(impl="ref")` and against the
port's sorted route, with the JAX suite's image bounds; the 48x48
gradients against the port's 'tiled' route and against JAX's oracle at
atol 5e-4 / rtol 5e-3; a float64 render that repeats bitwise and agrees
with the float32 one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu_torch.ops.render import render
from tests.helpers import assert_images_close, make_camera, random_scene, \
    render_j
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DIFF_PARAMS = ("xyz", "features_dc", "opacity_raw", "log_scales", "quats")
ORACLE_GRAD_TOL = dict(atol=5e-4, rtol=5e-3)   # tests/test_render.py:199


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("seed,hw", [(0, 64), (2, 80)])
def test_forward_matches_jax_oracle(seed, hw):
    js, jcam = random_scene(200, seed=seed), make_camera(hw, hw)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    want = render_j(js, jcam, jnp.asarray(bg), impl="ref")
    scene, cam = port_scene(js), port_camera(jcam)
    with torch.no_grad():
        got = render(scene, cam, torch.from_numpy(bg), impl="ref")
        sorted_route = render(scene, cam, torch.from_numpy(bg))
    for name, loose in (("color", 6e-3), ("depth", 2e-2), ("final_T", 6e-3),
                        ("alpha", 6e-3)):
        assert_images_close(_np(getattr(got, name)),
                            np.asarray(getattr(want, name)), loose=loose,
                            name=name)
        assert_images_close(_np(getattr(sorted_route, name)),
                            _np(getattr(got, name)), loose=loose,
                            name="sorted route " + name)
    np.testing.assert_array_equal(_np(got.radii), np.asarray(want.radii))
    np.testing.assert_array_equal(_np(got.visible), np.asarray(want.visible))
    assert int(got.num_rendered) == int(want.num_rendered)
    assert not bool(got.overflow) and got.n_contrib is None


def test_forward_nonsquare():
    js, jcam = random_scene(150, seed=5), make_camera(40, 72)
    want = render_j(js, jcam, impl="ref")
    scene, cam = port_scene(js), port_camera(jcam)
    with torch.no_grad():
        got = render(scene, cam, impl="ref")
        sorted_route = render(scene, cam)
    assert got.color.shape == (40, 72, 3)
    assert_images_close(_np(got.color), np.asarray(want.color), name="color")
    assert_images_close(_np(sorted_route.color), _np(got.color),
                        name="sorted route color")


@functools.lru_cache(maxsize=None)
def _jax_oracle_grad():
    cam = make_camera(48, 48)

    def loss(params, scene, probe):
        out = jrender(scene.replace(params=params), cam, jnp.zeros(3),
                      impl="ref")
        return jnp.sum(out.color * probe) + 0.1 * jnp.sum(out.depth)

    return jax.jit(jax.grad(loss))


def test_gradients_match_oracle():
    js = random_scene(100, seed=6)
    probe = np.array(jax.random.normal(jax.random.key(0), (48, 48, 3)))
    want = _jax_oracle_grad()(js.params, js, jnp.asarray(probe))
    tprobe = torch.from_numpy(probe)
    cam = port_camera(make_camera(48, 48))

    def grads(impl):
        scene = port_scene(js)
        out = render(scene, cam, torch.zeros(3), impl=impl)
        loss = torch.sum(out.color * tprobe) + 0.1 * torch.sum(out.depth)
        g = torch.autograd.grad(loss, [getattr(scene, k)
                                       for k in DIFF_PARAMS])
        return dict(zip(DIFF_PARAMS, (_np(x) for x in g)))

    g_ref, g_tiled = grads("ref"), grads("tiled")
    for k in DIFF_PARAMS:
        np.testing.assert_allclose(g_tiled[k], g_ref[k], **ORACLE_GRAD_TOL,
                                   err_msg=f"tiled vs ref: {k}")
        np.testing.assert_allclose(g_ref[k], np.asarray(getattr(want, k)),
                                   **ORACLE_GRAD_TOL,
                                   err_msg=f"port ref vs JAX ref: {k}")


def test_float64_repeats_bitwise():
    """The float64 oracle, the arbiter of float32 ties: a render and its
    gradient repeat bitwise, and agree with the float32 oracle within the
    image bounds."""
    js, cam = random_scene(120, seed=3), port_camera(make_camera(48, 48))
    probe = torch.from_numpy(np.random.RandomState(3).randn(48, 48, 3))
    runs = []
    for _ in range(2):
        scene = port_scene(js).to(torch.float64)
        out = render(scene, cam, torch.zeros(3, dtype=torch.float64),
                     impl="ref")
        assert out.color.dtype == torch.float64
        g = torch.autograd.grad(torch.sum(out.color * probe),
                                [getattr(scene, k) for k in DIFF_PARAMS])
        runs.append((out, g))
    (a, ga), (b, gb) = runs
    for name in ("color", "depth", "final_T"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
    with torch.no_grad():
        f32 = render(port_scene(js), cam, impl="ref")
    assert_images_close(_np(f32.color), _np(a.color), name="f32 vs f64")
