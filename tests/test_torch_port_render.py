"""Port vs JAX end to end: `ops/render.py::render` against
`render(impl="pallas")` on the same numpy scene and camera."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu_torch.ops.render import (
    default_max_instances,
    render,
    render_safe,
)
from gaussianeditor_tpu_torch.testing import assert_images_close, fraction_equal
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import port_camera, port_scene

BG = (0.1, 0.2, 0.3)


@functools.lru_cache(maxsize=None)
def _jit_render(with_override):
    def f(scene, cam, bg, oc):
        return jrender(scene, cam, bg, override_color=oc, impl="pallas",
                       max_instances=8192)

    return jax.jit(f)


CASES = {
    "seed0_64": dict(seed=0, hw=(64, 64), sh=3, override=False),
    "seed2_48": dict(seed=2, hw=(48, 48), sh=3, override=False),
    "40x72": dict(seed=6, hw=(40, 72), sh=3, override=False),
    "sh0": dict(seed=4, hw=(48, 48), sh=0, override=False),
    "mask_ch1": dict(seed=3, hw=(48, 48), sh=1, override=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_pallas(case):
    c = CASES[case]
    js = random_scene(150, seed=c["seed"], max_sh_degree=c["sh"],
                      capacity=180)
    jc = make_camera(*c["hw"])
    oc = None
    bg = np.asarray(BG, np.float32)
    if c["override"]:
        oc = (np.arange(180) % 2 == 0).astype(np.float32)[:, None]
        bg = bg[:1]
    want = _jit_render(c["override"])(
        js, jc, jnp.asarray(bg), None if oc is None else jnp.asarray(oc))
    want = jax.tree_util.tree_map(np.asarray, want)
    with torch.no_grad():
        got = render(port_scene(js), port_camera(jc), torch.from_numpy(bg),
                     override_color=None if oc is None
                     else torch.from_numpy(oc), max_instances=8192)
    assert got.color.shape == want.color.shape
    assert_images_close(got.color.numpy(), want.color, name="color")
    assert_images_close(got.depth.numpy(), want.depth, loose=2e-2,
                        name="depth")
    assert_images_close(got.final_T.numpy(), want.final_T, name="final_T")
    assert_images_close(got.alpha.numpy(), want.alpha, name="alpha")
    assert int(got.num_rendered) == int(want.num_rendered)
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_array_equal(got.radii.numpy(), want.radii)
    np.testing.assert_array_equal(got.visible.numpy(), want.visible)
    assert fraction_equal(got.n_contrib, want.n_contrib) >= 0.999


def test_render_safe_doubles_budget():
    js = random_scene(150, seed=2)
    scene, cam = port_scene(js), port_camera(make_camera(64, 64))
    with torch.no_grad():
        tight = render(scene, cam, max_instances=128)
        assert bool(tight.overflow)
        with pytest.warns(UserWarning, match="overflow"):
            out = render_safe(scene, cam, max_instances=128, max_retries=4)
        full = render(scene, cam, max_instances=8192)
    assert not bool(out.overflow)
    assert int(out.num_rendered) == int(full.num_rendered) > 128
    np.testing.assert_array_equal(out.color.numpy(), full.color.numpy())
    assert default_max_instances(1000) == 65536
    assert default_max_instances(4_000_000) == 128_000_000


def test_render_under_autograd_gives_finite_gradients():
    """Under autograd, render gives every parameter a finite gradient
    (the plain versions of the backward kernels, on CPU tensors)."""
    scene = port_scene(random_scene(20, seed=0))
    cam = port_camera(make_camera(32, 32))
    out = render(scene, cam)
    assert out.color.requires_grad
    params = [scene.xyz, scene.features_dc, scene.opacity_raw,
              scene.log_scales, scene.quats]
    grads = torch.autograd.grad(out.color.sum(), params)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().sum()) > 0
