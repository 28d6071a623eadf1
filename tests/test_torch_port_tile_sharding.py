"""Port vs JAX: tile-row strips and row halos.

In this process: `preprocess(tile_row_range=...)` against JAX's (rects,
`tiles_touched`, `visible` and radii exactly) and `ssim_map(rows=
"VALID")` on halo-padded rows against JAX's, with its gradient; strips
joined against the whole render on both strip routes. On 4
spawned gloo ranks (`testing.run_ranks`), one spawn on a 1-D "tile"
mesh: `tests/test_tile_sharding.py`'s strips at 64x64 against
JAX's whole render (atol 1e-5) and the strips' gradients summed over the
ranks against the whole render's, JAX's and the port's (normalised atol
1e-3); `tests/test_mesh2d.py`'s halo SSIM against `ssim`, JAX's and the
port's (rtol 1e-6, gradients atol 1e-6), and the exchanged rows
themselves. The 2-D step is `test_torch_port_mesh2d.py`'s."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu.train import losses as jlosses
from gaussianeditor_tpu_torch.ops.render import preprocess_scene, render
from gaussianeditor_tpu_torch.parallel.tile_sharded import render_strip
from gaussianeditor_tpu_torch.train import losses
from tests.helpers import make_camera, random_scene
from gaussianeditor_tpu_torch.testing import run_ranks
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
    scene_fields,
)
from tests.torch_port_ranks import GRAD_PARAMS, camera_args, strips_rank

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MI = 4096          # tests/test_tile_sharding.py


# --- in this process -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_preprocess(ty0, ty1):
    def f(s, c):
        return jpreprocess(
            s.params.xyz, s.params.log_scales, s.params.quats,
            s.get_opacity[:, 0], s.get_features, c, alive=s.alive,
            active_sh_degree=s.active_sh_degree,
            max_sh_degree=s.max_sh_degree, tile_row_range=(ty0, ty1))

    return jax.jit(f)


@pytest.mark.parametrize("hw,rows", [((64, 64), (0, 1)), ((64, 64), (1, 3)),
                                     ((64, 64), (3, 4)), ((72, 40), (2, 5))])
def test_preprocess_tile_row_range_matches_jax(hw, rows):
    js, jcam = random_scene(120, seed=3), make_camera(*hw)
    want = _jax_preprocess(*rows)(js, jcam)
    with torch.no_grad():
        got = preprocess_scene(port_scene(js), port_camera(jcam),
                               tile_row_range=rows)
    for f in ("rect_min", "rect_max", "tiles_touched", "visible", "radius"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert int(got.tiles_touched.sum()) > 0
    assert got.rect_max[:, 1].max() <= rows[1] - rows[0]


def test_ssim_map_valid_matches_jax():
    """A strip of 16 rows with 5 halo rows on each side: the map and the
    gradient of mean(map * probe) against JAX's (at the tolerance of the
    SSIM gradient in `test_torch_port_recon.py`); on a zero-padded image
    the VALID map is the SAME one."""
    rng = np.random.RandomState(2)
    a = rng.rand(2, 26, 48, 3).astype(np.float32)
    b = (0.5 * rng.rand(2, 26, 48, 3) + 0.5 * a).astype(np.float32)
    probe = rng.randn(2, 16, 48, 3).astype(np.float32)

    def jloss(x):
        return jnp.mean(jlosses.ssim_map(x, jnp.asarray(b), rows="VALID")
                        * probe)

    want_map = np.asarray(jlosses.ssim_map(jnp.asarray(a), jnp.asarray(b),
                                           rows="VALID"))
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_()
    got_map = losses.ssim_map(ta, torch.from_numpy(b), rows="VALID")
    assert got_map.shape == (2, 16, 48, 3)
    (got_grad,) = torch.autograd.grad(
        torch.mean(got_map * torch.from_numpy(probe)), [ta])
    np.testing.assert_allclose(got_map.detach().numpy(), want_map,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-9)

    img, tgt = a[0, 5:21], b[0, 5:21]
    pad = ((5, 5), (0, 0), (0, 0))
    valid = losses.ssim_map(torch.from_numpy(np.pad(img, pad)),
                            torch.from_numpy(np.pad(tgt, pad)), rows="VALID")
    same = losses.ssim_map(torch.from_numpy(img), torch.from_numpy(tgt))
    np.testing.assert_allclose(valid.numpy(), same.numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("impl", ["pallas", "tiled"])
def test_strips_in_one_process_match_the_route(impl):
    """`render_strip` over every strip of a 96x64 view (6 tile rows, as 3
    strips of 2), joined, against `render` on the same route: the strips
    keep the whole image's depth cut, so the tiles sort alike and only
    the y shift can round."""
    js, jcam = random_scene(150, seed=4), make_camera(96, 64)
    scene, cam = port_scene(js), port_camera(jcam)
    with torch.no_grad():
        whole = render(scene, cam, max_instances=MI, impl=impl)
        strips = [render_strip(scene, cam, ty0, 2, max_instances=MI,
                               impl=impl) for ty0 in (0, 2, 4)]
    for name in ("color", "final_T"):
        got = torch.cat([getattr(s, name) for s in strips]).numpy()
        np.testing.assert_allclose(got, getattr(whole, name).numpy(),
                                   atol=1e-5, err_msg=name)
    assert not any(bool(s.overflow) for s in strips)
    radii = np.max([s.radii.numpy() for s in strips], axis=0)
    visible = np.any([s.visible.numpy() for s in strips], axis=0)
    np.testing.assert_array_equal(radii, whole.radii.numpy())
    np.testing.assert_array_equal(visible, whole.visible.numpy())


# --- 4 ranks, a 1-D "tile" mesh ---------------------------------------------

@pytest.fixture(scope="module")
def strips():
    js, jcam = random_scene(120, seed=3), make_camera(64, 64)
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)
    probe = np.array(jax.random.normal(jax.random.key(0), (64, 64, 3)))
    rng = np.random.RandomState(2)
    a = rng.rand(64, 48, 3).astype(np.float32)
    b = (rng.rand(64, 48, 3) * 0.5 + a * 0.5).astype(np.float32)
    ranks = run_ranks(strips_rank, 4, scene_fields(js), js.max_sh_degree,
                      camera_args(port_camera(jcam)), bg, probe, MI, a, b)

    want = jrender(js, jcam, jnp.asarray(bg), impl="pallas", max_instances=MI)

    def jfull(params):
        out = jrender(js.replace(params=params), jcam, jnp.zeros(3),
                      impl="pallas", max_instances=MI)
        return jnp.sum(out.color * probe) + 0.05 * jnp.sum(out.final_T)

    jgrad = jax.jit(jax.grad(jfull))(js.params)
    scene = port_scene(js)
    out = render(scene, port_camera(jcam), torch.zeros(3), max_instances=MI)
    pgrad = torch.autograd.grad(
        torch.sum(out.color * torch.from_numpy(probe))
        + 0.05 * torch.sum(out.final_T),
        [getattr(scene, k) for k in GRAD_PARAMS])
    ta = torch.from_numpy(a).requires_grad_()
    s = losses.ssim(ta, torch.from_numpy(b))
    (sgrad,) = torch.autograd.grad(s, [ta])
    return dict(
        ranks=ranks, color=np.asarray(want.color),
        jgrad={k: np.asarray(getattr(jgrad, k)) for k in GRAD_PARAMS},
        pgrad={k: g.numpy() for k, g in zip(GRAD_PARAMS, pgrad)},
        a=a, ssim=float(s.detach()), jssim=float(jlosses.ssim(jnp.asarray(a),
                                                     jnp.asarray(b))),
        ssim_grad=sgrad.numpy(),
        jssim_grad=np.asarray(jax.grad(lambda x: jlosses.ssim(
            x, jnp.asarray(b)))(jnp.asarray(a))))


def test_strips_match_full_render(strips):
    for r in strips["ranks"]:
        assert not r["overflow"]
        np.testing.assert_allclose(r["color"], strips["color"], atol=1e-5)
    assert all(r["color"].tobytes() == strips["ranks"][0]["color"].tobytes()
               for r in strips["ranks"])


@pytest.mark.parametrize("against", ["jax", "port"])
def test_strip_gradients_sum_to_full(strips, against):
    full = strips["jgrad" if against == "jax" else "pgrad"]
    for k in GRAD_PARAMS:
        a, b = strips["ranks"][0]["grad." + k], full[k]
        den = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / den, b / den, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("against", ["jax", "port"])
def test_halo_ssim_exact_across_strips(strips, against):
    want = strips["jssim" if against == "jax" else "ssim"]
    want_grad = strips["jssim_grad" if against == "jax" else "ssim_grad"]
    grad = np.concatenate([r["ssim_grad"] for r in strips["ranks"]])
    for r in strips["ranks"]:
        np.testing.assert_allclose(r["ssim"], want, rtol=1e-6)
    np.testing.assert_allclose(grad, want_grad, atol=1e-6)


def test_halo_and_gather_rows(strips):
    a = strips["a"]
    hs, h = 16, 5
    pad = np.pad(a, ((h, h), (0, 0), (0, 0)))
    for i, r in enumerate(strips["ranks"]):
        np.testing.assert_array_equal(r["halo"], pad[i * hs:(i + 1) * hs
                                                     + 2 * h])
        np.testing.assert_array_equal(r["gathered"], a)
