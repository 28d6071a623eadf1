"""Port vs JAX: click tracing and the 'tiled' render route.

`utils/masks.py` (exactly equal), `utils/camera_math.py` (`project`,
`unproject` within 1e-5), `render(impl="tiled")` against the JAX 'tiled'
route (the JAX suite's image bounds; `n_contrib` equal but for at most
one flip in 10,000 contributing pairs, the bound of
`tests/test_torch_port_tracing.py`), a tile past `tile_cap` (the JAX
route sets `overflow` and its `render_safe` re-renders; the port walks
every tile whole), the 'tiled' route equal to `sorted_bin` at the same
depth cut then the tile compositor, `point_cloud_render`, and
`trace_from_click` on `tests/test_prompts_click.py`'s scene. The JAX side
renders its production route ('pallas', `ops.render.default_impl`
patched as in `tests/test_torch_port_edit.py`) except where it names
'tiled' itself.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit import tracing as jtracing
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu.ops.binning import bin_and_sort
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu.utils import camera_math as jcm
from gaussianeditor_tpu.utils import masks as jmasks
from gaussianeditor_tpu_torch.edit import tracing
from gaussianeditor_tpu_torch.guidance import fake
from gaussianeditor_tpu_torch.ops import render as trender
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    sorted_bin,
    tiled_depth_bits,
)
from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
from gaussianeditor_tpu_torch.ops.tile_composite import forward_tiles
from gaussianeditor_tpu_torch.testing import assert_images_close
from gaussianeditor_tpu_torch.utils import camera_math, masks
from tests.helpers import make_camera, random_scene
from tests.test_edit import _two_cluster_scene
from tests.torch_port_helpers import port_camera, port_scene

jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")


def assert_n_contrib_close(got, want):
    """Equal but for at most one flipped pair in 10,000 contributing ones
    (n_contrib counts a pixel's pairs up to its last contributor)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    flipped = np.abs(got - want).sum()
    assert flipped <= max(1.0, 1e-4 * want.sum()), (
        f"{flipped} flipped pairs of {want.sum()}")


# ---- masks and camera math ----

@pytest.mark.parametrize("iters", [0, 1, 3])
def test_masks_match_jax_exactly(iters):
    rng = np.random.RandomState(iters)
    m = (rng.rand(40, 56) > 0.8).astype(np.float32)
    ring = np.zeros((40, 56), np.float32)
    ring[10:30, 10:30] = 1.0
    ring[14:26, 14:26] = 0.0   # a closed hole for the fill
    for x in (m, ring, rng.rand(40, 56)):
        for f in ("dilate_mask", "erode_mask"):
            got = getattr(masks, f)(x, iters)
            want = getattr(jmasks, f)(x, iters)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(masks.fill_closed_areas(x),
                                      jmasks.fill_closed_areas(x))
    assert masks.fill_closed_areas(ring)[20, 20] == 1.0


def test_project_unproject_match_jax():
    rng = np.random.RandomState(0)
    for jc in jorbit_cameras(3, 4.0, 0.8, 0.7, 48, 64):
        tc = port_camera(jc)
        pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
        (tp, td), (jp, jd) = camera_math.project(tc, pts), jcm.project(jc, pts)
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
        depth = rng.uniform(1, 6, (48, 64)).astype(np.float32)
        pix = np.stack([rng.uniform(0, 64, 20), rng.uniform(0, 48, 20)],
                       axis=1).astype(np.float32)
        np.testing.assert_allclose(camera_math.unproject(tc, pix, depth),
                                   jcm.unproject(jc, pix, depth),
                                   rtol=1e-5, atol=1e-5)
        # a point projected and unprojected at its own depth comes back
        back = camera_math.unproject(tc, tp[:1], np.full((48, 64), td[0]))
        if 0 <= tp[0, 0] < 64 and 0 <= tp[0, 1] < 48:
            np.testing.assert_allclose(back[0], pts[0], atol=2e-2)


# ---- the 'tiled' route ----

# (height, width): 4, 16 and 128 tiles, so depth cuts of 29, 27 and 24 bits
TILED_CASES = {"4tiles": (32, 32, 80, 1), "16tiles": (64, 64, 200, 2),
               "128tiles": (128, 256, 300, 3)}


def _jax_tiled(js, cam, tile_cap=4096, **kw):
    return jax.jit(lambda s, c: jrender_mod.render(
        s, c, impl="tiled", tile_cap=tile_cap, chunk=64, **kw))(js, cam)


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_tiled_render_matches_jax_tiled(case):
    H, W, n, seed = TILED_CASES[case]
    js = random_scene(n, seed=seed, max_sh_degree=1)
    cam = make_camera(H, W)
    want = _jax_tiled(js, cam, max_instances=1 << 16)
    got = trender.render(port_scene(js), port_camera(cam), impl="tiled",
                         max_instances=1 << 16, tile_cap=7, chunk=3)
    assert not bool(want.overflow) and not bool(got.overflow)
    assert int(got.num_rendered) == int(want.num_rendered) > 0
    for f in ("color", "depth", "final_T"):
        assert_images_close(getattr(got, f), getattr(want, f), name=f)
    assert_n_contrib_close(got.n_contrib, want.n_contrib)


def test_tiled_is_sorted_bin_at_the_tiled_cut_then_b2():
    js = random_scene(200, seed=4)
    ts, tc = port_scene(js), port_camera(make_camera(64, 64))
    out = trender.render(ts, tc, impl="tiled")
    proc = trender.preprocess_scene(ts, tc)
    sb = sorted_bin(proc, 4, 4, trender.default_max_instances(ts.capacity),
                    depth_bits=tiled_depth_bits(16))
    tiles = forward_tiles(sb, 4, 3)
    for f, t in zip(("color", "depth", "final_T", "n_contrib"), tiles):
        want = tiles_to_image(t, 4, 4, 64, 64)
        assert torch.equal(getattr(out, f), want), f   # bg black: + 0
    # at 16 tiles the default route cuts at 24 bits, 'tiled' at 27
    assert tiled_depth_bits(16) == 27
    default = trender.render(ts, tc)
    assert_images_close(out.color, default.color)


def _jax_proc(js, cam):
    return jpreprocess(js.params.xyz, js.params.log_scales, js.params.quats,
                       js.get_opacity[:, 0], js.get_features, cam,
                       alive=js.alive, active_sh_degree=js.active_sh_degree,
                       max_sh_degree=js.max_sh_degree)


def test_tile_past_cap_overflows_in_jax_only():
    js = random_scene(150, seed=5, spread=0.3)   # crowded centre tiles
    cam = make_camera(64, 64)
    # a cap one short of the longest tile: render_safe retries once
    jp = _jax_proc(js, cam)
    jb = bin_and_sort(jp, 4, 4, 1 << 16)
    cap = int(np.max(np.asarray(jb.tile_end) - np.asarray(jb.tile_start))) - 1
    jout = _jax_tiled(js, cam, tile_cap=cap, max_instances=1 << 16)
    assert bool(jout.overflow)        # a tile passed the cap
    with pytest.warns(UserWarning, match="retrying at doubled"):
        jsafe = jrender_mod.render_safe(js, cam, impl="tiled", tile_cap=cap,
                                        chunk=64, max_instances=1 << 16)
    assert not bool(jsafe.overflow)
    got = trender.render(port_scene(js), port_camera(cam), impl="tiled",
                         tile_cap=cap, max_instances=1 << 16)
    assert not bool(got.overflow)
    for f in ("color", "depth", "final_T"):
        assert_images_close(getattr(got, f), getattr(jsafe, f), name=f)
    assert_n_contrib_close(got.n_contrib, jsafe.n_contrib)


def test_render_safe_doubles_only_the_budget():
    ts = port_scene(random_scene(60, seed=1))
    tc = port_camera(make_camera(64, 64))
    big = trender.render(ts, tc, impl="tiled", max_instances=1 << 16)
    with pytest.warns(UserWarning, match="max_instances=128"):
        out = trender.render_safe(ts, tc, impl="tiled", max_instances=128,
                                  tile_cap=1, max_retries=6)
    assert not bool(out.overflow)
    assert torch.equal(out.color, big.color)


def test_point_cloud_render_matches_jax(jax_pallas):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    cam = make_camera(48, 48)
    want = jax.jit(lambda p: jrender_mod.point_cloud_render(
        p, cam, point_scale=0.02, max_instances=8192, tile_cap=256,
        chunk=32).color)(jnp.asarray(pts))
    got = trender.point_cloud_render(torch.from_numpy(pts), port_camera(cam),
                                     point_scale=0.02, max_instances=8192,
                                     tile_cap=256, chunk=32)
    assert got.color.shape == (48, 48, 3) and got.color.device.type == "cpu"
    assert float(got.color.max()) > 0.9 and torch.isfinite(got.color).all()
    assert_images_close(got.color, want)
    # a coloured cloud and a background
    col = torch.from_numpy(rng.rand(200, 3).astype(np.float32))
    bg = torch.tensor([0.0, 0.0, 1.0])
    out = trender.point_cloud_render(torch.from_numpy(pts), port_camera(cam),
                                     point_scale=0.02, color=col, bg=bg)
    far = out.final_T > 0.999
    assert far.any() and torch.allclose(out.color[far][:, 2], torch.ones(1),
                                        atol=1e-3)


# ---- click tracing ----

@pytest.mark.parametrize("radius", [2.0, 0.3])
def test_trace_from_click_matches_jax(jax_pallas, radius):
    js = _two_cluster_scene(seed=3)
    jcams = jorbit_cameras(5, 4.0, 0.8, 0.8, 64, 64)
    jscene, jnorm = jtracing.trace_from_click(
        js, jcams, click_view=0, click_xy=(31.5, 31.5),
        point_segmentor=jfake.FakePointSegmentor(radius=radius),
        mask_thres=0.3, tile_cap=512, chunk=64)
    ts = port_scene(js)
    out, tnorm = tracing.trace_from_click(
        ts, [port_camera(c) for c in jcams], click_view=0,
        click_xy=(31.5, 31.5),
        point_segmentor=fake.FakePointSegmentor(radius=radius),
        mask_thres=0.3, tile_cap=512, chunk=64)
    assert out is ts   # written in place
    tm, jm = ts.mask.numpy(), np.asarray(jscene.mask)
    assert jm.sum() > 0
    assert (tm != jm).sum() <= max(1, 1e-4 * jm.size)
    assert_images_close(tnorm, jnorm, name="normalised weights")
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_trace_from_click_skips_views_that_miss_the_point():
    ts = port_scene(_two_cluster_scene(seed=3))
    cams = [port_camera(c) for c in jorbit_cameras(4, 4.0, 0.8, 0.8, 32, 32)]
    seen = []

    def seg(img, pts):
        seen.append(np.asarray(pts).copy())
        return np.ones(img.shape[:2], np.float32)

    # a click on an uncovered corner pixel: depth 0, the point lands at
    # the camera, behind every other view's image plane or outside it
    _, norm = tracing.trace_from_click(ts, cams, 0, (0.0, 0.0), seg)
    assert len(seen) < len(cams)
    assert norm.shape == (ts.capacity,)
    # one render for each view that sees the point: the click view's
    # gives both the depth and the segmentor's image
    calls = []

    def counting_render(s, c):
        calls.append(c)
        return trender.render(s, c)

    seen.clear()
    tracing.trace_from_click(ts, cams, 1, (15.5, 15.5), seg,
                             render_fn=counting_render)
    assert 1 <= len(calls) == len(seen)
