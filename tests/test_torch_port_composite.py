"""Port vs JAX: the forward tile compositor (kernel B2's plain version)
against the forward of `make_pallas_compositor_sorted` (Pallas, interpret
mode), both fed the same binning; and `tiles_to_image`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.binning_sorted import sorted_bin as jsorted_bin
from gaussianeditor_tpu.ops.composite import tiles_to_image as jtiles_to_image
from gaussianeditor_tpu.ops.pallas_composite import make_pallas_compositor_sorted
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
from gaussianeditor_tpu_torch.ops.tile_composite import (
    forward_tiles,
    forward_tiles_plain,
)
from gaussianeditor_tpu_torch.testing import assert_images_close
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import one_torch_thread, port_proc  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_INSTANCES = 8192


@functools.lru_cache(maxsize=None)
def _jit_forward(grid_x, grid_y, capacity, sh):
    comp = make_pallas_compositor_sorted(grid_x * grid_y, grid_x, 3,
                                         capacity, MAX_INSTANCES)

    def f(scene, cam):
        proc = jpreprocess(
            scene.params.xyz, scene.params.log_scales, scene.params.quats,
            scene.get_opacity[:, 0], scene.get_features, cam,
            alive=scene.alive, active_sh_degree=scene.active_sh_degree,
            max_sh_degree=sh)
        sb = jsorted_bin(proc, grid_x, grid_y, MAX_INSTANCES)
        return proc, comp(proc.mean2d, proc.conic, proc.opacity, proc.color,
                          proc.depth, sb)

    return jax.jit(f)


@pytest.fixture(scope="module", params=[(7, 48, 48), (1, 40, 72)],
            ids=["48x48", "40x72"])
def composited(request):
    seed, h, w = request.param
    js = random_scene(150, seed=seed, max_sh_degree=1, capacity=160)
    gx, gy = -(-w // 16), -(-h // 16)
    proc, want = _jit_forward(gx, gy, 160, 1)(js, make_camera(h, w))
    proc = jax.tree_util.tree_map(np.asarray, proc)
    want = jax.tree_util.tree_map(np.asarray, want)
    sb = sorted_bin(port_proc(proc), gx, gy, MAX_INSTANCES)
    got = forward_tiles(sb, gx, 3)
    return got, want, sb, gx


def test_compositor_images_match(composited):
    got, want, _, _ = composited
    assert_images_close(got.color.numpy(), want.color, name="color")
    assert_images_close(got.final_T.numpy(), want.final_T, name="final_T")
    assert_images_close(got.depth.numpy(), want.depth, loose=2e-2,
                        name="depth")


def test_compositor_n_contrib_exact(composited):
    got, want, _, _ = composited
    assert got.n_contrib.dtype == torch.int32
    np.testing.assert_array_equal(got.n_contrib.numpy(), want.n_contrib)
    assert want.n_contrib.max() > 0


def test_empty_tiles_and_work_count(composited):
    got, _, sb, gx = composited
    bounds = sb.tile_bounds.clone()
    bounds[1] = bounds[0]  # tile 0 loses its rows to tile 1
    out, _, _ = forward_tiles_plain(bounds, sb.payload, gx, 3)
    assert torch.all(out.color[0] == 0.0) and torch.all(out.depth[0] == 0.0)
    assert torch.all(out.final_T[0] == 1.0)
    assert torch.all(out.n_contrib[0] == 0)
    _, evaluated, contributed = forward_tiles_plain(sb.tile_bounds,
                                                    sb.payload, gx, 3)
    cnt = (sb.tile_bounds[1:] - sb.tile_bounds[:-1]).to(torch.int64)
    # a pixel evaluates its tile's rows up to its crossing at most, and
    # at least up to its last contributor
    assert torch.all(evaluated <= cnt[:, None])
    assert torch.all(evaluated >= got.n_contrib.to(torch.int64))
    assert torch.all(contributed <= got.n_contrib.to(torch.int64))
    assert contributed.sum() > 0


@pytest.mark.parametrize("h,w", [(40, 72), (64, 64), (17, 33)])
def test_tiles_to_image_matches(h, w):
    gx, gy = -(-w // 16), -(-h // 16)
    buf = np.random.RandomState(0).randn(gx * gy, 256, 2).astype(np.float32)
    want = np.asarray(jtiles_to_image(jnp.asarray(buf), gx, gy, h, w))
    got = tiles_to_image(torch.from_numpy(buf), gx, gy, h, w).numpy()
    np.testing.assert_array_equal(got, want)
