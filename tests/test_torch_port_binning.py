"""Port vs JAX: `ops/binning_sorted.py::sorted_bin`, fed the JAX
preprocess output, must match exactly: b_incl, tile_bounds, tile_nonempty,
num_rendered, overflow, the sorted pre-sort ranks and the sorted payload.
Kernel B1's plain version runs here; the CUDA kernel is held against it
on the card."""

import functools

import jax
import numpy as np
import pytest

from gaussianeditor_tpu.ops.binning_sorted import sorted_bin as jsorted_bin
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    DEAD_KEY,
    binning_key_plain,
    key_depth_bits,
    sorted_bin,
)
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import one_torch_thread, port_proc  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _jit_stages(grid_x, grid_y, max_instances):
    def f(scene, cam):
        proc = jpreprocess(
            scene.params.xyz, scene.params.log_scales, scene.params.quats,
            scene.get_opacity[:, 0], scene.get_features, cam,
            alive=scene.alive, active_sh_degree=scene.active_sh_degree,
            max_sh_degree=scene.max_sh_degree)
        return proc, jsorted_bin(proc, grid_x, grid_y, max_instances)

    return jax.jit(f)


def _binned(seed, h, w, max_instances, sh=1):
    js = random_scene(150, seed=seed, max_sh_degree=sh, capacity=200)
    gx, gy = -(-w // 16), -(-h // 16)
    proc, sb = _jit_stages(gx, gy, max_instances)(js, make_camera(h, w))
    proc = jax.tree_util.tree_map(np.asarray, proc)
    sb = jax.tree_util.tree_map(np.asarray, sb)
    return proc, sb, sorted_bin(port_proc(proc), gx, gy, max_instances), gx


@pytest.mark.parametrize("seed,h,w", [(0, 64, 64), (5, 40, 72)])
def test_sorted_bin_matches_exactly(seed, h, w):
    proc, want, got, _ = _binned(seed, h, w, 8192)
    total = int(want.num_rendered)
    assert total > 0 and not bool(want.overflow)
    np.testing.assert_array_equal(got.b_incl.numpy(), want.b_incl)
    np.testing.assert_array_equal(got.tile_bounds.numpy(), want.tile_bounds)
    np.testing.assert_array_equal(got.tile_nonempty.numpy(),
                                  want.tile_nonempty)
    assert int(got.num_rendered) == total
    assert bool(got.overflow) is False
    P = got.payload.shape[0]
    assert P == 7 + proc.color.shape[-1]
    # the JAX payload carries the pre-sort rank in row P, f32-exact
    np.testing.assert_array_equal(got.rank.numpy(),
                                  want.blocks[P, :total].astype(np.int64))
    np.testing.assert_array_equal(got.payload.numpy(),
                                  want.blocks[:P, :total])


def test_sorted_bin_overflow_matches():
    proc, want, got, _ = _binned(2, 64, 64, 200)
    R = 256  # 200 rounded up to the 128-row chunk
    assert int(want.num_rendered) > R and bool(want.overflow)
    assert bool(got.overflow) is True
    assert int(got.num_rendered) == int(want.num_rendered)
    assert got.payload.shape[1] == R  # buffers hold min(num_rendered, R)
    np.testing.assert_array_equal(got.tile_bounds.numpy(), want.tile_bounds)
    np.testing.assert_array_equal(got.rank.numpy(),
                                  want.blocks[got.payload.shape[0], :R]
                                  .astype(np.int64))


def test_binning_key_plain_dead_ranks():
    """Ranks past `total` get the dead key, which sorts after every live
    key; live keys decode to the tile walked in y-major rect order."""
    proc, want, got, gx = _binned(0, 64, 64, 8192)
    p = port_proc(proc)
    total = int(want.num_rendered)
    kdb = key_depth_bits(gx * gx)
    key, payload = binning_key_plain(
        got.b_incl, p.tiles_touched, p.rect_min, p.rect_max, p.mean2d,
        p.conic, p.opacity, p.depth, p.color, total + 40, total, gx, kdb)
    key = key.numpy()
    assert np.all(key[total:] == DEAD_KEY) and np.all(key[:total] < DEAD_KEY)
    assert payload.shape == (7 + p.color.shape[1], total + 40)
    # the first instance of every visible Gaussian sits at its rect corner
    tt = p.tiles_touched.numpy()
    b_prev = got.b_incl.numpy() - tt
    for g in np.flatnonzero(tt)[:20]:
        rx, ry = p.rect_min[g].tolist()
        assert key[b_prev[g]] >> kdb == ry * gx + rx
