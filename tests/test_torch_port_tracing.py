"""Port vs JAX: semantic tracing.

`sorted_bin` with the tracing's depth cut against `ops/binning.py::
bin_and_sort` (integer-exact, from the same preprocess), `apply_weights`
against `ops/apply_weights.py::apply_weights` with full, zero and random
soft masks at ch 1 and 2 and at 4, 16 and 128 tiles, the accumulation
over views, the overflow retry, `update_mask_from_views`, the bitwise
repeat, and kernel B4's plain version at GF 1 and 2.

Counts and weights: the two packages evaluate the same contribution
predicate in a different rounding order (XLA fuses the JAX scan, and a
(pixel, Gaussian) pair whose T lands within rounding of T_MIN, or whose
alpha lands within rounding of 1/255, may flip). So the counts must be
equal on every Gaussian but those of at most one flipped pair in 10,000
contributing pairs, and the normalised weights meet the JAX suite's image
bounds (`assert_images_close`); the raw sums agree to float32 rounding
on the Gaussians whose counts agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit import tracing as jtracing
from gaussianeditor_tpu.ops.apply_weights import apply_weights as japply
from gaussianeditor_tpu.ops.binning import bin_and_sort
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.edit import tracing
from gaussianeditor_tpu_torch.ops import apply_weights as aw
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    DEAD_KEY_BIASED,
    binning_key_plain,
    rank_segment_sum_plain,
    sorted_bin,
)
from gaussianeditor_tpu_torch.testing import assert_images_close
from tests.helpers import make_camera, random_scene
from tests.test_edit import _two_cluster_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_proc,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (height, width): 1, 4, 16 and 128 tiles, so depth cuts of 30, 29, 27 and
# 24 bits
SIZES = {"1tile": (16, 16), "4tiles": (32, 32), "16tiles": (64, 64),
         "128tiles": (128, 256)}


def _jax_proc(js, cam):
    C = js.capacity
    return jpreprocess(js.params.xyz, js.params.log_scales, js.params.quats,
                       js.get_opacity[:, 0], None, cam, alive=js.alive,
                       override_color=jnp.zeros((C, 1)))


@pytest.mark.parametrize("size", list(SIZES))
def test_sorted_bin_with_tracing_cut_matches_bin_and_sort(size):
    H, W = SIZES[size]
    js = random_scene(200, seed=3)
    jp = _jax_proc(js, make_camera(H, W))
    gx, gy = -(-W // 16), -(-H // 16)
    tile_bits = max((gx * gy + 1).bit_length(), 1)
    budget = 65536
    jb = bin_and_sort(jp, gx, gy, budget)
    sb = sorted_bin(port_proc(jp), gx, gy, budget, depth_bits=32 - tile_bits)
    nr = int(jb.num_rendered)
    assert nr > 0 and int(sb.num_rendered) == nr
    gid = torch.searchsorted(sb.b_incl, sb.rank.to(torch.int32), right=True)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jb.gauss_id)[:nr])
    np.testing.assert_array_equal(sb.tile_bounds[:-1].numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(sb.tile_bounds[1:].numpy(),
                                  np.asarray(jb.tile_end))
    # the key's plain version at this cut, biased int32: a dead rank's key
    # is INT32_MAX and sorts after every live one
    pp = port_proc(jp)
    key, _ = binning_key_plain(sb.b_incl, pp.tiles_touched, pp.rect_min,
                               pp.rect_max, pp.mean2d, pp.conic, pp.opacity,
                               pp.depth, pp.color, nr + 5, nr, gx,
                               32 - tile_bits)
    assert key.dtype == torch.int32
    assert int(key[:nr].max()) < DEAD_KEY_BIASED
    assert (key[nr:] == DEAD_KEY_BIASED).all()


def _mask(kind, H, W, ch, seed):
    if kind == "full":
        return np.ones((H, W, ch), np.float32)
    if kind == "zero":
        return np.zeros((H, W, ch), np.float32)
    return np.random.RandomState(seed).rand(H, W, ch).astype(np.float32)


def assert_counts_close(got, want, ch):
    """Equal but for at most one flipped pair in 10,000 contributing ones."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    flipped = np.abs(got - want).sum() / ch
    assert flipped <= max(1.0, 1e-4 * want.sum() / ch), (
        f"{flipped} flipped pairs of {want.sum() / ch}")
    assert np.all((got - want) % ch == 0)


def assert_weights_close(tw, tc, jw, jc):
    tw, jw = np.asarray(tw), np.asarray(jw)
    tc, jc = np.asarray(tc), np.asarray(jc)
    assert_images_close(tw / (tc[:, None] + 1e-7), jw / (jc[:, None] + 1e-7),
                        name="normalised weights")
    # the raw sums (hundreds of pixels of weight each) to float32 rounding
    same = tc == jc
    np.testing.assert_allclose(tw[same], jw[same], rtol=1e-5, atol=1e-5)


APPLY_CASES = {
    "full_4tiles_ch1": ("full", "4tiles", 1, 60, 1),
    "zero_4tiles_ch1": ("zero", "4tiles", 1, 30, 2),
    "random_16tiles_ch2": ("random", "16tiles", 2, 80, 4),
    "random_128tiles_ch1": ("random", "128tiles", 1, 200, 3),
    "random_128tiles_ch2": ("random", "128tiles", 2, 200, 3),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_apply_weights_matches_jax(case):
    kind, size, ch, n, seed = APPLY_CASES[case]
    H, W = SIZES[size]
    js = random_scene(n, seed=seed)
    cam = make_camera(H, W)
    img = _mask(kind, H, W, ch, seed)
    C = js.capacity
    w0 = np.random.RandomState(seed).rand(C, ch).astype(np.float32)
    c0 = np.arange(C, dtype=np.int32)   # running accumulators carry over
    jw, jc, jo = jax.jit(lambda s, c, i, w, k: japply(
        s, c, i, w, k, tile_cap=4096, chunk=128))(
        js, cam, jnp.asarray(img), jnp.asarray(w0), jnp.asarray(c0))
    tw, tc, to = aw.apply_weights(port_scene(js), port_camera(cam),
                                  torch.from_numpy(img), torch.from_numpy(w0),
                                  torch.from_numpy(c0))
    assert tc.dtype == torch.int32 and tw.shape == (C, ch)
    assert bool(to) == bool(jo) is False
    assert_counts_close(tc - torch.from_numpy(c0), np.asarray(jc) - c0, ch)
    assert_weights_close(tw, tc, jw, jc)
    if kind == "zero":
        np.testing.assert_array_equal(tw.numpy(), w0)
    assert int(tc.sum()) > int(c0.sum())


def _orbit(n, hw):
    jcams = jorbit_cameras(n, 4.0, 0.8, 0.8, hw, hw)
    return jcams, [port_camera(c) for c in jcams]


def _disk(hw, r):
    ys, xs = np.mgrid[0:hw, 0:hw]
    c = (hw - 1) / 2
    return (((xs - c) ** 2 + (ys - c) ** 2) < r ** 2).astype(np.float32)


def test_accumulate_over_views_matches_jax():
    js = _two_cluster_scene()
    jcams, tcams = _orbit(6, 64)
    rng = np.random.RandomState(0)
    masks = [_disk(64, 12) * rng.uniform(0.5, 1.0) for _ in jcams]
    jw, jc = jtracing.accumulate_view_weights(js, jcams, masks, tile_cap=4096)
    tw, tc = tracing.accumulate_view_weights(port_scene(js), tcams, masks)
    assert tw.shape == (js.capacity, 1) and tc.dtype == torch.int32
    assert_counts_close(tc, jc, 1)
    assert_weights_close(tw, tc, jw, jc)


def test_overflow_retry_equals_a_large_budget():
    ts = port_scene(random_scene(60, seed=1))
    cam = port_camera(make_camera(64, 64))
    img = torch.ones((64, 64, 1))
    C = ts.capacity
    w0, c0 = torch.zeros((C, 1)), torch.zeros((C,), dtype=torch.int32)
    _, _, over = aw.apply_weights(ts, cam, img, w0, c0, max_instances=128)
    assert bool(over)
    w_big, c_big, over_big = aw.apply_weights(ts, cam, img, w0, c0,
                                              max_instances=1 << 16)
    assert not bool(over_big)
    with pytest.warns(UserWarning, match="retrying at doubled"):
        w, c = tracing.accumulate_view_weights(ts, [cam], [img[..., 0]],
                                               max_instances=128)
    assert torch.equal(w, w_big) and torch.equal(c, c_big)


def test_update_mask_from_views_matches_jax():
    js = _two_cluster_scene()
    jcams, tcams = _orbit(6, 64)
    masks = [_disk(64, 12)] * len(jcams)
    jscene, jnorm = jtracing.update_mask_from_views(js, jcams, masks, 0.5,
                                                    tile_cap=4096)
    ts = port_scene(js)
    out, tnorm = tracing.update_mask_from_views(ts, tcams, masks, 0.5)
    assert out is ts   # written in place
    tm, jm = ts.mask.numpy(), np.asarray(jscene.mask)
    near = np.abs(np.asarray(jnorm) - 0.5) <= 1e-6
    np.testing.assert_array_equal(tm[~near], jm[~near])
    # the object cluster (first 30) mostly selected, the shell mostly not
    assert tm[:30].mean() > 0.6 and tm[30:90].mean() < 0.2
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_tracing_repeats_bitwise():
    ts = port_scene(_two_cluster_scene(seed=2))
    _, tcams = _orbit(4, 64)
    masks = [np.random.RandomState(i).rand(64, 64).astype(np.float32)
             for i in range(4)]
    w1, c1 = tracing.accumulate_view_weights(ts, tcams, masks)
    w2, c2 = tracing.accumulate_view_weights(ts, tcams, masks)
    assert torch.equal(w1, w2) and torch.equal(c1, c2)
    assert int(c1.sum()) > 0


@pytest.mark.parametrize("gf", [1, 2])
def test_b4_plain_at_narrow_rows_matches_float64(gf):
    rng = np.random.RandomState(gf)
    counts = rng.zipf(1.8, 1000).clip(max=200) * (rng.rand(1000) < 0.7)
    n = int(counts.sum())
    rows = (rng.randn(gf, n) * np.exp(3 * rng.randn(gf, n))).astype(np.float32)
    b_incl = np.cumsum(counts).astype(np.int32)
    got = rank_segment_sum_plain(torch.from_numpy(rows),
                                 torch.from_numpy(b_incl),
                                 torch.from_numpy(counts.astype(np.int32)),
                                 len(counts))
    want = np.zeros((len(counts), gf))
    ends = np.cumsum(counts)
    for g in range(len(counts)):
        want[g] = rows[:, ends[g] - counts[g]:ends[g]].astype(np.float64).sum(1)
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=1e-6, atol=0)
    assert not got[torch.from_numpy(counts == 0)].any()
