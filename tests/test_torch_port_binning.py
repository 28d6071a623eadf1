"""Port vs JAX: `ops/binning_sorted.py::sorted_bin`, fed the JAX
preprocess output, must match exactly: b_incl, tile_bounds, tile_nonempty,
num_rendered, overflow, the sorted pre-sort ranks and the sorted payload,
also on grids whose live keys set bit 31. Kernel B1's plain version runs
here, its biased int32 keys against the JAX kernel's uint32 keys; the CUDA
kernel is held against it on the card. `emulate_b1` replays the kernel's
block algorithm (its owner search, window walk, scan and aligned stores)
in numpy with the constants of `csrc/binning_key.cu`, against the plain
version on `testing.key_layouts`."""

import functools

import jax
import numpy as np
import pytest
import torch

import gaussianeditor_tpu.ops.binning_sorted as jbinning
from gaussianeditor_tpu.ops.binning_sorted import sorted_bin as jsorted_bin
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    DEAD_KEY,
    DEAD_KEY_BIASED,
    KEY_BIAS,
    binning_key_plain,
    key_depth_bits,
    sorted_bin,
)
from gaussianeditor_tpu_torch.testing import kernel_constants, key_layouts
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


# grids of 4 x 4, 5 x 3 (40 x 72 pixels), 16 x 12 (tiles from 128 on set
# bit 31 at 24 depth bits) and 82 x 53 (recon's 1297 x 840; from 4,096 on,
# at 19 depth bits)
GRIDS = [(0, 64, 64), (5, 40, 72), (0, 192, 256), (1, 840, 1297)]
BUDGET = 8192


def _budget(h, w):
    return BUDGET if h * w <= 64 * 64 else 1 << 16


def _binned(seed, h, w, max_instances, sh=1):
    js = random_scene(150, seed=seed, max_sh_degree=sh, capacity=200)
    gx, gy = -(-w // 16), -(-h // 16)
    proc, sb = _jit_stages(gx, gy, max_instances)(js, make_camera(h, w))
    proc = jax.tree_util.tree_map(np.asarray, proc)
    sb = jax.tree_util.tree_map(np.asarray, sb)
    return proc, sb, sorted_bin(port_proc(proc), gx, gy, max_instances), gx


@pytest.mark.parametrize("seed,h,w", GRIDS)
def test_sorted_bin_matches_exactly(seed, h, w):
    proc, want, got, gx = _binned(seed, h, w, _budget(h, w))
    total = int(want.num_rendered)
    assert total > 0 and not bool(want.overflow)
    T = want.tile_bounds.shape[0] - 1
    high = 1 << (31 - key_depth_bits(T))   # first tile whose key sets bit 31
    if T >= 128:
        assert want.tile_bounds[T] > want.tile_bounds[min(high, T)], \
            "no live key sets bit 31"
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
    assert key.dtype == torch.int32
    key = key.numpy().astype(np.int64)
    assert np.all(key[total:] == DEAD_KEY_BIASED)
    assert np.all(key[:total] < DEAD_KEY_BIASED)
    assert payload.shape == (7 + p.color.shape[1], total + 40)
    # the first instance of every visible Gaussian sits at its rect corner
    tt = p.tiles_touched.numpy()
    b_prev = got.b_incl.numpy() - tt
    for g in np.flatnonzero(tt)[:20]:
        rx, ry = p.rect_min[g].tolist()
        assert (key[b_prev[g]] + KEY_BIAS) >> kdb == ry * gx + rx


@pytest.mark.parametrize("seed,h,w", GRIDS)
def test_binning_key_plain_is_the_jax_key_biased(seed, h, w, monkeypatch):
    """Rank by rank over the JAX budget R, the plain version's int32 key
    plus 2^31 is the JAX key kernel's uint32 key (run in interpret mode,
    its output taken from an eager `sorted_bin`), and a stable sort of the
    biased keys puts every dead rank last."""
    js = random_scene(150, seed=seed, max_sh_degree=1, capacity=200)
    gx, gy = -(-w // 16), -(-h // 16)
    budget = _budget(h, w)
    jproc = jax.jit(lambda s, c: jpreprocess(
        s.params.xyz, s.params.log_scales, s.params.quats,
        s.get_opacity[:, 0], s.get_features, c, alive=s.alive,
        active_sh_degree=s.active_sh_degree,
        max_sh_degree=s.max_sh_degree))(js, make_camera(h, w))
    keys = []
    make = jbinning._make_key_kernel

    def spy(*args):
        call = make(*args)

        def run(*a):
            key, rows = call(*a)
            keys.append(np.asarray(key))
            return key, rows
        return run

    monkeypatch.setattr(jbinning, "_make_key_kernel", spy)
    want = jsorted_bin(jproc, gx, gy, budget)
    (jkey,) = keys
    R = -(-budget // 128) * 128
    total = int(want.num_rendered)
    assert 0 < total < R
    p = port_proc(jax.tree_util.tree_map(np.asarray, jproc))
    b_incl = torch.cumsum(p.tiles_touched, 0, dtype=torch.int32)
    key, _ = binning_key_plain(
        b_incl, p.tiles_touched, p.rect_min, p.rect_max, p.mean2d, p.conic,
        p.opacity, p.depth, p.color, R, total, gx, key_depth_bits(gx * gy))
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy().astype(np.int64) + KEY_BIAS,
                                  jkey[:R].astype(np.int64))
    assert np.all(jkey[total:R] == DEAD_KEY)
    skey = torch.sort(key, stable=True)[0].numpy()
    assert np.all(skey[total:] == DEAD_KEY_BIASED)
    assert np.all(skey[:total] < DEAD_KEY_BIASED)
    assert (w * h <= 64 * 64) or np.any(jkey[:total] >= 1 << 31)


# ---- kernel B1's block algorithm, replayed ----

def _count_le(b_incl, C, q, threads):
    """`count_le`: the block's search, a probe a thread."""
    tid = np.arange(threads)
    lo, hi = 0, C
    while hi - lo > threads:
        step = (hi - lo + threads - 1) // threads
        p = lo + (tid + 1) * step - 1
        le = (p < hi) & (b_incl[np.minimum(p, C - 1)] <= q)
        c = int(le.sum())
        assert np.all(le[:c]) and not np.any(le[c:]), "probes not a prefix"
        nhi = min(hi, lo + (c + 1) * step - 1) if c < threads else hi
        lo += c * step
        hi = nhi
    p = lo + tid
    le = (p < hi) & (b_incl[np.minimum(p, C - 1)] <= q)
    return lo + int(le.sum())


def _store_words(buf, written, start, cnt, words):
    """`store_words` at word address `start` of `buf`: the quads aligned
    on the address, whole or at the ragged ends in words; `written`
    counts the writes of each word."""
    a = start & 3
    base = start - a
    for qd in range(0, (a + cnt + 3) // 4):
        r = 4 * qd - a
        for i in range(4):
            if 0 <= r + i < cnt:
                buf[base + 4 * qd + i] = words[r + i]
                written[base + 4 * qd + i] += 1


def emulate_b1(b_incl, tt, rect_min, rect_max, fields, n, total, grid_x,
               depth_bits, key_offset=0, payload_offset=0):
    """Kernel B1's blocks in numpy, kRanks ranks each: (key [n] int32,
    payload [P, n] f32, pieces walked). The key and the payload are
    written at word offsets `key_offset` and `payload_offset` of flat
    buffers, so that the quads of `store_words` meet every alignment."""
    k = kernel_constants("binning_key.cu")
    threads, ranks, piece = k["kThreads"], k["kRanks"], k["kPiece"]
    C = len(b_incl)
    P = fields.shape[0]
    key_buf = np.zeros(key_offset + n, np.uint32)
    key_w = np.zeros(key_offset + n, np.int64)
    pay_buf = np.zeros(payload_offset + P * n, np.uint32)
    pay_w = np.zeros(payload_offset + P * n, np.int64)
    fbits = np.ascontiguousarray(fields, np.float32).view(np.uint32)
    btot = int(b_incl[-1])
    pieces = 0
    for q0 in range(0, n, ranks):
        cnt = min(ranks, n - q0)
        stop = min(q0 + cnt, btot)
        g_first = min(_count_le(b_incl, C, q0, threads), C - 1)
        own = np.full(ranks, -1, np.int64)
        own[0] = g_first
        if q0 < stop:
            base = (g_first + 1) & ~3
            while True:
                pieces += 1
                g = base + np.arange(piece)
                cur = np.where(g < C, b_incl[np.minimum(g, C - 1)], btot)
                prev = np.where(g == 0, 0, np.where(
                    g - 1 < C, b_incl[np.clip(g - 1, 0, C - 1)], btot))
                start = (cur > prev) & (prev > q0) & (prev < stop)
                own[prev[start] - q0] = g[start]
                g4 = base + 4 * np.arange(piece // 4)
                if np.any((cur[3::4] >= stop) | (g4 + 3 >= C - 1)):
                    break
                base += piece
        if q0 < btot < q0 + cnt:
            own[btot - q0] = C - 1
        marks = own[:cnt]
        owner = marks[marks >= 0][np.cumsum(marks >= 0) - 1]
        # the staged key fields, in uint32 arithmetic as the kernel's
        q = q0 + np.arange(cnt)
        bprev = (b_incl[owner] - tt[owner]).astype(np.int64)
        j = q - bprev
        live = (q < total) & (j >= 0) & (j < tt[owner])
        w = np.maximum(rect_max[owner, 0] - rect_min[owner, 0], 1)
        jd = np.where(live, j, 0)
        jy = jd // w
        jx = jd - jy * w
        tile = ((rect_min[owner, 1].astype(np.int64) + jy) * grid_x
                + rect_min[owner, 0] + jx) & 0xFFFFFFFF
        dk = fbits[6][owner].astype(np.int64) >> (32 - depth_bits)
        kv = ((((tile << depth_bits) & 0xFFFFFFFF) | dk) ^ (1 << 31))
        words = np.where(live, kv, 0x7FFFFFFF).astype(np.uint32)
        _store_words(key_buf, key_w, key_offset + q0, cnt, words)
        for f in range(P):
            _store_words(pay_buf, pay_w, payload_offset + f * n + q0, cnt,
                         fbits[f][owner])
    assert np.all(key_w[key_offset:] == 1), "a key word not written once"
    assert np.all(pay_w[payload_offset:] == 1), "a payload word not once"
    key = key_buf[key_offset:].view(np.int32)
    payload = pay_buf[payload_offset:].view(np.float32).reshape(P, n)
    return key, payload, pieces


def _layout_args(proc):
    tt = proc.tiles_touched.numpy().astype(np.int64)
    fields = torch.cat([proc.mean2d.T, proc.conic.T, proc.opacity[None],
                        proc.depth[None], proc.color.T]).numpy()
    return (np.cumsum(tt), tt, proc.rect_min.numpy().astype(np.int64),
            proc.rect_max.numpy().astype(np.int64), fields)


def test_key_layouts_cover_the_cases():
    """The layouts hold what their names say: a dead run longer than a
    window piece, a Gaussian over several blocks, n below, above and at
    total, n not a multiple of 4 or of a block's ranks, keys with bit 31,
    a single slot, 1 to 3 channels."""
    k = kernel_constants("binning_key.cu")
    lay = key_layouts()
    ns = [n for _, _, _, _, n, _, _ in lay]
    assert any(n % 4 for n in ns) and all(n % k["kRanks"] for n in ns)
    assert any(n > t for _, _, _, _, n, t, _ in lay)
    assert any(n < t for _, _, _, _, n, t, _ in lay)
    tts = [p.tiles_touched.numpy() for _, p, _, _, _, _, _ in lay]
    runs = []
    for tt in tts:
        edges = np.flatnonzero(np.diff(np.r_[1, tt, 1] == 0))
        runs += list(np.diff(edges)[::2])
    assert max(runs) > k["kPiece"]
    assert max(int(tt.max()) for tt in tts) > 2 * k["kRanks"]
    assert min(len(tt) for tt in tts) == 1
    assert {p.color.shape[1] for _, p, _, _, _, _, _ in lay} == {1, 2, 3}
    bit31 = 0
    for _, p, gx, _, n, total, db in lay:
        key, _ = binning_key_plain(
            torch.cumsum(p.tiles_touched, 0, dtype=torch.int32),
            p.tiles_touched, p.rect_min, p.rect_max, p.mean2d, p.conic,
            p.opacity, p.depth, p.color, n, total, gx, db)
        bit31 += int(((key.numpy() >= 0) & (key.numpy() != DEAD_KEY_BIASED))
                     .sum())
    assert bit31 > 0


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("index", range(5))
def test_b1_block_algorithm_matches_plain(index, offset):
    """The kernel's blocks replayed in numpy equal the plain version bit
    for bit on each layout, with the key and payload rows at each word
    alignment."""
    name, p, gx, _, n, total, db = key_layouts()[index]
    b_incl, tt, rmin, rmax, fields = _layout_args(p)
    key, payload, pieces = emulate_b1(b_incl, tt, rmin, rmax, fields, n,
                                      total, gx, db, key_offset=offset,
                                      payload_offset=(3 * offset) % 4)
    want_key, want_payload = binning_key_plain(
        torch.cumsum(p.tiles_touched, 0, dtype=torch.int32), p.tiles_touched,
        p.rect_min, p.rect_max, p.mean2d, p.conic, p.opacity, p.depth,
        p.color, n, total, gx, db)
    np.testing.assert_array_equal(key, want_key.numpy(), err_msg=name)
    np.testing.assert_array_equal(payload.view(np.uint32),
                                  want_payload.numpy().view(np.uint32),
                                  err_msg=name)
    assert pieces >= 1
