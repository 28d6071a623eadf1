"""Kernel B4's and B2's arithmetic, checked on the CPU.

B4 (`csrc/rank_segment_sum.cu`): both binnings give it the b_incl it
needs (the inclusive cumsum of tiles_touched); the dense route's gather
(`rows_by_rank`) puts rank q's row of B6's aligned rows in column q; a
numpy emulation of the kernel's walk (one block per range of slots, the
block's ranks staged in pieces and groups of fields, each slot's segment
added in double in rank order) gives the sequential float64 sums,
rounded once, bit for bit, on B3's rows and on B6's gathered. B2 and B5
(the walk of `csrc/composite_forward.cuh`): their pre-test `power < thr`
never skips a pair whose float32 alpha reaches 1/255. The kernels'
constants are read from their sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaussianeditor_tpu_torch.core.cameras import lookat_camera
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.binning_dense import CHUNK, dense_bin
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    rank_segment_sum,
    sorted_bin,
)
from gaussianeditor_tpu_torch.ops.dense_composite import rows_by_rank
from gaussianeditor_tpu_torch.ops.render import preprocess_scene

CSRC = Path(__file__).resolve().parents[1] / "gaussianeditor_tpu_torch" / "csrc"


def _constant(source: str, name: str) -> float:
    m = re.search(rf"constexpr \w+ {name} = ([0-9.e+-]+)f?;",
                  (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return float(m.group(1))


B4_SLOTS = int(_constant("rank_segment_sum.cu", "kSlots"))
B4_PIECE = int(_constant("rank_segment_sum.cu", "kPiece"))
B4_FIELDS = int(_constant("rank_segment_sum.cu", "kFields"))
B2_MARGIN = np.float32(_constant("composite_forward.cuh", "kMargin"))


def _rows(gf, n, seed):
    """Values over six decades, of either sign: their sums cancel."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-4, 2, (gf, n))
    return (mag * np.where(rng.rand(gf, n) < 0.5, -1.0, 1.0)).astype(
        np.float32)


def _proc(n=400, capacity=600, hw=64, seed=3):
    """A small scene's preprocess on the CPU, a third of its slots dead."""
    rng = np.random.RandomState(seed)

    def pad(x):
        out = np.zeros((capacity,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.from_numpy(out)

    scene = GaussianScene.create(dict(
        xyz=pad(rng.uniform(-1, 1, (n, 3))),
        features_dc=pad(rng.randn(n, 1, 3) * 0.5),
        features_rest=pad(rng.randn(n, 3, 3) * 0.1),
        opacity_raw=pad(rng.uniform(-1, 3, (n, 1))),
        log_scales=pad(np.log(rng.uniform(0.02, 0.2, (n, 3)))),
        quats=pad(rng.randn(n, 4)),
    ), max_sh_degree=1, active_sh_degree=1, alive=np.arange(capacity) < n)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, hw, hw,
                        device="cpu")
    with torch.no_grad():
        return preprocess_scene(scene, cam)


@pytest.mark.parametrize("binning", ["sorted", "dense"])
def test_b4_b_incl_is_the_cumsum_of_tiles_touched(binning):
    """B4 takes a block's ranks from its first slot's first to its last
    slot's last: that needs b_incl to be the inclusive cumsum of
    tiles_touched, on both routes, budget cut or not."""
    proc = _proc()
    tt = proc.tiles_touched
    assert int(tt.sum()) > 0 and bool((tt == 0).any())
    for budget in (1 << 20, int(tt.sum()) // 3):
        with torch.no_grad():
            b = (sorted_bin(proc, 4, 4, budget) if binning == "sorted"
                 else dense_bin(proc, 4, 4, budget))
        assert b.b_incl.dtype == torch.int32
        assert torch.equal(b.b_incl, torch.cumsum(tt, 0, dtype=torch.int32))


def test_rows_by_rank_reads_aligned_slots():
    """Column q of the gathered rows is aligned slot a_by_rank[q] of B6's
    [NC, GF, CHUNK] rows: row [a // CHUNK, :, a % CHUNK]."""
    rng = np.random.RandomState(4)
    NC, GF, n = 7, 9, 500
    grows = torch.from_numpy(_rows(GF, NC * CHUNK, 5)).reshape(NC, GF, CHUNK)
    a = torch.from_numpy(rng.permutation(NC * CHUNK)[:n])
    got = rows_by_rank(grows, a)
    assert got.shape == (GF, n)
    want = torch.stack([grows[int(c) // CHUNK, :, int(c) % CHUNK]
                        for c in a], dim=1)
    assert torch.equal(got, want)


def emulate_b4(rows, b_incl, tt, C, slots=B4_SLOTS, piece=B4_PIECE,
               fields=B4_FIELDS):
    """rank_segment_sum.cu's walk in numpy: block b owns slots [b * slots,
    ...); its ranks, from its first slot's first to its last slot's last
    (cut to n), are staged `piece` ranks and `fields` fields at a time;
    each slot adds its part of each piece to its float64 accumulators in
    rank order; the block's [slots, GF] tile is rounded to float32."""
    gf, n = rows.shape
    out = np.zeros((C, gf), np.float32)
    for g0 in range(0, C, slots):
        ns = min(slots, C - g0)
        hi = np.minimum(b_incl[g0:g0 + ns].astype(np.int64), n)
        lo = np.minimum(b_incl[g0:g0 + ns].astype(np.int64)
                        - tt[g0:g0 + ns], n)
        blo, bhi = int(lo[0]), int(hi[-1])
        tile = np.zeros((ns, gf), np.float32)
        for f0 in range(0, gf, fields):
            nf = min(fields, gf - f0)
            acc = [[0.0] * nf for _ in range(ns)]
            for p0 in range(blo, bhi, piece):
                m = min(piece, bhi - p0)
                stage = rows[f0:f0 + nf, p0:p0 + m]
                for s in range(ns):
                    for r in range(max(lo[s], p0) - p0, min(hi[s], p0 + m) - p0):
                        for k in range(nf):
                            acc[s][k] += float(stage[k, r])
            tile[:, f0:f0 + nf] = np.asarray(acc, np.float64).reshape(ns, nf)
        out[g0:g0 + ns] = tile
    return out


def sequential_sums(rows_rank, b_incl, tt, C):
    """Each segment summed in float64 from its first rank to its last,
    rounded once."""
    gf, n = rows_rank.shape
    out = np.zeros((C, gf), np.float32)
    for g in range(C):
        hi = min(int(b_incl[g]), n)
        lo = min(int(b_incl[g]) - int(tt[g]), n)
        for f in range(gf):
            s = 0.0
            for r in range(lo, hi):
                s += float(rows_rank[f, r])
            out[g, f] = s
    return out


def _b4_case(name):
    """(counts, n, gf, slots, piece, fields) of each emulation case."""
    rng = np.random.RandomState(len(name))
    if name == "all_dead_ranges":
        # whole slot blocks without a rank, between live ones
        counts = rng.randint(1, 4, 64)
        counts[8:40] = 0
        return counts, int(counts.sum()), 5, 8, 16, 3
    if name == "cut_at_n":
        counts = rng.randint(0, 9, 50)
        counts[-3:] = 7
        return counts, int(counts.sum()) - 10, 4, 8, 16, 3
    if name == "spans_pieces":
        # a segment of 40 ranks across three pieces of 16, and one that
        # starts in a piece and ends in the next
        counts = rng.randint(0, 3, 40)
        counts[5], counts[9] = 40, 13
        return counts, int(counts.sum()), 7, 8, 16, 3
    if name == "every_tile":
        # one Gaussian touching all 1024 tiles of a 512x512 frame, at the
        # kernel's own block, piece and field sizes
        counts = rng.randint(0, 5, 600)
        counts[rng.rand(600) < 0.6] = 0
        counts[300] = 1024
        return counts, int(counts.sum()), 10, B4_SLOTS, B4_PIECE, B4_FIELDS
    if name == "wide_fields":
        # more fields than one pass takes (the dense route at ch 8)
        counts = rng.randint(0, 6, 300)
        return counts, int(counts.sum()), 15, B4_SLOTS, B4_PIECE, B4_FIELDS
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all_dead_ranges", "cut_at_n",
                                  "spans_pieces", "every_tile",
                                  "wide_fields"])
@pytest.mark.parametrize("source", ["b3_rows", "b6_gathered"])
def test_b4_block_walk_is_the_sequential_double_sum(name, source):
    counts, n, gf, slots, piece, fields = _b4_case(name)
    C = len(counts)
    b_incl = np.cumsum(counts).astype(np.int32)
    tt = counts.astype(np.int32)
    rows_rank = _rows(gf, n, seed=C)
    rows = rows_rank
    if source == "b6_gathered":
        # the ranks' rows scattered over B6's aligned rows [NC, GF, CHUNK]
        # and gathered back into rank order, as the dense route does
        rng = np.random.RandomState(n)
        NC = -(-n // CHUNK) + 2
        col = rng.permutation(NC * CHUNK)[:n]
        flat = np.zeros((gf, NC * CHUNK), np.float32)
        flat[:, col] = rows_rank
        grows = torch.from_numpy(flat.reshape(gf, NC, CHUNK).transpose(
            1, 0, 2).copy())
        rows = rows_by_rank(grows, torch.from_numpy(col)).numpy()
    got = emulate_b4(rows, b_incl, tt, C, slots, piece, fields)
    want = sequential_sums(rows_rank, b_incl, tt, C)
    np.testing.assert_array_equal(got, want)
    assert not got[counts == 0].any()
    # and the plain version (the CPU's float64 index_add_) agrees
    plain = rank_segment_sum(torch.from_numpy(rows), torch.from_numpy(b_incl),
                             torch.from_numpy(tt), C)
    np.testing.assert_array_equal(plain.numpy(), want)


ALPHA_MIN = np.float32(1.0 / 255.0)
ALPHA_MAX = np.float32(0.99)


def _thr(op):
    """composite_forward.cuh's thr_of(op) in float32."""
    one, k255 = np.float32(1.0), np.float32(255.0)
    return np.float32(np.log(one / (k255 * op))) - B2_MARGIN


def _ulps(x, k):
    """x moved by k float32 ulps (k of either sign)."""
    x = np.float32(x)
    toward = np.float32(np.inf if k > 0 else -np.inf)
    for _ in range(abs(k)):
        x = np.nextafter(x, toward)
    return x


def _alpha(op, power, exp_ulps=0):
    """fminf(0.99, op * expf(power)) in float32, expf moved by exp_ulps."""
    e = _ulps(np.exp(np.float32(power)), exp_ulps)
    return np.minimum(ALPHA_MAX, np.float32(np.float32(op) * e))


@settings(max_examples=400, deadline=None)
@given(op=st.floats(min_value=2.0 ** -8, max_value=1.0, exclude_min=True,
                    width=32),
       off=st.one_of(st.integers(-200, 200),
                     st.floats(min_value=-3e-3, max_value=3e-3)))
def test_b2_pretest_never_skips_a_contributing_pair(op, off):
    """power < thr implies alpha < 1/255, for power near thr: a few ulps
    from it, or within three margins. The kernel's expf and logf may be
    off by 2 and 1 ulps from numpy's: the check takes exp 2 ulps up and
    thr 2 ulps up, the worst case for the claim."""
    op = np.float32(op)
    thr = _ulps(_thr(op), 2)
    if isinstance(off, int):
        power = _ulps(thr, off)
    else:
        power = np.float32(thr + np.float32(off))
    if not power < thr or power > 0:
        return
    assert _alpha(op, power, exp_ulps=2) < ALPHA_MIN


@settings(max_examples=200, deadline=None)
@given(op=st.floats(min_value=2.0 ** -8, max_value=1.0, exclude_min=True,
                    width=32))
def test_b2_pretest_margin_is_small(op):
    """The margin costs few exact tests: just above thr + 2 margins the
    pair's alpha already reaches 1/255 (op above 1/255 by a little more)."""
    op = np.float32(op)
    if op < np.float32(1.01 / 255.0):
        return
    power = np.float32(_thr(op) + 2 * B2_MARGIN + np.float32(1e-3))
    if power > 0:
        return
    assert _alpha(op, power) >= ALPHA_MIN


def test_b2_pretest_dead_rows_skip_everything():
    """Opacity 0 (padding rows, culled slots) gives thr = +inf; an opacity
    whose 255 op underflows too."""
    with np.errstate(divide="ignore", over="ignore"):
        assert _thr(np.float32(0.0)) == np.inf
        assert _thr(np.float32(1e-45)) == np.inf
