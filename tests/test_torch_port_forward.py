"""Kernel B5's layout and its plain version's contract, on the CPU.

B5 (`csrc/forward_chunk.cu`) stages a tile's chunks two at a time, lane
p % 128 of chunk bounds[t] + 2 batch + p / 128 in slot p, and gives the
row in slot i the n_contrib chunk_offset + lane + 1. That walks the
tile's rows in order, at B2's positions, when each tile's live chunks
are contiguous, all full but the last, with chunk_offset[c] = (c -
bounds[t]) 128: checked here for `dense_bin` on a seeded scene (budget
cut or not) and for `testing.dense_from_rows`, the card tests' layout.
`forward_chunks_plain` over such a layout equals `composite_rows_plain`
(B2's plain version) over the same rows bit for bit, at every width the
kernel's instances take.
"""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu_torch.core.cameras import lookat_camera
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.binning_dense import CHUNK, dense_bin
from gaussianeditor_tpu_torch.ops.dense_composite import (
    forward_chunks,
    forward_chunks_plain,
    tile_chunk_bounds,
)
from gaussianeditor_tpu_torch.ops.render import preprocess_scene
from gaussianeditor_tpu_torch.ops.tile_composite import composite_rows_plain
from gaussianeditor_tpu_torch.testing import adversarial_rows, dense_from_rows

BATCH = 256  # rows B5 stages a batch: two chunks


def _proc(ch, n=600, capacity=900, hw=96, seed=4):
    """A small scene's preprocess on the CPU, a third of its slots dead;
    ch != 3 renders a seeded [capacity, ch] feature."""
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
        log_scales=pad(np.log(rng.uniform(0.05, 0.4, (n, 3)))),
        quats=pad(rng.randn(n, 4)),
    ), max_sh_degree=1, active_sh_degree=1, alive=np.arange(capacity) < n)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, hw, hw,
                        device="cpu")
    oc = None
    if ch != 3:
        oc = torch.from_numpy(rng.uniform(0, 1, (capacity, ch)).astype(
            np.float32))
    with torch.no_grad():
        return preprocess_scene(scene, cam, override_color=oc)


def _check_layout(db):
    """Each tile's live chunks [bounds[t], bounds[t+1]) are its own, full
    but the last, at offsets 0, 128, ...; every other chunk is dead; and
    B5's staging visits the tile's rows in order, with n_contrib its
    position + 1. Returns the chunks per tile."""
    bounds = tile_chunk_bounds(db).tolist()
    tile = db.chunk_tile.tolist()
    nvalid = db.chunk_nvalid.tolist()
    offset = db.chunk_offset.tolist()
    T = len(bounds) - 1
    owned = np.zeros(len(nvalid), bool)
    for t in range(T):
        c0, c1 = bounds[t], bounds[t + 1]
        owned[c0:c1] = True
        assert c0 <= c1
        for c in range(c0, c1):
            assert tile[c] == t
            assert offset[c] == (c - c0) * CHUNK
            assert nvalid[c] == CHUNK if c < c1 - 1 else 1 <= nvalid[c] <= CHUNK
        # B5's batches: slot p holds lane p % 128 of chunk c + p / 128, live
        # below the chunk's n_valid and inside the tile's chunks
        seen = []
        for c in range(c0, c1, 2):
            for p in range(BATCH):
                cp, lane = c + p // CHUNK, p % CHUNK
                if cp < c1 and lane < nvalid[cp]:
                    seen.append(offset[cp] + lane + 1)
        cnt = (c1 - c0 - 1) * CHUNK + nvalid[c1 - 1] if c1 > c0 else 0
        assert seen == list(range(1, cnt + 1))
    assert not any(nvalid[c] for c in np.flatnonzero(~owned))
    return np.diff(bounds)


@pytest.mark.parametrize("budget", [1 << 16, 6000])
def test_dense_bin_layout_is_what_b5_walks(budget):
    proc = _proc(3)
    db = dense_bin(proc, 6, 6, budget)
    assert bool(db.overflow) == (budget == 6000)
    per_tile = _check_layout(db)
    # several tiles take more than one batch, some an odd chunk count
    assert per_tile.max() > 2 and (per_tile % 2 == 1).any()


@pytest.mark.parametrize("seed", [20, 21])
def test_dense_from_rows_layout_is_what_b5_walks(seed):
    start, cnt, payload, _ = adversarial_rows(seed, 3)
    _, db = dense_from_rows(start, cnt, payload)
    per_tile = _check_layout(db)
    assert (per_tile == 3).any() and (per_tile == 2).any()


@pytest.mark.parametrize("ch", [1, 3, 8, 32])
def test_forward_chunks_plain_is_composite_rows_plain(ch):
    """B5's plain version over the chunk layout of B2's rows is B2's plain
    version over the rows, bit for bit, and the wrapper takes it for CPU
    tensors."""
    start, cnt, payload, gx = adversarial_rows(40 + ch, ch)
    inst, db = dense_from_rows(start, cnt, payload)
    got, ev, co = forward_chunks_plain(inst, db, gx)
    want, ev_w, co_w = composite_rows_plain(start, cnt, payload, gx, ch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ev, ev_w) and torch.equal(co, co_w)
    assert int(co.sum()) > 0
    for a, b in zip(forward_chunks(inst, db, gx), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ch", [3, 8])
def test_forward_chunks_plain_reads_only_live_lanes(ch):
    """Whatever the padding lanes and the dead chunk hold, the result is
    the same: B5 stages such lanes as rows every pixel skips."""
    start, cnt, payload, gx = adversarial_rows(50 + ch, ch)
    inst, db = dense_from_rows(start, cnt, payload)
    lane = torch.arange(CHUNK)
    pad = lane[None, :] >= db.chunk_nvalid[:, None]
    junk = torch.from_numpy(np.random.RandomState(ch).uniform(
        -1e3, 1e3, inst.shape).astype(np.float32))
    dirty = torch.where(pad[:, None, :], junk, inst)
    assert not torch.equal(dirty, inst)
    for a, b in zip(forward_chunks_plain(dirty, db, gx)[0],
                    forward_chunks_plain(inst, db, gx)[0]):
        assert torch.equal(a, b)
