"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip on a machine without a CUDA device (the kernels
have no CPU mode). This file imports neither JAX nor the JAX test
helpers, so on a GPU machine without JAX it runs with
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu_torch.core.cameras import lookat_camera
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    SortedBinning,
    binning_key,
    binning_key_plain,
    key_depth_bits,
    rank_segment_sum,
    rank_segment_sum_plain,
    sorted_bin,
)
from gaussianeditor_tpu_torch.ops.dense_composite import (
    MAX_CHANNELS,
    backward_chunks,
    backward_chunks_plain,
    forward_chunks,
    forward_chunks_plain,
    pack_instances,
    rows_by_rank,
)
from gaussianeditor_tpu_torch.ops.preprocess import (
    preprocess,
    preprocess_plain,
)
from gaussianeditor_tpu_torch.ops.render import preprocess_scene, render
from gaussianeditor_tpu_torch.ops.tile_composite import (
    backward_tiles,
    backward_tiles_plain,
    composite_rows_plain,
    forward_tiles,
    forward_tiles_plain,
)
from gaussianeditor_tpu_torch.testing import (
    TIE_COLOR,
    TIE_QUAT,
    TIE_X,
    TIE_Y,
    adversarial_rows,
    assert_images_close,
    dense_from_rows,
    fraction_equal,
    key_layouts,
    tie_camera,
    tie_scene,
)

pytestmark = pytest.mark.cuda

NO_LAUNCHES = dict.fromkeys(_kernels.SIGNATURES, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _scene(n, device, seed=0, capacity=None, sh=1):
    rng = np.random.RandomState(seed)
    cap = capacity or n
    k = (sh + 1) ** 2

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    quats = rng.randn(n, 4).astype(np.float32)
    params = dict(
        xyz=pad(rng.uniform(-1, 1, (n, 3))),
        features_dc=pad(rng.randn(n, 1, 3) * 0.5),
        features_rest=pad(rng.randn(n, k - 1, 3) * 0.1),
        opacity_raw=pad(rng.uniform(-1, 3, (n, 1))),
        log_scales=pad(np.log(rng.uniform(0.01, 0.06, (n, 3)))),
        quats=pad(quats),
    )
    return GaussianScene.create(params, max_sh_degree=sh,
                                active_sh_degree=sh,
                                alive=np.arange(cap) < n)


def _proc(scene, hw, device, ch=3):
    """One view's preprocess; ch != 3 renders a seeded [C, ch] feature."""
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, hw, hw,
                        device=device)
    oc = None
    if ch != 3:
        g = torch.Generator(device="cpu").manual_seed(ch)
        oc = torch.rand((scene.capacity, ch), generator=g).to(device)
    with torch.no_grad():
        return preprocess_scene(scene, cam, override_color=oc)


@pytest.mark.parametrize("budget", [1 << 20, 3000])
def test_binning_key_kernel_matches_plain(cuda, budget):
    proc = _proc(_scene(20000, cuda, capacity=30000), 256, cuda)
    gx = 16
    b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
    total = int(b_incl[-1])
    n = min(total, budget) + 64  # some dead ranks past `total` as well
    kdb = key_depth_bits(gx * gx)
    key, payload = binning_key(proc, b_incl, n, total, gx, kdb)
    want_key, want_payload = binning_key_plain(
        b_incl, proc.tiles_touched, proc.rect_min, proc.rect_max,
        proc.mean2d, proc.conic, proc.opacity, proc.depth, proc.color, n,
        total, gx, kdb)
    torch.cuda.synchronize()
    assert key.dtype == torch.int32
    assert torch.equal(key, want_key)
    assert torch.equal(payload, want_payload)


@pytest.mark.parametrize("index", range(5))
def test_binning_key_kernel_on_adversarial_layouts(cuda, index):
    """B1 bitwise against its plain version on `key_layouts`: a dead run
    longer than a block's window, a Gaussian over several blocks, n below
    and above total and not a multiple of 4, keys with bit 31, C = 1; and
    `sorted_bin` on the card bitwise the CPU's (sort order, payload, tile
    bounds)."""
    name, p, gx, gy, n, total, db = key_layouts(device=cuda)[index]
    b_incl = torch.cumsum(p.tiles_touched, 0, dtype=torch.int32)
    key, payload = binning_key(p, b_incl, n, total, gx, db)
    want_key, want_payload = binning_key_plain(
        b_incl, p.tiles_touched, p.rect_min, p.rect_max, p.mean2d, p.conic,
        p.opacity, p.depth, p.color, n, total, gx, db)
    torch.cuda.synchronize()
    assert key.dtype == torch.int32
    assert torch.equal(key, want_key), name
    assert torch.equal(payload.view(torch.int32),
                       want_payload.view(torch.int32)), name
    got = sorted_bin(p, gx, gy, n, depth_bits=db)
    cpu = type(p)(*(t.cpu() for t in p))
    want = sorted_bin(cpu, gx, gy, n, depth_bits=db)
    for f in ("rank", "tile_bounds", "num_rendered", "overflow"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (name, f)
    assert torch.equal(got.payload.cpu().view(torch.int32),
                       want.payload.view(torch.int32)), name


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_forward_tile_kernel_matches_plain(cuda, ch):
    proc = _proc(_scene(20000, cuda, seed=ch), 200, cuda, ch=ch)
    gx = 13
    sb = sorted_bin(proc, gx, gx, 1 << 22)
    got = forward_tiles(sb, gx, ch)
    want, _, _ = forward_tiles_plain(sb.tile_bounds, sb.payload, gx, ch)
    torch.cuda.synchronize()
    assert_images_close(got.color, want.color, name="color")
    assert_images_close(got.depth, want.depth, loose=2e-2, name="depth")
    assert_images_close(got.final_T, want.final_T, name="final_T")
    assert torch.equal(got.n_contrib, want.n_contrib)


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_forward_tile_kernel_adversarial(cuda, ch):
    """B2 on rows made to sit on its thresholds: opacities just above
    1/255 and at the cap, centres far outside the tile (the kernel's
    pre-test skips a pair only where its alpha is surely below 1/255)."""
    start, cnt, payload, gx = adversarial_rows(30 + ch, ch, device=cuda)
    bounds = torch.cat([start, start[-1:] + cnt[-1:]]).to(torch.int32)
    T = start.shape[0]
    sb = SortedBinning(payload=payload, rank=None, tile_nonempty=cnt > 0,
                       tile_bounds=bounds, b_incl=None, num_rendered=None,
                       overflow=None)
    got = forward_tiles(sb, gx, ch)
    again = forward_tiles(sb, gx, ch)
    want = composite_rows_plain(start, cnt, payload, gx, ch)[0]
    torch.cuda.synchronize()
    assert got.color.shape == (T, 256, ch)
    assert_images_close(got.color, want.color, name="color")
    assert_images_close(got.final_T, want.final_T, name="final_T")
    assert torch.equal(got.n_contrib, want.n_contrib)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_render_on_cuda_counts_launches(cuda):
    scene = _scene(5000, cuda, capacity=8000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 64, 64,
                        device="cpu")
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = render(scene, cam)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(NO_LAUNCHES, binning_key=1,
                                            forward_tile=1,
                                            preprocess_forward=1)
    assert out.color.is_cuda and torch.isfinite(out.color).all()
    assert out.color.shape == (64, 64, 3) and out.color.max() > 0


def _cotangents(T, ch, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn((T, 256, ch), generator=g).to(device),
            torch.randn((T, 256), generator=g).to(device) * 0.1,
            torch.randn((T, 256), generator=g).to(device) * 0.05)


@pytest.mark.parametrize("ch", [1, 2, 3])
def test_backward_tile_kernel_matches_plain(cuda, ch):
    proc = _proc(_scene(20000, cuda, seed=5), 200, cuda, ch=ch)
    gx = 13
    sb = sorted_bin(proc, gx, gx, 1 << 22)
    tiles = forward_tiles(sb, gx, ch)
    g_color, g_depth, g_T = _cotangents(gx * gx, ch, cuda)
    args = (sb.tile_bounds, sb.payload, sb.rank, tiles, g_color, g_depth,
            g_T, gx, ch)
    got = backward_tiles(*args)
    want = backward_tiles_plain(*args)
    again = backward_tiles(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-2)
    assert torch.equal(got, again)
    # the widest instance is 3 channels: wider renders take the dense route
    wide = torch.zeros((gx * gx, 256, 4), device=cuda)
    with pytest.raises(ValueError, match="channels"):
        backward_tiles(sb.tile_bounds, sb.payload, sb.rank, tiles, wide,
                       g_depth, g_T, gx, 4)


def test_rank_segment_sum_kernel_matches_plain(cuda):
    rng = np.random.RandomState(3)
    counts = np.concatenate([rng.zipf(1.8, 5000).clip(max=300),
                             np.zeros(3000, np.int64)])
    rng.shuffle(counts)
    b_incl = torch.as_tensor(np.cumsum(counts).astype(np.int32), device=cuda)
    tt = torch.as_tensor(counts.astype(np.int32), device=cuda)
    n = int(counts.sum()) - 17   # a budget that cuts the last segments
    rows = torch.randn((10, n), device=cuda)
    C = len(counts)
    got = rank_segment_sum(rows, b_incl, tt, C)
    want = rank_segment_sum_plain(rows, b_incl, tt, C)
    torch.cuda.synchronize()
    scale = want.pow(2).mean(0).sqrt()
    assert float(((got - want).abs() / scale).max()) < 1e-5
    assert torch.equal(got, rank_segment_sum(rows, b_incl, tt, C))
    assert not got[tt == 0].any()
    # each segment summed in float64 in rank order and rounded once: the
    # plain version on the CPU sums in that order
    want_seq = rank_segment_sum_plain(rows.cpu(), b_incl.cpu(), tt.cpu(), C)
    assert torch.equal(got.cpu(), want_seq)


@pytest.mark.parametrize("layout", ["rows", "gathered"])
def test_rank_segment_sum_kernel_long_segment_bitwise(cuda, layout):
    """One Gaussian touching 1024 tiles among short and empty segments,
    across the kernel's staging pieces and slot blocks; B3's layout [GF,
    n], or B6's aligned rows [NC, GF, 128] gathered into rank order by
    `rows_by_rank`. Bitwise equal to the float64 sums in rank order,
    rounded once."""
    rng = np.random.RandomState(8)
    counts = rng.zipf(2.0, 3000).clip(max=40) * (rng.rand(3000) < 0.4)
    counts[1234] = 1024
    b_incl = torch.as_tensor(np.cumsum(counts).astype(np.int32), device=cuda)
    tt = torch.as_tensor(counts.astype(np.int32), device=cuda)
    n = int(counts.sum())
    C = len(counts)
    GF = 9
    rows = torch.randn((GF, n), device=cuda) * torch.exp(
        4 * torch.randn((GF, n), device=cuda))
    src = rows
    if layout == "gathered":
        NC = -(-n // 128) + 3
        perm = torch.randperm(NC * 128, generator=torch.Generator().manual_seed(
            8))[:n].to(cuda)
        aligned = torch.zeros((GF, NC * 128), device=cuda)
        aligned[:, perm] = rows
        src = rows_by_rank(
            aligned.reshape(GF, NC, 128).permute(1, 0, 2).contiguous(), perm)
        assert torch.equal(src, rows)
    got = rank_segment_sum(src, b_incl, tt, C)
    again = rank_segment_sum(src, b_incl, tt, C)
    want = rank_segment_sum_plain(rows.cpu(), b_incl.cpu(), tt.cpu(), C)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    assert not got[tt == 0].any()


def test_render_backward_on_cuda_counts_launches(cuda):
    scene = _scene(5000, cuda, capacity=8000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 64, 64,
                        device=cuda)
    _kernels.reset_launch_counts()
    out = render(scene, cam)
    grads = torch.autograd.grad(out.color.sum() + out.depth.sum(),
                                [scene.xyz, scene.opacity_raw])
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(
        NO_LAUNCHES, binning_key=1, forward_tile=1, backward_tile=1,
        rank_segment_sum=1, preprocess_forward=1, preprocess_backward=1)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().sum()) > 0


def _dense_view(cuda, ch, seed=4):
    proc = _proc(_scene(20000, cuda, seed=seed), 200, cuda, ch=ch)
    gx = 13
    db = dense_bin(proc, gx, gx, 1 << 22)
    inst = pack_instances(proc.mean2d, proc.conic, proc.opacity, proc.color,
                          proc.depth, db)
    return db, inst, gx


@pytest.mark.parametrize("ch", [1, 3, 8])
def test_forward_chunk_kernel_matches_plain(cuda, ch):
    db, inst, gx = _dense_view(cuda, ch)
    got = forward_chunks(inst, db, gx)
    want, _, _ = forward_chunks_plain(inst, db, gx)
    again = forward_chunks(inst, db, gx)
    torch.cuda.synchronize()
    assert_images_close(got.color, want.color, name="color")
    assert_images_close(got.depth, want.depth, loose=2e-2, name="depth")
    assert_images_close(got.final_T, want.final_T, name="final_T")
    assert fraction_equal(got.n_contrib, want.n_contrib) >= 0.999
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="channels"):
        wide = torch.zeros((inst.shape[0], 8 + MAX_CHANNELS, 128), device=cuda)
        forward_chunks(wide, db, gx)


@pytest.mark.parametrize("ch", [1, 3, 8, 32])
def test_forward_chunk_kernel_adversarial(cuda, ch):
    """B5 on the adversarial rows laid out in chunks of 128: partial last
    chunks, tiles of an odd chunk count, walks that end inside a chunk.
    Within the image bounds of its plain version, bitwise repeatable,
    blind to what the padding lanes hold, and at ch 1 and 3 bitwise equal
    to B2 on the same rows."""
    start, cnt, payload, gx = adversarial_rows(60 + ch, ch, device=cuda)
    inst, db = dense_from_rows(start, cnt, payload)
    T = start.shape[0]
    got = forward_chunks(inst, db, gx)
    again = forward_chunks(inst, db, gx)
    pad = (torch.arange(128, device=cuda)[None, :]
           >= db.chunk_nvalid[:, None])[:, None, :]
    junk = torch.rand(inst.shape, generator=torch.Generator().manual_seed(ch)
                      ).to(cuda) * 2e3 - 1e3
    dirty = forward_chunks(torch.where(pad, junk, inst), db, gx)
    want = forward_chunks_plain(inst, db, gx)[0]
    torch.cuda.synchronize()
    assert got.color.shape == (T, 256, ch)
    assert_images_close(got.color, want.color, name="color")
    assert_images_close(got.depth, want.depth, loose=2e-2, name="depth")
    assert_images_close(got.final_T, want.final_T, name="final_T")
    assert torch.equal(got.n_contrib, want.n_contrib)
    for a, b, c in zip(got, again, dirty):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    if ch <= 3:
        bounds = torch.cat([start, start[-1:] + cnt[-1:]]).to(torch.int32)
        sb = SortedBinning(payload=payload, rank=None, tile_nonempty=cnt > 0,
                           tile_bounds=bounds, b_incl=None, num_rendered=None,
                           overflow=None)
        for a, b in zip(got, forward_tiles(sb, gx, ch)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("ch", [1, 3, 8, 16, 32])
def test_backward_chunk_kernel_matches_plain(cuda, ch):
    db, inst, gx = _dense_view(cuda, ch, seed=6)
    tiles = forward_chunks(inst, db, gx)
    g_color, g_depth, g_T = _cotangents(gx * gx, ch, cuda)
    args = (inst, db, tiles, g_color, g_depth, g_T, gx)
    got = backward_chunks(*args)
    want = backward_chunks_plain(*args)
    again = backward_chunks(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-2)
    assert torch.equal(got, again)
    assert not got[db.chunk_nvalid == 0].any()


def _hold_to_float64(got, plain, *args):
    """`got` against `plain(*args)` evaluated in float64: every entry
    within the gradient tolerance plus 16 times what a float32 evaluation
    cannot decide there, the entry's largest change over two runs with
    every floating input moved by up to 2^-24 of itself. On the
    adversarial rows a few sums cancel by many orders of magnitude (the
    alpha cap makes dpower large, Gaussians hundreds of pixels away
    weight it by dx dy), and two float32 orders of the same sum differ
    there beyond atol 1e-3 / rtol 1e-2; elsewhere the allowance is nil
    (it widens the tolerance on under 1% of the entries). The plain
    version in float32 must meet the same bound."""
    gen = torch.Generator().manual_seed(0)

    def cast(x, noise):
        if isinstance(x, tuple):
            return type(x)(*(cast(v, noise) for v in x))
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        x = x.double()
        if noise:
            u = torch.rand(x.shape, generator=gen, dtype=torch.float64)
            x = x * (1.0 + 2.0 ** -24 * (2.0 * u.to(x.device) - 1.0))
        return x

    ref = plain(*(cast(a, False) for a in args))
    undecided = torch.zeros_like(ref)
    for _ in range(2):
        moved = plain(*(cast(a, True) for a in args))
        undecided = torch.maximum(undecided, (moved - ref).abs())
    tol = 1e-3 + 1e-2 * ref.abs()
    bound = tol + 16.0 * undecided
    want32 = plain(*args)
    assert bool(((want32.double() - ref).abs() <= bound).all())
    assert bool(((got.double() - ref).abs() <= bound).all())
    # the allowance widens the tolerance on a small share of entries
    assert float((16.0 * undecided > tol).double().mean()) < 1e-2


def test_backward_tile_kernel_adversarial(cuda):
    """B3 on rows made to stress its pixel sums: centres far outside the
    tile, radii of hundreds of pixels, opacities at the cap and near
    1/255 (`gaussianeditor_tpu_torch.testing.adversarial_rows`)."""
    start, cnt, payload, gx = adversarial_rows(11, 3, device=cuda)
    tiles = composite_rows_plain(start, cnt, payload, gx, 3)[0]
    bounds = torch.cat([start, start[-1:] + cnt[-1:]]).to(torch.int32)
    n = payload.shape[1]
    rank = torch.randperm(n, generator=torch.Generator().manual_seed(0)
                          ).to(cuda)
    g_color, g_depth, g_T = _cotangents(start.shape[0], 3, cuda, seed=11)
    args = (bounds, payload, rank, tiles, g_color, g_depth, g_T, gx, 3)
    got = backward_tiles(*args)
    again = backward_tiles(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _hold_to_float64(got, backward_tiles_plain, *args)
    assert torch.equal(got, again)


def test_backward_chunk_kernel_adversarial(cuda):
    """B6 at ch 8 on the adversarial rows, laid out in chunks of 128."""
    start, cnt, payload, gx = adversarial_rows(12, 8, device=cuda)
    inst, db = dense_from_rows(start, cnt, payload)
    tiles = composite_rows_plain(start, cnt, payload, gx, 8)[0]
    g_color, g_depth, g_T = _cotangents(start.shape[0], 8, cuda, seed=12)
    args = (inst, db, tiles, g_color, g_depth, g_T, gx)
    got = backward_chunks(*args)
    again = backward_chunks(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _hold_to_float64(got, backward_chunks_plain, *args)
    assert torch.equal(got, again)


def test_backward_routes_bitwise_equal_and_repeatable(cuda):
    """B3 then B4 and B6 then the rank gather then B4 give the same
    per-Gaussian sums bit for bit (the same rows in the same batches, the
    same arithmetic), and each repeats bitwise."""
    proc = _proc(_scene(20000, cuda, seed=7), 200, cuda)
    gx = 13   # 169 tiles: the two routes' depth keys keep the same bits
    C = proc.tiles_touched.shape[0]
    sb = sorted_bin(proc, gx, gx, 1 << 22)
    db = dense_bin(proc, gx, gx, 1 << 22)
    tiles = forward_tiles(sb, gx, 3)
    inst = pack_instances(proc.mean2d, proc.conic, proc.opacity, proc.color,
                          proc.depth, db)
    g = _cotangents(gx * gx, 3, cuda, seed=7)

    def sorted_route():
        rows = backward_tiles(sb.tile_bounds, sb.payload, sb.rank, tiles, *g,
                              gx, 3)
        return rank_segment_sum(rows, sb.b_incl, proc.tiles_touched, C)

    def dense_route():
        rows = rows_by_rank(backward_chunks(inst, db, tiles, *g, gx),
                            db.a_by_rank)
        return rank_segment_sum(rows, db.b_incl, proc.tiles_touched, C)

    a, b = sorted_route(), dense_route()
    a2, b2 = sorted_route(), dense_route()
    torch.cuda.synchronize()
    assert float(a.abs().max()) > 0
    assert torch.equal(a, a2)
    assert torch.equal(b, b2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("ch", [3, 8])
def test_render_pallas4_backward_on_cuda_counts_launches(cuda, ch):
    scene = _scene(5000, cuda, capacity=8000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 64, 64,
                        device=cuda)
    oc = None if ch == 3 else torch.rand((8000, ch), device=cuda)
    _kernels.reset_launch_counts()
    out = render(scene, cam, override_color=oc,
                 impl="pallas4" if ch == 3 else None)
    grads = torch.autograd.grad(out.color.sum() + out.depth.sum(),
                                [scene.xyz, scene.opacity_raw])
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(
        NO_LAUNCHES, forward_chunk=1, backward_chunk=1, rank_segment_sum=1,
        preprocess_forward=1, preprocess_backward=1)
    assert out.color.shape == (64, 64, ch)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().sum()) > 0


@pytest.mark.parametrize("ch", range(1, 9))
def test_render_every_width_on_cuda(cuda, ch):
    """Widths up to 3 take the sorted route (B1-B4), wider ones the dense
    route (B5, B6, B4); each gives an image and finite gradients."""
    scene = _scene(3000, cuda, seed=ch, capacity=4000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 48, 48,
                        device=cuda)
    oc = torch.rand((4000, ch), device=cuda, requires_grad=True)
    _kernels.reset_launch_counts()
    out = render(scene, cam, override_color=oc)
    grads = torch.autograd.grad(out.color.sum(), [scene.xyz, oc])
    torch.cuda.synchronize()
    if ch <= 3:
        want = dict(NO_LAUNCHES, binning_key=1, forward_tile=1,
                    backward_tile=1, rank_segment_sum=1)
    else:
        want = dict(NO_LAUNCHES, forward_chunk=1, backward_chunk=1,
                    rank_segment_sum=1)
    want.update(preprocess_forward=1, preprocess_backward=1)
    assert _kernels.launch_counts() == want
    assert out.color.shape == (48, 48, ch) and out.color.max() > 0
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[1].abs().sum()) > 0


def test_render_on_cuda_without_compiler_raises(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    scene = _scene(500, cuda)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 32, 32,
                        device=cuda)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
        render(scene, cam)


# ---- the edit loop's tracing and train step ----

def test_binning_key_kernel_at_a_28_bit_cut(cuda):
    """9 tiles leave 28 bits of depth: the cut semantic tracing takes."""
    proc = _proc(_scene(3000, cuda, seed=2), 48, cuda)
    gx = 3
    assert max((gx * gx + 1).bit_length(), 1) == 4
    b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
    total = int(b_incl[-1])
    key, payload = binning_key(proc, b_incl, total + 64, total, gx, 28)
    want_key, want_payload = binning_key_plain(
        b_incl, proc.tiles_touched, proc.rect_min, proc.rect_max,
        proc.mean2d, proc.conic, proc.opacity, proc.depth, proc.color,
        total + 64, total, gx, 28)
    torch.cuda.synchronize()
    assert torch.equal(key, want_key)
    assert torch.equal(payload, want_payload)
    sb = sorted_bin(proc, gx, gx, 1 << 20, depth_bits=28)
    assert int(sb.tile_bounds[-1]) == total


def test_rank_segment_sum_kernel_at_gf_2(cuda):
    """B4 on the tracing's rows: GF = ch + 1 = 2, C = 1000 (not a multiple
    of the kernel's 256 slots a block, nor of 4)."""
    rng = np.random.RandomState(5)
    counts = rng.zipf(1.8, 1000).clip(max=700) * (rng.rand(1000) < 0.8)
    b_incl = torch.as_tensor(np.cumsum(counts).astype(np.int32), device=cuda)
    tt = torch.as_tensor(counts.astype(np.int32), device=cuda)
    n = int(counts.sum())
    rows = torch.rand((2, n), device=cuda)
    rows[1] = torch.randint(0, 513, (n,), device=cuda).float()  # counts
    got = rank_segment_sum(rows, b_incl, tt, 1000)
    want = rank_segment_sum_plain(rows.cpu(), b_incl.cpu(), tt.cpu(), 1000)
    torch.cuda.synchronize()
    assert got.shape == (1000, 2)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, rank_segment_sum(rows, b_incl, tt, 1000))


def _counts_close(got, want, ch):
    d = (got.cpu().long() - want.cpu().long()).abs().sum() / ch
    return float(d) <= max(1.0, 1e-4 * float(want.long().sum()) / ch)


def test_apply_weights_on_cuda_repeats_and_matches_cpu(cuda):
    from gaussianeditor_tpu_torch.ops.apply_weights import apply_weights

    scene = _scene(6000, cuda, seed=4, capacity=8000)
    scene_cpu = _scene(6000, "cpu", seed=4, capacity=8000)
    cams = [lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 96, 160,
                          device=d) for d in (cuda, "cpu")]
    img = torch.rand((96, 160, 2), generator=torch.Generator().manual_seed(4))
    C = scene.capacity
    w0, c0 = torch.zeros((C, 2)), torch.zeros((C,), dtype=torch.int32)
    _kernels.reset_launch_counts()
    w1, c1, o1 = apply_weights(scene, cams[0], img.to(cuda), w0.to(cuda),
                               c0.to(cuda))
    w2, c2, _ = apply_weights(scene, cams[0], img.to(cuda), w0.to(cuda),
                              c0.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(NO_LAUNCHES, binning_key=2,
                                            rank_segment_sum=2,
                                            preprocess_forward=2)
    assert torch.equal(w1, w2) and torch.equal(c1, c2) and not bool(o1)
    wc, cc, _ = apply_weights(scene_cpu, cams[1], img, w0, c0)
    assert int(cc.sum()) > 0
    assert _counts_close(c1, cc, 2)
    assert_images_close(w1.cpu() / (c1.cpu()[:, None] + 1e-7),
                        wc / (cc[:, None] + 1e-7), name="normalised weights")


def test_edit_steps_with_lpips_repeat_bitwise(cuda):
    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit.edit_system import (
        EditConfig,
        EditSystem,
    )
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeGuidance,
        FakeSegmentor,
    )
    from gaussianeditor_tpu_torch.train.lpips import LPIPS, random_weights

    scene = _scene(5000, cuda, seed=6, capacity=6000)
    cams = orbit_cameras(4, 4.0, 0.8, 0.8, 64, 64, device=cuda)
    cfg = EditConfig(prompt="p", seg_prompt="x", batch_size=2, max_steps=3,
                     per_editing_step=2, densification_interval=2,
                     densify_until_step=3, densify_grad_threshold=1e-6,
                     cameras_extent=2.0)
    lp = LPIPS(random_weights(0))

    def run():
        sys_ = EditSystem(scene, cams, cfg, guidance=FakeGuidance(),
                          segmentor=FakeSegmentor((0.5, 0.5, 0.5), 0.6),
                          perceptual=lp)
        ms = []
        sys_.fit(callback=lambda s, m: ms.append(float(m["loss_p"])))
        return sys_, ms

    _kernels.reset_launch_counts()
    a, ma = run()
    counts = _kernels.launch_counts()
    b, mb = run()
    torch.cuda.synchronize()
    assert counts["forward_chunk"] == counts["backward_chunk"] == 0
    for k in ("binning_key", "forward_tile", "backward_tile",
              "rank_segment_sum"):
        assert counts[k] > 0, k
    # one preprocess forward a render or tracing view, one backward a
    # view's backward
    assert counts["preprocess_forward"] == counts["binning_key"]
    assert counts["preprocess_backward"] == counts["backward_tile"]
    assert ma == mb and all(v > 0 for v in ma)
    for k, v in a.state.scene.params().items():
        assert torch.equal(v, getattr(b.state.scene, k)), k
        assert torch.equal(a.state.opt_state.nu[k], b.state.opt_state.nu[k])
    assert torch.equal(a.state.scene.mask, b.state.scene.mask)
    assert torch.equal(a.state.stats.xyz_gradient_accum,
                       b.state.stats.xyz_gradient_accum)


def test_tiled_render_is_the_sorted_route_at_the_tiled_cut(cuda):
    """impl='tiled' is B1 at 32 - tile_bits depth bits, then B2: bitwise
    equal to `sorted_bin(depth_bits=...)` then `forward_tiles`, and only
    those kernels forward; under autograd B3 and B4 take the backward."""
    from gaussianeditor_tpu_torch.ops.composite import tiles_to_image

    scene = _scene(20000, cuda, seed=8, capacity=24000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 160, 256,
                        device=cuda)
    gx, gy = 16, 10
    bits = 32 - max((gx * gy + 1).bit_length(), 1)
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = render(scene, cam, impl="tiled", tile_cap=3, chunk=5)
    assert _kernels.launch_counts() == dict(NO_LAUNCHES, binning_key=1,
                                            forward_tile=1,
                                            preprocess_forward=1)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
        sb = sorted_bin(proc, gx, gy, 1 << 22, depth_bits=bits)
        tiles = forward_tiles(sb, gx, 3)
    torch.cuda.synchronize()
    for f, t in zip(("color", "depth", "final_T", "n_contrib"), tiles):
        assert torch.equal(getattr(out, f),
                           tiles_to_image(t, gx, gy, 160, 256)), f
    assert not bool(out.overflow)
    _kernels.reset_launch_counts()
    loss = render(scene, cam, impl="tiled").color.sum()
    loss.backward()
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(NO_LAUNCHES, binning_key=1,
                                            forward_tile=1, backward_tile=1,
                                            rank_segment_sum=1,
                                            preprocess_forward=1,
                                            preprocess_backward=1)
    assert torch.isfinite(scene.xyz.grad).all() and scene.xyz.grad.any()


@pytest.mark.parametrize("gf", [1, 10])
def test_rank_segment_sum_kernel_at_an_odd_capacity(cuda, gf):
    """B4 at C = 3 * 256 + 2 (a merged scene's capacity is no multiple of
    its 256 slots a block), every slot alive, some with no rows."""
    C = 3 * 256 + 2
    rng = np.random.RandomState(gf)
    counts = rng.zipf(1.6, C).clip(max=900) * (rng.rand(C) < 0.9)
    counts[-1] = 37          # the last, partial block has rows
    b_incl = torch.as_tensor(np.cumsum(counts).astype(np.int32), device=cuda)
    tt = torch.as_tensor(counts.astype(np.int32), device=cuda)
    rows = torch.randn((gf, int(counts.sum())), device=cuda)
    got = rank_segment_sum(rows, b_incl, tt, C)
    want = rank_segment_sum_plain(rows.cpu(), b_incl.cpu(), tt.cpu(), C)
    torch.cuda.synchronize()
    assert got.shape == (C, gf)
    assert torch.equal(got.cpu(), want)


def test_knn_dist_brute_on_cuda_matches_cpu(cuda):
    from gaussianeditor_tpu_torch.ops.knn import knn_dist_brute

    g = torch.Generator().manual_seed(0)
    pts, qs = torch.rand((5000, 3), generator=g), torch.rand((700, 3),
                                                            generator=g)
    valid = torch.rand(5000, generator=g) < 0.8
    want = knn_dist_brute(pts, qs, 4, valid=valid, chunk=256)
    got = knn_dist_brute(pts.to(cuda), qs.to(cuda), 4, valid=valid.to(cuda),
                         chunk=256)
    assert got.device.type == "cuda"
    scale = float((qs ** 2).sum(1).max() + (pts ** 2).sum(1).max())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=2 * np.finfo(np.float32).eps * scale)


def _disk(hw, r):
    ys, xs = np.mgrid[0:hw, 0:hw]
    c = (hw - 1) / 2
    return (((xs - c) ** 2 + (ys - c) ** 2) < r ** 2).astype(np.float32)


def test_del_and_add_systems_repeat_bitwise(cuda):
    """A small Delete (set-up and 3 steps) and Add (run and 2 refinement
    steps) on the card, each run twice: bitwise equal, through B1-B4
    only, and the caller's scene untouched."""
    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit.add_system import AddConfig, AddSystem
    from gaussianeditor_tpu_torch.edit.del_system import DelConfig, DelSystem
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeGuidance,
        FakeInpainter,
        FakeObjectGenerator,
    )

    scene = _scene(6000, cuda, seed=9, capacity=7000)
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    cams = orbit_cameras(4, 4.0, 0.8, 0.8, 64, 64, device=cuda)
    disk = _disk(64, 14)

    def run_del():
        cfg = DelConfig(seg_prompt="x", batch_size=2, max_steps=3,
                        densify_until_step=0, cameras_extent=2.0,
                        inpaint_scale=20.0, mask_dilate=2)
        s = DelSystem(scene, cams, cfg, inpainter=FakeInpainter(),
                      segmentor=lambda img, p: disk, perceptual=None)
        ms = []
        s.fit(callback=lambda i, m: ms.append(float(m["loss"])))
        return s, ms

    def run_add():
        cfg = AddConfig(prompt="p", bbox=(16, 16, 48, 48), batch_size=2,
                        densify_until_step=0, cameras_extent=2.0)
        s = AddSystem(scene, cams, cfg, inpainter=FakeInpainter(),
                      object_generator=FakeObjectGenerator(500, device=cuda))
        s.run()
        s.guidance = FakeGuidance()
        ms = []
        s.fit(n_steps=2, callback=lambda i, m: ms.append(float(m["loss"])))
        return s, ms

    for run in (run_del, run_add):
        _kernels.reset_launch_counts()
        a, ma = run()
        counts = _kernels.launch_counts()
        b, mb = run()
        torch.cuda.synchronize()
        assert counts["forward_chunk"] == counts["backward_chunk"] == 0
        for k in ("binning_key", "forward_tile", "backward_tile",
                  "rank_segment_sum"):
            assert counts[k] > 0, (run.__name__, k)
        assert ma == mb and np.isfinite(ma).all(), run.__name__
        for k, v in a.state.scene.params().items():
            assert torch.equal(v, getattr(b.state.scene, k)), k
        assert torch.equal(a.state.scene.alive, b.state.scene.alive)
        assert torch.equal(a.state.scene.mask, b.state.scene.mask)
    assert b.state.scene.capacity == 6000 + 500
    for k, v in scene.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- reconstruction and the CLI at a Mip-NeRF 360 view's size ----

RECON_HW = (840, 1297)


def _wide_camera(hw, device):
    h, w = hw
    fovy = 2 * np.arctan(np.tan(0.4) * h / w)
    return lookat_camera((0, 0.5, -4), (0, 0, 0), (0, 1, 0), 0.8, fovy, h, w,
                         device=device)


def test_ssim_is_bitwise_the_same_under_either_tf32_setting(cuda):
    from gaussianeditor_tpu_torch.train.losses import ssim

    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.rand((*RECON_HW, 3), generator=g).to(cuda)
    b = (a + 0.1 * torch.randn((*RECON_HW, 3), generator=g).to(cuda)).clamp(
        0, 1)

    def value_grad():
        x = a.clone().requires_grad_(True)
        v = ssim(x, b)
        (gx,) = torch.autograd.grad(v, x)
        return v.detach(), gx

    saved = torch.backends.cudnn.allow_tf32
    try:
        out = {}
        for tf32 in (True, False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            out.setdefault(tf32, []).append(value_grad())
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (v0, g0), (v1, g1) = out[True]
    (v2, g2), = out[False]
    assert torch.equal(v0, v1) and torch.equal(g0, g1)
    assert torch.equal(v0, v2) and torch.equal(g0, g2)
    ref = ssim(a.double().cpu(), b.double().cpu())
    assert abs(float(v0) - float(ref)) < 1e-5


def test_render_and_backward_at_1297x840_match_the_plain_route(cuda):
    """B1-B4 at 82 x 53 tiles (a 13-bit tile field, 19 depth bits, partial
    edge tiles on both axes) against the plain versions on the CPU."""
    import copy

    from gaussianeditor_tpu_torch.ops.binning_sorted import key_depth_bits
    from gaussianeditor_tpu_torch.train.losses import l1_loss, ssim

    assert key_depth_bits(82 * 53) == 19
    scene = _scene(40000, cuda, seed=12, capacity=48000, sh=3)
    g = torch.Generator(device="cpu").manual_seed(12)
    target = torch.rand((*RECON_HW, 3), generator=g)

    def run(s, dev):
        cam = _wide_camera(RECON_HW, dev)
        out = render(s, cam)
        t = target.to(dev)
        loss = 0.8 * l1_loss(out.color, t) + 0.2 * (1 - ssim(out.color, t))
        grads = torch.autograd.grad(loss, list(s.params().values()))
        return out, grads

    _kernels.reset_launch_counts()
    out_k, g_k = run(scene, cuda)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == dict(
        NO_LAUNCHES, binning_key=1, forward_tile=1, backward_tile=1,
        rank_segment_sum=1, preprocess_forward=1, preprocess_backward=1)
    out_p, g_p = run(copy.deepcopy(scene).to("cpu"), torch.device("cpu"))
    assert out_k.color.shape == (*RECON_HW, 3)
    assert int(out_k.num_rendered) == int(out_p.num_rendered)
    assert_images_close(out_k.color, out_p.color, name="color")
    assert_images_close(out_k.depth, out_p.depth, loose=2e-2, name="depth")
    assert fraction_equal(out_k.n_contrib, out_p.n_contrib) == 1.0
    for name, a, b in zip(scene.params(), g_k, g_p):
        b = b.to(cuda)
        assert torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        err = (a - b).abs()
        assert bool((err <= 1e-3 * scale + 1e-2 * b.abs()).all()), (
            name, float(err.max()), scale)


def _recon_inputs(device, n_views=4, hw=(136, 200)):
    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras

    target = _scene(6000, device, seed=21, sh=1)
    cams = orbit_cameras(n_views, 4.0, 0.8, 0.6, *hw, device=device)
    with torch.no_grad():
        images = [render(target, c).color.clamp(0, 1).cpu().numpy()
                  for c in cams]
    return cams, images


def test_recon_steps_through_every_event_repeat_bitwise(cuda):
    from gaussianeditor_tpu_torch.train.recon import ReconConfig, ReconTrainer

    cams, images = _recon_inputs(cuda)
    init = _scene(3000, cuda, seed=22, capacity=9000, sh=3)
    with torch.no_grad():
        init.active_sh_degree.zero_()
    cfg = ReconConfig(max_steps=20, densify_from_step=5,
                      densification_interval=5, densify_grad_threshold=1e-5,
                      opacity_reset_interval=15, oneup_sh_every=8,
                      cameras_extent=2.0)

    def run():
        tr = ReconTrainer(init, cams, images, cfg)
        ms = []
        tr.fit(callback=lambda s, m: ms.append(
            (float(m["loss"]), int(m.get("n_split", -1)))))
        return tr, ms

    _kernels.reset_launch_counts()
    a, ma = run()
    counts = _kernels.launch_counts()
    b, mb = run()
    torch.cuda.synchronize()
    assert counts == dict(NO_LAUNCHES, binning_key=20, forward_tile=20,
                          backward_tile=20, rank_segment_sum=20,
                          preprocess_forward=20, preprocess_backward=20)
    assert ma == mb and np.isfinite([m[0] for m in ma]).all()
    assert sum(m[1] > 0 for m in ma) >= 1     # a densify split Gaussians
    for k, v in a.scene.params().items():
        assert torch.equal(v, getattr(b.scene, k)), k
    assert torch.equal(a.scene.alive, b.scene.alive)
    assert int(a.scene.active_sh_degree) == 2


def test_recon_through_launch_counts_its_launches(cuda, tmp_path):
    import json
    import math

    from PIL import Image

    from gaussianeditor_tpu_torch.apps import launch
    from gaussianeditor_tpu_torch.core.cameras import fov2focal, lookat_c2w
    from gaussianeditor_tpu_torch.core.transforms import rotmat_to_quat
    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.data.colmap import (
        ColmapCamera,
        ColmapImage,
        write_colmap_model_bin,
    )

    ws = tmp_path / "ws"
    h, w = 104, 160
    f = fov2focal(0.8, w)
    cams = {1: ColmapCamera(1, "PINHOLE", w, h,
                            np.array([f, f, w / 2, h / 2]))}
    imgs = {}
    for i in range(4):
        th = 2 * math.pi * i / 4
        eye = np.array([4 * math.cos(th), 0.5, 4 * math.sin(th)])
        w2c = np.linalg.inv(lookat_c2w(eye, np.zeros(3), (0.0, 1.0, 0.0)))
        q = rotmat_to_quat(w2c[:3, :3])
        imgs[i + 1] = ColmapImage(i + 1, q, w2c[:3, 3], 1, f"v{i}.png")
    sparse = ws / "sparse" / "0"
    write_colmap_model_bin(str(sparse), cams, imgs)
    rng = np.random.RandomState(0)
    with open(sparse / "points3D.txt", "w") as fh:
        for j in range(2000):
            x, y, z = rng.uniform(-1, 1, 3)
            r, g, b = rng.randint(0, 255, 3)
            fh.write(f"{j} {x} {y} {z} {r} {g} {b} 0.5 0\n")
    target = _scene(6000, cuda, seed=23, sh=1)
    (ws / "images").mkdir()
    sc = CamScene(str(ws), h=h, w=w, device=cuda)
    for cam, name in zip(sc.cameras, sc.image_names):
        with torch.no_grad():
            img = render(target, cam).color.clamp(0, 1)
        Image.fromarray((img.cpu().numpy() * 255).astype(np.uint8)).save(
            ws / "images" / name)
    cfg = tmp_path / "recon.json"     # JSON is YAML
    out_dir = tmp_path / "out"
    cfg.write_text(json.dumps(dict(
        mode="recon", colmap_dir=str(ws), height=h, width=w, device="cuda",
        test_views=2, output_dir=str(out_dir),
        system=dict(max_steps=6, densify_from_step=3,
                    densification_interval=3, oneup_sh_every=2))))
    _kernels.reset_launch_counts()
    launch.main(["--config", str(cfg), "--train", "--test"])
    assert _kernels.launch_counts() == dict(
        NO_LAUNCHES, binning_key=6 + 2, forward_tile=6 + 2, backward_tile=6,
        rank_segment_sum=6, preprocess_forward=6 + 2, preprocess_backward=6)
    (trial,) = out_dir.iterdir()
    rows = [json.loads(line) for line in open(trial / "metrics.jsonl")]
    assert len(rows) == 6 and np.isfinite([r["loss"] for r in rows]).all()
    assert (trial / "last.ply").exists()
    assert [p.name for p in trial.iterdir() if p.name.startswith("turn")]


def test_served_frames_are_whole_steps_on_cuda(cuda):
    """The web UI on the card: frames taken while a fit runs are each
    bitwise a render of the scene after some whole step, in step order;
    the served scene never shares storage with the training state's; after
    the fit it is the scene of the same fit run in process."""
    import copy
    import dataclasses

    from gaussianeditor_tpu_torch.apps.webui import WebUIState
    from gaussianeditor_tpu_torch.core.cameras import lookat_c2w, orbit_cameras
    from gaussianeditor_tpu_torch.edit.edit_system import EditConfig
    from gaussianeditor_tpu_torch.guidance.fake import FakeGuidance
    from gaussianeditor_tpu_torch.testing import (
        watch_served_fit,
        whole_step_frames,
        whole_step_index,
    )

    state = WebUIState(
        _scene(5000, cuda, seed=7, capacity=6000),
        orbit_cameras(4, 4.0, 0.8, 0.8, 64, 64, device=cuda), 2.0,
        guidance=FakeGuidance(),
        edit_config=EditConfig(batch_size=2, cameras_extent=2.0,
                               densify_until_step=0))
    pose = [float(v) for v in lookat_c2w((0.0, 0.5, -4.0), (0.0, 0.0, 0.0),
                                         (0.0, 1.0, 0.0)).reshape(-1)]
    scene0 = copy.deepcopy(state.scene)
    frames, shared = watch_served_fit(state, pose, 64, steps=12)
    assert shared == 0, "the served scene shared the train state's storage"
    cfg = dataclasses.replace(state.edit_config, prompt="p", max_steps=12)
    want, system = whole_step_frames(scene0, state.cameras, cfg, pose, 64,
                                     FakeGuidance())
    assert len(frames) >= 2 and not np.array_equal(want[0], want[-1])
    idx = [whole_step_index(f, want) for f in frames]
    assert min(idx) >= 0 and idx == sorted(idx), idx
    served = list(state.scene.parameters()) + list(state.scene.buffers())
    fitted = list(system.scene.parameters()) + list(system.scene.buffers())
    for a, b in zip(served, fitted):
        assert torch.equal(a, b)


# (SH degree, active degree, override channels, offset, tile rows,
#  scale modifier) of the preprocess kernels' cases
PRE_CASES = {
    "sh3": (3, 3, None, True, None, 1.0),
    "sh0": (0, None, None, True, None, 1.0),
    "sh1-active0": (1, 0, None, True, None, 1.0),
    "sh2": (2, 2, None, False, None, 1.0),
    "sh4-active3": (4, 3, None, True, None, 1.0),
    "override-ch1": (3, 3, 1, True, None, 1.0),
    "override-ch3": (3, 3, 3, True, None, 1.0),
    "strip-scale": (3, 3, None, True, (2, 6), 1.4),
}


def _pre_inputs(name, device):
    D, active, oc_ch, with_off, rows, smod = PRE_CASES[name]
    scene = _scene(30000, device, seed=31, capacity=36000, sh=D)
    with torch.no_grad():
        scene.quats[:50] = 0.0                 # below clamp_min
        scene.opacity_raw[50:100] = -6.0       # dead opacity
    cam = lookat_camera((0, 0, -3), (0, 0, 0), (0, 1, 0), 0.8, 0.7, 128,
                        160, device=device)
    C = scene.capacity
    g = torch.Generator(device="cpu").manual_seed(7)
    oc = (None if oc_ch is None
          else torch.rand((C, oc_ch), generator=g).to(device))
    off = torch.zeros((C, 2), device=device) if with_off else None
    act = (None if active is None
           else torch.tensor(active, dtype=torch.int32, device=device))
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        scene.xyz, scene.log_scales, scene.quats, scene.features_dc,
        scene.features_rest)] + (
        [off.clone().requires_grad_(True)] if with_off else [])
    kw = dict(alive=scene.alive, active_sh_degree=act, max_sh_degree=D,
              scale_modifier=smod, override_color=oc, tile_row_range=rows)
    return leaves, scene.get_opacity[:, 0].detach(), cam, kw


@pytest.mark.parametrize("name", list(PRE_CASES))
def test_preprocess_kernels_match_plain(cuda, name):
    """The forward kernel gives the plain version's outputs on the card
    bit for bit, integer and float fields; the backward kernel is within
    1e-5 of each gradient's largest entry of autograd on the plain
    version, from a cotangent on the visible slots, and zero elsewhere."""
    leaves, op, cam, kw = _pre_inputs(name, cuda)
    xyz, ls, q, dc, rest = leaves[:5]
    off = leaves[5] if len(leaves) > 5 else None
    _kernels.reset_launch_counts()
    got = preprocess(xyz, ls, q, op, (dc, rest), cam, mean2d_offset_ndc=off,
                     **kw)
    assert _kernels.launch_counts() == dict(NO_LAUNCHES,
                                            preprocess_forward=1)
    want = preprocess_plain(xyz, ls, q, op, (dc, rest), cam,
                            mean2d_offset_ndc=off, **kw)
    for f in ("radius", "visible", "rect_min", "rect_max", "tiles_touched"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("mean2d", "depth", "conic", "color"):
        a, b = getattr(got, f).detach(), getattr(want, f).detach()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    vis = want.visible
    assert int(vis.sum()) > 1000
    names = ["mean2d", "depth", "conic"] + (
        ["color"] if kw["override_color"] is None else [])
    # column slices of one [C, 10] array, as the compositor's backward
    # hands them over
    g = torch.Generator(device="cpu").manual_seed(3)
    rows = torch.randn((vis.shape[0], 10), generator=g).to(cuda)
    rows = rows * vis[:, None]
    cols = dict(mean2d=rows[:, 0:2], conic=rows[:, 2:5], color=rows[:, 6:9],
                depth=rows[:, 9])
    cot = [cols[k] for k in names]
    wrt = leaves if kw["override_color"] is None else leaves[:3] + leaves[5:]
    g_k = torch.autograd.grad([getattr(got, k) for k in names], wrt, cot)
    g_p = torch.autograd.grad([getattr(want, k) for k in names], wrt, cot)
    assert _kernels.launch_counts()["preprocess_backward"] == 1
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        # (a gated band's gradient is zero in both)
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= 1e-5 * scale, (i, err, scale)
        assert not a[~vis].any(), i


def test_preprocess_float64_on_cuda_takes_the_plain_version(cuda):
    leaves, op, cam, kw = _pre_inputs("sh3", cuda)
    leaves = [t.detach().double().requires_grad_(True) for t in leaves]
    _kernels.reset_launch_counts()
    out = preprocess(*leaves[:3], op.double(), tuple(leaves[3:5]), cam,
                     mean2d_offset_ndc=leaves[5], **kw)
    grads = torch.autograd.grad(
        out.color.sum() + out.mean2d.sum() + out.conic.sum(), leaves)
    assert _kernels.launch_counts() == NO_LAUNCHES
    assert out.mean2d.dtype == torch.float64
    assert all(torch.isfinite(g).all() for g in grads)


def test_preprocess_half_on_cuda_raises(cuda):
    leaves, op, cam, kw = _pre_inputs("sh3", cuda)
    with pytest.raises(ValueError, match="float32"):
        preprocess(*[t.detach().half() for t in leaves[:3]], op.half(),
                   tuple(t.detach().half() for t in leaves[3:5]), cam, **kw)


@pytest.mark.parametrize("sh_form", ["pair", "tensor"])
@pytest.mark.parametrize("name", list(PRE_CASES))
def test_preprocess_kernels_at_ties_match_autograd(cuda, name, sh_form):
    """The kernels on `tie_scene`'s slots in float32, built on each tie of
    the backward (the frustum clamp at +-1.3 tanfov, max(SH + 0.5, 0) at
    0, clamp_min at |q|^2 = 1e-24) and on clamped, dead-opacity,
    zero-quaternion and dead slots: the forward bit for bit the plain
    version's; the backward, from a cotangent on every slot in front of
    the near plane, within 1e-5 of autograd on the plain version, of each
    gradient's largest entry and, on each tied slot, of that slot's own.
    `sh` as the pair and as one [C, K, 3] tensor, whose two slices the
    kernels get strided."""
    D, active, oc_ch, with_off, _, smod = PRE_CASES[name]
    rows = (1, 2) if name == "strip-scale" else None
    xyz, ls, q, op, dc, rest, alive = tie_scene(D, torch.float32, cuda)
    cam = tie_camera(cuda)
    C = xyz.shape[0]
    g = torch.Generator(device="cpu").manual_seed(5)
    oc = (None if oc_ch is None
          else torch.rand((C, oc_ch), generator=g).to(cuda))
    act = (None if active is None
           else torch.tensor(active, dtype=torch.int32, device=cuda))
    kw = dict(alive=alive, active_sh_degree=act, max_sh_degree=D,
              scale_modifier=smod, override_color=oc, tile_row_range=rows)
    sh = ([dc, rest] if sh_form == "pair" else [torch.cat([dc, rest], 1)])
    leaves = [t.clone().requires_grad_(True) for t in [xyz, ls, q] + sh]
    if with_off:
        leaves.append(torch.zeros((C, 2), device=cuda, requires_grad=True))
    off = leaves[-1] if with_off else None
    sh_in = tuple(leaves[3:5]) if sh_form == "pair" else leaves[3]

    def run(fn):
        return fn(leaves[0], leaves[1], leaves[2], op, sh_in, cam,
                  mean2d_offset_ndc=off, **kw)

    _kernels.reset_launch_counts()
    got = run(preprocess)
    want = run(preprocess_plain)
    for f in ("radius", "visible", "rect_min", "rect_max", "tiles_touched"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("mean2d", "depth", "conic", "color"):
        a, b = getattr(got, f).detach(), getattr(want, f).detach()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    colored = oc is None
    if colored:
        assert float(want.color[TIE_COLOR, 1]) == 0.0
    names = ["mean2d", "depth", "conic"] + (["color"] if colored else [])
    front = (want.depth > 0.2).float()
    cot = []
    for k in names:
        v = torch.randn(getattr(want, k).shape, generator=g).to(cuda)
        cot.append(v * (front if v.dim() == 1 else front[:, None]))
    wrt = leaves if colored else leaves[:3] + leaves[3 + len(sh):]
    g_k = torch.autograd.grad([getattr(got, k) for k in names], wrt, cot)
    g_p = torch.autograd.grad([getattr(want, k) for k in names], wrt, cot)
    assert _kernels.launch_counts() == dict(
        NO_LAUNCHES, preprocess_forward=1, preprocess_backward=1)
    ties = [TIE_X, TIE_Y, TIE_QUAT] + ([TIE_COLOR] if colored else [])
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        assert torch.isfinite(b).all(), i
        err = (a - b).abs().reshape(C, -1)
        ref = b.abs().reshape(C, -1)
        if not ref.numel():
            continue
        assert float(err.max()) <= 1e-5 * float(ref.max()), i
        for t in ties:
            assert float(err[t].max()) <= 1e-5 * float(ref[t].max()), (i, t)

