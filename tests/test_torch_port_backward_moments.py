"""The arithmetic of the backward kernels B3 and B6, emulated on the CPU.

`csrc/composite_backward.cuh` sums each row's gradient over the tile's
256 pixels with TF32 tensor-core products in the three-term split: the
moments 1, x', x'^2 of dpower over each segment of 8 pixels (D . Q),
expanded about the Gaussian's centre in float64, and W . Gacc, each
warp over its own 32 pixels in four k-steps, then the 8 warps in a fixed
order. `moments_backward` below repeats that arithmetic in torch (TF32
rounding as `cvt.rna` does it, each mma's sum exact then rounded to
float32, the same orders), and the tests hold it against the plain
per-pixel version `backward_rows_plain` at the gradient tolerance of
tests/test_pallas.py:87 (atol 1e-3 / rtol 1e-2) and against a float64
direct sum of the same per-pixel values within 1e-5 of each column's
RMS: on the JAX suite's scenes (tests/helpers.py seeds and sizes) and on
an adversarial one (centres far outside the tile, radii of hundreds of
pixels, opacities at the 0.99 cap and near 1/255). The kernels
themselves run only on the card (tests/test_torch_port_cuda.py); this
holds their design."""

import shutil

import numpy as np
import pytest
import torch

from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
from gaussianeditor_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN
from gaussianeditor_tpu_torch.ops.render import preprocess_scene
from gaussianeditor_tpu_torch.ops.tile_composite import (
    PX,
    backward_rows_plain,
    composite_rows_plain,
)
from gaussianeditor_tpu_torch.testing import adversarial_rows
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import port_camera, port_scene

ROWS = 32          # composite_backward.cuh kRows
WARPS = PX // 32
GRAD_TOL = dict(atol=1e-3, rtol=1e-2)   # tests/test_pallas.py:87
RMS_TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: `cvt.rna.tf32.f32`."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def q_segment() -> torch.Tensor:
    """[8, 8]: 1, x', x'^2 and zeros, x' a pixel's offset from the centre
    of its segment of 8 neighbours in a tile row."""
    x = torch.arange(8, dtype=torch.float32) - 3.5
    q = torch.zeros((8, 8))
    q[:, 0], q[:, 1], q[:, 2] = 1.0, x, x * x
    return q


def walk(start, cnt, payload, tiles, g_color, g_depth, g_T, grid_x, ch):
    """The per-pixel pass of the kernels: D (dpower) and W (alpha T),
    [T, L, PX] each, L the rows walked (the tile's largest n_contrib
    rounded up to whole batches of ROWS); zeros where a pair is off."""
    T = start.shape[0]
    n = payload.shape[1]
    start = start.to(torch.int64)
    cnt = cnt.to(torch.int64)
    t = torch.arange(T)[:, None]
    p = torch.arange(PX)[None, :]
    px = ((t % grid_x) * 16 + p % 16).to(torch.float32)
    py = ((t // grid_x) * 16 + p // 16).to(torch.float32)
    nc = tiles.n_contrib.to(torch.int64)
    S = g_T * tiles.final_T
    for c in range(ch):
        S = S + g_color[..., c] * tiles.color[..., c]
    S = S + g_depth * tiles.depth
    L = -(-int(nc.max()) // ROWS) * ROWS
    D = torch.zeros((T, L, PX))
    W = torch.zeros((T, L, PX))
    trans = torch.ones((T, PX))
    prefix = torch.zeros((T, PX))
    for i in range(L):
        r = payload[:, torch.clamp(start + i, max=n - 1)]
        xs, ys, ca, cb, cc, op, dep = (r[k][:, None] for k in range(7))
        dx = xs - px
        dy = ys - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = op * torch.exp(power)
        alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
        on = ((cnt > i)[:, None] & (i < nc) & ~(power > 0.0)
              & ~(alpha < ALPHA_MIN))
        w = torch.where(on, alpha * trans, 0.0)
        c_hat = g_depth * dep
        for c in range(ch):
            c_hat = c_hat + g_color[..., c] * r[7 + c][:, None]
        prefix = prefix + w * c_hat
        amc = torch.where(alpha_raw < ALPHA_MAX, alpha, 0.0)
        D[:, i] = torch.where(
            on, amc * (trans * c_hat - (S - prefix) / (1.0 - alpha)), 0.0)
        W[:, i] = w
        trans = torch.where(on, trans * (1.0 - alpha), trans)
    return D, W


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """One m16n8k8 step: acc + a . b over 8 pixels, the products and
    their sum exact, the result rounded to float32."""
    return (acc.double() + a.double() @ b.double()).float()


def moments_backward(start, cnt, payload, tiles, g_color, g_depth, g_T,
                     grid_x, ch, D, W):
    """The kernels' gradient rows [7 + ch, n] from the walk's D and W
    (`finish_row` in the header). Segment s of 8 pixels (warp s // 4,
    k-step s % 4): its moments m0, m1, m2 from the two D terms (d_lo Q,
    then d_hi Q, from zero), expanded about the Gaussian's centre in
    float64, thread j of a row summing warp j's four segments in order
    and the 8 threads' shares then added in order; gfeat per warp over
    its four k-steps (w_lo g_hi, w_hi g_lo, w_hi g_hi each), the warps
    summed in order in float64."""
    T, L, _ = D.shape
    n = payload.shape[1]
    nf = -(-(ch + 1) // 8) * 8
    gacc = torch.zeros((T, PX, nf))
    gacc[..., :ch] = g_color
    gacc[..., ch] = g_depth
    dh, dl = split(D)
    wh, wl = split(W)
    gh, gl = split(gacc)
    q = q_segment()
    idx = torch.clamp(start.to(torch.int64)[:, None] + torch.arange(L),
                      max=n - 1)
    f = payload[:, idx]                                       # [P, T, L]
    t = torch.arange(T)[:, None]
    x0 = f[0].double() - ((t % grid_x) * 16).double()
    y0 = f[1].double() - ((t // grid_x) * 16).double()
    total = [torch.zeros((T, L), dtype=torch.float64) for _ in range(6)]
    gfeat = torch.zeros((T, L, nf), dtype=torch.float64)
    for w in range(WARPS):
        v = [torch.zeros((T, L), dtype=torch.float64) for _ in range(6)]
        gw = torch.zeros((T, L, nf))
        for kk in range(4):
            k = slice(32 * w + 8 * kk, 32 * w + 8 * kk + 8)
            m = mma(mma(torch.zeros((T, L, 8)), dl[..., k], q), dh[..., k], q)
            m0, m1, m2 = (m[..., c].double() for c in range(3))
            X = x0 - ((kk & 1) * 8 + 3.5)
            Y = y0 - (2 * w + (kk >> 1))
            tt = X * m0 - m1
            for s, add in zip(v, (m0, tt, Y * m0, X * tt - (X * m1 - m2),
                                  Y * tt, Y * Y * m0)):
                s += add
            for x, y in ((wl, gh), (wh, gl), (wh, gh)):
                gw = mma(gw, x[..., k], y[:, k, :])
        total = [a + b for a, b in zip(total, v)]
        gfeat = gfeat + gw.double()
    s0, sx, sy, sxx, sxy, syy = total
    a, b, c, op = (f[k].double() for k in (2, 3, 4, 5))
    inv = torch.where(op > 0.0, 1.0 / op, 0.0)
    rows = torch.stack(
        [-(a * sx + b * sy), -(c * sy + b * sx), -0.5 * sxx, -sxy,
         -0.5 * syy, s0 * inv] + [gfeat[..., k] for k in range(ch + 1)],
        dim=0).float()
    out = torch.zeros((7 + ch, n))
    live = torch.arange(L)[None, :] < cnt.to(torch.int64)[:, None]
    out[:, idx[live]] = rows[:, live]
    return out


def direct_sum64(start, cnt, payload, g_color, g_depth, grid_x, ch, D, W):
    """The same rows as sums over the pixels of each pixel's partials, in
    float64, from the same D and W."""
    T, L, _ = D.shape
    n = payload.shape[1]
    idx = torch.clamp(start.to(torch.int64)[:, None] + torch.arange(L),
                      max=n - 1)
    f = payload[:, idx].double()[..., None]                   # [P, T, L, 1]
    t = torch.arange(T)[:, None]
    p = torch.arange(PX)[None, :]
    px = ((t % grid_x) * 16 + p % 16).double()[:, None]
    py = ((t // grid_x) * 16 + p // 16).double()[:, None]
    d, w = D.double(), W.double()
    dx, dy = f[0] - px, f[1] - py
    a, b, c, op = f[2], f[3], f[4], f[5]
    gacc = torch.cat([g_color, g_depth[..., None]], dim=-1).double()
    rows = torch.stack(
        [(-d * (a * dx + b * dy)).sum(-1), (-d * (c * dy + b * dx)).sum(-1),
         (-0.5 * d * dx * dx).sum(-1), (-d * dx * dy).sum(-1),
         (-0.5 * d * dy * dy).sum(-1),
         d.sum(-1) * torch.where(op[..., 0] > 0, 1.0 / op[..., 0], 0.0)]
        + [torch.einsum("tlp,tp->tl", w, gacc[..., k]) for k in range(ch + 1)],
        dim=0)
    out = torch.zeros((7 + ch, n), dtype=torch.float64)
    live = torch.arange(L)[None, :] < cnt.to(torch.int64)[:, None]
    out[:, idx[live]] = rows[:, live]
    return out


def _cotangents(T, ch, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(T, PX, ch).astype(np.float32)),
            torch.from_numpy(0.1 * rng.randn(T, PX).astype(np.float32)),
            torch.from_numpy(0.05 * rng.randn(T, PX).astype(np.float32)))


def suite_rows(n, seed, hw, ch):
    """The JAX suite's scene and camera (tests/helpers.py), preprocessed
    and binned by the port on the CPU; ch != 3 renders a seeded feature."""
    scene = port_scene(random_scene(n, seed=seed))
    cam = port_camera(make_camera(*hw))
    oc = None
    if ch != 3:
        oc = torch.from_numpy(np.random.RandomState(seed + ch).rand(
            scene.capacity, ch).astype(np.float32))
    gx, gy = -(-hw[1] // 16), -(-hw[0] // 16)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam, override_color=oc)
        sb = sorted_bin(proc, gx, gy, 1 << 16)
    b = sb.tile_bounds
    return b[:-1], b[1:] - b[:-1], sb.payload, gx


CASES = {
    # tests/helpers.py's scene at the sizes of tests/test_pallas.py:70, :91
    "suite48": lambda ch: suite_rows(100, 8, (48, 48), ch),
    "suite256": lambda ch: suite_rows(300, 4, (256, 256), ch),
    "adversarial": lambda ch: adversarial_rows(11, ch),
}


@pytest.mark.parametrize("ch", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_moment_reduction_matches_plain_and_float64(case, ch):
    start, cnt, payload, gx = CASES[case](ch)
    tiles = composite_rows_plain(start, cnt, payload, gx, ch)[0]
    T = start.shape[0]
    g_color, g_depth, g_T = _cotangents(T, ch, seed=ch)
    D, W = walk(start, cnt, payload, tiles, g_color, g_depth, g_T, gx, ch)
    assert D.shape[1] > ROWS, "the scene should span several batches"
    got = moments_backward(start, cnt, payload, tiles, g_color, g_depth,
                           g_T, gx, ch, D, W)
    want = backward_rows_plain(start, cnt, payload, None, tiles, g_color,
                               g_depth, g_T, gx, ch)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **GRAD_TOL)
    ref = direct_sum64(start, cnt, payload, g_color, g_depth, gx, ch, D, W)
    rms = ref.pow(2).mean(dim=1).sqrt()
    assert (rms > 0).all()
    rel = ((got.double() - ref).abs().max(dim=1).values / rms)
    assert float(rel.max()) <= RMS_TOL, rel


def test_q_is_exact_in_tf32():
    """The D products take two terms because Q needs no low part."""
    q = q_segment()
    assert torch.equal(tf32(q), q)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10          # TF32's step just above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, one], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one]


def test_kernel_library_path_covers_headers(tmp_path, monkeypatch):
    """An edited header of csrc/ gives the kernels that may include it a
    new library path, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", csrc)
    before = {k: _kernels._lib_path(k) for k in _kernels.SIGNATURES}
    header = csrc / "composite_backward.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {k: _kernels._lib_path(k) for k in _kernels.SIGNATURES}
    assert after["backward_tile"] != before["backward_tile"]
    assert after["backward_chunk"] != before["backward_chunk"]
    assert _kernels._lib_path("backward_tile") == after["backward_tile"]
    (csrc / "backward_tile.cu").write_text(
        (csrc / "backward_tile.cu").read_text() + "\n")
    assert _kernels._lib_path("backward_tile") != after["backward_tile"]
