"""Port vs JAX: the render's backward.

The preprocess VJP against `jax.vjp` of the JAX `preprocess`; the
render's parameter gradients (TileComposite: kernels B3 and B4 through
their plain versions) against JAX `render(impl="pallas")`, whose
backward runs the Pallas kernels in interpret mode, at the gradient
tolerance of `tests/test_pallas.py:87`; finite differences; bitwise
repeatability; B4's plain version against a float64 oracle; and the
preprocess stop-gradient fault (NaN gradients from dead slots and
low-opacity Gaussians)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu_torch.ops.binning_sorted import rank_segment_sum
from gaussianeditor_tpu_torch.ops.preprocess import preprocess
from gaussianeditor_tpu_torch.ops.render import render
from tests.helpers import make_camera, random_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = dict(atol=1e-3, rtol=1e-2)   # tests/test_pallas.py:87
DIFF_PARAMS = ("xyz", "features_dc", "features_rest", "opacity_raw",
               "log_scales", "quats")


def _port_grads(scene, cam, loss_fn, **kw):
    params = [getattr(scene, k) for k in DIFF_PARAMS]
    out = render(scene, cam, torch.zeros(3), **kw)
    grads = torch.autograd.grad(loss_fn(out), params)
    return {k: g.numpy() for k, g in zip(DIFF_PARAMS, grads)}


@functools.lru_cache(maxsize=None)
def _jax_grad(hw, mi, weights):
    cam = make_camera(*hw)
    wd, wa = weights

    def loss(params, scene, probe):
        out = jrender(scene.replace(params=params), cam, jnp.zeros(3),
                      impl="pallas", max_instances=mi)
        return (jnp.sum(out.color * probe) + wd * jnp.sum(out.depth)
                + wa * jnp.sum(out.alpha))

    return jax.jit(jax.grad(loss))


GRAD_CASES = {
    # tests/test_pallas.py:70 and :91 (the 256^2 restack branch)
    "48x48_seed8": dict(n=100, seed=8, hw=(48, 48), mi=8192,
                        weights=(0.1, 0.05)),
    "256x256_seed4": dict(n=300, seed=4, hw=(256, 256), mi=32768,
                          weights=(0.1, 0.0)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_render_gradients_match_pallas(case):
    c = GRAD_CASES[case]
    js = random_scene(c["n"], seed=c["seed"])
    probe = np.random.RandomState(c["seed"]).randn(*c["hw"], 3).astype(
        np.float32)
    want = _jax_grad(c["hw"], c["mi"], c["weights"])(js.params, js,
                                                     jnp.asarray(probe))
    wd, wa = c["weights"]
    tprobe = torch.from_numpy(probe)

    def loss(out):
        return (torch.sum(out.color * tprobe) + wd * torch.sum(out.depth)
                + wa * torch.sum(out.alpha))

    got = _port_grads(port_scene(js), port_camera(make_camera(*c["hw"])),
                      loss, max_instances=c["mi"])
    for name in DIFF_PARAMS:
        w = np.asarray(getattr(want, name))
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], w, **GRAD_TOL,
                                   err_msg=f"grad mismatch: {name}")
    assert np.abs(got["xyz"]).max() > 1e-3  # the scene has gradients


def test_gradient_finite_differences():
    # tests/test_pallas.py:121: seed 7 has no Gaussian near a discrete
    # rect or cutoff boundary, so central differences converge
    js = random_scene(20, seed=7)
    scene, cam = port_scene(js), port_camera(make_camera(32, 32))
    xyz0 = scene.xyz.detach().clone()

    def loss_at(xyz):
        with torch.no_grad():
            scene.xyz.copy_(xyz)
        out = render(scene, cam, max_instances=4096)
        return torch.sum(out.color)

    g = torch.autograd.grad(loss_at(xyz0), [scene.xyz])[0]
    v = torch.from_numpy(np.random.RandomState(0).randn(*xyz0.shape)
                         .astype(np.float32))
    eps = 1e-3
    with torch.no_grad():
        fd = (loss_at(xyz0 + eps * v) - loss_at(xyz0 - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(g * v)), float(fd),
                               rtol=5e-2, atol=1e-2)


def test_bitwise_repeatable_fwd_bwd():
    # tests/test_pallas.py:145
    js = random_scene(140, seed=12)
    cam = port_camera(make_camera(48, 48))

    def run():
        scene = port_scene(js)
        out = render(scene, cam, torch.zeros(3), max_instances=8192)
        loss = torch.sum(out.color * 1.7) + torch.sum(out.depth)
        grads = torch.autograd.grad(loss, [getattr(scene, k)
                                           for k in DIFF_PARAMS])
        return loss, grads

    v1, g1 = run()
    v2, g2 = run()
    assert v1.detach().numpy().tobytes() == v2.detach().numpy().tobytes()
    for a, b in zip(g1, g2):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def _preprocess_inputs(seed):
    js = random_scene(60, seed=seed, max_sh_degree=2, capacity=80)
    cam = make_camera(40, 56)
    rng = np.random.RandomState(seed)
    opacity = np.asarray(js.get_opacity[:, 0])
    sh = np.asarray(js.get_features)
    offset = np.zeros((80, 2), np.float32)
    cot = dict(mean2d=rng.randn(80, 2), conic=rng.randn(80, 3) * 1e-2,
               opacity=rng.randn(80), color=rng.randn(80, 3),
               depth=rng.randn(80))
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    return js, cam, opacity, sh, offset, cot


@pytest.mark.parametrize("seed", [0, 3])
def test_preprocess_vjp_matches_jax(seed):
    js, cam, opacity, sh, offset, cot = _preprocess_inputs(seed)
    p = js.params
    names = ("mean2d", "conic", "opacity", "color", "depth")

    def jf(xyz, ls, q, op, sh_, off):
        out = jpreprocess(xyz, ls, q, op, sh_, cam, alive=js.alive,
                          active_sh_degree=js.active_sh_degree,
                          max_sh_degree=2, mean2d_offset_ndc=off)
        return tuple(getattr(out, k) for k in names)

    primals = (p.xyz, p.log_scales, p.quats, jnp.asarray(opacity),
               jnp.asarray(sh), jnp.asarray(offset))
    outs, vjp = jax.vjp(jf, *primals)
    want = vjp(tuple(jnp.asarray(cot[k]) for k in names))

    ins = [torch.tensor(np.asarray(a), requires_grad=True) for a in primals]
    tcam = port_camera(cam)
    out = preprocess(*ins[:5], tcam, alive=torch.from_numpy(
        np.array(js.alive)), active_sh_degree=2, max_sh_degree=2,
        mean2d_offset_ndc=ins[5])
    for k, o in zip(names, outs):
        np.testing.assert_allclose(getattr(out, k).detach().numpy(),
                                   np.asarray(o), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got = torch.autograd.grad([getattr(out, k) for k in names], ins,
                              [torch.from_numpy(cot[k]) for k in names])
    for label, g, w in zip(("xyz", "log_scales", "quats", "opacity", "sh",
                            "offset"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-12
        assert np.isfinite(g.numpy()).all(), label
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=2e-5,
                                   err_msg=label)


def test_low_opacity_and_dead_slots_give_finite_gradients():
    """Dead slots and Gaussians of opacity <= 1/256 (an empty rect) give
    finite gradients, the viewspace probe's included. The rect
    arithmetic, whose sqrt(2 ln(256 op) c_xx) has an infinite derivative
    at ln(256 op) <= 0, is detached as the JAX package stops it."""
    js = random_scene(30, seed=5, capacity=50)
    fields = js.params
    raw = np.array(fields.opacity_raw)
    raw[:4, 0] = np.log((1 / 300) / (1 - 1 / 300))   # op < 1/256
    js = js.replace(params=fields.replace(opacity_raw=jnp.asarray(raw)))
    scene, cam = port_scene(js), port_camera(make_camera(32, 32))
    offset = torch.zeros((50, 2), requires_grad=True)
    out = render(scene, cam, torch.zeros(3), mean2d_offset_ndc=offset,
                 max_instances=4096)
    loss = torch.sum(out.color) + torch.sum(out.depth) + torch.sum(out.alpha)
    params = [getattr(scene, k) for k in DIFF_PARAMS]
    grads = torch.autograd.grad(loss, params + [offset])
    for name, g in zip(DIFF_PARAMS + ("mean2d_offset_ndc",), grads):
        assert torch.isfinite(g).all(), name
    assert not bool(out.visible[:4].any())   # dead opacity: not binned
    assert float(grads[-1].abs().sum()) > 0


def _segments(counts, gf, seed):
    rng = np.random.RandomState(seed)
    b_incl = np.cumsum(counts).astype(np.int32)
    n = int(b_incl[-1])
    mag = 10.0 ** rng.uniform(-4, 2, (gf, n))
    rows = (mag * np.where(rng.rand(gf, n) < 0.5, -1.0, 1.0)).astype(
        np.float32)
    return rows, b_incl


def test_rank_segment_sum_matches_float64_at_production_R():
    # the adversarial case of tests/test_reduce_accuracy.py:31 at R = 400k:
    # 8 huge Gaussians own half the ranks, the rest a heavy-tailed count
    R, GF = 400_000, 10
    rng = np.random.RandomState(0)
    huge = rng.multinomial(R // 2, np.ones(8) / 8)
    rest = rng.zipf(1.7, 120_000)
    rest = rest[np.cumsum(rest) <= R - R // 2]
    counts = np.concatenate([huge, rest, [0, 0, 0]]).astype(np.int64)
    counts = np.concatenate([counts, [R - counts.sum()]])
    rng.shuffle(counts)
    rows, b_incl = _segments(counts, GF, seed=1)
    C = len(counts)
    got = rank_segment_sum(torch.from_numpy(rows), torch.from_numpy(b_incl),
                           torch.from_numpy(counts.astype(np.int32)), C)
    gid = np.repeat(np.arange(C), counts)
    truth = np.zeros((C, GF), np.float64)
    np.add.at(truth, gid, rows.T.astype(np.float64))
    # float64 sums rounded once: within half an ulp of the truth
    np.testing.assert_array_equal(got.numpy(), truth.astype(np.float32))
    assert not got.numpy()[counts == 0].any()


def test_rank_segment_sum_cuts_ranks_at_n():
    # a budget below num_rendered cuts the last segments at n
    counts = np.array([3, 0, 4, 2, 5], np.int64)
    rows, b_incl = _segments(counts, 4, seed=2)
    n = 8
    got = rank_segment_sum(torch.from_numpy(rows[:, :n]),
                           torch.from_numpy(b_incl),
                           torch.from_numpy(counts.astype(np.int32)), 5)
    want = np.zeros((5, 4), np.float32)
    want[0] = rows[:, 0:3].astype(np.float64).sum(1)
    want[2] = rows[:, 3:7].astype(np.float64).sum(1)
    want[3] = rows[:, 7:8].astype(np.float64).sum(1)
    np.testing.assert_array_equal(got.numpy(), want)
