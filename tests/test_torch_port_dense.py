"""Port vs JAX: the dense ('pallas4') render route.

`dense_bin` against the JAX `dense_bin`, fed the same JAX preprocess
output: integer-exact on every live value. The port sizes its buffers to
`num_rendered` (R_eff = num_rendered rounded up to 128 ranks, R_eff +
128 (T + 1) aligned slots) where the JAX function holds the whole budget,
so past the live ranks the two differ by design: sorted rows and ranks
are compared up to min(num_rendered, R), chunk metadata on the port's
chunks (the first sorted row only on live chunks), and the JAX chunks
beyond them must be dead.

Kernels B5 and B6 through their plain versions against the Pallas
`make_forward` and `make_backward` (interpret mode), each fed the same
instance matrix and chunk metadata, for 1, 3 and 8 channels. Then the
route as a whole against JAX `render(impl="pallas4")` and against the
port's own sorted route, one `make_train_step(impl="pallas4")` step
against JAX's, bitwise repeatability and the routing.

Tolerances: images `assert_images_close` (`tests/helpers.py:67`, the
depth at loose 2e-2 as in `tests/test_pallas.py:37`); gradients and
gradient rows atol 1e-3 / rtol 1e-2 (`tests/test_pallas.py:87`); sorted
against dense 2e-6 on images and 3e-4 of each gradient's max
(`tests/test_pallas.py:198-220`); integers exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.ops.binning_dense import (
    dense_bin as jdense_bin,
    dense_capacities as jdense_capacities,
)
from gaussianeditor_tpu.ops.pallas_composite import (
    _pad8,
    make_backward,
    make_forward,
)
from gaussianeditor_tpu.ops.preprocess import preprocess as jpreprocess
from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu_torch.ops import render as render_mod
from gaussianeditor_tpu_torch.ops.binning_dense import (
    dense_bin,
    dense_capacities,
)
from gaussianeditor_tpu_torch.ops.dense_composite import (
    backward_chunks_plain,
    forward_chunks_plain,
    pack_instances,
)
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.testing import assert_images_close
from tests.helpers import make_camera, random_scene
from tests.test_torch_port_train import check_one_step, run_both
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_proc,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MI = 8192
GRAD_TOL = dict(atol=1e-3, rtol=1e-2)   # tests/test_pallas.py:87
DIFF_PARAMS = ("xyz", "features_dc", "features_rest", "opacity_raw",
               "log_scales", "quats")


def _override(ch, cap, seed):
    """A seeded [cap, ch] feature to render, or None for SH colors."""
    if ch == 3:
        return None
    return np.random.RandomState(100 + seed).rand(cap, ch).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jit_stages(grid_x, grid_y, max_instances, with_override):
    def f(scene, cam, oc):
        proc = jpreprocess(
            scene.params.xyz, scene.params.log_scales, scene.params.quats,
            scene.get_opacity[:, 0],
            None if with_override else scene.get_features, cam,
            alive=scene.alive, active_sh_degree=scene.active_sh_degree,
            max_sh_degree=scene.max_sh_degree, override_color=oc)
        return proc, jdense_bin(proc, grid_x, grid_y, max_instances)

    return jax.jit(f)


def _binned(seed, h, w, max_instances, ch=3):
    js = random_scene(130, seed=seed, max_sh_degree=1, capacity=160)
    oc = _override(ch, 160, seed)
    gx, gy = -(-w // 16), -(-h // 16)
    proc, want = _jit_stages(gx, gy, max_instances, oc is not None)(
        js, make_camera(h, w), None if oc is None else jnp.asarray(oc))
    proc = jax.tree_util.tree_map(np.asarray, proc)
    want = jax.tree_util.tree_map(np.asarray, want)
    p = port_proc(proc)
    return p, want, dense_bin(p, gx, gy, max_instances), gx, gy


def _assert_bin_matches(got, want, max_instances):
    total = int(want.num_rendered)
    n = min(total, -(-max_instances // 128) * 128)
    NC = got.chunk_tile.shape[0]
    assert int(got.num_rendered) == total
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_array_equal(got.b_incl.numpy(), want.b_incl)
    np.testing.assert_array_equal(got.tile_nonempty.numpy(),
                                  want.tile_nonempty)
    np.testing.assert_array_equal(got.sorted_g[:n].numpy(),
                                  want.sorted_g[:n])
    np.testing.assert_array_equal(got.a_by_rank[:n].numpy(),
                                  want.a_by_rank[:n])
    for k in ("chunk_tile", "chunk_first", "chunk_nvalid", "chunk_offset"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k)[:NC], err_msg=k)
        assert not getattr(want, k)[NC:].any(), f"a JAX chunk past NC: {k}"
    live = got.chunk_nvalid.numpy() > 0
    assert live.any()
    np.testing.assert_array_equal(got.chunk_p0.numpy()[live],
                                  want.chunk_p0[:NC][live])
    assert int(got.chunk_nvalid.sum()) == n


@pytest.mark.parametrize("seed,h,w", [(0, 64, 48), (5, 40, 72)])
def test_dense_bin_matches_exactly(seed, h, w):
    _, want, got, gx, gy = _binned(seed, h, w, MI)
    assert int(want.num_rendered) > 0 and not bool(want.overflow)
    _assert_bin_matches(got, want, MI)
    caps = dense_capacities(MI, gx * gy)
    assert caps == jdense_capacities(MI, gx * gy)
    assert caps[2] == want.chunk_tile.shape[0] > got.chunk_tile.shape[0]
    # buffers sized to num_rendered, not to the budget
    assert got.sorted_g.shape[0] == -(-int(want.num_rendered) // 128) * 128


def test_dense_bin_overflow_matches():
    # cf. tests/test_torch_port_binning.py:67: a budget below num_rendered
    _, want, got, _, _ = _binned(2, 64, 64, 200)
    assert int(want.num_rendered) > 256 and bool(want.overflow)
    assert got.sorted_g.shape[0] == 256   # 200 rounded up to the chunk
    _assert_bin_matches(got, want, 200)


# ---- kernels B5 and B6, through their plain versions, per module ----

@functools.lru_cache(maxsize=None)
def _jax_kernels(num_tiles, grid_x, ch, num_chunks):
    return (jax.jit(make_forward(num_tiles, grid_x, ch, num_chunks)),
            jax.jit(make_backward(num_tiles, grid_x, ch, num_chunks)))


@pytest.fixture(scope="module", params=[1, 3, 8], ids=lambda c: f"ch{c}")
def chunk_case(request):
    """One view's instance matrix and metadata in both layouts, the
    forwards of both packages and a seeded cotangent."""
    ch = request.param
    p, _, db, gx, gy = _binned(7, 48, 64, MI, ch=ch)
    T = gx * gy
    inst = pack_instances(p.mean2d, p.conic, p.opacity, p.color, p.depth, db)
    NC = inst.shape[0]
    assert inst.shape == (NC, 7 + ch, 128)
    jinst = np.zeros((NC, _pad8(7 + ch), 128), np.float32)
    jinst[:, :7 + ch] = inst.numpy()
    meta = [jnp.asarray(getattr(db, k).numpy()) for k in
            ("chunk_tile", "chunk_first", "chunk_nvalid", "chunk_offset")]
    jfwd, jbwd = _jax_kernels(T, gx, ch, NC)
    (out,) = jfwd(*meta, jnp.asarray(jinst))
    out = np.asarray(out)
    # tiles without chunks are never visited (pallas_composite.py:1161-1164)
    empty = ~db.tile_nonempty.numpy()[:, None]
    want = dict(color=np.where(empty[..., None], 0.0, out[..., :ch]),
                depth=np.where(empty, 0.0, out[..., ch]),
                final_T=np.where(empty, 1.0, out[..., ch + 1]),
                n_contrib=np.where(empty, 0, out[..., ch + 2]).astype(np.int32))
    tiles, _, _ = forward_chunks_plain(inst, db, gx)
    rng = np.random.RandomState(ch)
    cot = (rng.randn(T, 256, ch).astype(np.float32),
           (0.1 * rng.randn(T, 256)).astype(np.float32),
           (0.05 * rng.randn(T, 256)).astype(np.float32))
    return dict(ch=ch, db=db, inst=inst, meta=meta, jinst=jinst, jbwd=jbwd,
                want=want, tiles=tiles, cot=cot, gx=gx, T=T)


def test_forward_chunks_plain_matches_make_forward(chunk_case):
    c = chunk_case
    got, want = c["tiles"], c["want"]
    assert_images_close(got.color.numpy(), want["color"], name="color")
    assert_images_close(got.depth.numpy(), want["depth"], loose=2e-2,
                        name="depth")
    assert_images_close(got.final_T.numpy(), want["final_T"], name="final_T")
    np.testing.assert_array_equal(got.n_contrib.numpy(), want["n_contrib"])
    assert want["n_contrib"].max() > 0


def test_backward_chunks_plain_matches_make_backward(chunk_case):
    c = chunk_case
    ch, db, tiles = c["ch"], c["db"], c["tiles"]
    g_color, g_depth, g_T = c["cot"]
    # both fed the same forward residuals: the port's plain forward
    nc = tiles.n_contrib.numpy()
    gall = np.concatenate(
        [g_color, g_depth[..., None], tiles.color.numpy(),
         tiles.depth.numpy()[..., None], g_T[..., None],
         tiles.final_T.numpy()[..., None], nc.astype(np.float32)[..., None]],
        axis=-1)
    nv, co, ct = (db.chunk_nvalid.numpy(), db.chunk_offset.numpy(),
                  db.chunk_tile.numpy())
    active = ((nv > 0) & (co < nc.max(axis=1)[ct])).astype(np.int32)
    (grows,) = c["jbwd"](*c["meta"], jnp.asarray(active),
                         jnp.asarray(c["jinst"]), jnp.asarray(gall))
    want = np.asarray(grows)[:, :7 + ch]
    got = backward_chunks_plain(c["inst"], db, tiles,
                                *(torch.from_numpy(a) for a in c["cot"]),
                                c["gx"]).numpy()
    assert got.shape == want.shape
    live = nv > 0
    assert np.abs(want[live]).max() > 1e-2   # the view has gradients
    np.testing.assert_allclose(got[live], want[live], **GRAD_TOL)
    assert not got[~live].any()


# ---- the route as a whole ----

ROUTE_CASES = {
    "sh_ch3_64x48": dict(seed=15, hw=(64, 48), ch=3),
    "feat_ch8_40x72": dict(seed=6, hw=(40, 72), ch=8),
}


@functools.lru_cache(maxsize=None)
def _jax_route(hw, with_override):
    cam = make_camera(*hw)

    def fwd(scene, oc):
        return jrender(scene, cam, override_color=oc, impl="pallas4",
                       max_instances=MI)

    def loss(params, oc, scene, probe):
        out = jrender(scene.replace(params=params), cam, override_color=oc,
                      impl="pallas4", max_instances=MI)
        return (jnp.sum(out.color * probe) + 0.1 * jnp.sum(out.depth)
                + 0.05 * jnp.sum(out.alpha))

    argnums = (0, 1) if with_override else 0
    return jax.jit(fwd), jax.jit(jax.grad(loss, argnums=argnums))


def _route_inputs(case):
    c = ROUTE_CASES[case]
    js = random_scene(130, seed=c["seed"], max_sh_degree=1, capacity=160)
    oc = _override(c["ch"], 160, c["seed"])
    probe = np.random.RandomState(c["seed"]).randn(
        *c["hw"], c["ch"]).astype(np.float32)
    return c, js, oc, probe


def _port_render_grads(js, hw, oc, probe, impl="pallas4"):
    """The port's render and its gradients for the loss of `_jax_route`."""
    scene = port_scene(js)
    toc = None if oc is None else torch.tensor(oc, requires_grad=True)
    out = render(scene, port_camera(make_camera(*hw)), override_color=toc,
                 impl=impl, max_instances=MI)
    loss = (torch.sum(out.color * torch.from_numpy(probe))
            + 0.1 * torch.sum(out.depth) + 0.05 * torch.sum(out.alpha))
    params = [getattr(scene, k) for k in DIFF_PARAMS]
    # an override leaves the SH features out of the graph: zero gradients
    grads = torch.autograd.grad(loss, params + ([toc] if oc is not None
                                                else []), allow_unused=True)
    named = {k: (torch.zeros_like(p) if g is None else g).numpy()
             for k, p, g in zip(DIFF_PARAMS, params, grads)}
    if oc is not None:
        named["override_color"] = grads[-1].numpy()
    return out, named


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_render_pallas4_matches_jax(case):
    c, js, oc, _ = _route_inputs(case)
    fwd, _ = _jax_route(c["hw"], oc is not None)
    want = jax.tree_util.tree_map(
        np.asarray, fwd(js, None if oc is None else jnp.asarray(oc)))
    with torch.no_grad():
        got = render(port_scene(js), port_camera(make_camera(*c["hw"])),
                     override_color=None if oc is None
                     else torch.from_numpy(oc), impl="pallas4",
                     max_instances=MI)
    assert got.color.shape == want.color.shape == c["hw"] + (c["ch"],)
    assert_images_close(got.color.numpy(), want.color, name="color")
    assert_images_close(got.depth.numpy(), want.depth, loose=2e-2,
                        name="depth")
    assert_images_close(got.final_T.numpy(), want.final_T, name="final_T")
    np.testing.assert_array_equal(got.n_contrib.numpy(), want.n_contrib)
    assert int(got.num_rendered) == int(want.num_rendered) > 0
    assert bool(got.overflow) == bool(want.overflow) is False


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_render_pallas4_gradients_match_jax(case):
    c, js, oc, probe = _route_inputs(case)
    _, grad = _jax_route(c["hw"], oc is not None)
    if oc is None:
        jg = grad(js.params, None, js, jnp.asarray(probe))
        want = {k: np.asarray(getattr(jg, k)) for k in DIFF_PARAMS}
    else:
        jg, jgo = grad(js.params, jnp.asarray(oc), js, jnp.asarray(probe))
        want = {k: np.asarray(getattr(jg, k)) for k in DIFF_PARAMS}
        want["override_color"] = np.asarray(jgo)
    _, got = _port_render_grads(js, c["hw"], oc, probe)
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], w, **GRAD_TOL,
                                   err_msg=f"grad mismatch: {name}")
    assert np.abs(got["xyz"]).max() > 1e-3


def test_dense_matches_sorted_route():
    # tests/test_pallas.py:189-220 on the port: both routes sort alike
    js = random_scene(130, seed=15)
    probe = np.random.RandomState(3).randn(64, 48, 3).astype(np.float32)
    o4, g4 = _port_render_grads(js, (64, 48), None, probe, impl="pallas4")
    o5, g5 = _port_render_grads(js, (64, 48), None, probe, impl="pallas")
    assert int(o5.num_rendered) == int(o4.num_rendered)
    np.testing.assert_allclose(o5.color.detach().numpy(),
                               o4.color.detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(o5.final_T.detach().numpy(),
                               o4.final_T.detach().numpy(), atol=2e-6)
    np.testing.assert_array_equal(o5.n_contrib.numpy(), o4.n_contrib.numpy())
    for k in DIFF_PARAMS:
        if g4[k].size == 0:
            continue
        den = np.abs(g4[k]).max() + 1e-8
        np.testing.assert_allclose(g5[k] / den, g4[k] / den, atol=3e-4,
                                   err_msg=k)


def test_train_step_pallas4_matches_jax():
    # the tolerances of tests/test_torch_port_train.py::
    # test_train_step_matches_jax
    check_one_step(*run_both(False, False, 1, impl="pallas4"))


def test_dense_route_bitwise_repeatable():
    js = random_scene(140, seed=12)
    probe = np.random.RandomState(1).randn(48, 48, 8).astype(np.float32)
    oc = _override(8, 140, 12)
    runs = [_port_render_grads(js, (48, 48), oc, probe) for _ in range(2)]
    (o1, g1), (o2, g2) = runs
    for a, b in ((o1.color, o2.color), (o1.depth, o2.depth),
                 (o1.final_T, o2.final_T), (o1.n_contrib, o2.n_contrib)):
        assert a.detach().numpy().tobytes() == b.detach().numpy().tobytes()
    for k in g1:
        assert g1[k].tobytes() == g2[k].tobytes(), k


def test_routing(monkeypatch):
    """More than 3 channels take the dense route unless impl says
    otherwise, on 'tiled' too; the JAX package's dense oracle 'ref'
    raises."""
    calls = []

    def spy(*args):
        calls.append(args[0].color.shape[-1])
        return dense_bin(*args)

    monkeypatch.setattr(render_mod, "dense_bin", spy)
    js = random_scene(40, seed=3)
    scene, cam = port_scene(js), port_camera(make_camera(32, 32))
    with torch.no_grad():
        render(scene, cam, override_color=torch.ones(40, 8))
        assert calls == [8]
        render(scene, cam, override_color=torch.ones(40, 2))
        render(scene, cam)
        assert calls == [8]
        render(scene, cam, impl="pallas4")
        assert calls == [8, 3]
        render(scene, cam, impl="tiled")
        assert calls == [8, 3]
        render(scene, cam, impl="tiled", override_color=torch.ones(40, 5))
        assert calls == [8, 3, 5]
        with pytest.raises(ValueError, match="ROADMAP"):
            render(scene, cam, impl="ref")
        with pytest.raises(ValueError, match="impl"):
            render(scene, cam, impl="dense")
