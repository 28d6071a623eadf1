"""Port vs JAX: the Add system, the object path, the transforms and KNN.

The transforms within 1e-6; `compact` and `concat_scenes` exactly equal
on every field (the object's SH rest padded and cut); `k_nearest_neighbors`
exact, `knn_dist_brute` within 1e-5 relative, the native route within
1e-6 relative of the JAX package's; `align_depth_scale` and
`place_object_in_scene` within 1e-5; `AddSystem.run()`'s merged scene
against the JAX system's (the base exactly, the placed object within
1e-5), with and without a depth estimator; a refinement that moves only
the object and leaves the caller's scene alone; `load_obj`,
`sample_mesh_surface` and `render_mesh_lambertian` exactly equal;
`photometric_fit`'s losses at rtol 1e-3 over 3 steps; the Wonder3D
adapter's commands and stub pipeline (as `tests/test_add_externals.py`);
the DPT adapter's architecture (skipped without `transformers`). The
JAX side renders its production route ('pallas', `ops.render.
default_impl` patched) except where it names 'tiled' itself.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core import transforms as jtf
from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit import add_system as jadd
from gaussianeditor_tpu.edit import mesh_to_gs as jmesh
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu.models.gaussians import concat_scenes as jconcat
from gaussianeditor_tpu.native import knn_sq_dists_native as jknn_native
from gaussianeditor_tpu.ops import knn as jknn
from gaussianeditor_tpu_torch.core import transforms as tf
from gaussianeditor_tpu_torch.edit import add_system, mesh_to_gs
from gaussianeditor_tpu_torch.edit import wonder3d_adapter as w3d
from gaussianeditor_tpu_torch.guidance import fake
from gaussianeditor_tpu_torch.models.gaussians import concat_scenes
from gaussianeditor_tpu_torch.native import knn_sq_dists_native
from gaussianeditor_tpu_torch.ops import knn
from tests.helpers import make_camera, random_scene
from tests.test_add_externals import CUBE_OBJ
from tests.torch_port_helpers import PARAMS, port_camera, port_scene

jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")
jtrainer_mod = importlib.import_module("gaussianeditor_tpu.train.trainer")
FIELDS = ("alive", "mask", "generation", "anchor_weights", "n_generations",
          "active_sh_degree")


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")


def assert_scene_equal(ts, js, rtol=0.0, atol=0.0, rows=slice(None)):
    """Every field of a port scene against a JAX scene: integers and
    bools exactly, floats to (rtol, atol) on `rows`."""
    assert ts.max_sh_degree == js.max_sh_degree
    for k in PARAMS:
        for t, j, what in ((getattr(ts, k), getattr(js.params, k), ""),
                           (getattr(ts, "anchor_" + k),
                            getattr(js.anchor, k), "anchor_")):
            t, j = t.detach().numpy(), np.asarray(j)
            assert t.shape == j.shape, what + k
            np.testing.assert_allclose(t[rows], j[rows], rtol=rtol,
                                       atol=atol, err_msg=what + k)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


# ---- transforms ----

def test_transforms_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(50, 4).astype(np.float32)
    q[0] = 0.0                       # a dead slot's zero quaternion
    s = rng.uniform(0.01, 0.5, (50, 3)).astype(np.float32)
    tq, ts_ = torch.from_numpy(q), torch.from_numpy(s)
    jq, js_ = jnp.asarray(q), jnp.asarray(s)

    def close(t, j, name):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=name)

    close(tf.build_scaling_rotation(ts_, tq),
          jtf.build_scaling_rotation(js_, jq), "build_scaling_rotation")
    cov = tf.build_covariance(ts_, tq, 1.3)
    close(cov, jtf.build_covariance(js_, jq, 1.3), "build_covariance")
    close(tf.strip_symmetric(cov), jtf.strip_symmetric(jnp.asarray(
        cov.numpy())), "strip_symmetric")
    assert torch.equal(tf.unstrip_symmetric(tf.strip_symmetric(cov)), cov)
    close(tf.quat_multiply(tq[:1], tq), jtf.quat_multiply(jq[:1], jq),
          "quat_multiply")
    for seed in range(6):   # every branch of rotmat_to_quat
        R = np.asarray(jtf.quat_to_rotmat(jnp.asarray(
            np.random.RandomState(seed).randn(4).astype(np.float32))))
        np.testing.assert_allclose(tf.rotmat_to_quat(R),
                                   jtf.rotmat_to_quat(R), atol=1e-6)
    for R in (np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
              np.diag([-1.0, -1, 1])):
        np.testing.assert_allclose(tf.rotmat_to_quat(R),
                                   jtf.rotmat_to_quat(R), atol=1e-6)
    xyz = rng.randn(50, 3).astype(np.float32)
    off = rng.randn(3).astype(np.float32)
    txyz, jxyz = torch.from_numpy(xyz), jnp.asarray(xyz)
    close(tf.translate_xyz(txyz, torch.from_numpy(off)),
          jtf.translate_xyz(jxyz, jnp.asarray(off)), "translate_xyz")
    ls = np.log(s)
    for t, j in zip(tf.scale_gaussians(txyz, torch.from_numpy(ls), 1.7,
                                       torch.from_numpy(off)),
                    jtf.scale_gaussians(jxyz, jnp.asarray(ls), 1.7,
                                        jnp.asarray(off))):
        close(t, j, "scale_gaussians")
    R = tf.quat_to_rotmat(tq[3])
    rq = torch.from_numpy(tf.rotmat_to_quat(R.numpy()))
    for t, j in zip(tf.rotate_gaussians(txyz, tq, R, rq,
                                        torch.from_numpy(off)),
                    jtf.rotate_gaussians(jxyz, jq, jnp.asarray(R.numpy()),
                                         jnp.asarray(rq.numpy()),
                                         jnp.asarray(off))):
        close(t, j, "rotate_gaussians")
    np.testing.assert_array_equal(tf.default_model_rotation(),
                                  jtf.default_model_rotation())


# ---- compact and concat_scenes ----

def _with_dead(js, seed):
    alive = np.random.RandomState(seed).rand(js.capacity) < 0.7
    mask = np.random.RandomState(seed + 1).rand(js.capacity) < 0.5
    gen = np.arange(js.capacity, dtype=np.int32) % 3
    return js.replace(alive=jnp.asarray(alive), mask=jnp.asarray(mask),
                      generation=jnp.asarray(gen),
                      n_generations=jnp.asarray(3, jnp.int32))


def test_compact_matches_jax():
    js = _with_dead(random_scene(40, seed=1, max_sh_degree=2), 1)
    ts = port_scene(js)
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    out = ts.compact()
    assert_scene_equal(out, js.compact())
    assert out.capacity == int(np.asarray(js.alive).sum()) < ts.capacity
    for k, v in ts.state_dict().items():   # the input is unchanged
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("degrees", [(3, 0), (1, 1), (0, 2)])
def test_concat_scenes_matches_jax(degrees):
    db, do = degrees
    jb = _with_dead(random_scene(30, seed=2, max_sh_degree=db), 2)
    jo = _with_dead(random_scene(12, seed=3, max_sh_degree=do,
                                 capacity=16), 4)
    jb = jb.replace(anchor_weights=jb.anchor_weights.at[0].set(0.07),
                    active_sh_degree=jnp.asarray(db, jnp.int32))
    got = concat_scenes(port_scene(jb), port_scene(jo))
    want = jconcat(jb, jo)
    assert_scene_equal(got, want)
    nb = int(np.asarray(jb.alive).sum())
    assert got.mask[nb:].all() and not got.mask[:nb].any()
    assert int(got.n_generations) == 1 and not got.generation.any()


def test_concat_scenes_refuses_two_devices():
    a = port_scene(random_scene(5, seed=1))
    b = port_scene(random_scene(5, seed=2)).to("meta")
    with pytest.raises(ValueError, match="one first"):
        concat_scenes(a, b)


# ---- knn ----

def test_knn_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.rand(3000, 3).astype(np.float32)
    qs = rng.rand(500, 3).astype(np.float32)
    for k in (1, 4):
        td, ti = knn.k_nearest_neighbors(pts, qs, k)
        jd, ji = jknn.k_nearest_neighbors(pts, qs, k)
        assert td.dtype == np.float32 and ti.dtype == np.int32
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ti, ji)
    valid = rng.rand(3000) < 0.8
    got = knn.knn_dist_brute(torch.from_numpy(pts), torch.from_numpy(qs), 3,
                             valid=torch.from_numpy(valid), chunk=128)
    want = jknn.knn_dist_brute(jnp.asarray(pts), jnp.asarray(qs), 3,
                               valid=jnp.asarray(valid), chunk=128)
    assert got.shape == (500, 3)
    # |q|^2 + |p|^2 - 2 q.p cancels: each package's matrix product rounds
    # its own way, so beside 1e-5 relative the bound takes the float32
    # rounding of the summands (two ulps of max |q|^2 + max |p|^2)
    scale = float((qs ** 2).sum(1).max() + (pts ** 2).sum(1).max())
    atol = 2 * np.finfo(np.float32).eps * scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)
    exact = np.sort(((qs[:, None].astype(np.float64) - pts[None]) ** 2).sum(
        -1)[:, valid], axis=1)[:, :3]
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=atol)
    # the native route against the JAX package's native route
    got = knn.mean_sq_dist_to_3nn(pts)
    want = jknn.mean_sq_dist_to_3nn(pts)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(knn_sq_dists_native(pts, qs, 3),
                               jknn_native(pts, qs, 3), rtol=1e-6)
    np.testing.assert_allclose(
        knn.mean_sq_dist_to_3nn(pts, prefer_native=False),
        jknn.mean_sq_dist_to_3nn(pts, prefer_native=False), rtol=1e-6)


def test_native_builds_under_build_dir():
    from gaussianeditor_tpu_torch import native

    assert native.get_lib() is not None
    path = native.lib_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))


# ---- depth alignment and placement ----

def test_align_and_place_match_jax():
    rng = np.random.RandomState(0)
    est = rng.uniform(1, 5, (32, 32)).astype(np.float32)
    rendered = (2.0 * est + 0.5 + 0.01 * rng.randn(32, 32)).astype(np.float32)
    obj = np.zeros((32, 32), bool)
    obj[10:20, 10:20] = True
    a, b = add_system.align_depth_scale(est, rendered, obj)
    ja, jb = jadd.align_depth_scale(est, rendered, obj)
    assert abs(a - ja) < 1e-5 and abs(b - jb) < 1e-5
    assert add_system.align_depth_scale(est, np.zeros_like(est), obj) == (
        1.0, 0.0)

    js = random_scene(20, seed=6, spread=0.5)
    jcam = make_camera(64, 64)
    bbox = (20, 24, 44, 48)
    ts = port_scene(js)
    out = add_system.place_object_in_scene(ts, port_camera(jcam), bbox, 3.0)
    assert out is ts   # placed in place
    want = jadd.place_object_in_scene(js, jcam, bbox, 3.0)
    for k in ("xyz", "log_scales", "quats"):
        np.testing.assert_allclose(getattr(ts, k).detach().numpy(),
                                   np.asarray(getattr(want.params, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ---- the Add system ----

class RampDepth:
    """A monocular depth estimate: a ramp over the image."""

    def __call__(self, image):
        h, w = np.asarray(image).shape[:2]
        return (np.linspace(1.0, 2.0, h)[:, None] * np.ones((1, w))
                ).astype(np.float32)


def _add_systems(js, depth=False, **kw):
    kw = dict(dict(prompt="blend", bbox=(16, 16, 48, 48), anchor_view_id=1,
                   batch_size=2, max_steps=3, per_editing_step=10,
                   densify_until_step=0, cameras_extent=2.0,
                   max_instances=8192, tile_cap=512, chunk=64), **kw)
    jcams = jorbit_cameras(4, 4.0, 0.8, 0.8, 64, 64)
    jsys = jadd.AddSystem(js, jcams, jadd.AddConfig(**kw),
                          inpainter=jfake.FakeInpainter(),
                          object_generator=jfake.FakeObjectGenerator(300),
                          depth_estimator=RampDepth() if depth else None)
    ts = port_scene(js)
    tsys = add_system.AddSystem(
        ts, [port_camera(c) for c in jcams], add_system.AddConfig(**kw),
        inpainter=fake.FakeInpainter(),
        object_generator=fake.FakeObjectGenerator(300, device="cpu"),
        depth_estimator=RampDepth() if depth else None)
    return jsys, tsys, ts


def test_fake_object_generator_matches_jax():
    img = np.random.RandomState(0).rand(20, 30, 3).astype(np.float32)
    got = fake.FakeObjectGenerator(500, seed=2, device="cpu")(img, "p")
    want = jfake.FakeObjectGenerator(500, seed=2)(img, "p")
    assert got.device.type == "cpu"
    assert_scene_equal(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("depth", [False, True])
def test_add_run_matches_jax(depth):
    js = _with_dead(random_scene(60, seed=9, max_sh_degree=1), 9)
    jsys, tsys, ts = _add_systems(js, depth=depth)
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    got, want = tsys.run(), jsys.run()
    assert got is tsys.scene
    nb = int(np.asarray(js.alive).sum())
    assert got.capacity == want.capacity == nb + 300
    assert_scene_equal(got, want, rows=slice(0, nb))
    assert_scene_equal(got, want, rtol=1e-5, atol=1e-5,
                       rows=slice(nb, None))
    assert got.mask[nb:].all() and not got.mask[:nb].any()
    for k, v in ts.state_dict().items():   # the caller's scene
        assert torch.equal(v, before[k]), k


def test_add_refinement_moves_only_the_object():
    js = random_scene(40, seed=7)
    _, tsys, ts = _add_systems(js)
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    merged = tsys.run()
    start = {k: v.detach().clone() for k, v in merged.params().items()}
    # what the JAX CLI runs after run() (apps/launch.py:385-389)
    tsys.guidance = fake.FakeGuidance()
    losses = []
    tsys.fit(n_steps=3, callback=lambda s, m: losses.append(float(m["loss"])))
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = tsys.state.scene
    # the mask gates every group but the rotation, as the reference's
    # apply_grad_mask hooks do (gaussian_model.py:837-856)
    for k, v in start.items():
        if k != "quats":
            assert torch.equal(getattr(out, k)[:40], v[:40]), k
    assert (out.xyz[40:] != start["xyz"][40:]).any()
    assert (out.features_dc[40:] != start["features_dc"][40:]).any()
    for k, v in ts.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- mesh to Gaussians ----

def _octahedron(r=0.5):
    v = np.array([[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0],
                  [0, 0, r], [0, 0, -r]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def test_mesh_io_sampling_and_raster_match_jax(tmp_path):
    path = str(tmp_path / "cube.obj")
    with open(path, "w") as fh:
        fh.write(CUBE_OBJ + "f 1 2 3 4\n")   # and a quad, fan-triangulated
    for t, j in zip(mesh_to_gs.load_obj(path), jmesh.load_obj(path)):
        np.testing.assert_array_equal(t, j)
    v, f, c = mesh_to_gs.load_obj(path)
    for cols in (c, None):
        for t, j in zip(mesh_to_gs.sample_mesh_surface(v, f, 700, cols, 3),
                        jmesh.sample_mesh_surface(v, f, 700, cols, 3)):
            np.testing.assert_array_equal(t, j)
    got = mesh_to_gs.mesh_to_gaussians(path, n_samples=400, device="cpu")
    assert_scene_equal(got, jmesh.mesh_to_gaussians(path, n_samples=400),
                       rtol=1e-6, atol=1e-7)
    ov, of = _octahedron()
    for jc in jorbit_cameras(3, 1.5, 0.8, 0.8, 40, 48):
        for kw in (dict(), dict(bg=0.0, ambient=0.5)):
            np.testing.assert_array_equal(
                mesh_to_gs.render_mesh_lambertian(ov, of, port_camera(jc),
                                                  **kw),
                jmesh.render_mesh_lambertian(ov, of, jc, **kw))


def test_photometric_fit_matches_jax(jax_pallas, monkeypatch):
    v, f = _octahedron()
    pts, cols = mesh_to_gs.sample_mesh_surface(v, f, 300, None, 0)
    jcams = jorbit_cameras(4, 1.5, 0.8, 0.8, 32, 32, center=v.mean(axis=0))
    targets = np.stack([jmesh.render_mesh_lambertian(v, f, c, bg=0.0)
                        for c in jcams])
    from gaussianeditor_tpu.models.gaussians import GaussianScene as JScene
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

    # the JAX step's metrics, recorded by wrapping its make_train_step
    jl = []
    make = jtrainer_mod.make_train_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def run(*sa):
            state, m = step(*sa)
            jl.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(jtrainer_mod, "make_train_step", recording_make)
    jfit = jmesh.photometric_fit(JScene.from_points(pts, cols, 0), jcams,
                                 targets, steps=3, max_instances=4096)
    tscene = GaussianScene.from_points(pts, cols, 0, device="cpu")
    tl = []
    out = mesh_to_gs.photometric_fit(
        tscene, [port_camera(c) for c in jcams], targets, steps=3,
        max_instances=4096, callback=lambda s, m: tl.append(float(m["loss"])))
    assert out is tscene and len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    # geometry frozen, appearance moved
    for k in ("xyz", "log_scales", "quats", "opacity_raw"):
        assert torch.equal(getattr(out, k), getattr(out, "anchor_" + k)), k
    assert (out.features_dc != out.anchor_features_dc).any()
    np.testing.assert_allclose(out.features_dc.detach().numpy(),
                               np.asarray(jfit.params.features_dc),
                               atol=1e-4)
    with pytest.warns(UserWarning, match="dispatch_burst=4"):
        mesh_to_gs.photometric_fit(tscene, [port_camera(c) for c in jcams],
                                   targets, steps=1, max_instances=4096,
                                   dispatch_burst=4)


def test_refine_with_guidance_trains_a_copy():
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

    v, f = _octahedron()
    pts, cols = mesh_to_gs.sample_mesh_surface(v, f, 300, None, 0)
    scene = GaussianScene.from_points(pts, cols, 0, device="cpu")
    before = {k: t.clone() for k, t in scene.state_dict().items()}
    out = mesh_to_gs.refine_with_guidance(
        scene, fake.FakeGuidance(), "a red toy", n_views=4, steps=2, hw=32,
        max_instances=8192)
    assert out is not scene and out.device.type == "cpu"
    assert (out.features_dc != scene.features_dc).any()
    for k, t in scene.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_fit_colorless_mesh_learns_shading():
    v, f = _octahedron()
    losses = []
    scene = mesh_to_gs.fit_colorless_mesh(
        (v, f), n_samples=300, n_views=4, hw=32, steps=16,
        max_instances=8192, device="cpu",
        callback=lambda s, m: losses.append(float(m["loss_l1"])))
    dc = scene.features_dc.detach()[scene.alive]
    assert float(dc.std()) > 0.01
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---- Wonder3D and DPT adapters ----

def _stub_runner(log):
    def run(cmd, cwd):
        log.append((list(cmd), cwd))
        save_dir = cmd[cmd.index("--save_dir") + 1]
        if "test_mvdiffusion_seq.py" in cmd:
            for i in range(14):
                open(os.path.join(save_dir, f"pred_{i}.png"), "w").close()
        elif "launch.py" in cmd:
            with open(os.path.join(save_dir, "inpaint_mesh.obj"), "w") as fh:
                fh.write(CUBE_OBJ)
        else:
            raise AssertionError(f"unexpected command {cmd}")
    return run


def test_wonder3d_commands_and_stub_pipeline(tmp_path):
    from gaussianeditor_tpu.edit import wonder3d_adapter as jw3d

    args = ("/envs/w3d", "/cache/mv", "/cache")
    assert w3d.mvdiffusion_command(*args) == jw3d.mvdiffusion_command(*args)
    args = ("/envs/w3d", "/cache", "/cache/multiview_pred_images")
    assert w3d.nsr_command(*args) == jw3d.nsr_command(*args)
    assert "dataset.scene=multiview_pred_images" in w3d.nsr_command(*args)
    assert ({f.name for f in dataclasses.fields(w3d.Wonder3DGenerator)}
            == {f.name for f in dataclasses.fields(jw3d.Wonder3DGenerator)}
            | {"device"})

    log = []
    gen = w3d.Wonder3DGenerator(
        wonder3d_root=str(tmp_path / "w3d"), cache_dir=str(tmp_path / "c"),
        python_prefix="/envs/w3d", n_gaussians=500,
        runner=_stub_runner(log), device="cpu")
    img = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    scene = gen(img, "a toy robot")
    assert [cwd for _, cwd in log] == [
        str(tmp_path / "w3d"), os.path.join(str(tmp_path / "w3d"),
                                            "instant-nsr-pl")]
    assert os.path.exists(tmp_path / "c" / "removed_bg.png")
    assert scene.device.type == "cpu" and int(scene.n_alive) == 500
    want = jmesh.mesh_to_gaussians(gen.mesh_path, n_samples=500)
    assert_scene_equal(scene, want, rtol=1e-6, atol=1e-7)
    gen(img, "a toy robot")
    assert len(log) == 2   # cached: no subprocess the second time

    def noop(cmd, cwd):
        if "test_mvdiffusion_seq.py" in cmd:
            d = cmd[cmd.index("--save_dir") + 1]
            for i in range(14):
                open(os.path.join(d, f"p{i}.png"), "w").close()

    gen = w3d.Wonder3DGenerator(wonder3d_root=str(tmp_path),
                                cache_dir=str(tmp_path / "d"), runner=noop,
                                device="cpu")
    with pytest.raises(RuntimeError, match="no mesh"):
        gen(np.zeros((16, 16, 3), np.float32), "x")


def test_dpt_architecture_only(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    from gaussianeditor_tpu_torch.edit.dpt_adapter import DPTDepthEstimator

    est = DPTDepthEstimator(pretrained=None, device="cpu", image_size=96)
    img = np.random.RandomState(0).rand(48, 64, 3).astype(np.float32)
    depth = est(img)
    assert depth.shape == (48, 64) and depth.dtype == np.float32
    assert np.isfinite(depth).all()
    mono = depth.astype(np.float64)
    mono = (mono - mono.min()) / max(float(np.ptp(mono)), 1e-6) + 0.5
    a, b = add_system.align_depth_scale(mono, 2.0 * mono + 0.7,
                                        np.zeros((48, 64), bool))
    assert abs(a - 2.0) < 1e-2 and abs(b - 0.7) < 2e-2
