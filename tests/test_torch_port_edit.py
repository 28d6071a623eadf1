"""Port vs JAX: the edit loop.

The config system, view selection, the fakes, the prompt library, a
6-step `EditSystem.fit` with semantic tracing and one densify step (the
split noise JAX's key would draw injected into the port), the mask's
gate on updates, progressive resolution, the caller's scene left alone,
checkpoints across the two packages, a bitwise resume, async guidance,
the score injection and `dispatch_burst`. The JAX system renders through
its production route: `ops.render.default_impl` is patched to 'pallas',
as `tests/test_torch_port_train.py` runs its reference (no JAX file
changes). Losses at rtol 1e-3, as `test_train_trajectory_matches_jax`;
images at the JAX suite's bounds; integers and view ids exactly."""

import dataclasses
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.config import config as jconfig
from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.data import view_dataset as jviews
from gaussianeditor_tpu.edit import edit_system as jedit
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu.guidance import prompts as jprompts
from gaussianeditor_tpu.train import checkpoint as jckpt
from gaussianeditor_tpu.train import optim as joptim
from gaussianeditor_tpu.train import trainer as jtrainer
from gaussianeditor_tpu.train.densify import init_densify_stats as jinit_stats
from gaussianeditor_tpu.train.perceptual import (
    multiscale_gradient_loss as jmsg_loss,
)
from gaussianeditor_tpu_torch.config import config
from gaussianeditor_tpu_torch.data import view_dataset as views
from gaussianeditor_tpu_torch.edit import edit_system
from gaussianeditor_tpu_torch.guidance import fake, prompts
from gaussianeditor_tpu_torch.train import checkpoint
from gaussianeditor_tpu_torch.train.perceptual import multiscale_gradient_loss
from gaussianeditor_tpu_torch.testing import assert_images_close
from tests.helpers import random_scene
from tests.torch_port_helpers import PARAMS, port_camera, port_scene

LOSS_KEYS = ("loss", "loss_l1", "loss_p", "loss_anchor_color",
             "loss_anchor_geo", "loss_anchor_scale", "loss_anchor_opacity")
DENSIFY_KEYS = ("n_cloned", "n_split", "n_pruned", "n_dropped")
# the module (the package's `ops.render` attribute is the function)
jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")


# ---- config, views, fakes, prompts ----

def test_config_matches_jax(tmp_path):
    for v, s in ((0.5, 3), ([0, 1.0, 3.0, 10], 4), ([2.0, 5.0, 8], 20),
                 ([5, 1.0, 2.0, 5], 9), ([2, 1.0, 3.0, 6], 1)):
        assert config.C(v, s) == jconfig.C(v, s)
    got = config.load_config("configs/edit.yaml", ["system.max_steps=7"])
    want = jconfig.load_config("configs/edit.yaml", ["system.max_steps=7"])
    assert got == want and got["system"]["max_steps"] == 7
    tcfg = config.parse_structured(edit_system.EditConfig, got["system"])
    jcfg = jconfig.parse_structured(jedit.EditConfig, want["system"])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(edit_system.EditConfig()) == dataclasses.asdict(
        jedit.EditConfig())
    with pytest.raises(ValueError, match="unknown config keys"):
        config.parse_structured(edit_system.EditConfig, {"bogus": 1})


def test_view_selection_matches_jax():
    for total, k, seed in ((40, 12, 0), (10, 48, 0), (96, 48, 3)):
        assert (views.select_train_views(total, k, seed)
                == jviews.select_train_views(total, k, seed))
    vc = dict(height=[32, 64], width=[32, 64], batch_size=[1, 3],
              resolution_milestones=[5], max_view_num=7, seed=2)
    ts = views.TrainViewSchedule(20, views.ViewDataConfig(**vc))
    js = jviews.TrainViewSchedule(20, jviews.ViewDataConfig(**vc))
    for s in range(12):
        assert ts.resolution_at(s) == js.resolution_at(s)
        assert ts.sample_batch(s) == js.sample_batch(s)
    assert (views.select_val_views(ts.view_subset, 4)
            == jviews.select_val_views(js.view_subset, 4))
    assert views.select_test_views(9) == jviews.select_test_views(9)
    for kw in (dict(), dict(max_view_num=4), dict(max_view_num=50)):
        a = edit_system.ViewSampler(11, 3, seed=5, **kw)
        b = jedit.ViewSampler(11, 3, seed=5, **kw)
        assert a.views == b.views
        assert [a.sample() for _ in range(9)] == [b.sample() for _ in range(9)]
        assert a.sample(2) == b.sample(2)


def test_fakes_match_jax_bitwise():
    rng = np.random.RandomState(0)
    img = rng.rand(24, 20, 3).astype(np.float32)
    origin = rng.rand(24, 20, 3).astype(np.float32)
    mask = rng.rand(24, 20) > 0.6
    for s in (1.0, 0.4):
        np.testing.assert_array_equal(
            fake.FakeGuidance(s)(img, origin, "make it warm").edit_image,
            jfake.FakeGuidance(s)(img, origin, "make it warm").edit_image)
    for ref in (None, (0.2, 0.5, 0.7)):
        np.testing.assert_array_equal(
            fake.FakeSegmentor(ref, 0.4)(img, "the bear"),
            jfake.FakeSegmentor(ref, 0.4)(img, "the bear"))
    pts = np.array([[5.0, 7.0]])
    np.testing.assert_array_equal(fake.FakePointSegmentor()(img, pts),
                                  jfake.FakePointSegmentor()(img, pts))
    np.testing.assert_array_equal(fake.FakeInpainter()(img, mask, "p"),
                                  jfake.FakeInpainter()(img, mask, "p"))


def test_resolve_prompt_matches_jax():
    assert prompts.DEFAULT_PROMPT_LIBRARY == jprompts.DEFAULT_PROMPT_LIBRARY
    for p in ("lib:hamburger", "lib:panda_chef", "lib:DRAGON", "plain text"):
        assert prompts.resolve_prompt(p) == jprompts.resolve_prompt(p)
    for bad in ("lib:dslr", "lib:unicorn"):
        with pytest.raises(ValueError):
            prompts.resolve_prompt(bad)
    lib = {"dreamfusion": ["a red fox", "a blue whale"]}
    assert prompts.resolve_prompt("lib:fox", library=lib) == "a red fox"


# ---- the edit loop against JAX ----

class DiskSegmentor:
    """A centred disk whatever the image, so both packages trace the same
    2D masks."""

    def __call__(self, image, prompt):
        h, w = np.asarray(image).shape[:2]
        ys, xs = np.mgrid[0:h, 0:w]
        r = 0.3 * min(h, w)
        return (((xs - (w - 1) / 2) ** 2 + (ys - (h - 1) / 2) ** 2)
                < r ** 2).astype(np.float32)


def _cluster_scene(seed=0, n_obj=30, n_bg=50, capacity=112):
    """An object cluster at the origin in a background shell, with spare
    capacity for densification."""
    rng = np.random.RandomState(seed)
    obj = rng.uniform(-0.25, 0.25, (n_obj, 3))
    theta = rng.uniform(0, 2 * np.pi, n_bg)
    phi = rng.uniform(-0.6, 0.6, n_bg)
    bg = 1.5 * np.stack([np.cos(theta) * np.cos(phi), np.sin(phi),
                         np.sin(theta) * np.cos(phi)], axis=1)
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n_obj + n_bg] = np.concatenate([obj, bg])
    scene = random_scene(n_obj + n_bg, seed=seed, capacity=capacity)
    return scene.replace(params=scene.params.replace(xyz=jnp.asarray(xyz)))


def jax_densify_noise(seed, capacity):
    """The split draws the JAX system's key gives its densify steps, in
    order: `key, sub = split(key)`, then `normal` on split(sub)."""
    key = jax.random.key(seed)

    def noise(step):
        nonlocal key
        key, sub = jax.random.split(key)
        return tuple(torch.from_numpy(np.array(
            jax.random.normal(k, (capacity, 3))))
            for k in jax.random.split(sub))

    return noise


def _systems(js, n_views, hw, seg=None, **kw):
    jcams = jorbit_cameras(n_views, 4.0, 0.8, 0.8, hw, hw)
    jsys = jedit.EditSystem(js, jcams, jedit.EditConfig(**kw),
                            guidance=jfake.FakeGuidance(), segmentor=seg,
                            perceptual=jmsg_loss)
    tsys = edit_system.EditSystem(
        port_scene(js), [port_camera(c) for c in jcams],
        edit_system.EditConfig(**kw), guidance=fake.FakeGuidance(),
        segmentor=seg, perceptual=multiscale_gradient_loss)
    return jsys, tsys


def _spy(system):
    """Record each step's view ids and targets."""
    seen = []
    sample, step = system.sampler.sample, system.train_step

    def spy_sample(*a):
        ids = sample(*a)
        seen.append([list(ids)])
        return ids

    def spy_step(state, cams, targets, *a):
        seen[-1].append(np.array(np.asarray(targets)))
        return step(state, cams, targets, *a)

    system.sampler.sample = spy_sample
    system.train_step = spy_step
    return seen


def test_edit_fit_matches_jax(jax_pallas):
    js = _cluster_scene()
    kw = dict(prompt="lib:hamburger", seg_prompt="the object", batch_size=2,
              max_steps=6, per_editing_step=3, densification_interval=3,
              densify_until_step=6, edit_until_step=6, cameras_extent=2.0,
              densify_grad_threshold=1e-6, max_densify_percent=0.5,
              max_instances=8192, seed=3)
    jsys, tsys = _systems(js, 4, 32, seg=DiskSegmentor(), **kw)
    assert tsys.cfg.prompt == jsys.cfg.prompt == "a DSLR photo of a hamburger"
    jseen, tseen = _spy(jsys), _spy(tsys)
    jm, tm = [], []
    jsys.fit(callback=lambda s, m: jm.append((s, m)))
    tsys.fit(callback=lambda s, m: tm.append((s, m)),
             densify_noise=jax_densify_noise(3, js.capacity))
    # the traced mask
    jmask = np.asarray(jsys.state.scene.mask)
    assert 0 < jmask.sum() < np.asarray(js.alive).sum()
    np.testing.assert_array_equal(tsys.scene.mask.numpy(), jmask)
    # the same views and targets at each step
    assert [s for s, _ in tm] == [s for s, _ in jm] == list(range(6))
    for (jids, jt), (tids, tt) in zip(jseen, tseen):
        assert tids == jids
        assert_images_close(tt, jt, name="targets")
    for (_, j), (_, t) in zip(jm, tm):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    # one densify step, at step 3, with its info in that step's metrics
    for k in DENSIFY_KEYS:
        assert int(tm[3][1][k]) == int(jm[3][1][k]), k
        assert all(k not in m for s, m in tm if s != 3)
    assert int(tm[3][1]["n_cloned"]) + int(tm[3][1]["n_split"]) > 0
    ts, jsc = tsys.state.scene, jsys.state.scene
    for k in ("alive", "mask", "generation", "n_generations"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(jsc, k)), err_msg=k)
    assert tsys.state.step == int(jsys.state.step) == 6


def test_score_inject_matches_jax(jax_pallas):
    def sds(renders, origins, prompt, step):
        return 0.01 * (renders - origins) + 1e-4 * step, {}

    def dds(renders, origins, tgt, src, step):
        return 0.02 * renders * (len(tgt) - len(src)) / 10.0, {}

    js = random_scene(40, seed=6)
    loss = dict(lambda_sds=[0, 0.5, 1.5, 10], lambda_dds=2.0)
    kw = dict(prompt="p", batch_size=2, max_steps=2, cameras_extent=2.0,
              max_instances=8192)
    jcams = jorbit_cameras(3, 4.0, 0.8, 0.8, 32, 32)
    jsys = jedit.EditSystem(js, jcams, jedit.EditConfig(
        loss=jtrainer.LossWeights(**loss), **kw), guidance=None,
        perceptual=None, sds_guidance=sds, dds_guidance=dds,
        dds_prompts=("a target", "src"))
    tsys = edit_system.EditSystem(
        port_scene(js), [port_camera(c) for c in jcams],
        edit_system.EditConfig(loss=edit_system.LossWeights(**loss), **kw),
        guidance=None, perceptual=None, sds_guidance=sds, dds_guidance=dds,
        dds_prompts=("a target", "src"))
    jsys.on_fit_start()
    tsys.on_fit_start()
    for ids, step in (([0, 2], 0), ([1, 1], 7)):
        got = tsys._score_inject(ids, step)
        assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 3)
        assert_images_close(got, jsys._score_inject(ids, step),
                             name="inject")


def test_resolution_schedule_matches_jax():
    js = random_scene(30, seed=11)
    kw = dict(prompt="p", batch_size=1, max_steps=9, cameras_extent=2.0,
              resolution_milestones=[3, 6], heights=[32, 48, 64],
              widths=[32, 40, 64], batch_sizes=[1, 1, 2])
    jsys, tsys = _systems(js, 3, 32, **kw)
    for s in range(10):
        assert tsys._res_at(s) == jsys._res_at(s)
    for s in (0, 2, 3, 5, 6, 8):
        for sys_ in (tsys, jsys):
            sys_.origin_frames[0] = sys_.edit_frames[0] = "stale"
        assert tsys._apply_resolution(s) == jsys._apply_resolution(s)
        assert tsys._cur_hw == jsys._cur_hw
        assert ([(c.height, c.width) for c in tsys.cameras]
                == [(c.height, c.width) for c in jsys.cameras])
        assert (set(tsys.origin_frames) == set(jsys.origin_frames)
                and set(tsys.edit_frames) == set(jsys.edit_frames))


def test_fit_steps_through_resolutions():
    sizes_seen = []

    class ShapeSpyGuidance(fake.FakeGuidance):
        def __call__(self, render_img, origin, prompt):
            sizes_seen.append(np.asarray(origin).shape[:2])
            return super().__call__(render_img, origin, prompt)

    cfg = edit_system.EditConfig(
        prompt="p", batch_size=1, max_steps=7, per_editing_step=2,
        densification_interval=100, edit_until_step=7, cameras_extent=2.0,
        max_instances=8192, resolution_milestones=[3, 5],
        heights=[32, 48, 24], widths=[32, 48, 40], batch_sizes=[1, 1, 2])
    cams = [port_camera(c) for c in jorbit_cameras(3, 4.0, 0.8, 0.8, 32, 32)]
    sys_ = edit_system.EditSystem(port_scene(random_scene(50, seed=11)), cams,
                                  cfg, guidance=ShapeSpyGuidance(),
                                  perceptual=None)
    batches = []
    sys_.fit(callback=lambda s, m: batches.append(
        (s, sys_._cur_hw, float(m["loss"]))))
    assert [hw for _, hw, _ in batches] == [(32, 32)] * 3 + [(48, 48)] * 2 + [
        (24, 40)] * 2
    assert np.isfinite([v for *_, v in batches]).all()
    assert set(sizes_seen) == {(32, 32), (48, 48), (24, 40)}
    assert all(f.shape[:2] == (24, 40) for f in sys_.edit_frames.values())
    assert all(f.shape[:2] == (24, 40) for f in sys_.origin_frames.values())


# ---- the port's own behaviour ----

def _snapshot(scene):
    return {k: v.detach().clone() for k, v in
            list(scene.named_parameters()) + list(scene.named_buffers())}


def _port_system(scene, n_views=4, hw=32, seg=None, **kw):
    cfg = dict(prompt="p", batch_size=2, per_editing_step=3,
               densification_interval=3, densify_until_step=5,
               densify_grad_threshold=1e-6, max_densify_percent=0.5,
               cameras_extent=2.0, max_instances=8192)
    cfg.update(kw)
    cams = [port_camera(c)
            for c in jorbit_cameras(n_views, 4.0, 0.8, 0.8, hw, hw)]
    return edit_system.EditSystem(scene, cams, edit_system.EditConfig(**cfg),
                                  guidance=fake.FakeGuidance(), segmentor=seg,
                                  perceptual=multiscale_gradient_loss)


def test_fit_leaves_the_callers_scene_alone():
    scene = port_scene(_cluster_scene(seed=1))
    before = _snapshot(scene)
    sys_ = _port_system(scene, seg=DiskSegmentor(), seg_prompt="x",
                        max_steps=6)
    info = []
    sys_.fit(callback=lambda s, m: info.append(m.get("n_split")))
    assert any(v is not None for v in info)
    for k, v in _snapshot(scene).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(sys_.state.scene.mask, scene.mask)  # traced
    assert not torch.equal(sys_.state.scene.xyz, scene.xyz)    # trained
    assert sys_.scene is not sys_.state.scene
    assert torch.equal(sys_.scene.xyz, sys_.state.scene.xyz)


def test_mask_gates_updates():
    """With an all-False semantic mask only the rotation may move."""
    scene = port_scene(random_scene(40, seed=4))
    scene.set_mask(torch.zeros_like(scene.mask))
    sys_ = _port_system(scene, max_steps=4, densify_until_step=0)
    sys_.fit()
    for k in ("xyz", "features_dc", "features_rest", "opacity_raw",
              "log_scales"):
        assert torch.equal(getattr(sys_.state.scene, k), getattr(scene, k)), k
    assert not torch.equal(sys_.state.scene.quats, scene.quats)


def _train_state_fields(state):
    out = {"step": np.asarray(state.step), "count":
           np.asarray(state.opt_state.count)}
    s = state.scene
    for k in PARAMS:
        out["params." + k] = getattr(s, k).detach().numpy()
        out["anchor." + k] = getattr(s, "anchor_" + k).numpy()
        out["mu." + k] = state.opt_state.mu[k].numpy()
        out["nu." + k] = state.opt_state.nu[k].numpy()
    for k in ("alive", "mask", "generation", "anchor_weights",
              "n_generations", "active_sh_degree"):
        out[k] = getattr(s, k).numpy()
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[k] = getattr(state.stats, k).numpy()
    return out


def _jax_train_state_fields(state):
    out = {"step": np.asarray(state.step),
           "count": np.asarray(state.opt_state.count)}
    s = state.scene
    for k in PARAMS:
        out["params." + k] = np.asarray(getattr(s.params, k))
        out["anchor." + k] = np.asarray(getattr(s.anchor, k))
        out["mu." + k] = np.asarray(getattr(state.opt_state.mu, k))
        out["nu." + k] = np.asarray(getattr(state.opt_state.nu, k))
    for k in ("alive", "mask", "generation", "anchor_weights",
              "n_generations", "active_sh_degree"):
        out[k] = np.asarray(getattr(s, k))
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[k] = np.asarray(getattr(state.stats, k))
    return out


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.RandomState(2)
    js = random_scene(30, seed=2, capacity=40, max_sh_degree=1)
    js = js.set_mask(jnp.asarray(rng.rand(40) < 0.5) & js.alive)
    jopt = joptim.GaussianAdam(config=joptim.OptimConfig())
    state = jtrainer.init_train_state(js, jopt)
    g = joptim.GaussianParams(**{
        k: jnp.asarray(rng.randn(*getattr(js.params, k).shape)
                       .astype(np.float32)) for k in PARAMS})
    params, opt_state = jopt.step(js.params, g, state.opt_state)
    state = state.replace(
        scene=js.replace(params=params), opt_state=opt_state,
        stats=jinit_stats(40).replace(
            xyz_gradient_accum=jnp.asarray(rng.rand(40).astype(np.float32)),
            denom=jnp.asarray(rng.randint(0, 5, 40).astype(np.float32))),
        step=jnp.asarray(17, jnp.int32))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_train_state(jpath, state)
    loaded = checkpoint.load_train_state(jpath, device="cpu")
    assert loaded.scene.max_sh_degree == 1
    want = _jax_train_state_fields(state)
    got = _train_state_fields(loaded)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    checkpoint.save_train_state(tpath, loaded)
    jf, tf = np.load(jpath), np.load(tpath)
    assert sorted(jf.files) == sorted(tf.files)
    for k in jf.files:
        assert jf[k].dtype == tf[k].dtype and jf[k].shape == tf[k].shape, k
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    back = _jax_train_state_fields(jckpt.load_train_state(tpath))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _state_equal(a, b):
    fa, fb = _train_state_fields(a), _train_state_fields(b)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_resume_reproduces_the_uninterrupted_run_bitwise(tmp_path):
    scene = port_scene(_cluster_scene(seed=4))
    kw = dict(seg=DiskSegmentor(), seg_prompt="x", max_steps=10,
              edit_until_step=10, per_editing_step=4)
    ref = _port_system(scene, **kw)
    ref.fit()
    a = _port_system(scene, checkpoint_every=6, checkpoint_dir=str(tmp_path),
                     **kw)
    a.fit(n_steps=6)
    assert (tmp_path / "state_000006.npz").exists()
    b = _port_system(scene, **kw)
    b.resume(str(tmp_path / "state_000006.npz"))
    assert b.state.step == 6
    _state_equal(b.state, a.state)
    b.fit(n_steps=4)
    assert b.state.step == ref.state.step == 10
    _state_equal(b.state, ref.state)


def test_async_guidance_rides_one_worker_thread():
    main_thread = threading.get_ident()
    call_threads = []

    class SlowGuidance(fake.FakeGuidance):
        def __call__(self, render, origin, prompt):
            call_threads.append(threading.get_ident())
            time.sleep(0.05)
            return super().__call__(render, origin, prompt)

    cams = [port_camera(c) for c in jorbit_cameras(3, 4.0, 0.8, 0.8, 32, 32)]
    cfg = edit_system.EditConfig(
        prompt="p", batch_size=1, max_steps=12, per_editing_step=3,
        densification_interval=100, edit_until_step=12, cameras_extent=2.0,
        max_instances=8192, async_guidance=True)
    sys_ = edit_system.EditSystem(port_scene(random_scene(50, seed=13)), cams,
                                  cfg, guidance=SlowGuidance(),
                                  perceptual=None)
    losses = []
    sys_.fit(callback=lambda s, m: losses.append(float(m["loss"])))
    assert np.isfinite(losses).all() and len(losses) == 12
    assert call_threads and main_thread not in call_threads
    assert len(set(call_threads)) == 1
    assert len(sys_._pending_targets) < len(call_threads)


def test_dispatch_burst_warns_and_calls_back_every_step():
    scene = port_scene(random_scene(40, seed=8))
    with pytest.warns(UserWarning, match="dispatch_burst=5"):
        sys_ = _port_system(scene, max_steps=7, dispatch_burst=5)
    steps = []
    sys_.fit(callback=lambda s, m: steps.append(s))
    assert steps == list(range(7)) and sys_.state.step == 7
