"""Port vs JAX: the Delete system.

`near_gaussians_by_mask` exactly equal (`tests/test_edit.py`'s hand case
and random ones), and a `DelSystem` on `tests/test_edit.py`'s
two-cluster scene with a disk segmentor: after `on_fit_start` the alive
slots, the shell mask, the anchor and the per-view hole masks equal to
the JAX system's, the inpainted targets at the JAX suite's image bounds,
then 6 steps whose losses agree at rtol 1e-3 (as
`tests/test_torch_port_edit.py`; the inpainter tints the frame, see
`TintingInpainter`); the caller's scene is left bitwise as it was, and
a resolution milestone fails as the JAX system's does. The JAX system
renders its origin frames through its production route
(`ops.render.default_impl` patched to 'pallas'); both systems render the
hole masks through 'tiled'.
"""

import importlib

import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit import del_system as jdel
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu.train.perceptual import (
    multiscale_gradient_loss as jmsg_loss,
)
from gaussianeditor_tpu_torch.edit import del_system
from gaussianeditor_tpu_torch.guidance import fake
from gaussianeditor_tpu_torch.train.perceptual import multiscale_gradient_loss
from gaussianeditor_tpu_torch.testing import assert_images_close
from tests.test_edit import _two_cluster_scene
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_KEYS = ("loss", "loss_l1", "loss_p", "loss_anchor_color",
             "loss_anchor_geo", "loss_anchor_scale", "loss_anchor_opacity")
jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")


@pytest.mark.parametrize("name", ["del", "add"])
def test_configs_match_jax(name):
    """configs/del.yaml and configs/add.yaml parse into equal configs."""
    import dataclasses

    from gaussianeditor_tpu.config import config as jconfig
    from gaussianeditor_tpu.edit import add_system as jadd
    from gaussianeditor_tpu_torch.config import config
    from gaussianeditor_tpu_torch.edit import add_system

    tcls, jcls = {"del": (del_system.DelConfig, jdel.DelConfig),
                  "add": (add_system.AddConfig, jadd.AddConfig)}[name]
    raw = config.load_config(f"configs/{name}.yaml")["system"]
    assert raw == jconfig.load_config(f"configs/{name}.yaml")["system"]
    got = config.parse_structured(tcls, raw)
    want = jconfig.parse_structured(jcls, raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_near_gaussians_hand_case_matches_jax():
    xyz = np.zeros((10, 3), np.float32)
    xyz[:5] = np.array([[-0.1, -0.1, -0.1], [0.1, 0.1, 0.1],
                        [0.1, -0.1, 0.0], [-0.1, 0.1, 0.0],
                        [0.0, 0.0, 0.1]], np.float32)
    xyz[5] = [0.11, 0, 0]
    xyz[6] = [0.0, 0.115, 0]
    xyz[7] = [2.0, 0, 0]
    xyz[8] = [0, 0, 0.12]
    xyz[9] = [5.0, 5.0, 5.0]
    mask = np.zeros(10, bool)
    mask[:5] = True
    alive = np.ones(10, bool)
    got = del_system.near_gaussians_by_mask(xyz, mask, alive, 0.15)
    np.testing.assert_array_equal(
        got, jdel.near_gaussians_by_mask(xyz, mask, alive, 0.15))
    assert got[[5, 6, 8]].all() and not got[[0, 1, 2, 3, 4, 7, 9]].any()
    # nothing masked, or nothing left: an empty shell
    assert not del_system.near_gaussians_by_mask(xyz, ~alive, alive, 1).any()
    assert not del_system.near_gaussians_by_mask(xyz, alive, alive, 1).any()


@pytest.mark.parametrize("thresh", [0.03, 0.1, 0.3])
def test_near_gaussians_random_matches_jax(thresh):
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    mask = np.linalg.norm(xyz - 0.2, axis=1) < 0.3
    alive = rng.rand(20000) < 0.9
    got = del_system.near_gaussians_by_mask(xyz, mask, alive, thresh)
    want = jdel.near_gaussians_by_mask(xyz, mask, alive, thresh)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    assert not (got & mask).any() and not (got & ~alive).any()


class DiskSegmentor:
    def __init__(self, hw, r=10):
        ys, xs = np.mgrid[0:hw, 0:hw]
        c = (hw - 1) / 2
        self.disk = (((xs - c) ** 2 + (ys - c) ** 2) < r ** 2).astype(
            np.float32)

    def __call__(self, image, prompt):
        return self.disk


class TintingInpainter:
    """`FakeInpainter`, then a fixed tint of the whole frame. With
    `FakeInpainter` alone the targets equal the pruned renders outside
    the holes, so the L1 residual there is each package's own rounding
    noise (the train step's render against the cached one), and Adam's
    first step turns that noise's sign into a full learning-rate step:
    the trajectories then part on the noise, not on the port. The tint
    makes every residual a real one."""

    def __init__(self, inpainter):
        self.inpainter = inpainter

    def __call__(self, image, mask, prompt):
        out = self.inpainter(image, mask, prompt)
        return np.clip(out * np.float32(0.9) + np.float32(0.05), 0, 1)


DEL_KW = dict(seg_prompt="object", batch_size=2, max_steps=6,
              densify_until_step=0, cameras_extent=2.0, inpaint_scale=30.0,
              max_instances=8192, tile_cap=512, chunk=64, mask_dilate=2,
              seed=1)


def _systems(js, hw=48, tint=False, **kw):
    kw = {**DEL_KW, **kw}
    jcams = jorbit_cameras(4, 4.0, 0.8, 0.8, hw, hw)
    jinp, tinp = jfake.FakeInpainter(), fake.FakeInpainter()
    if tint:
        jinp, tinp = TintingInpainter(jinp), TintingInpainter(tinp)
    jsys = jdel.DelSystem(js, jcams, jdel.DelConfig(**kw), inpainter=jinp,
                          segmentor=DiskSegmentor(hw), perceptual=jmsg_loss)
    ts = port_scene(js)
    tsys = del_system.DelSystem(ts, [port_camera(c) for c in jcams],
                                del_system.DelConfig(**kw), inpainter=tinp,
                                segmentor=DiskSegmentor(hw),
                                perceptual=multiscale_gradient_loss)
    return jsys, tsys, ts


def _snapshot(scene):
    return {k: v.detach().clone() for k, v in
            list(scene.named_parameters()) + list(scene.named_buffers())}


def test_del_system_matches_jax(jax_pallas):
    js = _two_cluster_scene(seed=5)
    jsys, tsys, ts = _systems(js, tint=True)
    before = _snapshot(ts)
    jsys.on_fit_start()
    tsys.on_fit_start()
    sj, st = jsys.scene, tsys.scene
    jalive = np.asarray(sj.alive)
    assert jalive[:30].mean() < 0.4 and jalive[30:].mean() > 0.8
    np.testing.assert_array_equal(st.alive.numpy(), jalive)
    jmask = np.asarray(sj.mask)
    assert 0 < jmask.sum() and not (jmask & ~jalive).any()
    np.testing.assert_array_equal(st.mask.numpy(), jmask)
    for k in PARAMS:   # the anchor is refreshed from the pruned scene
        np.testing.assert_array_equal(
            getattr(st, "anchor_" + k).numpy(),
            np.asarray(getattr(sj.anchor, k)), err_msg=k)
    tm, jm = tsys.render_view_masks(), jsys.render_view_masks()
    assert sorted(tm) == sorted(jm) == [0, 1, 2, 3]
    for i in tm:
        np.testing.assert_array_equal(tm[i], jm[i], err_msg=f"view {i}")
    assert 0 < sum(m.sum() for m in tm.values())
    for i in range(4):
        assert_images_close(tsys.edit_frames[i], jsys.edit_frames[i],
                            name=f"inpainted target {i}")
        assert_images_close(tsys.origin_frames[i], jsys.origin_frames[i],
                            name=f"pruned render {i}")

    jl, tl = [], []
    jsys.fit(n_steps=6, callback=lambda s, m: jl.append(m))
    tsys.fit(n_steps=6, callback=lambda s, m: tl.append(m))
    assert len(tl) == len(jl) == 6
    for j, t in zip(jl, tl):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    # the targets stayed the inpainted frames
    for i in range(4):
        assert_images_close(tsys.edit_frames[i], jsys.edit_frames[i])
    # only the shell trained; the caller's scene is untouched
    out = tsys.scene
    moved = (out.xyz != st.anchor_xyz).any(dim=1)
    assert moved.any() and not (moved & ~out.mask).any()
    for k, v in _snapshot(ts).items():
        assert torch.equal(v, before[k]), k


def test_del_milestone_fails_as_in_jax():
    """A size change clears the cached frames and Del's targets are never
    made again, so the next step's target lookup fails, as in the JAX
    system (`edit_system.py:_apply_resolution` and `fit`'s
    `self.edit_frames[v]`)."""
    kw = dict(max_steps=2, resolution_milestones=[1], heights=[48, 32],
              widths=[48, 32])
    _, tsys, _ = _systems(_two_cluster_scene(seed=5), **kw)
    steps = []
    with pytest.raises(KeyError):
        tsys.fit(n_steps=2, callback=lambda s, m: steps.append(s))
    assert steps == [0] and tsys._cur_hw == (32, 32) and not tsys.edit_frames


def test_del_requires_a_seg_prompt():
    _, tsys, _ = _systems(_two_cluster_scene(seed=5), seg_prompt="")
    with pytest.raises(ValueError, match="seg_prompt"):
        tsys.on_fit_start()
