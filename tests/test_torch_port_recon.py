"""Port vs JAX: vanilla reconstruction (`train/recon.py`) and SSIM.

`ReconTrainer` against the JAX `ReconTrainer(dispatch_burst=1)` on the
same numpy scene, cameras and images, the JAX trainer rendering through
its production route (`ops.render.default_impl` patched to 'pallas', its
Pallas kernels in interpret mode, as `tests/test_torch_port_edit.py`
runs its reference) and the JAX key's split draws injected into the
port's densify steps. A schedule that crosses SH one-ups, densify steps
and an opacity reset: the view order equal, the losses at rtol 1e-3 (the
trajectory tolerance of `tests/test_torch_port_train.py`), integers
exactly, parameters after each event at the bounds stated below. Then
the JAX suite's PSNR test mirrored, `dispatch_burst`, the caller's scene
left alone, and SSIM at a size that is not a multiple of 16."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.ops.render import render as jrender
from gaussianeditor_tpu.train import losses as jlosses
from gaussianeditor_tpu.train import recon as jrecon
from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.train import losses, recon
from tests.helpers import random_scene
from tests.test_torch_port_edit import jax_densify_noise
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")


def _targets(jcams, seed):
    """Each camera's render of another random scene, through JAX."""
    other = random_scene(60, seed=seed, max_sh_degree=1)
    return [np.asarray(jrender(other, c, jnp.zeros(3), impl="tiled",
                               max_instances=8192).color) for c in jcams]


def _spy_views(trainer):
    seen = []
    nxt = trainer._next_view

    def spy():
        v = nxt()
        seen.append(v)
        return v

    trainer._next_view = spy
    return seen


# steps 0-12: SH one up at 4 and 8, densify after 5 and 10, opacity reset
# after 7
SCHEDULE = dict(max_steps=13, oneup_sh_every=4, densify_from_step=5,
                densification_interval=5, densify_grad_threshold=1e-6,
                opacity_reset_interval=7, cameras_extent=2.0,
                max_instances=8192, seed=3)
SEGMENTS = (5, 1, 2, 5)      # fit boundaries after steps 4, 5, 7 and 12


def test_recon_trainer_matches_jax(jax_pallas):
    js = random_scene(60, seed=5, max_sh_degree=2, capacity=160)
    js = js.replace(active_sh_degree=jnp.int32(0))
    jcams = jorbit_cameras(4, 4.0, 0.8, 0.8, 48, 48)
    images = _targets(jcams, seed=6)
    jt = jrecon.ReconTrainer(js, jcams, images,
                             jrecon.ReconConfig(**SCHEDULE))
    tscene = port_scene(js)
    tt = recon.ReconTrainer(tscene, [port_camera(c) for c in jcams], images,
                            recon.ReconConfig(**SCHEDULE))
    jviews, tviews = _spy_views(jt), _spy_views(tt)
    jm, tm = [], []
    noise = jax_densify_noise(SCHEDULE["seed"], js.capacity)
    for n in SEGMENTS:
        jt.fit(n_steps=n, callback=lambda s, m: jm.append((s, m)))
        tt.fit(n_steps=n, callback=lambda s, m: tm.append((s, m)),
               densify_noise=noise)
        jsc, tsc = jt.state.scene, tt.state.scene
        assert tt.state.step == int(jt.state.step)
        for k in ("alive", "mask", "generation", "n_generations",
                  "active_sh_degree"):
            np.testing.assert_array_equal(getattr(tsc, k).numpy(),
                                          np.asarray(getattr(jsc, k)),
                                          err_msg=k)
        # Adam moves every entry by about its group's learning rate a
        # step, so the packages' rounding shows in units of it: each
        # group is held within a tenth of one step (the largest seen is
        # under a hundredth)
        alive = tsc.alive.numpy()
        lrs = tt.optim.group_lrs(0)
        for k in PARAMS:
            a = getattr(tsc, k).detach().numpy()[alive]
            b = np.asarray(getattr(jsc.params, k))[alive]
            err = np.abs(a - b).max()
            assert err <= 0.1 * lrs[k], (k, tt.state.step, err)
    assert tviews == jviews and len(tviews) == 13
    assert [s for s, _ in tm] == [s for s, _ in jm] == list(range(13))
    for (_, j), (_, t) in zip(jm, tm):
        for k in ("loss", "l1"):
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    # the densify steps: every alive Gaussian asks, the first fills 60 of
    # the 100 free slots, the second asks for more than are left
    grants = [int(tm[s][1]["n_cloned"]) + int(tm[s][1]["n_split"])
              for s in (5, 10)]
    assert grants == [60, 40], grants
    assert int(tm[10][1]["n_dropped"]) > 0
    assert int(tt.state.scene.active_sh_degree) == 2
    # the opacity reset after step 7 zeroed the opacity moments, which
    # steps 8-12 then refilled from the new raw opacity
    assert tt.state.opt_state.nu["opacity_raw"].abs().max() > 0
    # the caller's scene is left as it was
    for k, v in port_scene(js).state_dict().items():
        assert torch.equal(tscene.state_dict()[k], v), k


def test_opacity_reset_zeroes_exactly_the_opacity_moments():
    js = random_scene(40, seed=2, max_sh_degree=1, capacity=48)
    cams = [port_camera(c) for c in jorbit_cameras(3, 4.0, 0.8, 0.8, 32, 32)]
    images = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    cfg = recon.ReconConfig(max_steps=3, opacity_reset_interval=2,
                            densify_from_step=100, oneup_sh_every=0,
                            cameras_extent=2.0, max_instances=8192)
    tt = recon.ReconTrainer(port_scene(js), cams, images, cfg)
    tt.fit(n_steps=2)
    before = {k: (tt.state.opt_state.mu[k].clone(),
                  tt.state.opt_state.nu[k].clone()) for k in PARAMS}
    tt.fit(n_steps=1)        # step 2, then the reset after it
    op = torch.sigmoid(tt.scene.opacity_raw)[tt.scene.alive]
    assert op.max() <= 0.01 + 1e-6
    for k in PARAMS:
        mu, nu = tt.state.opt_state.mu[k], tt.state.opt_state.nu[k]
        if k == "opacity_raw":
            assert not mu.any() and not nu.any()
        else:
            assert not torch.equal(nu, before[k][1]) or not nu.any(), k
            assert nu[tt.scene.alive].abs().max() > 0, k
    # the next step uses the new raw opacity: its moments refill
    raw = tt.scene.opacity_raw.detach().clone()
    tt.fit(n_steps=1)
    assert tt.state.opt_state.nu["opacity_raw"].abs().max() > 0
    assert not torch.equal(tt.scene.opacity_raw.detach(), raw)


def test_photometric_fit_improves_psnr():
    """`tests/test_recon.py::test_photometric_fit_improves_psnr` on the
    port: +5 dB in 60 steps from wrong colours and opacities."""
    target = port_scene(random_scene(60, seed=0))
    cams = orbit_cameras(10, 4.0, 0.8, 0.8, 48, 48, device="cpu")

    def rfn(s, c):
        with torch.no_grad():
            return render(s, c, torch.zeros(3), impl="tiled",
                          max_instances=4096).color

    images = [rfn(target, c).numpy() for c in cams]
    init = port_scene(random_scene(60, seed=0))
    with torch.no_grad():
        init.features_dc.zero_()
        init.opacity_raw.zero_()
    cfg = recon.ReconConfig(
        max_steps=60, densify_from_step=10_000, opacity_reset_interval=0,
        oneup_sh_every=0, cameras_extent=2.0, max_instances=4096,
        tile_cap=256, chunk=32, impl="tiled")
    trainer = recon.ReconTrainer(init, cams, images, cfg)
    target0 = torch.from_numpy(images[0])
    before = float(losses.psnr(rfn(init, cams[0]), target0))
    trainer.fit()
    after = float(losses.psnr(rfn(trainer.scene, cams[0]), target0))
    assert after > before + 5.0, f"PSNR {before:.2f} -> {after:.2f}"


def test_dispatch_burst_warns_and_trains_the_per_step_model():
    js = random_scene(40, seed=3, max_sh_degree=1, capacity=128)
    jcams = jorbit_cameras(5, 4.0, 0.8, 0.8, 32, 32)
    images = _targets(jcams, seed=4)

    def run(burst):
        cfg = recon.ReconConfig(
            max_steps=12, densify_from_step=5, densification_interval=5,
            densify_grad_threshold=1e-8, opacity_reset_interval=10,
            oneup_sh_every=4, cameras_extent=2.0, max_instances=8192,
            dispatch_burst=burst)
        tt = recon.ReconTrainer(port_scene(js),
                                [port_camera(c) for c in jcams], images, cfg)
        seen = []
        tt.fit(callback=lambda s, m: seen.append((s, float(m["loss"]))))
        return tt, seen

    a, seen_a = run(1)
    with pytest.warns(UserWarning, match="dispatch_burst=4"):
        b, seen_b = run(4)
    assert seen_a == seen_b and [s for s, _ in seen_a] == list(range(12))
    for k in PARAMS:
        assert torch.equal(getattr(a.scene, k), getattr(b.scene, k)), k
    assert torch.equal(a.scene.alive, b.scene.alive)


@pytest.mark.parametrize("hw", [(37, 53), (21, 16)], ids=["37x53", "21x16"])
def test_ssim_and_its_gradient_match_jax(hw):
    import jax

    rng = np.random.RandomState(sum(hw))
    a = rng.rand(*hw, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*hw, 3), 0, 1).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    got = losses.ssim(ta, torch.from_numpy(b))
    (g,) = torch.autograd.grad(got, ta)
    want, jg = jax.value_and_grad(jlosses.ssim)(jnp.asarray(a),
                                                jnp.asarray(b))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-9)
