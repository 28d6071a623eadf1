"""Port vs JAX: the train layer.

Losses, the perceptual proxy, anchors, `GaussianAdam`, densify (with the
split noise that `jax.random.normal` drew injected into the port) and
the train step, each fed the same numpy inputs as the JAX function it
replaces. Integers and masks must agree exactly, floats to rtol 1e-6;
the train step's gradients at the gradient tolerance of
`tests/test_pallas.py:87`, its loss terms to rtol 1e-4 after one step
and 1e-3 over three."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.train import anchors as janchors
from gaussianeditor_tpu.train import losses as jlosses
from gaussianeditor_tpu.train import optim as joptim
from gaussianeditor_tpu.train import trainer as jtrainer
from gaussianeditor_tpu.train.densify import DensifyConfig as JDensifyConfig
from gaussianeditor_tpu.train.densify import init_densify_stats as jinit_stats
from gaussianeditor_tpu.train.perceptual import (
    multiscale_gradient_loss as jmsg_loss,
)
from gaussianeditor_tpu_torch.train import anchors, losses, optim, trainer
from gaussianeditor_tpu_torch.train.densify import DensifyConfig
from gaussianeditor_tpu_torch.train.perceptual import multiscale_gradient_loss
from tests.helpers import random_scene
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_adam_state,
    port_camera,
    port_scene,
    port_stats,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLOAT = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(atol=1e-3, rtol=1e-2)   # tests/test_pallas.py:87


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _assert_scene_equal(ts, js, **tol):
    for k in PARAMS:
        np.testing.assert_allclose(getattr(ts, k).detach().numpy(),
                                   np.asarray(getattr(js.params, k)),
                                   err_msg=k, **tol)
        np.testing.assert_allclose(getattr(ts, "anchor_" + k).numpy(),
                                   np.asarray(getattr(js.anchor, k)),
                                   err_msg="anchor " + k, **tol)
    for k in ("alive", "mask", "generation", "n_generations",
              "active_sh_degree"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.anchor_weights.numpy(),
                               np.asarray(js.anchor_weights), **tol)


# ---- losses and the perceptual proxy ----

def _image_pair(seed, hw=(24, 20)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*hw, 3).astype(np.float32)
    b = rng.rand(*hw, 3).astype(np.float32)
    b[:6] = a[:6]       # ties (pred == target), as on background pixels
    return a, b


@pytest.mark.parametrize("name", ["l1", "msg"])
def test_loss_value_and_gradient_match_jax(name):
    jf = {"l1": jlosses.l1_loss, "msg": jmsg_loss}[name]
    tf = {"l1": losses.l1_loss, "msg": multiscale_gradient_loss}[name]
    a, b = _image_pair(1)
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tv = tf(ta, torch.from_numpy(b))
    (tg,) = torch.autograd.grad(tv, [ta])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    # the ties take JAX's gradient (abs'(0) = +1), not torch's 0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)


def test_psnr_and_ssim_match_jax():
    a, b = _image_pair(2, hw=(32, 28))
    np.testing.assert_allclose(float(losses.psnr(_t(a), _t(b))),
                               float(jlosses.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.ssim(_t(a), _t(b))),
                               float(jlosses.ssim(a, b)), rtol=1e-5)
    assert abs(float(losses.ssim(_t(a), _t(a))) - 1.0) < 1e-5


# ---- Adam ----

def test_expon_lr_matches_jax():
    for step in (0, 1, 7, 250, 999, 1000, 1200):
        want = float(joptim.expon_lr(step, 4.8e-4, 3.2e-6,
                                     lr_delay_mult=0.01, max_steps=1000))
        got = optim.expon_lr(step, 4.8e-4, 3.2e-6, lr_delay_mult=0.01,
                             max_steps=1000)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert optim.expon_lr(-3, 1e-2, 1e-4) == 0.0
    np.testing.assert_allclose(
        optim.expon_lr(0, 1e-2, 1e-4, lr_delay_steps=10, lr_delay_mult=0.1,
                       max_steps=100), 1e-3, rtol=1e-6)


def test_gaussian_adam_matches_jax():
    rng = np.random.RandomState(0)
    js = random_scene(24, seed=1, max_sh_degree=1, capacity=32)
    cfg = dict(spatial_lr_scale=2.5, position_lr_max_steps=40)
    jopt = joptim.GaussianAdam(config=joptim.OptimConfig(**cfg))
    topt = optim.GaussianAdam(config=optim.OptimConfig(**cfg))
    jparams, jstate = js.params, jopt.init(js.params)
    ts = port_scene(js)
    tstate = topt.init(ts.params())
    mask = np.arange(32) % 3 != 0
    for step in range(4):
        g = {k: rng.randn(*getattr(jparams, k).shape).astype(np.float32)
             for k in PARAMS}
        jparams, jstate = jopt.step(
            jparams, joptim.GaussianParams(**{k: jnp.asarray(v)
                                              for k, v in g.items()}),
            jstate, grad_mask=jnp.asarray(mask), step_override=step + 5)
        topt.step(ts.params(), {k: _t(v) for k, v in g.items()}, tstate,
                  grad_mask=_t(mask), step_override=step + 5)
    assert tstate.count == int(jstate.count) == 4
    for k in PARAMS:
        np.testing.assert_allclose(getattr(ts, k).detach().numpy(),
                                   np.asarray(getattr(jparams, k)),
                                   err_msg=k, **FLOAT)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(tstate, m)[k].numpy(),
                np.asarray(getattr(getattr(jstate, m), k)), err_msg=m + k,
                rtol=1e-6, atol=1e-12)
    # rotation ignores the mask; the other groups do not move outside it
    assert (ts.quats.detach().numpy()[~mask]
            != np.asarray(js.params.quats)[~mask]).any()
    np.testing.assert_array_equal(ts.xyz.detach().numpy()[~mask],
                                  np.asarray(js.params.xyz)[~mask])

    reset = (np.arange(32) % 5 == 0)
    jstate = jopt.reset_slots(jstate, jnp.asarray(reset))
    topt.reset_slots(tstate, _t(reset))
    jstate = jopt.replace_param(jstate, "opacity_raw")
    topt.replace_param(tstate, "opacity_raw")
    for k in PARAMS:
        np.testing.assert_array_equal(tstate.mu[k].numpy(),
                                      np.asarray(getattr(jstate.mu, k)))


# ---- anchors ----

def _anchored_scene(seed=3, n=40, cap=48):
    """A scene whose parameters moved off the anchor, in two generations."""
    js = random_scene(n, seed=seed, max_sh_degree=1, capacity=cap)
    rng = np.random.RandomState(seed)
    moved = {k: np.asarray(getattr(js.params, k))
             + 0.05 * rng.randn(*getattr(js.params, k).shape).astype(
                 np.float32) for k in PARAMS}
    gen = (np.arange(cap) % 2).astype(np.int32)
    weights = np.asarray(js.anchor_weights).copy()
    weights[1] = 0.3
    mask = np.asarray(js.alive) & (np.arange(cap) % 7 != 0)
    return js.replace(
        params=js.params.replace(**{k: jnp.asarray(v)
                                    for k, v in moved.items()}),
        generation=jnp.asarray(gen), anchor_weights=jnp.asarray(weights),
        n_generations=jnp.asarray(2, jnp.int32), mask=jnp.asarray(mask))


def test_anchor_loss_and_schedule_match_jax():
    js = _anchored_scene()
    ts = port_scene(js)
    want = janchors.anchor_loss(js)
    got = anchors.anchor_loss(ts)
    assert set(got) == set(want)
    for k in want:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    for _ in range(3):
        js = janchors.update_anchor_loss_schedule(js, 0.1, 1.3)
        anchors.update_anchor_loss_schedule(ts, 0.1, 1.3)
        np.testing.assert_allclose(ts.anchor_weights.numpy(),
                                   np.asarray(js.anchor_weights), **FLOAT)
        assert int(ts.n_generations) == int(js.n_generations)
    js, ts = js.update_anchor(), ts.update_anchor()
    assert all(float(v) == 0.0 for v in anchors.anchor_loss(ts).values())


# ---- densify ----

DENSIFY_CASES = {
    # gradients above the threshold on small (clone) and large (split)
    # Gaussians, a low-opacity masked slot to prune, spare capacity
    "clone_split_prune": dict(n=40, cap=64, pct=1.0, grad_hot=12),
    # the top-percent quantile gate
    "quantile": dict(n=40, cap=80, pct=0.1, grad_hot=40),
    # more requests than free slots: the excess is dropped
    "exhausted": dict(n=40, cap=44, pct=1.0, grad_hot=12),
}


@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_densify_step_matches_jax(case):
    c = DENSIFY_CASES[case]
    C = c["cap"]
    rng = np.random.RandomState(4)
    js = _anchored_scene(seed=4, n=c["n"], cap=C)
    ls = np.asarray(js.params.log_scales).copy()
    ls[: c["n"] // 2] = np.log(0.004)           # small: clone
    ls[c["n"] // 2: c["n"]] = np.log(0.03)      # large: split
    raw = np.asarray(js.params.opacity_raw).copy()
    raw[5, 0] = -8.0                            # prune (masked, alive)
    js = js.replace(params=js.params.replace(log_scales=jnp.asarray(ls),
                                             opacity_raw=jnp.asarray(raw)))
    accum = np.zeros(C, np.float32)
    hot = rng.choice(c["n"], c["grad_hot"], replace=False)
    accum[hot] = rng.uniform(0.5, 2.0, len(hot)).astype(np.float32)
    denom = np.where(accum > 0, 2.0, 0.0).astype(np.float32)
    radii = rng.randint(0, 9, C).astype(np.float32)

    jopt = joptim.GaussianAdam(config=joptim.OptimConfig())
    jstate = jtrainer.init_train_state(js, jopt)
    g = joptim.GaussianParams(**{
        k: jnp.asarray(rng.randn(*getattr(js.params, k).shape)
                       .astype(np.float32)) for k in PARAMS})
    _, opt_state = jopt.step(js.params, g, jstate.opt_state)
    jstate = jstate.replace(
        opt_state=opt_state,
        stats=jinit_stats(C).replace(xyz_gradient_accum=jnp.asarray(accum),
                                     denom=jnp.asarray(denom),
                                     max_radii2d=jnp.asarray(radii)))
    cfg = dict(max_grad=0.5, max_densify_percent=c["pct"], min_opacity=0.005,
               max_screen_size=5.0, percent_dense=0.01)
    key = jax.random.key(7)
    ka, kb = jax.random.split(key)
    noise = tuple(_t(jax.random.normal(k, (C, 3))) for k in (ka, kb))

    tstate = trainer.TrainState(scene=port_scene(js),
                                opt_state=port_adam_state(jstate.opt_state),
                                stats=port_stats(jstate.stats), step=0)
    jnew, jinfo = jtrainer.make_densify_step(
        jopt, JDensifyConfig(**cfg), 1.0, 0.1, 1.3)(jstate, key)
    tnew, tinfo = trainer.make_densify_step(
        optim.GaussianAdam(), DensifyConfig(**cfg), 1.0, 0.1, 1.3)(
        tstate, noise=noise)
    for k in jinfo:
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(tinfo["n_cloned"]) + int(tinfo["n_split"]) > 0
    if case == "exhausted":
        assert int(tinfo["n_dropped"]) > 0
    _assert_scene_equal(tnew.scene, jnew.scene, **FLOAT)
    for k in PARAMS:
        np.testing.assert_array_equal(tnew.opt_state.mu[k].numpy() == 0,
                                      np.asarray(getattr(jnew.opt_state.mu,
                                                         k)) == 0)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert not getattr(tnew.stats, f).any()


# ---- the train step ----

HW = 32
B = 2
WEIGHTS = dict(lambda_l1=10.0, lambda_p=10.0, lambda_anchor_color=5.0,
               lambda_anchor_geo=50.0, lambda_anchor_scale=50.0,
               lambda_anchor_opacity=50.0)
# configs/edit.yaml's learning-rate scalers (gs_lr_scaler 3,
# gs_final_lr_scaler 2, color 3, opacity 2, scaling 2, rotation 2)
LRS = dict(position_lr_init=0.00016 * 3, position_lr_final=0.0000016 * 2,
           position_lr_max_steps=2000, feature_lr=0.0125 * 3,
           opacity_lr=0.05 * 2, scaling_lr=0.005 * 2, rotation_lr=0.001 * 2)
LOSS_KEYS = ("loss", "loss_l1", "loss_p", "loss_inject", "loss_anchor_color",
             "loss_anchor_geo", "loss_anchor_opacity", "loss_anchor_scale")


@functools.lru_cache(maxsize=None)
def _jax_step(local_edit, with_inject, impl):
    jopt = joptim.GaussianAdam(config=joptim.OptimConfig(**LRS))
    return jopt, jtrainer.make_train_step(
        jopt, jtrainer.LossWeights(**WEIGHTS), perceptual=jmsg_loss,
        impl=impl, local_edit=local_edit, with_inject=with_inject,
        max_instances=8192)


def _train_inputs(seed):
    js = _anchored_scene(seed=seed, n=60, cap=80)
    cams = jorbit_cameras(B, 4.0, 0.8, 0.8, HW, HW)
    rng = np.random.RandomState(seed)
    targets = rng.rand(B, HW, HW, 3).astype(np.float32)
    inject = (1e-3 * rng.randn(B, HW, HW, 3)).astype(np.float32)
    return js, cams, targets, inject


def run_both(local_edit, with_inject, steps, seed=11, impl="pallas"):
    """`steps` train steps of the JAX package and of the port, both on the
    render route `impl`, from the same scene, cameras and targets."""
    js, cams, targets, inject = _train_inputs(seed)
    jopt, jstep = _jax_step(local_edit, with_inject, impl)
    jstate = jtrainer.init_train_state(js, jopt)
    cam_batch = jtrainer.stack_cameras(cams)
    topt = optim.GaussianAdam(config=optim.OptimConfig(**LRS))
    tstep = trainer.make_train_step(
        topt, trainer.LossWeights(**WEIGHTS),
        perceptual=multiscale_gradient_loss, local_edit=local_edit,
        with_inject=with_inject, impl=impl, max_instances=8192)
    tstate = trainer.init_train_state(port_scene(js), topt)
    tcams = [port_camera(c) for c in cams]
    kw_j = dict(inject_grad=jnp.asarray(inject)) if with_inject else {}
    kw_t = dict(inject_grad=_t(inject)) if with_inject else {}
    history, grads = [], {}
    for _ in range(steps):
        jstate, jm = jstep(jstate, cam_batch, jnp.asarray(targets), **kw_j)
        tstate, tm = tstep(tstate, tcams, _t(targets), grads=grads, **kw_t)
        history.append((jm, tm))
    return jstate, tstate, history, grads


def check_one_step(jstate, tstate, history, grads):
    """One train step of the port against the JAX package's: the loss
    terms to rtol 1e-4, the gradients at GRAD_TOL, Adam's first moment,
    the parameters that moved for sure, and the densify statistics."""
    jm, tm = history[0]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert bool(tm["overflow"]) == bool(jm["overflow"]) is False
    assert tstate.step == int(jstate.step) == 1
    # after one step mu = (1 - beta1) * masked gradient
    mask = tstate.scene.mask.numpy()
    for k in PARAMS:
        jmu = np.asarray(getattr(jstate.opt_state.mu, k))
        g = grads[k].numpy()
        if k != "quats":
            g = g * mask.reshape((-1,) + (1,) * (g.ndim - 1))
        np.testing.assert_allclose(g, jmu / np.float32(0.1), **GRAD_TOL,
                                   err_msg=f"grad {k}")
        np.testing.assert_allclose(tstate.opt_state.mu[k].numpy(), jmu,
                                   atol=1e-4, rtol=1e-2, err_msg=f"mu {k}")
        # new parameters: one Adam step moves each entry by about its
        # group's learning rate, in the gradient's sign
        p_t = getattr(tstate.scene, k).detach().numpy()
        p_j = np.asarray(getattr(jstate.scene.params, k))
        sure = np.abs(jmu / 0.1) > 1e-2
        np.testing.assert_allclose(p_t[sure], p_j[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=f"param {k}")
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tstate.stats, f).numpy(),
                                   np.asarray(getattr(jstate.stats, f)),
                                   **GRAD_TOL, err_msg=f)
    np.testing.assert_array_equal(tstate.stats.denom.numpy(),
                                  np.asarray(jstate.stats.denom))
    assert tstate.stats.xyz_gradient_accum.max() > 0


@pytest.mark.parametrize("local_edit,with_inject", [(False, False),
                                                    (True, True)],
                         ids=["edit", "local_inject"])
def test_train_step_matches_jax(local_edit, with_inject):
    check_one_step(*run_both(local_edit, with_inject, 1))


def test_train_trajectory_matches_jax():
    _, tstate, history, _ = run_both(False, False, 3, seed=13)
    for jm, tm in history:
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    for k in PARAMS:
        assert torch.isfinite(getattr(tstate.scene, k)).all(), k
        assert torch.isfinite(tstate.opt_state.nu[k]).all(), k


def test_train_state_clone_repeats_bitwise():
    js, cams, targets, _ = _train_inputs(5)
    topt = optim.GaussianAdam(config=optim.OptimConfig(**LRS))
    tstep = trainer.make_train_step(topt, trainer.LossWeights(**WEIGHTS),
                                    perceptual=multiscale_gradient_loss,
                                    max_instances=8192)
    state = trainer.init_train_state(port_scene(js), topt)
    tcams = [port_camera(c) for c in cams]
    copy = state.clone()
    g1, g2 = {}, {}
    s1, m1 = tstep(state, tcams, _t(targets), grads=g1)
    s2, m2 = tstep(copy, tcams, _t(targets), grads=g2)
    assert float(m1["loss"]) == float(m2["loss"])
    for k in PARAMS:
        assert torch.equal(g1[k], g2[k]), k
        assert torch.equal(getattr(s1.scene, k), getattr(s2.scene, k)), k
    assert s1.scene.xyz.data_ptr() != s2.scene.xyz.data_ptr()


def test_localized_view_shares_parameters():
    js = _anchored_scene()
    ts = port_scene(js)
    view = ts.localized()
    assert view.xyz is ts.xyz
    np.testing.assert_array_equal(view.alive.numpy(),
                                  np.asarray(js.localized().alive))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    ts.set_mask(torch.zeros_like(ts.mask))
    assert not ts.mask.any() and ts.alive.any()
    ts.one_up_sh_degree()
    assert int(ts.active_sh_degree) == int(js.one_up_sh_degree()
                                           .active_sh_degree)


def test_configs_default_to_jax():
    for port_cls, jax_cls in ((DensifyConfig, JDensifyConfig),
                              (optim.OptimConfig, joptim.OptimConfig),
                              (trainer.LossWeights, jtrainer.LossWeights)):
        assert dataclasses.asdict(port_cls()) == {
            f.name: getattr(jax_cls(), f.name)
            for f in dataclasses.fields(jax_cls)}
