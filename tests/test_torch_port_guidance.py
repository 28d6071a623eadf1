"""Port vs JAX: the guidance layer.

The score paths (`guidance/score.py`, `FakeLatentModel`): the schedule
bitwise, the CFG combinations exactly, SDS and DDS image gradients and
info against the JAX functions with JAX's draws of t and the noise
injected (rtol 1e-5 / atol 1e-6), the encoder's VJP against its closed
form in float64, the C() annealing of the step range and the clip, DDS
zero on identical inputs, and SDS-only and DDS training through the
port's `EditSystem` moving the parameters (as `tests/test_score.py`).
The prompt module (`guidance/prompts.py`) and the conditioning images
(`guidance/image_cond.py`) are numpy in both packages and held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import lookat_camera as jlookat_camera
from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu.guidance import image_cond as jimage_cond
from gaussianeditor_tpu.guidance import prompts as jprompts
from gaussianeditor_tpu.guidance import score as jscore
from gaussianeditor_tpu_torch.core.cameras import lookat_camera, orbit_cameras
from gaussianeditor_tpu_torch.guidance import fake, image_cond, prompts, score
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-5, 1e-6


def _img(seed, b=1, hw=32):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def _jax_draws(g, B, hw, step):
    """JAX's t and noise for a call at `step` (score.py:149-162)."""
    lo, hi = jscore._steps_at(g.cfg, g.sched.num_train_timesteps, step)
    kt, kn = jax.random.split(jax.random.key(step))
    t = jax.random.randint(kt, (B,), lo, hi + 1)
    shape = (B, hw // 8, hw // 8, jfake.FakeLatentModel.latent_channels)
    noise = jax.random.normal(kn, shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


def _pair(kind, **cfg):
    """The JAX and the port guidance of `kind` on the fake latent model."""
    jcls, tcls = {"sds": (jscore.SDSGuidance, score.SDSGuidance),
                  "dds": (jscore.DDSGuidance, score.DDSGuidance)}[kind]
    jcfg = jscore.ScoreConfig(**cfg) if cfg else None
    tcfg = score.ScoreConfig(**cfg) if cfg else None
    return (jcls(jfake.FakeLatentModel(), jcfg),
            tcls(fake.FakeLatentModel(device="cpu"), tcfg))


# --- the fake latent model, the schedule, CFG ---

def test_fake_latent_model_matches_jax():
    jm, tm = jfake.FakeLatentModel(seed=3), fake.FakeLatentModel(seed=3,
                                                                 device="cpu")
    np.testing.assert_array_equal(tm.proj.numpy(), jm.proj)
    x = _img(0, b=2)
    np.testing.assert_allclose(tm.encode(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.encode(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    z = np.random.RandomState(1).randn(2, 4, 4, 4).astype(np.float32)
    c = np.random.RandomState(2).randn(2, 4, 4, 4).astype(np.float32)
    t = np.array([10, 900])
    for prompt, cond in (("a", None), ("", c)):
        want = jm.unet(jnp.asarray(z), jnp.asarray(t), prompt,
                       None if cond is None else jnp.asarray(cond))
        got = tm.unet(torch.from_numpy(z), torch.from_numpy(t), prompt,
                      None if cond is None else torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_schedule_bitwise():
    js, ts = jscore.DDIMSchedule(), score.DDIMSchedule()
    assert ts.alphas_cumprod.dtype == torch.float32
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4, 4, 4).astype(np.float32)
    n = rng.randn(3, 4, 4, 4).astype(np.float32)
    t = np.array([0, 417, 999])
    want = js.add_noise(jnp.asarray(x), jnp.asarray(n),
                        jnp.asarray(t)[:, None, None, None])
    got = ts.add_noise(torch.from_numpy(x), torch.from_numpy(n),
                       torch.from_numpy(t)[:, None, None, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(ts.w(torch.from_numpy(t)).numpy(),
                                  np.asarray(js.w(jnp.asarray(t))))


def test_cfg_combinations_exact():
    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(2, 4, 4, 4).astype(np.float32) for _ in range(3))
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    ja, jb, jc = (jnp.asarray(v) for v in (a, b, c))
    np.testing.assert_array_equal(
        score.cfg_combine3(ta, tb, tc, 7.5, 1.5).numpy(),
        np.asarray(jscore.cfg_combine3(ja, jb, jc, 7.5, 1.5)))
    np.testing.assert_array_equal(
        score.cfg_combine2(ta, tb, 12.0).numpy(),
        np.asarray(jscore.cfg_combine2(ja, jb, 12.0)))
    # equal branches collapse to the branch value; scales 1, 1 -> text
    assert torch.allclose(score.cfg_combine3(ta, ta, ta, 7.5, 1.5), ta)
    one = torch.ones_like(ta)
    assert torch.allclose(score.cfg_combine3(one, 2 * one, ta, 1.0, 1.0), one)


# --- SDS and DDS against JAX, with JAX's draws injected ---

@pytest.mark.parametrize("B,step,clip", [(1, 0, None), (2, 7, None),
                                         (2, 3, 1e-3)])
def test_sds_matches_jax(B, step, clip):
    jg, tg = _pair("sds", grad_clip=clip) if clip else _pair("sds")
    rgb, cond = _img(2, b=B), _img(3, b=B)
    want, jinfo = jg(rgb, cond, "make it snowy", step=step)
    t, noise = _jax_draws(jg, B, 32, step)
    got, info = tg(rgb, cond, "make it snowy", step=step, t=t, noise=noise)
    assert isinstance(got, np.ndarray) and got.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert (info["min_step"], info["max_step"]) == (jinfo["min_step"],
                                                    jinfo["max_step"])
    for k in ("grad_norm", "loss_sds"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,step", [(1, 5), (2, 11)])
def test_dds_matches_jax(B, step):
    jg, tg = _pair("dds")
    rgb, origin = _img(4, b=B), _img(5, b=B)
    want, jinfo = jg(rgb, origin, "a red car", "a blue car", step=step)
    t, noise = _jax_draws(jg, B, 32, step)
    got, info = tg(rgb, origin, "a red car", "a blue car", step=step, t=t,
                   noise=noise)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for k in ("grad_norm", "loss_dds"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]),
                                   rtol=RTOL, atol=ATOL)


def test_sds_vjp_is_the_closed_form():
    """The fake encoder is linear: its VJP spreads cot @ proj^T / 64 over
    each 8x8 block. The image gradient must be that, in float64, of the
    latent gradient grad / B, recomputed from the same draws."""
    model = fake.FakeLatentModel(device="cpu")
    g = score.SDSGuidance(model)
    rgb, cond = _img(6, b=2), _img(7, b=2)
    gen = torch.Generator().manual_seed(11)
    t = torch.randint(20, 981, (2,), generator=gen)
    noise = torch.randn((2, 4, 4, 4), generator=gen)
    got, _ = g(rgb, cond, "p", step=0, t=t, noise=noise)

    lat = model.encode(torch.from_numpy(rgb))
    clat = model.encode(torch.from_numpy(cond))
    tb = t[:, None, None, None]
    noisy = g.sched.add_noise(lat, noise, tb)
    pred = score.cfg_combine3(model.unet(noisy, t, "p", clat),
                              model.unet(noisy, t, "", clat),
                              model.unet(noisy, t, "", torch.zeros_like(clat)),
                              7.5, 1.5)
    grad = (g.sched.w(tb) * (pred - noise)).double().numpy() / 2
    per_block = grad @ model.proj.double().numpy().T / 64.0  # [B, 4, 4, 3]
    want = np.repeat(np.repeat(per_block, 8, axis=1), 8, axis=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_tensor_inputs_give_tensors_and_repeat():
    g = score.SDSGuidance(fake.FakeLatentModel(device="cpu"))
    rgb, cond = torch.from_numpy(_img(0, b=2)), torch.from_numpy(_img(1, b=2))
    a, _ = g(rgb, cond, "p", step=7)
    b, _ = g(rgb, cond, "p", step=7)
    c, _ = g(rgb, cond, "p", step=8)
    assert isinstance(a, torch.Tensor) and torch.equal(a, b)
    assert not torch.equal(a, c)   # t and the noise follow the step


def test_annealing_and_clip():
    cfg = score.ScoreConfig(max_step_percent=[0, 0.98, 0.5, 100],
                            grad_clip=[0, 1.0, 1e-6, 100])
    g = score.SDSGuidance(fake.FakeLatentModel(device="cpu"), cfg)
    _, info0 = g(_img(0), _img(1), "p", step=0)
    _, info1 = g(_img(0), _img(1), "p", step=100)
    assert info0["max_step"] == int(1000 * 0.98)
    assert info1["max_step"] == int(1000 * 0.5)
    n_latent = (32 // fake.FakeLatentModel.down) ** 2 * 4
    assert float(info1["grad_norm"]) <= np.sqrt(n_latent) * 1e-6 + 1e-12
    assert float(info0["grad_norm"]) > np.sqrt(n_latent) * 1e-6


def test_dds_zero_when_identical():
    g = score.DDSGuidance(fake.FakeLatentModel(device="cpu"))
    rgb = _img(4)
    gi, info = g(rgb, rgb, "same", "same", step=5)
    np.testing.assert_array_equal(gi, 0.0)
    assert float(info["grad_norm"]) == 0.0
    gi, info = g(rgb, rgb, "a red car", "a blue car", step=5)
    assert float(info["grad_norm"]) > 0 and np.abs(gi).max() > 0


# --- score guidance through the editing loop ---

def _edit_system(**loss):
    from gaussianeditor_tpu_torch.edit.edit_system import EditConfig
    from gaussianeditor_tpu_torch.train.trainer import LossWeights
    from tests.helpers import random_scene
    from tests.torch_port_helpers import port_scene

    cfg = EditConfig(prompt="make it autumn", batch_size=2, max_steps=3,
                     per_editing_step=10, densify_until_step=0,
                     cameras_extent=2.0, max_instances=4096,
                     loss=LossWeights(**loss))
    return (port_scene(random_scene(50, seed=3)),
            orbit_cameras(4, 4.0, 0.8, 0.8, 32, 32, device="cpu"), cfg)


def test_dds_second_guidance_slot():
    from gaussianeditor_tpu_torch.edit.edit_system import EditSystem

    scene, cams, cfg = _edit_system(lambda_dds=0.5)
    sys_ = EditSystem(scene, cams, cfg, guidance=fake.FakeGuidance(),
                      perceptual=None,
                      dds_guidance=score.DDSGuidance(
                          fake.FakeLatentModel(device="cpu")),
                      dds_prompts=("autumn trees", "summer trees"))
    vals = []
    sys_.fit(callback=lambda s, m: vals.append(float(m["loss_inject"])))
    assert len(vals) == 3 and np.isfinite(vals).all()
    assert any(v != 0.0 for v in vals)


@pytest.mark.parametrize("kind", ["sds", "dds"])
def test_score_only_training_moves_params(kind):
    """Score distillation without target guidance (lambda_l1 = lambda_p =
    0): the injected gradient reaches the parameters."""
    from gaussianeditor_tpu_torch.edit.edit_system import EditSystem

    lam = {"sds": dict(lambda_sds=10.0), "dds": dict(lambda_dds=10.0)}[kind]
    scene, cams, cfg = _edit_system(lambda_l1=0.0, lambda_p=0.0, **lam)
    model = fake.FakeLatentModel(device="cpu")
    slot = ({"sds_guidance": score.SDSGuidance(model)} if kind == "sds" else
            {"dds_guidance": score.DDSGuidance(model),
             "dds_prompts": ("autumn trees", "summer trees")})
    sys_ = EditSystem(scene, cams, cfg, guidance=None, perceptual=None,
                      **slot)
    sys_.on_fit_start()
    before = sys_.state.scene.features_dc.detach().clone()
    st = sys_.fit(n_steps=2)
    assert torch.isfinite(st.scene.xyz).all()
    assert (st.scene.features_dc - before).abs().max() > 0


# --- prompts ---

@pytest.mark.parametrize("azimuth,elevation", [
    (0.0, 0.0), (45.0, 0.0), (46.0, 0.0), (90.0, 0.0), (-90.0, 10.0),
    (135.0, 0.0), (180.0, 0.0), (-179.0, 0.0), (30.0, 75.0), (270.0, 5.0)])
def test_view_prompts_match_jax(azimuth, elevation):
    assert (prompts.view_direction(azimuth, elevation)
            == jprompts.view_direction(azimuth, elevation))
    got = prompts.perp_neg_view_prompt(azimuth, elevation)
    want = jprompts.perp_neg_view_prompt(azimuth, elevation)
    assert got.pos_blend == want.pos_blend
    assert got.negatives == want.negatives


def test_perp_neg_math_matches_jax():
    for f in (prompts.PERP_NEG_F_SB, prompts.PERP_NEG_F_FSB,
              prompts.PERP_NEG_F_FS, prompts.PERP_NEG_F_SF):
        assert f in (jprompts.PERP_NEG_F_SB, jprompts.PERP_NEG_F_FSB,
                     jprompts.PERP_NEG_F_FS, jprompts.PERP_NEG_F_SF)
        for r in (0.0, 0.3, 1.0):
            assert (prompts.shifted_exponential_decay(*f, r)
                    == jprompts.shifted_exponential_decay(*f, r))
    rng = np.random.RandomState(0)
    pos, unc = rng.randn(4, 8), rng.randn(4, 8)
    negs = [(rng.randn(4, 8), -0.7), (rng.randn(4, 8), -0.2)]
    np.testing.assert_array_equal(
        prompts.perpendicular_component(pos, unc),
        jprompts.perpendicular_component(pos, unc))
    np.testing.assert_array_equal(prompts.perp_neg_combine(pos, unc, negs),
                                  jprompts.perp_neg_combine(pos, unc, negs))
    out = prompts.perp_neg_combine(np.array([1.0, 0.0]), np.zeros(2),
                                   [(np.array([0.0, 1.0]), -0.5)])
    np.testing.assert_allclose(out, [1.0, -0.5])


@pytest.mark.parametrize("prompt,mask_ids", [
    ("a dog lying down", None), ("a stone statue", None),
    ("a red car", [0]), ("a red car", None)])
def test_debiased_prompts_match_jax(prompt, mask_ids):
    def probe(text):
        if "lying" in text:
            return np.array([0.1, 0.1, 0.1, 0.7])
        if "red" in text:
            return np.array([0.7, 0.1, 0.1, 0.1])
        return np.full(4, 0.25)

    got = prompts.get_debiased_prompts(prompt, probe, mask_ids=mask_ids)
    assert got == jprompts.get_debiased_prompts(prompt, probe,
                                                mask_ids=mask_ids)
    if prompt == "a dog lying down":
        assert got[3] == prompt and all("lying" not in p for p in got[:3])


def test_camera_angles_and_prompt_processor_match_jax():
    pp, jpp = (prompts.PromptProcessor(prompt="a bear statue"),
               jprompts.PromptProcessor(prompt="a bear statue"))
    cams = orbit_cameras(8, 3.0, 0.8, 0.8, 32, 32, device="cpu")
    jcams = jorbit_cameras(8, 3.0, 0.8, 0.8, 32, 32)
    for c, jc in zip(cams, jcams):
        np.testing.assert_allclose(prompts.camera_angles(c),
                                   jprompts.camera_angles(jc), atol=1e-4)
    assert pp.for_cameras(cams) == jpp.for_cameras(jcams)
    assert {p.rsplit(", ", 1)[1] for p in pp.for_cameras(cams)} >= {
        "front view", "back view", "side view"}
    eye = np.array([0, 5.0, 0.1])
    cam = lookat_camera(eye, np.zeros(3), np.array([0, 1.0, 0]), 0.8, 0.8,
                        32, 32, device="cpu")
    jcam = jlookat_camera(eye, np.zeros(3), np.array([0, 1.0, 0]), 0.8, 0.8,
                          32, 32)
    assert pp.for_camera(cam) == jpp.for_camera(jcam) == \
        "a bear statue, overhead view"
    off = prompts.PromptProcessor(prompt="x", use_view_dependent=False)
    assert off.for_camera(cam) == "x"


# --- conditioning images ---

def _edge_image(hw=64):
    img = np.zeros((hw, hw, 3), np.float32)
    img[:, hw // 2:] = 1.0
    return img


def test_image_cond_matches_jax():
    rng = np.random.RandomState(0)
    imgs = [_edge_image(), np.full((32, 32, 3), 0.5, np.float32),
            rng.rand(40, 48, 3).astype(np.float32)]
    for img in imgs:
        np.testing.assert_array_equal(image_cond.canny_cond(img),
                                      jimage_cond.canny_cond(img))
        for kind in ("p2p", "inpaint", "canny"):
            np.testing.assert_array_equal(
                image_cond.prepare_image_cond(kind, img),
                jimage_cond.prepare_image_cond(kind, img))
    depth = np.tile(np.linspace(1, 3, 32, dtype=np.float32), (32, 1))
    depth[0, 0] = 0.0
    mask = rng.rand(32, 32) > 0.3
    for m in (None, mask):
        np.testing.assert_array_equal(
            image_cond.normal_from_depth(depth, m),
            jimage_cond.normal_from_depth(depth, m))
    np.testing.assert_array_equal(
        image_cond.prepare_image_cond("normal", imgs[0], depth=depth),
        jimage_cond.prepare_image_cond("normal", imgs[0], depth=depth))
    det = lambda rgb: np.full_like(rgb, 0.25)  # noqa: E731
    np.testing.assert_array_equal(
        image_cond.prepare_image_cond("normal", imgs[0], normal_detector=det),
        0.25)


@pytest.mark.parametrize("kind,kw", [("normal", {}), ("scribble", {})])
def test_image_cond_errors_match_jax(kind, kw):
    with pytest.raises(ValueError) as got:
        image_cond.prepare_image_cond(kind, _edge_image(), **kw)
    with pytest.raises(ValueError) as want:
        jimage_cond.prepare_image_cond(kind, _edge_image(), **kw)
    assert str(got.value) == str(want.value)


def test_normal_bae_is_gated_as_in_jax():
    with pytest.raises(ImportError) as got:
        image_cond.NormalBaeCond(device="cpu")
    with pytest.raises(ImportError) as want:
        jimage_cond.NormalBaeCond(device="cpu")
    assert str(got.value) == str(want.value)
