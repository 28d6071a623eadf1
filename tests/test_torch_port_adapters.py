"""Port vs JAX: the diffusion adapters' plumbing.

The stand-in pipelines of `tests/test_adapter_plumbing.py` (VAE encode
and decode, a DDIM-style scheduler, a UNet asserting the ip2p input
contract) drive the port's adapters as that file drives the JAX ones,
and the two packages' outputs are compared on the same inputs and the
same torch seed. Without diffusers (or lang-segment-anything) every
adapter raises the JAX module's ImportError, and the CLI's builders
construct the adapters from stand-ins.
"""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu.guidance import diffusers_adapters as jadapters
from gaussianeditor_tpu_torch.apps import launch
from gaussianeditor_tpu_torch.guidance import diffusers_adapters as adapters
from tests.test_adapter_plumbing import (
    LC,
    LH,
    LW,
    H,
    MockPipe,
    W,
    _CallablePipe,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rgb(seed):
    return np.random.RandomState(seed).rand(H, W, 3).astype(np.float32)


def test_ip2p_edit_matches_jax_adapter():
    got = adapters.InstructPix2PixGuidance(device="cpu", pipe=MockPipe(),
                                           diffusion_steps=4)
    want = jadapters.InstructPix2PixGuidance(device="cpu", pipe=MockPipe(),
                                             diffusion_steps=4)
    rgb, origin = _rgb(0), _rgb(1)
    torch.manual_seed(0)
    out = got(rgb, origin, "make it night")
    torch.manual_seed(0)
    ref = want(rgb, origin, "make it night")
    assert out.edit_image.shape == (H, W, 3)
    assert np.isfinite(out.edit_image).all()
    assert 0.0 <= out.edit_image.min() and out.edit_image.max() <= 1.0
    assert got.pipe.unet.calls == 4   # one 3-way pass per DDIM step
    np.testing.assert_array_equal(out.edit_image, ref.edit_image)
    # the sampled t never leaks into the scheduler's training range
    assert got.pipe.scheduler.config.num_train_timesteps == 1000


@pytest.mark.parametrize("clip", [None, 1e-6])
def test_ip2p_sds_grad_matches_jax_adapter(clip):
    got = adapters.InstructPix2PixGuidance(device="cpu", pipe=MockPipe())
    want = jadapters.InstructPix2PixGuidance(device="cpu", pipe=MockPipe())
    rgb, origin = _rgb(2), _rgb(3)
    torch.manual_seed(0)
    g, info = got.sds_image_grad(rgb, origin, "prompt", step=5,
                                 grad_clip=clip)
    torch.manual_seed(0)
    jg, jinfo = want.sds_image_grad(rgb, origin, "prompt", step=5,
                                    grad_clip=clip)
    assert g.shape == (H, W, 3) and np.isfinite(g).all()
    np.testing.assert_array_equal(g, jg)
    assert info == jinfo
    assert info["min_step"] == 20 and info["max_step"] == 980
    if clip is None:
        assert np.abs(g).max() > 0
    else:
        assert info["grad_norm"] <= clip * LC * LH * LW + 1e-8


@pytest.mark.parametrize("control_type", ["canny", "p2p"])
def test_controlnet_cond_flows_to_pipe(control_type):
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[:, W // 2:] = 1.0  # a vertical edge
    outs = []
    for mod in (adapters, jadapters):
        pipe = _CallablePipe()
        g = mod.ControlNetGuidance(control_type=control_type, device="cpu",
                                   pipe=pipe)
        outs.append((g(rgb, rgb, "sharpen"), pipe.kwargs))
    (out, kw), (ref, jkw) = outs
    assert out.edit_image.shape == (H, W, 3)
    np.testing.assert_array_equal(out.edit_image, ref.edit_image)
    np.testing.assert_array_equal(np.asarray(kw["image"]),
                                  np.asarray(jkw["image"]))
    assert kw["num_inference_steps"] == 20
    if control_type == "canny":
        assert np.asarray(kw["image"]).max() == 255   # the edge shows


@pytest.mark.parametrize("kind", ["controlnet", "sdxl"])
def test_inpainters_mask_and_seed(kind):
    img = _rgb(0)
    mask = np.zeros((H, W), np.float32)
    mask[10:20, 10:20] = 1.0
    pipe = _CallablePipe()
    if kind == "controlnet":
        inp = adapters.ControlNetInpainter(device="cpu", pipe=pipe, seed=7)
        jpipe = _CallablePipe()
        ref = jadapters.ControlNetInpainter(device="cpu", pipe=jpipe,
                                            seed=7)(img, mask, "")
    else:
        inp = adapters.SDXLInpainter(device="cpu", pipe=pipe)
    out = inp(img, mask, "")
    assert out.shape == (H, W, 3) and out.dtype == np.float32
    mk = np.asarray(pipe.kwargs["mask_image"])
    assert mk[15, 15] == 255 and mk[0, 0] == 0
    assert pipe.kwargs["num_inference_steps"] == 20
    if kind == "controlnet":
        assert pipe.kwargs["generator"].initial_seed() == 7
        np.testing.assert_array_equal(out, ref)


def test_langsam_segmentor_with_a_stand_in_model():
    class Model:
        def __init__(self, masks):
            self.masks = masks

        def predict(self, image, prompt):
            assert image.size == (W, H) and prompt == "the bear"
            return self.masks, None, None

    m = np.zeros((H, W), bool)
    m[5:9, 3:7] = True
    got = adapters.LangSAMSegmentor(device="cpu", model=Model([m]))(
        _rgb(0), "the bear")
    np.testing.assert_array_equal(got, m.astype(np.float32))
    empty = adapters.LangSAMSegmentor(device="cpu", model=Model([]))(
        _rgb(0), "the bear")
    assert empty.shape == (H, W) and empty.max() == 0


@pytest.mark.parametrize("make", [
    lambda m: m.InstructPix2PixGuidance(device="cpu"),
    lambda m: m.ControlNetGuidance("canny", device="cpu"),
    lambda m: m.ControlNetInpainter(device="cpu"),
    lambda m: m.SDXLInpainter(device="cpu"),
    lambda m: m.LangSAMSegmentor(device="cpu"),
], ids=["ip2p", "controlnet", "controlnet_inpaint", "sdxl", "langsam"])
def test_adapters_raise_the_jax_import_error(make):
    with pytest.raises(ImportError) as got:
        make(adapters)
    with pytest.raises(ImportError) as want:
        make(jadapters)
    assert str(got.value) == str(want.value).replace(
        "gaussianeditor_tpu.", "gaussianeditor_tpu_torch.")


def test_cli_builds_adapters_from_stand_ins():
    g = launch.build_guidance("ip2p", {"device": "cpu", "guidance_kwargs": {
        "pipe": MockPipe(), "diffusion_steps": 2}})
    assert isinstance(g, adapters.InstructPix2PixGuidance)
    assert g.device == "cpu" and g.diffusion_steps == 2
    c = launch.build_guidance("controlnet-canny", {
        "device": "cpu", "guidance_kwargs": {"pipe": _CallablePipe()}})
    assert isinstance(c, adapters.ControlNetGuidance)
    assert c.control_type == "canny" and c.device == "cpu"
    c = launch.build_guidance("controlnet", {
        "guidance_kwargs": {"pipe": _CallablePipe()}})
    assert c.control_type == "p2p" and c.device == "cuda"
