"""The port's own InstructPix2Pix pipeline (`guidance/sd15.py`) against
its plain reference (`guidance/sd15_ref.py`), on seeded weights.

At a small size (UNet channels 32/64/64, 2 heads, cross width 16, 8
groups; VAE channels 16/16/32/32 over a 128x128 image, a 16x16 latent)
in float32: the UNet, the VAE's encode and decode, and one whole 3-way
guidance refresh through the adapter with the generator's draws
replayed. At the published widths on the meta device: the state dict's
names and shapes, the parameter counts, and the benchmark's UNet and VAE
work counts against `torch.utils.flop_counter`. DDIM's arithmetic by
hand, and the CLI's `build_guidance` driving `EditSystem.fit` with no
diffusers installed. On a card (marked `cuda`), the UNet's CUDA graph
against its eager forward, and a frame thread that renders through the
graph's capture.

This file imports neither JAX nor the JAX test helpers, so on a GPU
machine without JAX it runs with
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_sd15.py
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gaussianeditor_tpu_torch.apps import launch
from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
from gaussianeditor_tpu_torch.edit.edit_system import EditConfig, EditSystem
from gaussianeditor_tpu_torch.guidance import sd15
from gaussianeditor_tpu_torch.guidance import sd15_ref as ref
from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
    InstructPix2PixGuidance,
)
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread, as `tests/torch_port_helpers.py` sets
    it (not imported: the card's machine may hold another `tests`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
UNET = dict(ref.UNET, block_out_channels=(32, 64, 64),
            cross_attention_dim=16, attention_head_dim=2, norm_num_groups=8)
VAE = dict(ref.VAE, block_out_channels=(16, 16, 32, 32), layers_per_block=1,
           norm_num_groups=8)
# float32 through some 40 layers whose sums run in other orders on the two
# sides (SDPA against the explicit softmax, conv algorithms): the gaps
# read 2e-7 to 1e-6; a wrong term or scale moves them to 1e-2 and more
F32_GAP = 1e-5


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def small():
    u, v, text = ref.seeded_state_dicts(5, "cpu", UNET, VAE)
    pipe = sd15.build_pipeline("cpu", state_dicts=(u, v, text),
                               unet_dtype="float32", vae_dtype="float32",
                               generator_seed=3, unet_config=UNET,
                               vae_config=VAE)
    return u, v, text, pipe


def test_unet_against_the_reference(small):
    u, _, _, pipe = small
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 16, 16, generator=g)
    ctx = torch.randn(3, 77, 16, generator=g)
    got = pipe.unet(x, torch.tensor(501), encoder_hidden_states=ctx).sample
    want = ref.unet(u, x, torch.full((3,), 501), ctx, UNET)
    assert got.shape == (3, 4, 16, 16)
    assert _rel(got, want) < F32_GAP
    # a timestep per row on the device's side reads the same
    per_row = pipe.unet(x, torch.full((3,), 501),
                        encoder_hidden_states=ctx).sample
    assert _rel(per_row, want) < F32_GAP


def test_vae_against_the_reference(small):
    _, v, _, pipe = small
    g = torch.Generator().manual_seed(1)
    img = torch.rand(1, 3, 128, 128, generator=g) * 2 - 1
    dist = pipe.vae.encode(img).latent_dist
    mean, logvar = ref.vae_encode(v, img, VAE)
    assert _rel(dist.mode(), mean) < F32_GAP
    assert _rel(dist.std, torch.exp(0.5 * logvar)) < F32_GAP
    z = torch.randn(1, 4, 16, 16, generator=g)
    assert _rel(pipe.vae.decode(z).sample, ref.vae_decode(v, z, VAE)) \
        < F32_GAP


def test_a_whole_refresh_against_the_reference(small):
    """The adapter over the native pipeline: t, the encoder's sample and
    the start noise come from the pipeline's generator, so the reference
    replays them from its state."""
    u, v, text, pipe = small
    g = InstructPix2PixGuidance(device="cpu", pipe=pipe)
    rng = np.random.RandomState(0)
    rgb = rng.rand(128, 128, 3).astype(np.float32)
    cond = rng.rand(128, 128, 3).astype(np.float32)
    state = pipe.generator.get_state()
    seen = {}
    decode = pipe.vae.decode
    pipe.vae.decode = lambda z: seen.setdefault("z", z) is not None and \
        decode(z)
    before = profiling.counters()["unet_evals"]
    try:
        out = g(rgb, cond, "turn him into a clown").edit_image
    finally:
        del pipe.vae.decode
    assert profiling.counters()["unet_evals"] - before == 20
    gen = torch.Generator()
    gen.set_state(state)
    r = ref.refresh(u, v, rgb, cond, text, gen, unet_cfg=UNET, vae_cfg=VAE)
    assert 20 <= r["t"] <= 980
    assert out.shape == (128, 128, 3) and out.dtype == np.float32
    assert _rel(seen["z"], r["latents"] / VAE["scaling_factor"]) < F32_GAP
    assert _rel(out, r["image"]) < F32_GAP
    # the override of the training range is undone
    assert pipe.scheduler.config.num_train_timesteps == 1000


def test_ddim_by_hand():
    s = sd15.DDIMScheduler()
    ac = s.alphas_cumprod
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32) ** 2
    assert torch.equal(ac, torch.cumprod(1 - betas, 0))
    s.config.num_train_timesteps = 500
    s.set_timesteps(20)
    assert s.timesteps.tolist() == list(range(476, 0, -25))
    assert s.timesteps.tolist() == ref.ddim_timesteps(500, 20)
    g = torch.Generator().manual_seed(2)
    x, e = torch.randn(1, 4, 8, 8, generator=g), \
        torch.randn(1, 4, 8, 8, generator=g)
    # a middle step goes to the previous timestep
    a, ap = float(ac[251]), float(ac[226])
    x0 = (x - (1 - a) ** 0.5 * e) / a ** 0.5
    want = ap ** 0.5 * x0 + (1 - ap) ** 0.5 * e
    assert torch.allclose(s.step(e, torch.tensor(251), x).prev_sample, want,
                          rtol=1e-6, atol=1e-6)
    # the last (timestep 1, previous -24) lands on alphas_cumprod[0]
    a, ap = float(ac[1]), float(ac[0])
    x0 = (x - (1 - a) ** 0.5 * e) / a ** 0.5
    want = ap ** 0.5 * x0 + (1 - ap) ** 0.5 * e
    assert torch.allclose(s.step(e, s.timesteps[-1], x).prev_sample, want,
                          rtol=1e-6, atol=1e-6)
    a = float(ac[476])
    assert torch.allclose(s.add_noise(x, e, s.timesteps[:1]),
                          a ** 0.5 * x + (1 - a) ** 0.5 * e, rtol=1e-6,
                          atol=1e-6)
    with pytest.raises(ValueError):
        s.config.num_train_timesteps = 10
        s.set_timesteps(20)


def test_the_override_is_restored_after_an_exception(small):
    _, _, _, pipe = small

    class Broken:
        dtype = torch.float32

        def __call__(self, *a, **k):
            raise RuntimeError("out of memory")

    unet, pipe.unet = pipe.unet, Broken()
    try:
        g = InstructPix2PixGuidance(device="cpu", pipe=pipe)
        img = np.zeros((128, 128, 3), np.float32)
        with pytest.raises(RuntimeError, match="out of memory"):
            g(img, img, "p")
    finally:
        pipe.unet = unet
    assert pipe.scheduler.config.num_train_timesteps == 1000


@pytest.mark.parametrize("name", ["UNET", "VAE", "SCHEDULER",
                                  "TRANSFORMER_GN_EPS", "LAYER_NORM_EPS",
                                  "VAE_EPS"])
def test_the_program_and_the_reference_state_the_same_model(name):
    """Each side states the published configuration and diffusers' eps
    values on its own; they agree."""
    assert getattr(sd15, name) == getattr(ref, name)


@pytest.fixture(scope="module")
def published():
    """The UNet and the VAE at the program's own (published) widths on the
    meta device."""
    with torch.device("meta"):
        return (sd15.UNet2DConditionModel().half(),
                sd15.AutoencoderKL().half())


def test_published_names_shapes_and_sizes(published):
    unet, vae = published
    for m, shapes in ((unet, ref.unet_shapes()), (vae, ref.vae_shapes())):
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} \
            == shapes
    assert sum(p.numel() for p in unet.parameters()) == 859_532_484
    assert sum(p.numel() for p in vae.parameters()) == 83_653_863


def test_work_counts_match_the_flop_counter(published):
    from benchmark.ext import ip2p_edit as ip2p

    unet, vae = published
    with torch.device("meta"):
        x = torch.empty(3, 8, 64, 64, dtype=torch.half)
        ctx = torch.empty(3, 77, 768, dtype=torch.half)
        img = torch.empty(1, 3, 512, 512, dtype=torch.half)
        z = torch.empty(1, 4, 64, 64, dtype=torch.half)
    counted = []
    for f in (lambda: unet(x, torch.tensor(500), encoder_hidden_states=ctx),
              lambda: vae.encode(img).latent_dist.mode(),
              lambda: vae.decode(z)):
        with FlopCounterMode(display=False) as fc:
            f()
        counted.append(fc.get_total_flops())
    enc, dec = ip2p.vae_flops(512, 512)
    assert counted == [ip2p.unet_flops(64, 64), enc, dec]
    w = dict(height=512, width=512)
    assert ip2p.unet_least_s(w) == counted[0] / ip2p.PEAK_FP16
    assert ip2p.vae_least_s(w) == (2 * enc + dec) / ip2p.PEAK_FP16


def test_a_saved_state_dict_loads(small, tmp_path):
    """`weights=PATH`: the state dicts and text states `torch.save`d under
    "unet", "vae" and "text_states" give the same pipeline."""
    u, v, text, pipe = small
    path = str(tmp_path / "ip2p.pt")
    torch.save({"unet": u, "vae": v, "text_states": text}, path)
    loaded = sd15.build_pipeline("cpu", weights=path, unet_dtype="float32",
                                 vae_dtype="float32", unet_config=UNET,
                                 vae_config=VAE)
    for a, b in ((loaded.unet, pipe.unet), (loaded.vae, pipe.vae)):
        sb = b.state_dict()
        assert all(torch.equal(x, sb[k]) for k, x in a.state_dict().items())
    assert torch.equal(loaded.text_states, pipe.text_states)
    with pytest.raises(ValueError):
        sd15.build_pipeline("cpu", seed=1, weights=path)


def test_seeded_weights_repeat():
    a = ref.seeded_state_dicts(7, "cpu", UNET, VAE)
    b = ref.seeded_state_dicts(7, "cpu", UNET, VAE)
    c = ref.seeded_state_dicts(8, "cpu", UNET, VAE)
    for x, y, z in zip(a[:2], b[:2], c[:2]):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert not any(torch.equal(x[k], z[k]) for k in x if x[k].ndim > 1)
    assert torch.equal(a[2], b[2]) and a[2].shape == (2, 77, 16)


def test_the_benchmark_copy_of_the_reference_is_the_same_file():
    assert (ROOT / "gaussianeditor_tpu_torch/guidance/sd15_ref.py"
            ).read_bytes() == (ROOT / "benchmark/ext/ip2p_reference.py"
                               ).read_bytes()


def test_the_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((ROOT / "gaussianeditor_tpu_torch/guidance/sd15_ref.py"
                      ).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch"}


def _scene(n, capacity, seed=0, device="cpu"):
    rng = np.random.RandomState(seed)

    def pad(x):
        out = np.zeros((capacity,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    return GaussianScene.create(dict(
        xyz=pad(rng.uniform(-1, 1, (n, 3))),
        features_dc=pad(rng.randn(n, 1, 3) * 0.5),
        features_rest=pad(rng.randn(n, 3, 3) * 0.1),
        opacity_raw=pad(rng.uniform(-1, 3, (n, 1))),
        log_scales=pad(np.log(rng.uniform(0.03, 0.12, (n, 3)))),
        quats=pad(rng.randn(n, 4))), max_sh_degree=1, active_sh_degree=1,
        alive=np.arange(capacity) < n)


def test_the_cli_builds_the_native_pipeline_for_the_edit():
    """`build_guidance("ip2p")` with `guidance_kwargs.native`, no diffusers:
    the edit refreshes its batch's targets through it every
    `per_editing_step` steps, each refresh 20 UNet calls."""
    assert importlib.util.find_spec("diffusers") is None
    g = launch.build_guidance("ip2p", {"device": "cpu", "guidance_kwargs": {
        "native": dict(seed=4, unet_dtype="float32", vae_dtype="float32",
                       unet_config=UNET, vae_config=VAE)}})
    assert isinstance(g.pipe, sd15.InstructPix2PixPipeline)
    assert g.pipe.unet.dtype == torch.float32
    cams = orbit_cameras(4, 4.0, 0.8, 0.8, 64, 64, device="cpu")
    system = EditSystem(
        _scene(300, 400), cams,
        EditConfig(prompt="turn him into a clown", batch_size=2, max_steps=4,
                   per_editing_step=2, edit_until_step=100,
                   densification_interval=100, cameras_extent=2.0,
                   max_instances=1 << 15, seed=3),
        guidance=g, perceptual=None)
    before = profiling.counters()["unet_evals"]
    seen = []
    system.fit(n_steps=4, callback=lambda s, m: seen.append(
        {v: f.copy() for v, f in system.edit_frames.items()}))
    # steps 0 and 1 touch the four views first, step 2 refreshes its
    # batch's two, step 3 none: six refreshes of 20 UNet calls
    assert profiling.counters()["unet_evals"] - before == 20 * 6
    frames = system.edit_frames
    assert sorted(frames) == [0, 1, 2, 3]
    for f in frames.values():
        assert f.shape == (64, 64, 3) and np.isfinite(f).all()
        assert 0.0 <= f.min() and f.max() <= 1.0
    assert not np.array_equal(frames[0], system.origin_frames[0])
    assert np.isfinite(system.state.scene.xyz.detach().numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_the_cuda_graph_replays_the_eager_forward(dtype):
    """The graph captured at the first call, replayed at other timesteps
    (host numbers, host tensors and a tensor a row on the card) and other
    inputs, gives the eager forward's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    pipe = sd15.build_pipeline(dev, seed=6, unet_dtype=dtype,
                               unet_config=UNET, vae_config=VAE)
    g = torch.Generator(dev).manual_seed(0)
    ctx = pipe._encode_prompt("p", dev, 1, True, "")
    for t in (501, torch.tensor(20), torch.tensor([7, 7, 7], device=dev)):
        x = torch.randn(3, 8, 16, 16, generator=g, device=dev)
        dt = pipe.unet.dtype
        eager = pipe.unet._body(x.to(dt), sd15.timestep_sinusoid(
            t, 3, pipe.unet.conv_in.out_channels, dev), ctx.to(dt))
        got = pipe.unet(x, t, encoder_hidden_states=ctx).sample
        assert got.dtype == getattr(torch, dtype)
        assert torch.equal(got, eager)
    assert len(pipe.unet._graphs) == 1


@pytest.mark.cuda
def test_a_frame_thread_runs_through_the_first_capture(monkeypatch):
    """The web UI's case: a frame thread renders, allocates afresh and
    reads back while the edit's thread makes the UNet's first call, which
    captures its graph. Frames are made between the capture's begin and
    end; neither side fails, every frame is the one rendered before, and
    the graph replays the eager forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    scene = _scene(300, 400, device=dev)
    cam = orbit_cameras(1, 4.0, 0.8, 0.8, 64, 64, device=dev)[0]
    with torch.no_grad():
        want = render(scene, cam).color.cpu()
    pipe = sd15.build_pipeline(dev, seed=6, unet_config=UNET, vae_config=VAE)
    frames, errors, stop = [0], [], threading.Event()

    def serve():
        try:
            while not stop.is_set():
                # a size no freed block holds: a fresh cudaMalloc
                torch.empty((frames[0] + 1) << 19, device=dev).fill_(1.0)
                with torch.no_grad():
                    got = render(scene, cam).color.cpu()
                if not torch.equal(got, want):
                    raise AssertionError("a frame changed")
                frames[0] += 1
        except Exception as e:      # handed to the test's thread
            errors.append(e)

    made = []

    class Graph(torch.cuda.CUDAGraph):
        def capture_begin(self, *args, **kwargs):
            super().capture_begin(*args, **kwargs)
            first = frames[0]
            deadline = time.monotonic() + 30.0
            while (frames[0] < first + 3 and not errors
                   and time.monotonic() < deadline):
                time.sleep(1e-3)        # frames while this thread captures
            made.append(frames[0] - first)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        while frames[0] == 0 and not errors:
            time.sleep(1e-3)
        ctx = pipe._encode_prompt("p", dev, 1, True, "")
        x = torch.randn(3, 8, 16, 16, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        got = pipe.unet(x, 501, encoder_hidden_states=ctx).sample
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not errors, errors
    assert made and made[0] >= 3
    dt = pipe.unet.dtype
    eager = pipe.unet._body(x.to(dt), sd15.timestep_sinusoid(
        501, 3, pipe.unet.conv_in.out_channels, dev), ctx.to(dt))
    assert torch.equal(got, eager)
