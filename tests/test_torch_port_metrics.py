"""Port vs JAX: image metrics, CLIP metrics, saving and profiling.

`compute_image_metrics` against the JAX function on the same images,
LPIPS from one random-weights file that both packages read (PSNR and
SSIM at rtol 1e-5, LPIPS at rtol 1e-4: float32 convolutions in another
order); `evaluate_dirs` and its CLI; `compute_clip_directional` and
`EditSystem.compute_clip` with a deterministic fake embedder; the image
grid decoded against the JAX grid's pixels; `save_video` without
ffmpeg; `StepTimer`'s summary on injected times."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit import edit_system as jedit
from gaussianeditor_tpu.guidance.fake import FakeGuidance as JFakeGuidance
from gaussianeditor_tpu.train import metrics as jmetrics
from gaussianeditor_tpu.train.lpips_jax import random_weights, save_weights
from gaussianeditor_tpu.utils import clip_metrics as jclip
from gaussianeditor_tpu.utils import profiling as jprofiling
from gaussianeditor_tpu.utils import saving as jsaving
from gaussianeditor_tpu_torch.edit import edit_system
from gaussianeditor_tpu_torch.guidance.fake import FakeGuidance
from gaussianeditor_tpu_torch.train import metrics
from gaussianeditor_tpu_torch.utils import clip_metrics, profiling, saving
from tests.helpers import random_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_camera,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pairs(n=3, hw=(40, 36), seed=0):
    rng = np.random.RandomState(seed)
    preds = [rng.rand(*hw, 3).astype(np.float32) for _ in range(n)]
    gts = [np.clip(p + 0.1 * rng.randn(*hw, 3), 0, 1).astype(np.float32)
           for p in preds]
    return preds, gts


@pytest.fixture
def lpips_file(tmp_path):
    path = str(tmp_path / "lpips.npz")
    save_weights(path, random_weights(0))
    return path


def test_compute_image_metrics_matches_jax(lpips_file):
    preds, gts = _pairs()
    got = metrics.compute_image_metrics(preds, gts, lpips_file, device="cpu")
    want = jmetrics.compute_image_metrics(preds, gts, lpips_file)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=1e-4)


def test_lpips_is_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("GSEDIT_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    preds, gts = _pairs(1)
    got = metrics.compute_image_metrics(preds, gts, device="cpu")
    assert got["lpips"] is None and np.isfinite(got["psnr"])


def _write_dirs(tmp_path, preds, gts):
    rdir, gdir = tmp_path / "renders", tmp_path / "gt"
    rdir.mkdir(), gdir.mkdir()
    for i, (p, g) in enumerate(zip(preds, gts)):
        Image.fromarray((p * 255).astype(np.uint8)).save(rdir / f"{i:02d}.png")
        Image.fromarray((g * 255).astype(np.uint8)).save(gdir / f"{i:02d}.png")
    return str(rdir), str(gdir)


def test_evaluate_dirs_and_cli_match_jax(tmp_path, lpips_file):
    rdir, gdir = _write_dirs(tmp_path, *_pairs(2, seed=3))
    got = metrics.evaluate_dirs(rdir, gdir, lpips_file, device="cpu")
    want = jmetrics.evaluate_dirs(rdir, gdir, lpips_file)
    assert got["n_images"] == want["n_images"] == 2
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=1e-4)
    out = str(tmp_path / "m.json")
    metrics.main([rdir, gdir, "--out", out, "--lpips_weights", lpips_file,
                  "--device", "cpu"])
    assert json.load(open(out)) == got


def test_evaluate_dirs_errors(tmp_path):
    rdir, gdir = tmp_path / "r", tmp_path / "g"
    rdir.mkdir(), gdir.mkdir()
    with pytest.raises(ValueError, match="no images"):
        metrics.evaluate_dirs(str(rdir), str(gdir), device="cpu")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(rdir / "a.png")
    with pytest.raises(FileNotFoundError, match="missing ground truth"):
        metrics.evaluate_dirs(str(rdir), str(gdir), device="cpu")


class _FakeClip:
    """`tests/test_dataset_eval.py`'s deterministic embedder: image ->
    mean-colour features, text -> hash-derived vector."""

    def embed_image(self, image):
        img = np.asarray(image, np.float32)
        m = img.reshape(-1, 3).mean(0)
        return np.concatenate([m, m * m, [1.0]])

    def embed_text(self, text):
        import hashlib

        h = hashlib.sha256(text.encode()).digest()
        return np.frombuffer(h[:7], np.uint8).astype(np.float32) / 255.0


def test_clip_directional_matches_jax():
    origin, edited = _pairs(3, hw=(16, 16), seed=4)
    emb = _FakeClip()
    assert isinstance(emb, clip_metrics.ClipEmbedder)
    got = clip_metrics.compute_clip_directional(emb, origin, edited, "a",
                                                "b c")
    want = jclip.compute_clip_directional(emb, origin, edited, "a", "b c")
    assert got == want


def test_edit_system_compute_clip_matches_jax():
    js = random_scene(40, seed=5)
    jcams = jorbit_cameras(3, 4.0, 0.8, 0.8, 32, 32)
    kw = dict(prompt="x", batch_size=2, max_steps=1, densify_until_step=0,
              cameras_extent=2.0, max_instances=4096,
              clip_prompt_origin="a photo",
              clip_prompt_target="an autumn photo")
    jsys = jedit.EditSystem(js, jcams, jedit.EditConfig(**kw),
                            guidance=JFakeGuidance(), perceptual=None)
    tsys = edit_system.EditSystem(
        port_scene(js), [port_camera(c) for c in jcams],
        edit_system.EditConfig(**kw), guidance=FakeGuidance(),
        perceptual=None)
    jsys.on_fit_start()
    tsys.on_fit_start()
    got = tsys.compute_clip(embedder=_FakeClip())
    want = jsys.compute_clip(embedder=_FakeClip())
    assert set(got) == {"clip_similarity", "clip_directional"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    bare = edit_system.EditSystem(
        port_scene(js), [port_camera(c) for c in jcams],
        edit_system.EditConfig(max_instances=4096), guidance=FakeGuidance(),
        perceptual=None)
    with pytest.raises(AssertionError, match="clip_prompt"):
        bare.compute_clip(embedder=_FakeClip())


def test_clip_similarity_needs_the_clip_package():
    with pytest.raises(ImportError, match="openai-clip"):
        clip_metrics.TorchClipSimilarity(device="cpu")


def test_image_grid_decodes_to_the_jax_grid(tmp_path):
    rng = np.random.RandomState(0)
    imgs = [rng.rand(12, 10, 3).astype(np.float32) for _ in range(5)]
    imgs[2] = rng.rand(12, 10).astype(np.float32)     # grayscale
    imgs[3] = (rng.rand(12, 10, 3) * 255).astype(np.uint8)
    for cols in (None, 2):
        saving.save_image_grid(str(tmp_path / "t.png"), imgs, cols=cols)
        jsaving.save_image_grid(str(tmp_path / "j.png"), imgs, cols=cols)
        got = np.asarray(Image.open(tmp_path / "t.png"))
        want = np.asarray(Image.open(tmp_path / "j.png"))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    saving.save_image(str(tmp_path / "sub" / "one.png"), imgs[0])
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "sub" / "one.png")),
        saving._to_u8(imgs[0]))


def test_save_video_writes_a_gif_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(saving.shutil, "which", lambda name: None)
    rng = np.random.RandomState(1)
    frames = [rng.rand(9, 11, 3).astype(np.float32) for _ in range(4)]
    path = saving.save_video(str(tmp_path / "v" / "turn.mp4"), frames, fps=4)
    assert path == str(tmp_path / "v" / "turn.gif")
    with Image.open(path) as im:
        assert im.n_frames == 4 and im.size == (11, 9)
    assert saving.save_video(str(tmp_path / "w.gif"), frames) == str(
        tmp_path / "w.gif")


def test_step_timer_summary_matches_jax():
    times = {"step": [0.030, 0.010, 0.020, 0.050, 0.040],
             "densify": [0.2], "render": [0.001 * i for i in range(1, 12)]}
    t, j = profiling.StepTimer(), jprofiling.StepTimer()
    t.times = {k: list(v) for k, v in times.items()}
    j.times = {k: list(v) for k, v in times.items()}
    assert t.summary() == j.summary()
    with t.phase("live"):
        pass
    assert t.summary()["live"]["count"] == 1


