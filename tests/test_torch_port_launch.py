"""Port vs JAX: the command-line launcher (`apps/launch.py`).

Each of the four modes end to end with `device: cpu` and the trial
directory it promises; one recon config through both CLIs on one
workspace (no densify in range: the draws do not cross frameworks), the
two `last.ply` files held at `tests/test_torch_port_recon.py`'s
parameter bound and the losses of `metrics.jsonl` at rtol 1e-3;
--gradio, --resume, --validate and --test; the TensorBoard logger
without tensorboard; the guidance names whose adapters are not ported;
and no fallback to the CPU when the config names no device."""

import importlib
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from gaussianeditor_tpu.apps.launch import main as jlaunch_main
from gaussianeditor_tpu.train.lpips_jax import random_weights, save_weights
from gaussianeditor_tpu_torch.apps import launch
from gaussianeditor_tpu_torch.data.camera_scene import CamScene
from gaussianeditor_tpu_torch.models.ply import load_ply, save_ply
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
from tests.helpers import random_scene
from tests.test_data_config import _make_workspace
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_scene,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

jrender_mod = importlib.import_module("gaussianeditor_tpu.ops.render")
HW = 48


@pytest.fixture
def workspace(tmp_path):
    """A COLMAP workspace (4 views, 50 SfM points) with each view's
    render of a random scene as a PNG in images/."""
    ws = _make_workspace(tmp_path / "ws")
    sc = CamScene(ws, h=HW, w=HW, device="cpu")
    target = port_scene(random_scene(60, seed=5))
    os.makedirs(os.path.join(ws, "images"))
    for cam, name in zip(sc.cameras, sc.image_names):
        with torch.no_grad():
            im = render(target, cam, torch.zeros(3)).color.clamp(0, 1)
        Image.fromarray((im.numpy() * 255).astype(np.uint8)).save(
            os.path.join(ws, "images", os.path.splitext(name)[0] + ".png"))
    return ws


@pytest.fixture
def ply(tmp_path):
    path = str(tmp_path / "scene.ply")
    save_ply(port_scene(random_scene(60, seed=0, max_sh_degree=1)), path)
    return path


def _config(tmp_path, name, **cfg):
    cfg.setdefault("output_dir", str(tmp_path / ("out_" + name)))
    path = str(tmp_path / (name + ".yaml"))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg["output_dir"]


def _trial(out_dir):
    trials = os.listdir(out_dir)
    assert len(trials) == 1, trials
    return os.path.join(out_dir, trials[0])


def _rows(trial):
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


SMALL = dict(batch_size=2, per_editing_step=10, densify_until_step=0,
             max_instances=8192)
MODES = {
    "edit": (dict(guidance="fake", system=dict(prompt="make it blue",
                                               max_steps=3, **SMALL)),
             ["--train", "--validate", "--test", "--export"]),
    "del": (dict(system=dict(seg_prompt="the object", max_steps=3,
                             inpaint_scale=20.0, **SMALL)),
            ["--train", "--export"]),
    "add": (dict(system=dict(prompt="p", refine_steps=2,
                             bbox=[12, 12, 36, 36], **SMALL)),
            ["--train"]),
    "recon": (dict(sh_degree=1,
                   system=dict(max_steps=4, densify_from_step=2,
                               densification_interval=2,
                               densify_grad_threshold=1e-6,
                               opacity_reset_interval=3, oneup_sh_every=2,
                               max_instances=8192)),
              ["--train", "--test", "--export"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_runs_end_to_end(mode, tmp_path, workspace, ply, lpips_env):
    extra, flags = MODES[mode]
    cfg = dict(mode=mode, colmap_dir=workspace, height=HW, width=HW,
               device="cpu", n_val_views=2, test_views=2, **extra)
    if mode != "recon":
        cfg["gs_source"] = ply
    path, out = _config(tmp_path, mode, **cfg)
    launch.main(["--config", path, *flags])
    trial = _trial(out)
    for f in ("parsed.yaml", "cmd.txt", "code.zip", "metrics.jsonl",
              "last.ply"):
        assert os.path.exists(os.path.join(trial, f)), f
    with zipfile.ZipFile(os.path.join(trial, "code.zip")) as z:
        names = set(z.namelist())
    assert {"apps/launch.py", "csrc/forward_tile.cu",
            "native/simple_knn.cpp"} <= names
    rows = _rows(trial)
    n_steps = cfg["system"].get("max_steps", cfg["system"].get(
        "refine_steps"))
    assert [r["step"] for r in rows] == list(range(n_steps))
    assert np.isfinite([r["loss"] for r in rows]).all()
    assert load_ply(os.path.join(trial, "last.ply"), device="cpu").n_alive > 0
    if mode != "add":
        assert os.path.exists(os.path.join(trial, "progress"))
    if mode == "add":
        merged = load_ply(os.path.join(trial, "merged.ply"), device="cpu")
        assert int(merged.n_alive) == 60 + 2000
    if mode == "edit":
        with open(os.path.join(trial, "validation", "metrics.json")) as f:
            val = json.load(f)
        assert all(np.isfinite(val[k]) for k in ("psnr", "ssim", "lpips"))
        assert len([f for f in os.listdir(os.path.join(trial, "validation"))
                    if f.startswith("val_")]) == 2
    if mode in ("edit", "recon"):
        turn = [f for f in os.listdir(trial) if f.startswith("turntable")]
        assert turn == ["turntable.gif"]      # no ffmpeg here
        with Image.open(os.path.join(trial, "turntable.gif")) as im:
            assert im.n_frames == cfg["test_views"] and im.size == (HW, HW)
    if mode == "recon":
        assert any("n_split" in r for r in rows)


@pytest.fixture
def lpips_env(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips.npz")
    save_weights(path, random_weights(0))
    monkeypatch.setenv("GSEDIT_LPIPS_WEIGHTS", path)
    return path


def test_recon_cli_matches_jax_cli(tmp_path, workspace, monkeypatch):
    monkeypatch.setattr(jrender_mod, "default_impl", lambda: "pallas")
    system = dict(max_steps=6, oneup_sh_every=3, densify_from_step=10_000,
                  opacity_reset_interval=0, max_instances=8192, seed=2)
    cfg = dict(mode="recon", colmap_dir=workspace, height=HW, width=HW,
               capacity_multiplier=2, system=system)
    jpath, jout = _config(tmp_path, "jax", **cfg)
    tpath, tout = _config(tmp_path, "port", device="cpu", **cfg)
    jlaunch_main(["--config", jpath, "--train"])
    launch.main(["--config", tpath, "--train"])
    jt, tt = _trial(jout), _trial(tout)
    jrows, trows = _rows(jt), _rows(tt)
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == list(
        range(6))
    for j, t in zip(jrows, trows):
        for k in ("loss", "l1"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3, atol=1e-6,
                                       err_msg=k)
    js = load_ply(os.path.join(jt, "last.ply"), device="cpu")
    ts = load_ply(os.path.join(tt, "last.ply"), device="cpu")
    assert js.capacity == ts.capacity == 50
    lrs = GaussianAdam(config=OptimConfig()).group_lrs(0)
    lrs["xyz"] *= CamScene(workspace, h=HW, w=HW,
                           device="cpu").cameras_extent
    # the SfM init is isotropic, so the rotations' true gradient is zero
    # and each package's is rounding noise, which Adam turns into steps of
    # either sign: the rotations are held at one learning rate a step,
    # the rest at a tenth of one step
    for k in PARAMS:
        err = float((getattr(ts, k) - getattr(js, k)).detach().abs().max())
        bound = lrs[k] * (len(trows) if k == "quats" else 0.1)
        assert err <= bound, (k, err)


def _edit_cfg(tmp_path, name, workspace, ply, **system):
    return _config(tmp_path, name, mode="edit", gs_source=ply,
                   colmap_dir=workspace, height=HW, width=HW, device="cpu",
                   system=dict(prompt="p", **SMALL, **system))


def test_gradio_writes_logs_progress_and_the_scene(tmp_path, workspace, ply):
    path, out = _edit_cfg(tmp_path, "gradio", workspace, ply, max_steps=2)
    launch.main(["--config", path, "--train", "--gradio"])
    trial = _trial(out)
    for f in ("logs", "progress", "last.ply"):
        assert os.path.exists(os.path.join(trial, f)), f
    with open(os.path.join(trial, "progress")) as f:
        assert f.read().startswith("1/2 ")


def test_resume_continues_from_a_checkpoint(tmp_path, workspace, ply):
    path, out = _edit_cfg(tmp_path, "first", workspace, ply, max_steps=2,
                          checkpoint_every=2)
    launch.main(["--config", path, "--train"])
    ckpt = os.path.join(_trial(out), "ckpts", "state_000002.npz")
    assert os.path.exists(ckpt)
    path, out = _edit_cfg(tmp_path, "second", workspace, ply, max_steps=4)
    launch.main(["--config", path, "--train", "--resume", ckpt])
    assert [r["step"] for r in _rows(_trial(out))] == [2, 3]


@pytest.mark.parametrize("error", [ImportError, RuntimeError],
                         ids=["no_clip_package", "no_clip_weights"])
def test_validate_records_a_clip_failure(error, tmp_path, workspace, ply,
                                         lpips_env, monkeypatch):
    """Without the clip package, or with it and no weights (`clip.load`
    then raises), --validate writes `clip_error` beside the image metrics,
    as the JAX CLI does."""
    from gaussianeditor_tpu_torch.utils import clip_metrics

    def absent(*a, **k):
        raise error("CLIP unavailable")

    monkeypatch.setattr(clip_metrics, "TorchClipSimilarity", absent)
    path, out = _edit_cfg(tmp_path, "clip", workspace, ply, max_steps=1,
                          clip_prompt_origin="a scene",
                          clip_prompt_target="a blue scene")
    launch.main(["--config", path, "--validate"])
    with open(os.path.join(_trial(out), "validation", "metrics.json")) as f:
        val = json.load(f)
    assert val["clip_error"] == "CLIP unavailable"
    assert all(np.isfinite(val[k]) for k in ("psnr", "ssim", "lpips"))


def test_tensorboard_logger_writes_and_degrades(tmp_path, monkeypatch):
    tb = launch.TensorBoardLogger(str(tmp_path / "a"))
    assert tb.writer is not None
    tb(0, {"loss": 1.0, "skipme": object()})
    tb.close()
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "a" / "tb"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning, match="tensorboard unavailable"):
        tb = launch.TensorBoardLogger(str(tmp_path / "b"))
    assert tb.writer is None
    tb(0, {"loss": 1.0})
    tb.close()


@pytest.mark.parametrize("build,name", [
    (launch.build_guidance, "ip2p"),
    (launch.build_guidance, "controlnet"),
    (launch.build_guidance, "controlnet-depth"),
    (launch.build_segmentor, "langsam"),
    (launch.build_inpainter, "controlnet"),
    (launch.build_inpainter, "sdxl"),
], ids=lambda v: getattr(v, "__name__", v))
def test_unported_guidance_names_raise(build, name):
    args = (name, {}) if build is launch.build_guidance else (name,)
    with pytest.raises(ValueError, match="queue A: the guidance layer"):
        build(*args)
    with pytest.raises(ValueError, match="unknown"):
        build(*(("bogus",) + args[1:]))


def test_no_device_key_means_cuda_and_no_fallback(tmp_path, workspace, ply):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device exists")
    path, out = _config(tmp_path, "nodev", mode="edit", gs_source=ply,
                        colmap_dir=workspace, height=HW, width=HW,
                        system=dict(prompt="p", max_steps=1, **SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--config", path, "--train"])
