"""Command-line launcher for the four modes: edit, del, add and recon.

Counterpart of `gaussianeditor_tpu/apps/launch.py` (`build_guidance`,
`build_segmentor`, `build_inpainter`, `ProgressWriter`, `MetricsLogger`,
`TensorBoardLogger`, `_load_posed_images`, `main`):

    python -m gaussianeditor_tpu_torch.apps.launch --config cfg.yaml \
        [--train] [--validate] [--test] [--export] [--resume STATE.npz] \
        [--gradio] [key.path=value ...]

The config is the JAX CLI's (see its module docstring), with one more
key, `device` (default "cuda"): where the scene, the cameras and the
training live. Nothing moves to the CPU unless the config says so.
Each run writes a trial directory `<output_dir>/<YYYYmmdd-HHMMSS>/`:
`parsed.yaml`, `cmd.txt`, `code.zip` (the port's sources),
`metrics.jsonl`, `progress`, `logs` (with --gradio), `last.ply`,
`merged.ply` (add), `validation/` (--validate) and the turntable
(--test: `turntable.mp4` where ffmpeg is on the PATH, else
`turntable.gif`). The run ends by printing the wall time of its parts
in ms (set-up, training, validation, export, the turntable's renders and
its write) as a `timings: {...}` JSON line, and the process's launches
of each hand-written kernel as a `launches: {...}` line.

Guidance, segmentation and inpainting take the fakes of
`guidance/fake.py` ('fake') or the diffusion adapters of
`guidance/diffusers_adapters.py` (`ip2p`, `controlnet[-<type>]`,
`langsam`, and `controlnet` or `sdxl` as an inpainter) on the config's
device; those raise the JAX CLI's ImportError where diffusers (or
lang-segment-anything) is missing. Add takes the Wonder3D adapter with
`wonder3d_root` and the DPT depth estimator with `dpt: true`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
import warnings

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.config.config import load_config, parse_structured
from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.utils.profiling import StepTimer

def build_guidance(name: str, cfg: dict):
    """The JAX CLI's guidance by name: 'fake', 'ip2p' or
    'controlnet[-<control type>]'. The diffusion adapters run on the
    config's `device` unless `guidance_kwargs` names one; without
    diffusers they raise ImportError."""
    if name == "fake":
        from gaussianeditor_tpu_torch.guidance.fake import FakeGuidance

        return FakeGuidance()
    kwargs = {"device": cfg.get("device", "cuda"),
              **cfg.get("guidance_kwargs", {})}
    if name == "ip2p":
        from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
            InstructPix2PixGuidance,
        )

        return InstructPix2PixGuidance(**kwargs)
    if name.startswith("controlnet"):
        from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
            ControlNetGuidance,
        )

        control_type = name.split("-", 1)[1] if "-" in name else "p2p"
        return ControlNetGuidance(control_type=control_type, **kwargs)
    raise ValueError(f"unknown guidance '{name}'")


def build_segmentor(name: str, device="cuda"):
    if name == "fake":
        from gaussianeditor_tpu_torch.guidance.fake import FakeSegmentor

        return FakeSegmentor()
    if name == "langsam":
        from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
            LangSAMSegmentor,
        )

        return LangSAMSegmentor(device=str(device))
    raise ValueError(f"unknown segmentor '{name}'")


def build_inpainter(name: str, device="cuda"):
    if name == "fake":
        from gaussianeditor_tpu_torch.guidance.fake import FakeInpainter

        return FakeInpainter()
    if name == "controlnet":
        from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
            ControlNetInpainter,
        )

        return ControlNetInpainter(device=str(device))
    if name == "sdxl":
        from gaussianeditor_tpu_torch.guidance.diffusers_adapters import (
            SDXLInpainter,
        )

        return SDXLInpainter(device=str(device))
    raise ValueError(f"unknown inpainter '{name}'")


_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")


def _snapshot_code(trial_dir: str) -> None:
    """Zip the port's sources (Python, CUDA and C++) into
    <trial>/code.zip, the reference's CodeSnapshotCallback
    (threestudio/utils/callbacks.py:59-80); works outside a git
    checkout."""
    import zipfile

    try:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = os.path.join(trial_dir, "code.zip")
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            for root, _, files in os.walk(pkg_root):
                for fn in files:
                    if fn.endswith(_SOURCE_SUFFIXES):
                        p = os.path.join(root, fn)
                        z.write(p, os.path.relpath(p, pkg_root))
    except OSError as e:  # the snapshot is best-effort provenance
        warnings.warn(f"code snapshot failed: {e}")


class ProgressWriter:
    """File-based progress reporting (the reference's ProgressCallback
    for gradio, utils/callbacks.py:118-156): writes `step/total pct%` to
    <trial>/progress every `interval` steps."""

    def __init__(self, trial_dir: str, total: int, interval: int = 10):
        self.path = os.path.join(trial_dir, "progress")
        self.total = max(int(total), 1)
        self.interval = max(int(interval), 1)

    def __call__(self, step: int, metrics: dict) -> None:
        if step % self.interval == 0 or step + 1 == self.total:
            with open(self.path, "w") as f:
                f.write(f"{step}/{self.total} "
                        f"{100.0 * step / self.total:.1f}%\n")


class MetricsLogger:
    """JSON-lines metrics logger (the reference's CSVLogger role): one
    row per step of every metric that converts to a float."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.f = open(os.path.join(out_dir, "metrics.jsonl"), "a")

    def __call__(self, step: int, metrics: dict) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                pass
        self.f.write(json.dumps(row) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


class TensorBoardLogger:
    """TensorBoard scalar logger behind the same callback interface (the
    reference's TensorboardLogger, launch.py:110-169). Without
    tensorboard it warns and logs nothing."""

    def __init__(self, out_dir: str):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(os.path.join(out_dir, "tb"))
        except ImportError as e:  # logging must never kill training
            warnings.warn(f"tensorboard unavailable ({e}); TB logging off")

    def __call__(self, step: int, metrics: dict) -> None:
        if self.writer is None:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self) -> None:
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()


def _load_posed_images(img_dir: str, scene_cams) -> list:
    """The COLMAP-registered training images at each camera's size
    (resized bilinearly where it differs), float32 [H, W, 3] in [0, 1];
    the reference's `scene/dataset_readers.py` PIL load and resize."""
    from PIL import Image

    images = []
    for cam, name in zip(scene_cams.cameras, scene_cams.image_names):
        path = os.path.join(img_dir, name)
        if not os.path.exists(path):
            stem = os.path.splitext(name)[0]
            for ext in (".png", ".jpg", ".jpeg", ".JPG", ".PNG"):
                if os.path.exists(os.path.join(img_dir, stem + ext)):
                    path = os.path.join(img_dir, stem + ext)
                    break
            else:
                raise FileNotFoundError(
                    f"training image {name} not found under {img_dir}")
        with Image.open(path) as f:
            im = np.asarray(f)
        if im.dtype != np.uint8:
            im = np.clip(im, 0, 255).astype(np.uint8)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        im = im[..., :3]
        if im.shape[:2] != (cam.height, cam.width):
            im = np.asarray(Image.fromarray(im).resize(
                (cam.width, cam.height), Image.BILINEAR))
        images.append(im.astype(np.float32) / 255.0)
    return images


@contextlib.contextmanager
def _timed(timer: StepTimer, name: str, device: torch.device):
    """`timer.phase(name)`, the device synchronised before it ends."""
    with timer.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _build_system(mode: str, cfg: dict, sys_cfg: dict, scene, scene_cams,
                  images, trial_dir: str, device: torch.device):
    """The mode's system (Add's `run()` done and its merged scene saved);
    `images` are recon's posed images."""
    from gaussianeditor_tpu_torch.models.ply import save_ply

    if mode == "edit":
        from gaussianeditor_tpu_torch.edit.edit_system import (
            EditConfig,
            EditSystem,
        )

        return EditSystem(
            scene, scene_cams.cameras, parse_structured(EditConfig, sys_cfg),
            guidance=build_guidance(cfg.get("guidance", "fake"), cfg),
            segmentor=build_segmentor(cfg.get("segmentor", "fake"), device)
            if sys_cfg.get("seg_prompt") else None,
        )
    if mode == "del":
        from gaussianeditor_tpu_torch.edit.del_system import (
            DelConfig,
            DelSystem,
        )

        return DelSystem(
            scene, scene_cams.cameras, parse_structured(DelConfig, sys_cfg),
            inpainter=build_inpainter(cfg.get("inpainter", "fake"), device),
            segmentor=build_segmentor(cfg.get("segmentor", "fake"), device),
        )
    if mode == "add":
        from gaussianeditor_tpu_torch.edit.add_system import (
            AddConfig,
            AddSystem,
        )

        if cfg.get("wonder3d_root"):
            # a Wonder3D checkout: the three-stage subprocess pipeline
            # (GassuianEditorAdd.py:121-157)
            from gaussianeditor_tpu_torch.edit.wonder3d_adapter import (
                Wonder3DGenerator,
            )

            generator = Wonder3DGenerator(
                wonder3d_root=cfg["wonder3d_root"],
                cache_dir=os.path.join(trial_dir, "add_cache"),
                refine_prompt=str(cfg.get("refine_prompt", "")),
                device=str(device),
            )
        else:
            from gaussianeditor_tpu_torch.guidance.fake import (
                FakeObjectGenerator,
            )

            generator = FakeObjectGenerator(device=device)
        depth_est = None
        if cfg.get("dpt", False):
            from gaussianeditor_tpu_torch.edit.dpt_adapter import (
                DPTDepthEstimator,
            )

            depth_est = DPTDepthEstimator(
                pretrained=cfg.get("dpt_checkpoint",
                                   "Intel/dpt-hybrid-midas"),
                device=device)
        system = AddSystem(
            scene, scene_cams.cameras, parse_structured(AddConfig, sys_cfg),
            inpainter=build_inpainter(cfg.get("inpainter", "fake"), device),
            object_generator=generator,
            depth_estimator=depth_est,
        )
        merged = system.run()
        save_ply(merged, os.path.join(trial_dir, "merged.ply"))
        return system
    if mode == "recon":
        # vanilla 3DGS reconstruction from a COLMAP workspace and its
        # posed images (the reference's gaussiansplatting/train.py)
        from gaussianeditor_tpu_torch.train.recon import (
            ReconConfig,
            ReconTrainer,
        )

        return ReconTrainer(scene, scene_cams.cameras, images,
                            parse_structured(ReconConfig, sys_cfg))
    raise ValueError(f"unknown mode '{mode}'")


def _validate(system, cfg: dict, trial_dir: str, device) -> None:
    """Validation grids (origin | target | render) over linspaced views
    and a metrics JSON (GassuianEditor.validation_step,
    GassuianEditor.py:283-345)."""
    from gaussianeditor_tpu_torch.data.view_dataset import select_val_views
    from gaussianeditor_tpu_torch.train.metrics import compute_image_metrics
    from gaussianeditor_tpu_torch.utils.saving import save_image_grid

    if system.state is None:
        system.on_fit_start()
    val_dir = os.path.join(trial_dir, "validation")
    os.makedirs(val_dir, exist_ok=True)
    val_views = select_val_views(system.sampler.views,
                                 int(cfg.get("n_val_views", 8)))
    preds, targets = [], []
    for vid in val_views:
        system._refresh_targets([vid], int(system.state.step))
        rendered = system._render_cache(system.state.scene,
                                        system.cameras[vid]).cpu().numpy()
        origin = system.origin_frames[vid]
        target = system.edit_frames.get(vid, origin)
        preds.append(rendered)
        targets.append(target)
        save_image_grid(os.path.join(val_dir, f"val_{vid:03d}.png"),
                        [origin, target, rendered])
    metrics_out = compute_image_metrics(preds, targets, device=device)
    if system.cfg.clip_prompt_origin and system.cfg.clip_prompt_target:
        try:
            metrics_out.update(system.compute_clip())
        except Exception as e:  # the clip package or its weights absent
            metrics_out["clip_error"] = str(e)
    with open(os.path.join(val_dir, "metrics.json"), "w") as f:
        json.dump(metrics_out, f, indent=2)
    print(f"validation metrics: {metrics_out}")


def _turntable(final_scene, n_views: int, radius: float, h: int, w: int,
               trial_dir: str, timer: StepTimer, device) -> str:
    """Render an orbit of `n_views` around the alive centres and write it
    (`save_video`); returns the path written."""
    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.utils.saving import save_video

    with _timed(timer, "test_render", device), torch.no_grad():
        xyz = final_scene.xyz.detach()[final_scene.alive]
        center = xyz.mean(dim=0).cpu().numpy().astype(np.float64)
        cams = orbit_cameras(n_views, radius=radius, fovx=0.8, fovy=0.8,
                             height=h, width=w, center=center, device=device)
        bg = torch.zeros(3, device=device)
        frames = [render(final_scene, c, bg).color.cpu().numpy()
                  for c in cams]
    with _timed(timer, "test_write", device):
        return save_video(os.path.join(trial_dir, "turntable.mp4"), frames)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true",
                        help="save validation image grids + metrics JSON")
    parser.add_argument("--test", action="store_true",
                        help="render a turntable video of the result")
    parser.add_argument("--export", action="store_true",
                        help="save the resulting scene as PLY")
    parser.add_argument("--resume", default="",
                        help="TrainState .npz to resume training from "
                             "(edit and del)")
    parser.add_argument("--gradio", action="store_true",
                        help="headless-frontend mode: logs to <trial>/logs, "
                             "progress to <trial>/progress, and the scene "
                             "is exported after training")
    parser.add_argument("overrides", nargs="*", help="key.path=value")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    mode = cfg.get("mode", "edit")
    device = resolve_device(cfg.get("device", "cuda"))
    out_dir = cfg.get("output_dir", "outputs/trial")
    trial_dir = os.path.join(out_dir, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(trial_dir, exist_ok=True)
    log_handler = None
    if args.gradio:
        # a frontend polls <trial>/progress and tails <trial>/logs, and
        # picks up the exported scene (reference launch.py:123-126,
        # :195-197)
        log_handler = logging.FileHandler(os.path.join(trial_dir, "logs"))
        log_handler.setLevel(logging.INFO)
        logging.getLogger().addHandler(log_handler)
        args.export = args.export or args.train
    try:
        _run(args, cfg, mode, device, trial_dir)
    finally:
        if log_handler is not None:
            logging.getLogger().removeHandler(log_handler)
            log_handler.close()


def _run(args, cfg: dict, mode: str, device: torch.device,
         trial_dir: str) -> None:
    import yaml

    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import (
        load_ply,
        ply_vertex_count,
        save_ply,
    )

    with open(os.path.join(trial_dir, "parsed.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(trial_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    _snapshot_code(trial_dir)
    timer = StepTimer()

    # height/width may be lists with resolution_milestones (the
    # reference's data block, gs_load.py:174-208): the cameras are built
    # at the first size; the edit system steps through the schedule
    hs, ws = cfg.get("height", 512), cfg.get("width", 512)
    h_list = hs if isinstance(hs, (list, tuple)) else [hs]
    w_list = ws if isinstance(ws, (list, tuple)) else [ws]
    h, w = int(h_list[0]), int(w_list[0])
    with _timed(timer, "cameras", device):
        scene_cams = CamScene(cfg["colmap_dir"], h=h, w=w, device=device)
    cap_mult = float(cfg.get("capacity_multiplier", 4))
    with _timed(timer, "scene", device):
        if cfg.get("gs_source"):
            n_pts = ply_vertex_count(cfg["gs_source"])
            scene = load_ply(cfg["gs_source"], capacity=int(n_pts * cap_mult),
                             device=device)
        else:
            xyz, rgb = scene_cams.load_points()
            scene = GaussianScene.from_points(
                xyz, rgb, max_sh_degree=int(cfg.get("sh_degree", 3)),
                capacity=int(len(xyz) * cap_mult), device=device,
            )

    logger = MetricsLogger(trial_dir)
    sys_cfg = dict(cfg.get("system", {}))
    sys_cfg.setdefault("cameras_extent", scene_cams.cameras_extent)
    if len(h_list) > 1 and mode == "edit":
        # the reference-style data schedule, into the edit system
        sys_cfg.setdefault("heights", [int(x) for x in h_list])
        sys_cfg.setdefault("widths", [int(x) for x in w_list])
        sys_cfg.setdefault("resolution_milestones",
                           list(cfg.get("resolution_milestones", [])))
        if isinstance(sys_cfg.get("batch_size"), (list, tuple)):
            bs_list = list(sys_cfg["batch_size"])
            sys_cfg["batch_size"] = int(bs_list[0])
            sys_cfg.setdefault("batch_sizes", [int(x) for x in bs_list])

    images = None
    if mode == "recon":
        with _timed(timer, "images", device):
            images = _load_posed_images(
                os.path.join(cfg["colmap_dir"],
                             cfg.get("images_subdir", "images")),
                scene_cams)
    with _timed(timer, "system", device):
        system = _build_system(mode, cfg, sys_cfg, scene, scene_cams,
                               images, trial_dir, device)

    with _timed(timer, "train", device):
        if args.train and mode in ("edit", "del"):
            if not system.cfg.checkpoint_dir:
                system.cfg.checkpoint_dir = os.path.join(trial_dir, "ckpts")
            if args.resume:
                system.resume(args.resume)
            progress = ProgressWriter(trial_dir, system.cfg.max_steps)
            tb = (TensorBoardLogger(trial_dir)
                  if cfg.get("tensorboard", False) else None)

            def _cb(step, metrics):
                logger(step, metrics)
                progress(step, metrics)
                if tb is not None:
                    tb(step, metrics)

            remaining = system.cfg.max_steps - (
                int(system.state.step) if system.state is not None else 0)
            system.fit(n_steps=max(remaining, 0), callback=_cb)
            if tb is not None:
                tb.close()
        elif args.train and mode == "add" and system.cfg.refine_steps > 0:
            from gaussianeditor_tpu_torch.guidance.fake import FakeGuidance

            system.guidance = FakeGuidance()
            system.fit(n_steps=system.cfg.refine_steps, callback=logger)
        elif args.train and mode == "recon":
            progress = ProgressWriter(trial_dir, system.cfg.max_steps)

            def _rcb(step, metrics):
                logger(step, metrics)
                progress(step, metrics)

            system.fit(callback=_rcb)
    logger.close()
    final_scene = system.scene

    if args.validate and mode in ("edit", "del"):
        with _timed(timer, "validate", device):
            _validate(system, cfg, trial_dir, device)

    if args.export or args.train:
        path = os.path.join(trial_dir, "last.ply")
        with _timed(timer, "export", device):
            save_ply(final_scene, path)
        print(f"saved {path}")

    if args.test:
        written = _turntable(final_scene, int(cfg.get("test_views", 60)),
                             scene_cams.cameras_extent, h, w, trial_dir,
                             timer, device)
        print(f"saved {written}")
    print("timings: " + json.dumps(
        {k: v["mean_ms"] for k, v in timer.summary().items()}))
    print("launches: " + json.dumps(_kernels.launch_counts()))


if __name__ == "__main__":
    main()
