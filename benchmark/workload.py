"""Traffic drivers: the edit loop, the reconstruction loop and the web UI
with its viewer. Each builds the program from the cell's files and the
seed, runs its first steps as set-up, times the window, then frees the
program's state and holds what the program produced against the
reference (`reference.py`).

Which program call each driver times:
  * `edit`: `EditSystem.fit`, one call for the whole window, stopped at
    its deadline through `should_stop`; set-up is `on_fit_start` and the
    first `warm_steps` steps through the same `fit`.
  * `recon`: `ReconTrainer.fit(n_steps=1)` back to back from the
    traffic's `start_step`; set-up is the trainer and its first steps.
  * `webui`: the web UI's HTTP server in this process, a served edit
    started by `POST /edit`, and one viewer's closed loop of
    `GET /render` along a seeded orbit, client clock from send until the
    whole PNG is read.

A traffic file names its driver; `driver` finds it here or in a module
of `benchmark/ext/`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import http.client
import io
import json
import math
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import ext
from benchmark import reference as R
from benchmark import scene as S
from benchmark import tracing

WARM_STEPS = 3      # the steps the reference follows; set-up runs them
MAX_STEPS = 10 ** 9


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False      # the reference in TF32 in the program's place
    window: bool = True        # False: set-up and the check only


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[tracing.Trace] = None
    memory_peak: int = 0
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: List[dict] = dataclasses.field(default_factory=list)
    views_per_step: int = 1
    perceptual: str = "lpips"
    anchors: bool = False
    check_s: float = 0.0
    info: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the least seconds a step of work beyond what `counts.step_least_s`
    # counts (render, losses, Adam), for the `mfu` kind
    extra_least_s: float = 0.0
    spans: Optional[object] = None      # `spans.Spans` of a traced window


def percentile(values: list, q: float):
    """Nearest-rank percentile."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_seed(seed: int) -> int:
    """The seed the program's configs take (numpy's RandomState wants
    it below 2^32)."""
    return int(seed) % (1 << 31)


# --- the program's objects, from the benchmark's inputs ---

def program_scene(cfg: dict, params: Dict[str, torch.Tensor]):
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

    sc = cfg["scene"]
    return GaussianScene.create(
        params, max_sh_degree=int(sc["sh_degree"]),
        anchor_weight_init_g0=float(cfg.get("anchor_weight_init_g0", 0.05)),
        active_sh_degree=int(sc["sh_degree"]),
        alive=np.arange(int(sc["capacity"])) < int(sc["n_gaussians"]))


def program_cameras(poses: List[dict], device) -> list:
    from gaussianeditor_tpu_torch.core.cameras import lookat_camera

    return [lookat_camera(p["eye"], p["target"], p["up"], p["fovx"],
                          p["fovy"], p["height"], p["width"], device=device)
            for p in poses]


def targets(cfg: dict, seed: int, device) -> torch.Tensor:
    cam = cfg["cameras"]
    n = sum(int(r["count"]) for r in cam["rings"])
    return S.smooth_images(n, int(cam["height"]), int(cam["width"]),
                           int(cfg["targets"]["grid"]), seed, 1, device)


def reference_train(cfg: dict) -> dict:
    """The reference's rates and loss weights, from the configuration:
    an edit's `train` and `loss` blocks, or a reconstruction's `recon`
    block (unscaled rates; L1 and D-SSIM weighted by lambda_dssim)."""
    o = cfg["optim"]
    t = cfg.get("train") or cfg["recon"]

    def scaler(k):
        return float(t.get(k, 1.0))

    lr = dict(position_lr_init=o["position_lr_init"] * scaler("gs_lr_scaler"),
              position_lr_final=o["position_lr_final"]
              * scaler("gs_final_lr_scaler"),
              position_lr_max_steps=t["max_steps"],
              spatial_lr_scale=t["cameras_extent"],
              feature_lr=o["feature_lr"] * scaler("color_lr_scaler"),
              opacity_lr=o["opacity_lr"] * scaler("opacity_lr_scaler"),
              scaling_lr=o["scaling_lr"] * scaler("scaling_lr_scaler"),
              rotation_lr=o["rotation_lr"] * scaler("rotation_lr_scaler"))
    if "recon" in cfg:
        lam = float(cfg["recon"]["lambda_dssim"])
        return dict(lr=lr, lambda_l1=1.0 - lam, lambda_p=lam,
                    perceptual=cfg["perceptual"], anchor=None)
    loss = cfg["loss"]
    anchor = dict(color=loss["lambda_anchor_color"],
                  geo=loss["lambda_anchor_geo"],
                  scale=loss["lambda_anchor_scale"],
                  opacity=loss["lambda_anchor_opacity"],
                  weight_g0=cfg["anchor_weight_init_g0"])
    return dict(lr=lr, lambda_l1=loss["lambda_l1"],
                lambda_p=loss["lambda_p"], perceptual=cfg["perceptual"],
                anchor=anchor)


# --- what the program produced in its first steps ---

class Readings:
    """The program's losses, first gradient and change over the set-up
    steps, as the train state holds them: the gradient from Adam's first
    moment after one step (mu = (1 - beta1) g), the change against the
    parameters before the first step."""

    def __init__(self, params0: Dict[str, torch.Tensor]):
        self.p0 = params0
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}

    def record(self, state, metrics) -> None:
        self.losses.append(metrics["loss"].detach().clone())
        if len(self.losses) == 1:
            self.grad = {k: torch.linalg.vector_norm(m, dtype=torch.float64)
                         / 0.1 for k, m in state.opt_state.mu.items()}
        if len(self.losses) == WARM_STEPS:
            self.change = {k: torch.linalg.vector_norm(
                getattr(state.scene, k).detach() - v, dtype=torch.float64)
                for k, v in self.p0.items()}
            self.p0 = {}

    def values(self) -> tuple:
        return ([float(x) for x in self.losses],
                {k: float(v) for k, v in self.grad.items()},
                {k: float(v) for k, v in self.change.items()})


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[set] = None) -> float:
    """The worst leaf's gap between the two sides' norms, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def training_checks(prog: tuple, cell: Cell, picks: List[List[int]],
                    start_step: int, run: Run,
                    target_picks: Optional[List[List[int]]] = None) -> None:
    """Follow the first steps with the reference and compare: each
    step's loss, the first gradient's norms, the change's norms. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the change (they move by round-off alone).
    `picks` are the views of each step, `target_picks` the targets'
    indices (default: the views')."""
    t0 = time.perf_counter()
    cfg, dev, seed = cell.cfg, cell.device, cell.seed
    sc = cfg["scene"]
    n = int(sc["n_gaussians"])
    poses = S.camera_poses(cfg["cameras"])
    tg = targets(cfg, seed, dev)
    params = S.scene_params(sc, seed, dev)
    lw = S.lpips_weights(seed, dev) if cfg["perceptual"] == "lpips" else None
    p0 = {k: v[:n].clone() for k, v in params.items()}
    tpicks = picks if target_picks is None else target_picks

    def follow(tf32: bool) -> tuple:
        tr = R.Trainer(params, n, int(sc["sh_degree"]), reference_train(cfg),
                       lpips_w=lw)
        losses = [tr.step(start_step + s, [R.camera(poses[v], dev)
                                            for v in picks[s]],
                          tg[tpicks[s]], tf32=tf32)
                  for s in range(WARM_STEPS)]
        grad = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                for k, g in tr.first_grad.items()}
        change = {k: float(torch.linalg.vector_norm(tr.p[k] - p0[k],
                                                    dtype=torch.float64))
                  for k in p0}
        return (losses, grad, change), tr.work

    if prog is None:        # the control: the reference in TF32
        prog, _ = follow(True)
    ref, work = follow(False)
    run.work = work
    med = statistics.median(ref[1].values())
    keep = {k for k, v in ref[1].items() if v >= 1e-3 * med}
    run.checks["loss_gap"] = max(abs(a - b) / abs(b)
                                 for a, b in zip(prog[0], ref[0]))
    run.checks["grad_gap"] = norm_gap(prog[1], ref[1])
    run.checks["step_gap"] = norm_gap(prog[2], ref[2], keep)
    for k in ref[1]:
        run.info[f"grad_gap.{k}"] = norm_gap(prog[1], ref[1], {k})
        run.info[f"step_gap.{k}"] = norm_gap(prog[2], ref[2], {k})
    run.check_s = time.perf_counter() - t0


def control_picks(cfg: dict, seed: int, batch: int) -> List[List[int]]:
    n = sum(int(r["count"]) for r in cfg["cameras"]["rings"])
    rng = np.random.RandomState(program_seed(seed))
    return [[int(v) for v in rng.permutation(n)[:batch]]
            for _ in range(WARM_STEPS)]


WARM_SLOTS = 1 << 16


def warm_densify(scene, cfg: dict, seed: int, device) -> None:
    """Run the program's densify and prune once on a scene of the first
    `WARM_SLOTS` slots, half of them alive, with random accumulators, so
    that the kernels and library modules of the window's first densify
    event are loaded in set-up (no copy of the whole scene)."""
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.train.densify import (
        DensifyConfig,
        DensifyStats,
        densify_and_prune,
    )

    t = cfg["train"]
    C = min(WARM_SLOTS, scene.capacity)
    small = GaussianScene.create(
        {k: getattr(scene, k).detach()[:C].clone() for k in R.PARAMS},
        max_sh_degree=int(cfg["scene"]["sh_degree"]),
        anchor_weight_init_g0=float(cfg["anchor_weight_init_g0"]),
        active_sh_degree=int(cfg["scene"]["sh_degree"]),
        alive=np.arange(C) < C // 2)
    g = S.generator(seed, 998, device)
    f32 = dict(dtype=torch.float32, device=device)
    densify_and_prune(
        small,
        DensifyStats(torch.rand((C,), generator=g, **f32),
                     torch.ones((C,), **f32), torch.zeros((C,), **f32)),
        DensifyConfig(max_grad=t["densify_grad_threshold"],
                      max_densify_percent=t["max_densify_percent"],
                      min_opacity=t["min_opacity"],
                      max_screen_size=t["max_screen_size"],
                      percent_dense=cfg["optim"]["percent_dense"]),
        t["cameras_extent"], t["anchor_weight_init"],
        t["anchor_weight_multiplier"], noise=split_noise(C, seed, -1, device))


def free_program() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def timed(cell: Cell, run: Run, body: Callable[[float], int]) -> None:
    """Run `body(deadline)` (which returns the steps it completed) over
    the window, ended by a synchronize, under the profiler when
    traced."""
    with tracing.profiler() if cell.trace else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        run.steps = body(t0 + cell.seconds)
        sync(cell.device)
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        run.trace = tracing.Trace(prof)
    run.attempted = run.steps


def peak_memory(cell: Cell) -> int:
    if cell.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(cell.device))


# --- the edit loop ---

def edit(cell: Cell) -> Run:
    cfg, dev, seed = cell.cfg, cell.device, cell.seed
    run = Run(views_per_step=int(cfg["train"]["batch_size"]),
              perceptual="lpips", anchors=True)
    if cell.control:
        training_checks(None, cell, control_picks(
            cfg, seed, run.views_per_step), 0, run)
        return run
    from gaussianeditor_tpu_torch.edit.edit_system import (
        EditConfig,
        EditSystem,
    )
    from gaussianeditor_tpu_torch.train.lpips import lpips
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    scene = program_scene(cfg, S.scene_params(cfg["scene"], seed, dev))
    cams = program_cameras(S.camera_poses(cfg["cameras"]), dev)
    frames = targets(cfg, seed, dev).cpu().numpy()
    weights = S.lpips_weights(seed, dev)
    loss = {k: v for k, v in cfg["loss"].items()}
    system = EditSystem(
        scene, cams,
        EditConfig(**cfg["train"], loss=LossWeights(**loss),
                   anchor_weight_init_g0=cfg["anchor_weight_init_g0"],
                   seed=program_seed(seed)),
        guidance=None, perceptual=lambda p, t: lpips(weights, p, t))
    del scene
    system.on_fit_start()
    for v in range(len(frames)):
        system.edit_frames[v] = frames[v]
    del frames
    picks: List[List[int]] = []
    sample = system.sampler.sample
    system.sampler.sample = lambda bs=None: picks.append(sample(bs)) or \
        picks[-1]
    rd = Readings({k: getattr(system.state.scene, k).detach().clone()
                   for k in R.PARAMS})
    system.fit(n_steps=WARM_STEPS,
               callback=lambda s, m: rd.record(system.state, m))
    del system.sampler.sample
    prog = rd.values()
    warm_densify(system.state.scene, cfg, seed, dev)
    sync(dev)
    run.setup_s = time.perf_counter() - cell.t_start
    snap: Dict[str, dict] = {}
    if cell.window:
        dens = system.densify_step

        def densify_step(state, generator=None, noise=None):
            # the first densify event: the state before and after it
            if snap:
                return dens(state, generator=generator, noise=noise)
            snap["before"] = _densify_state(state)
            out = dens(state, generator=generator, noise=noise)
            snap["after"] = _densify_state(state)
            snap["noise"] = noise
            return out

        system.densify_step = densify_step
        cap = int(cfg["scene"]["capacity"])

        def body(deadline):
            n = [0]
            system.fit(n_steps=MAX_STEPS,
                       callback=lambda s, m: n.__setitem__(0, n[0] + 1),
                       should_stop=lambda: time.perf_counter() >= deadline,
                       densify_noise=lambda s: split_noise(cap, seed, s, dev))
            return n[0]

        timed(cell, run, body)
    run.memory_peak = peak_memory(cell)
    del system, weights
    free_program()
    training_checks(prog, cell, picks, 0, run)
    if snap:
        densify_checks(snap, cfg, run)
    return run


def split_noise(capacity: int, seed: int, step: int, device) -> tuple:
    """The two [C, 3] standard-normal split draws of the densify event
    after `step`, made from the seed."""
    g = S.generator(seed, 1000 + step, device)
    eps = torch.randn((2, capacity, 3), generator=g, dtype=torch.float32,
                      device=device)
    return eps[0], eps[1]


def _densify_state(state) -> dict:
    sc = state.scene
    return dict(p={k: getattr(sc, k).detach().clone() for k in R.PARAMS},
                alive=sc.alive.clone(), mask=sc.mask.clone(),
                accum=state.stats.xyz_gradient_accum.clone(),
                denom=state.stats.denom.clone())


def densify_checks(snap: dict, cfg: dict, run: Run) -> None:
    """The reference's densify and prune from the program's own state
    before the event, against the program's state after it: the alive
    set must be the same slot for slot."""
    t = cfg["train"]
    b = snap["before"]
    p, alive = R.densify(b["p"], b["alive"], b["mask"], b["accum"],
                         b["denom"], snap["noise"], dict(
                             max_densify_percent=t["max_densify_percent"],
                             percent_dense=cfg["optim"]["percent_dense"],
                             extent=t["cameras_extent"],
                             max_grad=t["densify_grad_threshold"],
                             min_opacity=t["min_opacity"]))
    a = snap["after"]
    run.checks["densify_alive_diff"] = float((a["alive"] != alive).sum())
    both = a["alive"] & alive
    run.info["densify_added"] = int(alive.sum() - b["alive"].sum())
    run.info["densify_param_gap"] = max(
        float((a["p"][k][both] - p[k][both]).abs().max()
              / torch.clamp_min(p[k][both].abs().max(), 1e-30)) for k in p)


# --- reconstruction ---

def recon(cell: Cell) -> Run:
    cfg, dev, seed = cell.cfg, cell.device, cell.seed
    start = int(cell.traffic["start_step"])
    run = Run(views_per_step=1, perceptual="ssim", anchors=False)
    if cell.control:
        training_checks(None, cell, control_picks(cfg, seed, 1), start, run)
        return run
    from gaussianeditor_tpu_torch.train.recon import ReconConfig, ReconTrainer

    scene = program_scene(cfg, S.scene_params(cfg["scene"], seed, dev))
    cams = program_cameras(S.camera_poses(cfg["cameras"]), dev)
    images = list(targets(cfg, seed, dev).cpu().numpy())
    trainer = ReconTrainer(scene, cams, images,
                           ReconConfig(**cfg["recon"],
                                       seed=program_seed(seed)))
    del scene, images
    trainer.state.step = start
    picks: List[List[int]] = []
    nxt = trainer._next_view
    trainer._next_view = lambda: picks.append([nxt()]) or picks[-1][0]
    rd = Readings({k: getattr(trainer.state.scene, k).detach().clone()
                   for k in R.PARAMS})
    for _ in range(WARM_STEPS):
        trainer.fit(n_steps=1,
                    callback=lambda s, m: rd.record(trainer.state, m))
    del trainer._next_view
    prog = rd.values()
    sync(dev)
    run.setup_s = time.perf_counter() - cell.t_start
    if cell.window:
        def body(deadline):
            n = 0
            while time.perf_counter() < deadline:
                trainer.fit(n_steps=1)
                n += 1
            return n

        timed(cell, run, body)
    run.memory_peak = peak_memory(cell)
    del trainer
    free_program()
    training_checks(prog, cell, picks, start, run)
    return run


# --- the web UI ---

class _Targets:
    """Guidance that hands out the benchmark's seeded targets in turn,
    one per first touch of a view (no diffusion weights here)."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.k = 0

    def __call__(self, rgb, cond_rgb, prompt):
        from gaussianeditor_tpu_torch.guidance.base import GuidanceOutput

        out = self.frames[self.k % len(self.frames)]
        self.k += 1
        return GuidanceOutput(edit_image=out)


def first_touch_targets(picks: List[List[int]], n: int) -> List[List[int]]:
    """The index of the target `_Targets` handed each view of `picks`:
    the edit asks the guidance for a view's target at its first touch,
    in the batch's order."""
    order: Dict[int, int] = {}
    for ids in picks:
        for v in ids:
            order.setdefault(v, len(order))
    return [[order[v] % n for v in ids] for ids in picks]


SCENE_KEYS = R.PARAMS + ("alive",)


def fingerprint(t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A scene version's float64 sums, one a tensor, on the device."""
    return torch.stack([t[k].detach().sum(dtype=torch.float64)
                        for k in SCENE_KEYS])


class _Served:
    """Hooks on the web UI's served edit and frames. The edit that
    `POST /edit` builds: the views its first steps drew, its readings
    (`Readings`), and the fingerprint of its scene at every published
    step. A frame: when `want` names the request in flight, a snapshot
    of the served scene it renders, taken in `_render`, under the
    state's lock."""

    def __init__(self, state):
        self.picks: List[List[int]] = []
        self.rd: Optional[Readings] = None
        self.fps: Dict[int, torch.Tensor] = {}
        self.snaps: Dict[int, Dict[str, torch.Tensor]] = {}
        self.want: Optional[int] = None
        fit_and_serve, render = state._fit_and_serve, state._render

        def hooked_fit_and_serve(system):
            self.rd = Readings({k: getattr(system.scene, k).detach().clone()
                                for k in R.PARAMS})
            sample, fit = system.sampler.sample, system.fit

            def hooked_sample(bs=None):
                out = sample(bs)
                if len(self.picks) < WARM_STEPS:
                    self.picks.append(out)
                return out

            def hooked_fit(callback=None, **kw):
                def cb(step, metrics):
                    callback(step, metrics)     # the server's: publish
                    if len(self.rd.losses) < WARM_STEPS:
                        self.rd.record(system.state, metrics)
                    sc = system.state.scene
                    self.fps[int(step)] = fingerprint(
                        {k: getattr(sc, k) for k in SCENE_KEYS})

                return fit(callback=cb, **kw)

            system.sampler.sample, system.fit = hooked_sample, hooked_fit
            return fit_and_serve(system)

        def hooked_render(cam, overlay):
            k = self.want
            if k is not None and k not in self.snaps:
                self.snaps[k] = {n: getattr(state.scene, n).detach().clone()
                                 for n in SCENE_KEYS}
            return render(cam, overlay)

        state._fit_and_serve, state._render = hooked_fit_and_serve, \
            hooked_render


def orbit(traffic: dict, seed: int, count: int) -> List[tuple]:
    """A viewer's drag along an orbit: (theta, phi, radius) per frame,
    theta and phi stepped by seeded normal draws, phi held in range."""
    o = traffic["orbit"]
    rng = np.random.RandomState(program_seed(seed) ^ 0x5EED)
    th = rng.uniform(0, 2 * math.pi)
    ph = float(o["phi0"])
    out = []
    for _ in range(count):
        th += rng.normal(*o["theta_step"])
        ph = float(np.clip(ph + rng.normal(0.0, o["phi_step_sd"]),
                           *o["phi_range"]))
        out.append((th, ph, float(o["radius"])))
    return out


def frame_marks(traffic: dict, seed: int, seconds: float) -> List[float]:
    """When, into the window, the frames compared are sent: the first
    request sent at or after each mark, the window's first and the rest
    drawn from the seed."""
    rng = np.random.RandomState(program_seed(seed) ^ 0xF8A3)
    return [0.0] + sorted(rng.uniform(0.0, 0.9 * seconds, int(
        traffic["check_frames"]) - 1).tolist())


class Viewer:
    """One HTTP client of the web UI, as the page's `refresh()` is."""

    def __init__(self, port: int, size: int):
        self.port, self.size = port, size

    def request(self, method: str, path: str, body: Optional[dict] = None,
                timeout: float = 120.0) -> bytes:
        c = http.client.HTTPConnection("127.0.0.1", self.port,
                                       timeout=timeout)
        try:
            data = None if body is None else json.dumps(body).encode()
            c.request(method, path, body=data)
            r = c.getresponse()
            out = r.read()
            if r.status != 200:
                raise OSError(f"{method} {path}: HTTP {r.status}")
            return out
        finally:
            c.close()

    def frame(self, pose: tuple) -> bytes:
        th, ph, r = pose
        return self.request("GET", f"/render?theta={th!r}&phi={ph!r}"
                            f"&radius={r!r}&size={self.size}&overlay=0")


def decode_png(data: Optional[bytes], size: int) -> Optional[np.ndarray]:
    from PIL import Image

    if data is None:
        return None
    try:
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, ValueError):
        return None
    return img if img.shape == (size, size, 3) else None


def frame_checks(frames: List[Optional[np.ndarray]],
                 refs: List[torch.Tensor], run: Run) -> None:
    """Level gaps between served frames and the reference's renders
    quantised as the server quantises them: the share of channel values
    a level or more off, a frame missing or not decoded counting all its
    values, and no frame compared a share of 1. The largest gap is
    `info` only: at a pixel whose Gaussians' culling or depth order turns
    on a last bit, sound runs read it as high as the TF32 control does,
    so it separates nothing."""
    off, total, worst = 0, 0, 0
    for got, ref in zip(frames, refs):
        want = (torch.clamp(ref, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        total += want.size
        if got is None:
            off += want.size
            worst = 255
            continue
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        off += int((d >= 1).sum())
        worst = max(worst, int(d.max()))
    run.checks["frame_off_share"] = off / total if total else 1.0
    run.info["frame_level_max"] = float(worst)


def lpips_npz_dir() -> str:
    """Where the web UI's LPIPS weights file goes: the run's TMPDIR, or
    the checkout's build directory."""
    d = os.environ.get("TMPDIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "tmp")
    os.makedirs(d, exist_ok=True)
    return d


def webui(cell: Cell) -> Run:
    cfg, tr, dev, seed = cell.cfg, cell.traffic, cell.device, cell.seed
    sc = cfg["scene"]
    n, deg = int(sc["n_gaussians"]), int(sc["sh_degree"])
    size = int(tr["size"])
    run = Run(views_per_step=int(cfg["train"]["batch_size"]),
              perceptual="lpips", anchors=True)

    def ref_pose(center, pose):
        th, ph, r = pose
        eye = center + r * np.array([math.cos(th) * math.cos(ph),
                                     math.sin(ph), math.sin(th) * math.cos(ph)])
        return dict(eye=eye, target=center, up=np.array([0.0, 1.0, 0.0]),
                    fovx=0.8, fovy=0.8, height=size, width=size)

    def ref_center():
        xyz = S.scene_params(sc, seed, dev)["xyz"][:n]
        return xyz.double().mean(0).cpu().numpy()

    if cell.control:
        training_checks(None, cell, control_picks(
            cfg, seed, run.views_per_step), 0, run)
        params = S.scene_params(sc, seed, dev)
        alive = torch.arange(int(sc["capacity"]), device=dev) < n
        center = ref_center()
        poses = orbit(tr, seed + 1, int(tr["check_frames"]))
        shots = [R.frame(params, alive, deg, ref_pose(center, p), dev,
                         tf32=True) for p in poses]
        got = [(torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()
               for x in shots]
        frame_checks(got, [R.frame(params, alive, deg, ref_pose(center, p),
                                   dev) for p in poses], run)
        run.checks["frame_version_miss"] = 0.0
        return run

    from gaussianeditor_tpu_torch.apps.webui import WebUIState, serve
    from gaussianeditor_tpu_torch.edit.edit_system import EditConfig
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    w = S.lpips_weights(seed, dev)
    path = os.path.join(lpips_npz_dir(), f"benchmark-lpips-{os.getpid()}.npz")
    np.savez(path, **{k: (v.permute(2, 3, 1, 0) if k.startswith("conv")
                          and k.endswith("_w") else v).cpu().numpy()
                      for k, v in w.items()})
    del w
    os.environ["GSEDIT_LPIPS_WEIGHTS"] = path
    scene = program_scene(cfg, S.scene_params(sc, seed, dev))
    warm_densify(scene, cfg, seed, dev)
    frames = targets(cfg, seed, dev).cpu().numpy()
    state = WebUIState(
        scene,
        program_cameras(S.camera_poses(cfg["cameras"]), dev),
        float(cfg["train"]["cameras_extent"]),
        guidance=_Targets(frames),
        edit_config=EditConfig(**cfg["train"],
                               loss=LossWeights(**cfg["loss"]),
                               anchor_weight_init_g0=cfg[
                                   "anchor_weight_init_g0"],
                               seed=program_seed(seed)))
    del scene
    served = _Served(state)
    server = serve(state, port=0, block=False)
    pngs: Dict[int, bytes] = {}
    poses = orbit(tr, seed, 100_000)
    try:
        viewer = Viewer(server.server_address[1], size)
        for p in poses[:2]:
            viewer.frame(p)
        viewer.request("POST", "/edit", {"prompt": tr["prompt"],
                                         "steps": int(cfg["train"]
                                                      ["max_steps"]),
                                         "mode": "edit"})

        def step():
            return state.last_metrics.get("step", -1)

        def next_step(after: float) -> tuple:
            s = step()
            while True:
                now = time.perf_counter()
                t = step()
                if t != s and now >= after:
                    return now, t
                if not state.training:
                    raise RuntimeError(f"the served edit ended: "
                                       f"{state.last_metrics}")
                s = t
                time.sleep(0.001)

        next_step(0.0)
        while step() < WARM_STEPS - 1:
            next_step(0.0)
        run.setup_s = time.perf_counter() - cell.t_start
        if cell.window:
            with (tracing.profiler() if cell.trace
                  else contextlib.nullcontext()) as prof:
                t_a, s_a = next_step(0.0)
                deadline = t_a + cell.seconds
                marks = frame_marks(tr, seed, cell.seconds)
                sent = [0]

                def client():
                    k, j = 2, 0
                    while time.perf_counter() < deadline:
                        t0 = time.perf_counter()
                        served.want = None
                        while j < len(marks) and t0 - t_a >= marks[j]:
                            j += 1
                            served.want = k
                        sent[0] += 1
                        try:
                            pngs[k] = viewer.frame(poses[k])
                            run.latencies_ms.append(
                                1e3 * (time.perf_counter() - t0))
                        except OSError:
                            run.failed += 1
                        k += 1
                    served.want = None

                th = threading.Thread(target=client)
                th.start()
                t_b, s_b = next_step(deadline)
                th.join()
                sync(dev)
            if prof is not None:
                run.trace = tracing.Trace(prof)
            run.window_s, run.steps = t_b - t_a, s_b - s_a
            run.attempted = sent[0]
        viewer.request("POST", "/stop", {})
        if not state.join(600):
            raise RuntimeError("the served edit did not stop")
        if served.rd is None or len(served.rd.losses) < WARM_STEPS:
            raise RuntimeError("the served edit's first steps were not seen")
        run.memory_peak = peak_memory(cell)
        fps = torch.stack([served.fps[s] for s in sorted(served.fps)]).cpu()
        prog, picks, snaps = served.rd.values(), served.picks, served.snaps
    finally:
        server.shutdown()
        server.server_close()
        os.remove(path)
    bad = sum(decode_png(p, size) is None for p in pngs.values())
    run.failed += bad
    run.checks["bad_frames"] = float(bad)
    del state, server, served
    free_program()
    training_checks(prog, cell, picks, 0, run,
                    target_picks=first_touch_targets(picks, len(frames)))
    if not cell.window:
        return run
    t0 = time.perf_counter()
    center = ref_center()
    got, refs, miss = [], [], 0
    for k in sorted(snaps):
        snap = snaps.pop(k)
        fp = fingerprint(snap).cpu()
        if not bool(torch.isclose(fps, fp, rtol=1e-12, atol=0.0)
                    .all(1).any()):
            miss += 1
        got.append(decode_png(pngs.get(k), size))
        refs.append(R.frame(snap, snap["alive"], deg,
                            ref_pose(center, poses[k]), dev))
        del snap
    frame_checks(got, refs, run)
    run.checks["frame_version_miss"] = float(miss)
    run.info["frames_compared"] = len(refs)
    run.check_s += time.perf_counter() - t0
    return run


DRIVERS = {"edit": edit, "recon": recon, "webui": webui}


def driver(name: str) -> Callable[[Cell], Run]:
    """The driver `name`, of `DRIVERS` or of a module of `benchmark/ext/`;
    `LookupError` for a name neither defines."""
    return ext.lookup("DRIVERS", name, DRIVERS)
