"""Edit system: the instruction-driven editing loop.

Counterpart of `gaussianeditor_tpu/edit/edit_system.py` (`EditConfig`,
`make_optimizer`, `ViewSampler`, `EditSystem`). Guidance and segmentation
run on the host over numpy images; rendering, losses, backward, Adam and
densification run on the scene's device through `train.trainer`'s
`make_train_step` and `make_densify_step`.

What differs from the JAX system:
  * State. The port's train step updates its state in place, so the
    system never trains the caller's scene: tracing masks a copy, and the
    train state holds its own copy. `self.scene` stays the scene the
    origin frames are rendered from (masked, otherwise untouched) until
    `fit` returns, when it becomes a copy of the trained scene, as the
    JAX system's does.
  * Densify draws. The split noise comes from a `torch.Generator` on the
    scene's device seeded with `cfg.seed` at construction; like the JAX
    key, `resume` does not restore it. `fit(densify_noise=...)` injects
    the draws instead (tests hand both packages JAX's numbers).
  * One loop. `dispatch_burst > 1` (the JAX package's device-program
    bursts) runs the per-step loop, with a warning.
  * Host traffic per step: the target upload, the train step's
    `num_rendered` reads, and one device-to-host copy for each view whose
    target is refreshed (span `guidance.refresh`, rid: the view). The
    overflow flag is read once, after the loop.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import functools
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gaussianeditor_tpu_torch.config.config import C
from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.data.view_dataset import select_train_views
from gaussianeditor_tpu_torch.edit.tracing import update_mask_from_views
from gaussianeditor_tpu_torch.guidance.base import Guidance, Segmentor
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
)
from gaussianeditor_tpu_torch.train.densify import DensifyConfig
from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
from gaussianeditor_tpu_torch.train.trainer import (
    LossWeights,
    TrainState,
    init_train_state,
    make_densify_step,
    make_train_step,
    upload_images,
)
from gaussianeditor_tpu_torch.utils.profiling import span, sync

_WEIGHT_FIELDS = ("lambda_l1", "lambda_p", "lambda_anchor_color",
                  "lambda_anchor_geo", "lambda_anchor_scale",
                  "lambda_anchor_opacity")


@dataclasses.dataclass
class EditConfig:
    """The JAX package's `EditConfig`, field for field, so that
    `configs/edit.yaml`'s `system` block loads into either."""

    prompt: str = ""
    seg_prompt: str = ""            # empty -> no semantic tracing
    # CLIP directional-eval prompts (compute_clip)
    clip_prompt_origin: str = ""
    clip_prompt_target: str = ""
    local_edit: bool = False        # train/render only the masked region
    mask_thres: float = 0.5
    batch_size: int = 2
    max_steps: int = 1500
    per_editing_step: int = 10
    edit_begin_step: int = 0
    edit_until_step: int = 1000
    densify_until_step: int = 1300
    densification_interval: int = 100
    densify_grad_threshold: float = 0.01
    max_densify_percent: float = 0.01
    min_opacity: float = 0.005
    max_screen_size: float = 5.0
    anchor_weight_init_g0: float = 0.05
    anchor_weight_init: float = 0.1
    anchor_weight_multiplier: float = 1.3
    # seeded training-view subset size; None or >= len(cameras) trains on
    # every view
    max_view_num: Optional[int] = None
    # progressive resolution: at global step resolution_milestones[i] the
    # render size steps to (heights[i+1], widths[i+1]) and the batch to
    # batch_sizes[i+1]; index 0 of each list is the pre-milestone value.
    # Empty lists = the cameras' own size. Cached origin and edited frames
    # are dropped on a size change and regenerate lazily.
    resolution_milestones: List[int] = dataclasses.field(
        default_factory=list)
    heights: List[int] = dataclasses.field(default_factory=list)
    widths: List[int] = dataclasses.field(default_factory=list)
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    # learning-rate scalers of OptimConfig's defaults
    gs_lr_scaler: float = 3.0
    gs_final_lr_scaler: float = 2.0
    color_lr_scaler: float = 3.0
    opacity_lr_scaler: float = 2.0
    scaling_lr_scaler: float = 2.0
    rotation_lr_scaler: float = 2.0
    cameras_extent: float = 1.0     # spatial_lr_scale
    seed: int = 0
    # periodic TrainState checkpoints: 0 = off
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    # refresh edited targets on one worker thread while training goes
    # on; a refresh lands one interval late, and a view's first target is
    # always generated before its first step
    async_guidance: bool = False
    # the JAX package's multi-step device programs; the port runs the
    # per-step loop whatever this says (values > 1 warn)
    dispatch_burst: int = 1
    # renderer knobs: the instance budget; tile_cap and chunk are the JAX
    # package's and are accepted for its configs (the port walks whole
    # tiles)
    max_instances: Optional[int] = None
    tile_cap: int = 1024
    chunk: int = 128


def make_optimizer(cfg: EditConfig) -> GaussianAdam:
    base = OptimConfig()
    oc = OptimConfig(
        position_lr_init=base.position_lr_init * cfg.gs_lr_scaler,
        position_lr_final=base.position_lr_final * cfg.gs_final_lr_scaler,
        position_lr_max_steps=cfg.max_steps,
        feature_lr=base.feature_lr * cfg.color_lr_scaler,
        opacity_lr=base.opacity_lr * cfg.opacity_lr_scaler,
        scaling_lr=base.scaling_lr * cfg.scaling_lr_scaler,
        rotation_lr=base.rotation_lr * cfg.rotation_lr_scaler,
        spatial_lr_scale=cfg.cameras_extent,
    )
    return GaussianAdam(config=oc)


class ViewSampler:
    """Without-replacement refilling camera stack; `max_view_num`
    restricts training to a seeded view subset."""

    def __init__(self, n_views: int, batch_size: int, seed: int = 0,
                 max_view_num: Optional[int] = None):
        self.batch = batch_size
        if max_view_num is not None and max_view_num < n_views:
            self.views = select_train_views(n_views, max_view_num, seed)
        else:
            self.views = list(range(n_views))
        self.n = len(self.views)
        self.rng = np.random.RandomState(seed)
        self._stack: List[int] = []

    def sample(self, batch_size: Optional[int] = None) -> List[int]:
        out = []
        for _ in range(batch_size if batch_size is not None else self.batch):
            if not self._stack:
                self._stack = [self.views[i]
                               for i in self.rng.permutation(self.n)]
            out.append(int(self._stack.pop()))
        return out


class EditSystem:
    def __init__(
        self,
        scene: GaussianScene,
        cameras: Sequence[Camera],
        config: EditConfig,
        guidance: Optional[Guidance],
        segmentor: Optional[Segmentor] = None,
        perceptual: object = "auto",
        sds_guidance: Optional[Callable] = None,
        dds_guidance: Optional[Callable] = None,
        dds_prompts: Optional[tuple] = None,
    ):
        self.scene = scene
        self.cameras = list(cameras)
        if config.prompt.startswith("lib:"):
            # "lib:keyword_keyword" prompt-library lookup
            from gaussianeditor_tpu_torch.guidance.prompts import (
                resolve_prompt,
            )

            config = dataclasses.replace(
                config, prompt=resolve_prompt(config.prompt))
        self.cfg = config
        # the primary guidance makes edited targets; None trains on the
        # score callables only (targets fall back to the origin renders)
        self.guidance = guidance
        # score slots: (renders [B,H,W,3], origins, prompt(s), step=) ->
        # (image gradient [B,H,W,3], info), numpy on the host, weighted
        # by cfg.loss.lambda_sds and lambda_dds
        self.sds_guidance = sds_guidance
        self.dds_guidance = dds_guidance
        self.dds_prompts = dds_prompts or (config.prompt, "")
        self.segmentor = segmentor
        if perceptual == "auto":
            # LPIPS when converted weights exist, else the proxy (warns)
            from gaussianeditor_tpu_torch.train.lpips import make_perceptual

            perceptual = make_perceptual()
        self.perceptual = perceptual
        self.optim = make_optimizer(config)
        self._with_inject = (
            sds_guidance is not None or dds_guidance is not None
        )
        self.train_step = make_train_step(
            self.optim, config.loss, perceptual=self.perceptual,
            local_edit=config.local_edit, with_inject=self._with_inject,
            max_instances=config.max_instances,
        )
        self.densify_step = make_densify_step(
            self.optim,
            DensifyConfig(
                max_grad=config.densify_grad_threshold,
                max_densify_percent=config.max_densify_percent,
                min_opacity=config.min_opacity,
                max_screen_size=config.max_screen_size,
                percent_dense=OptimConfig().percent_dense,
            ),
            config.cameras_extent,
            config.anchor_weight_init,
            config.anchor_weight_multiplier,
        )
        self.sampler = ViewSampler(len(self.cameras), config.batch_size,
                                   config.seed,
                                   max_view_num=config.max_view_num)
        # progressive resolution: the base cameras keep their own size,
        # self.cameras carries the schedule's current size
        self._base_cameras = list(self.cameras)
        self._cur_hw: Optional[tuple] = None
        if config.resolution_milestones and not (
                len(config.heights) == len(config.widths)
                == len(config.resolution_milestones) + 1):
            raise ValueError("need len(heights) == len(widths) == "
                             "len(resolution_milestones) + 1")
        self._apply_resolution(0)
        self.origin_frames: Dict[int, np.ndarray] = {}
        self.edit_frames: Dict[int, np.ndarray] = {}
        self._pending_targets: Dict[int, object] = {}
        self._guidance_pool = None
        self.state: Optional[TrainState] = None
        self.generator = torch.Generator(
            device=scene.device).manual_seed(config.seed)
        if config.dispatch_burst > 1:
            warnings.warn(
                f"dispatch_burst={config.dispatch_burst}: the port runs the "
                "per-step loop (one train step per call, a callback every "
                "step); bursts are the JAX package's device programs")

    @torch.no_grad()
    def _render_cache(self, scene, cam: Camera) -> torch.Tensor:
        """The color render [H, W, 3] of `scene`, left on the device."""
        dev = scene.device
        return render(scene, cam, torch.zeros(3, device=dev),
                      max_instances=self.cfg.max_instances).color

    # --- progressive resolution ---

    def _res_at(self, step: int) -> tuple:
        """(height, width, batch_size) for a global step, bisecting the
        milestone list."""
        cfg = self.cfg
        if not cfg.resolution_milestones:
            if cfg.heights:  # fixed override of the camera size
                return cfg.heights[0], cfg.widths[0], cfg.batch_size
            c = self._base_cameras[0]
            return c.height, c.width, cfg.batch_size
        i = bisect.bisect_right([-1] + list(cfg.resolution_milestones),
                                step) - 1
        bs = (cfg.batch_sizes[i] if cfg.batch_sizes else cfg.batch_size)
        return cfg.heights[i], cfg.widths[i], bs

    def _apply_resolution(self, step: int) -> int:
        """Step the camera resolution for `step`; returns the batch size.
        A size change drops the per-view frame caches (rendered at the old
        size): origin renders regenerate lazily, edited targets at the
        next touch."""
        h, w, bs = self._res_at(step)
        if self._cur_hw != (h, w):
            if self._cur_hw is not None:
                self.origin_frames.clear()
                self.edit_frames.clear()
                self._pending_targets.clear()
            self.cameras = [c.rescale(h, w) for c in self._base_cameras]
            self._cur_hw = (h, w)
        return bs

    # --- setup ---

    def render_all_views(self) -> Dict[int, np.ndarray]:
        """Render and cache the origin frame of every view."""
        for i, cam in enumerate(self.cameras):
            if i not in self.origin_frames:
                self.origin_frames[i] = self._render_cache(
                    self.scene, cam).cpu().numpy()
        return self.origin_frames

    def _origin_frame(self, vid: int) -> np.ndarray:
        """Origin render of one view, regenerated lazily after a
        resolution change (self.scene at the current size)."""
        if vid not in self.origin_frames:
            self.origin_frames[vid] = self._render_cache(
                self.scene, self.cameras[vid]).cpu().numpy()
        return self.origin_frames[vid]

    def update_mask(self) -> None:
        """Semantic tracing with the segmentor over every view's origin
        frame; the mask and the anchor go into a copy of the scene."""
        assert self.segmentor is not None
        self.render_all_views()
        masks = [
            self.segmentor(self.origin_frames[i], self.cfg.seg_prompt)
            for i in range(len(self.cameras))
        ]
        scene, _ = update_mask_from_views(
            copy.deepcopy(self.scene), self.cameras, masks,
            self.cfg.mask_thres, tile_cap=self.cfg.tile_cap,
            chunk=self.cfg.chunk,
        )
        self.scene = scene.update_anchor()

    def on_fit_start(self) -> None:
        self.render_all_views()
        if self.cfg.seg_prompt and self.segmentor is not None:
            self.update_mask()
        self.state = init_train_state(copy.deepcopy(self.scene), self.optim)

    def compute_clip(self, embedder=None) -> Dict[str, float]:
        """CLIP directional similarity between the origin renders and the
        current renders over all views (`utils/clip_metrics.py`).
        `embedder` defaults to the openai-CLIP embedder on the scene's
        device; any `ClipEmbedder` works (tests pass a fake)."""
        from gaussianeditor_tpu_torch.utils.clip_metrics import (
            TorchClipSimilarity,
            compute_clip_directional,
        )

        assert self.cfg.clip_prompt_origin and self.cfg.clip_prompt_target, (
            "set clip_prompt_origin and clip_prompt_target"
        )
        if embedder is None:
            embedder = TorchClipSimilarity(device=self.scene.device)
        self.render_all_views()
        scene = self.state.scene if self.state is not None else self.scene
        edited = [self._render_cache(scene, cam).cpu().numpy()
                  for cam in self.cameras]
        origin = [self.origin_frames[i] for i in range(len(self.cameras))]
        return compute_clip_directional(
            embedder, origin, edited,
            self.cfg.clip_prompt_origin, self.cfg.clip_prompt_target,
        )

    # --- per-step target refresh ---

    def _drain_guidance_futures(self) -> None:
        for vid, fut in list(self._pending_targets.items()):
            if fut.done():
                self.edit_frames[vid] = fut.result()
                del self._pending_targets[vid]

    def _guidance_submit(self, fn, *args):
        """Every guidance call rides one worker thread: diffusion
        pipelines are not reentrant, so nothing may call them on the main
        thread while a background refresh is in flight."""
        if self._guidance_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._guidance_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="guidance",
            )
        return self._guidance_pool.submit(fn, *args)

    def _guidance_call(self, fn, *args):
        """Run a guidance call serialised with background refreshes; with
        async_guidance off there is no worker and the call is direct."""
        if not self.cfg.async_guidance:
            return fn(*args)
        return self._guidance_submit(fn, *args).result()

    def _gen_target(self, current: torch.Tensor, origin: np.ndarray,
                    vid: Optional[int] = None):
        # `current` is left on the device: on the async path its copy to
        # the host happens on the guidance worker, not in the train loop
        with span("guidance.refresh", rid=vid):
            with sync("target", current.numel() * current.element_size()):
                current = current.cpu().numpy()
            out = self.guidance(current, origin, self.cfg.prompt)
            return np.asarray(out.edit_image, np.float32)

    def _refresh_targets(self, view_ids: List[int], step: int) -> None:
        if self.guidance is None:
            # score-only training: targets fall back to the origin renders
            for vid in view_ids:
                self.edit_frames.setdefault(vid, self._origin_frame(vid))
            return
        if self.cfg.async_guidance:
            self._drain_guidance_futures()
        for vid in view_ids:
            stale = (
                vid not in self.edit_frames
                or (self.cfg.per_editing_step > 0
                    and self.cfg.edit_begin_step <= step
                    < self.cfg.edit_until_step
                    and step % self.cfg.per_editing_step == 0)
            )
            if not stale:
                continue
            current = self._render_cache(self.state.scene, self.cameras[vid])
            if self.cfg.async_guidance and vid in self.edit_frames:
                # refresh in the background; train on the previous target
                # until it lands
                if vid not in self._pending_targets:
                    self._pending_targets[vid] = self._guidance_submit(
                        self._gen_target, current, self._origin_frame(vid),
                        vid)
            else:
                # a first touch must block, still through the one worker
                self.edit_frames[vid] = self._guidance_call(
                    self._gen_target, current, self._origin_frame(vid), vid)

    def _score_inject(self, view_ids: List[int], step: int) -> torch.Tensor:
        """Host-side SDS/DDS image gradients for the batch, weighted by
        their C()-scheduled lambdas, on the scene's device."""
        renders = np.stack([
            self._render_cache(self.state.scene, self.cameras[v]).cpu().numpy()
            for v in view_ids
        ])
        origins = np.stack([self._origin_frame(v) for v in view_ids])
        g = np.zeros_like(renders)
        # serialised with any in-flight background refresh: the score
        # callables may wrap the same pipeline as the target guidance
        if self.sds_guidance is not None:
            lam = C(self.cfg.loss.lambda_sds, step)
            if lam > 0:
                gi, _ = self._guidance_call(
                    functools.partial(self.sds_guidance, step=step),
                    renders, origins, self.cfg.prompt,
                )
                g = g + lam * np.asarray(gi, np.float32)
        if self.dds_guidance is not None:
            lam = C(self.cfg.loss.lambda_dds, step)
            if lam > 0:
                tgt, src = self.dds_prompts
                gi, _ = self._guidance_call(
                    functools.partial(self.dds_guidance, step=step),
                    renders, origins, tgt, src,
                )
                g = g + lam * np.asarray(gi, np.float32)
        return upload_images(np.asarray(g, np.float32),
                             self.state.scene.device)

    # --- training ---

    def resume(self, ckpt_path: str) -> None:
        """Restore a periodic checkpoint. Runs on_fit_start first when it
        has not run (for the origin frames and the mask), then swaps in
        the restored state and fast-forwards the view sampler to the
        checkpoint's step, replaying the milestone batch sizes."""
        if self.state is None:
            self.on_fit_start()
        self.state = load_train_state(ckpt_path, device=self.scene.device)
        self.scene = copy.deepcopy(self.state.scene)
        for i in range(int(self.state.step)):
            _, _, bs = self._res_at(i)
            self.sampler.sample(bs)

    def fit(self, n_steps: Optional[int] = None, callback=None,
            should_stop=None, densify_noise: Optional[Callable] = None
            ) -> TrainState:
        """Run the training loop. `should_stop()` is polled each step.
        densify_noise: step -> (eps_a, eps_b), the two [C, 3] split draws
        of the densify step at that step, in place of the generator's."""
        if self.state is None:
            self.on_fit_start()
        n = n_steps if n_steps is not None else self.cfg.max_steps
        overflow_any = None
        step = int(self.state.step)
        end = step + n
        while step < end:
            if should_stop is not None and should_stop():
                break
            with span("edit.step", rid=step):
                metrics = self._step(step, callback, densify_noise)
            # accumulated on the device; read once after the loop
            overflow_any = (metrics["overflow"] if overflow_any is None
                            else overflow_any | metrics["overflow"])
            step += 1
        if overflow_any is not None:
            with sync("overflow", 1):
                overflowed = bool(overflow_any)
            if overflowed:
                warnings.warn(
                    "render instance budget overflowed during training — "
                    "splats were dropped on at least one step; rebuild "
                    "the system with a larger max_instances"
                )
        self.scene = copy.deepcopy(self.state.scene)
        return self.state

    def _step(self, step: int, callback, densify_noise) -> dict:
        """One step of `fit`: targets, the train step, densify at its
        interval, the callback and a checkpoint at its interval."""
        bs = self._apply_resolution(step)
        view_ids = self.sampler.sample(bs)
        with span("edit.targets"):
            self._refresh_targets(view_ids, step)
            targets = upload_images(
                np.stack([self.edit_frames[v] for v in view_ids]),
                self.state.scene.device)
        w = self.cfg.loss
        weights_t = type(w)(**{f: C(getattr(w, f), step)
                               for f in _WEIGHT_FIELDS})
        cams = [self.cameras[v] for v in view_ids]
        with span("train.step"):
            if self._with_inject:
                inject = self._score_inject(view_ids, step)
                self.state, metrics = self.train_step(
                    self.state, cams, targets, weights_t, inject)
            else:
                self.state, metrics = self.train_step(
                    self.state, cams, targets, weights_t)
        if (step < self.cfg.densify_until_step and step > 0
                and step % self.cfg.densification_interval == 0):
            with span("train.densify"):
                if densify_noise is not None:
                    self.state, dinfo = self.densify_step(
                        self.state, noise=densify_noise(step))
                else:
                    self.state, dinfo = self.densify_step(
                        self.state, generator=self.generator)
            metrics = {**metrics, **dinfo}
        if callback is not None:
            with span("edit.callback"):
                callback(step, metrics)
        if (self.cfg.checkpoint_every > 0 and self.cfg.checkpoint_dir
                and (step + 1) % self.cfg.checkpoint_every == 0):
            save_train_state(
                os.path.join(self.cfg.checkpoint_dir,
                             f"state_{step + 1:06d}.npz"),
                self.state,
            )
        return metrics
