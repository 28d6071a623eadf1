"""Vanilla 3DGS reconstruction: a photometric fit to posed images.

Counterpart of `gaussianeditor_tpu/train/recon.py` (`ReconConfig`,
`ReconTrainer`; the reference's `gaussiansplatting/train.py`): per step
one view, drawn from refilling `np.random.RandomState(seed)` permutation
stacks, the loss (1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM),
the viewspace gradient into the densify statistics and one
`GaussianAdam` step; densify and prune on an interval with
threshold-only gating (no quantile gate, `max_densify_percent` 1.0),
periodic opacity resets that zero the opacity moments, and the active
SH degree one up every `oneup_sh_every` steps.

The step is `train.trainer.make_train_step` with L1 and SSIM as its
photometric and perceptual terms and the anchor weights at zero, so it
skips the anchor terms as the JAX trainer's loss has none; the densify
step is `make_densify_step`. The trainer trains its own copy of
the scene (the port's steps update in place), so the caller's scene is
left as it was. The images are uploaded to the scene's device once.
Densify draws its split noise from a `torch.Generator` on that device
seeded with `config.seed`, or from `fit(densify_noise=...)`.
`dispatch_burst > 1` (the JAX package's multi-step device programs)
warns and runs the per-step loop: the view draws are the same, so such
a config trains the same model.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.train.densify import DensifyConfig, reset_opacity
from gaussianeditor_tpu_torch.train.losses import ssim
from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
from gaussianeditor_tpu_torch.train.trainer import (
    LossWeights,
    TrainState,
    init_train_state,
    make_densify_step,
    make_train_step,
    upload_images,
)
from gaussianeditor_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class ReconConfig:
    """The JAX package's `ReconConfig`, field for field (the vanilla
    hyperparameters of gaussiansplatting/train.py and arguments/
    __init__.py:71-89)."""

    max_steps: int = 7000
    lambda_dssim: float = 0.2
    densify_from_step: int = 500
    densify_until_step: int = 15000
    densification_interval: int = 100
    densify_grad_threshold: float = 0.0002
    opacity_reset_interval: int = 3000
    oneup_sh_every: int = 1000
    min_opacity: float = 0.005
    max_screen_size: float = 20.0
    cameras_extent: float = 1.0
    seed: int = 0
    max_instances: Optional[int] = None
    # tile_cap and chunk are the JAX renderer's; the port walks whole tiles
    tile_cap: int = 2048
    chunk: int = 128
    impl: Optional[str] = None
    # the JAX package's multi-step device programs; the port runs the
    # per-step loop whatever this says (values > 1 warn)
    dispatch_burst: int = 1


def _dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 1.0 - ssim(pred, target)


class ReconTrainer:
    def __init__(self, scene: GaussianScene, cameras: Sequence[Camera],
                 images: Sequence[np.ndarray], config: ReconConfig):
        self.cfg = config
        dev = scene.device
        self.cameras = [c.to(dev) for c in cameras]
        self.images = [upload_images(np.array(im, np.float32), dev)
                       for im in images]
        oc = OptimConfig(spatial_lr_scale=config.cameras_extent,
                         position_lr_max_steps=config.max_steps)
        self.optim = GaussianAdam(config=oc)
        self.state = init_train_state(copy.deepcopy(scene), self.optim)
        self.rng = np.random.RandomState(config.seed)
        self._stack: List[int] = []
        lam = config.lambda_dssim
        self.train_step = make_train_step(
            self.optim,
            LossWeights(lambda_l1=1.0 - lam, lambda_p=lam,
                        lambda_anchor_color=0.0, lambda_anchor_geo=0.0,
                        lambda_anchor_scale=0.0, lambda_anchor_opacity=0.0),
            perceptual=_dssim, impl=config.impl,
            max_instances=config.max_instances)
        self.densify_step = make_densify_step(
            self.optim,
            DensifyConfig(
                max_grad=config.densify_grad_threshold,
                max_densify_percent=1.0,  # vanilla: threshold-only gating
                min_opacity=config.min_opacity,
                max_screen_size=config.max_screen_size,
                percent_dense=oc.percent_dense,
            ),
            config.cameras_extent,
            anchor_weight_init=0.0, anchor_weight_multiplier=1.0)
        self.generator = torch.Generator(device=dev).manual_seed(config.seed)
        if config.dispatch_burst > 1:
            warnings.warn(
                f"dispatch_burst={config.dispatch_burst}: the port runs the "
                "per-step loop (one train step per call, a callback every "
                "step); bursts are the JAX package's device programs")

    @property
    def scene(self) -> GaussianScene:
        return self.state.scene

    def _next_view(self) -> int:
        if not self._stack:
            self._stack = list(self.rng.permutation(len(self.cameras)))
        return int(self._stack.pop())

    def _sh_up_at(self, s: int) -> bool:
        cfg = self.cfg
        return s > 0 and cfg.oneup_sh_every > 0 and s % cfg.oneup_sh_every == 0

    def _densify_after(self, s: int) -> bool:
        cfg = self.cfg
        return (cfg.densify_from_step <= s < cfg.densify_until_step
                and s % cfg.densification_interval == 0 and s > 0)

    def _reset_after(self, s: int) -> bool:
        cfg = self.cfg
        return (cfg.opacity_reset_interval > 0 and s > 0
                and s % cfg.opacity_reset_interval == 0)

    def fit(self, n_steps: Optional[int] = None, callback=None,
            densify_noise: Optional[Callable] = None) -> TrainState:
        """Run `n_steps` steps (default: `max_steps`) from the current one.
        callback(step, metrics) after each step: `loss` and `l1` as
        0-dim device tensors, and on a densify step its counts
        (`n_cloned`, `n_split`, `n_pruned`, `n_dropped`). densify_noise:
        step -> (eps_a, eps_b), the two [C, 3] split draws of the densify
        step after that step, in place of the generator's."""
        n = n_steps if n_steps is not None else self.cfg.max_steps
        step = self.state.step
        end = step + n
        while step < end:
            with span("recon.step", rid=step):
                self._step(step, callback, densify_noise)
            step += 1
        return self.state

    def _step(self, step: int, callback, densify_noise) -> None:
        if self._sh_up_at(step):
            self.state.scene.one_up_sh_degree()
        vid = self._next_view()
        with span("train.step"):
            self.state, m = self.train_step(
                self.state, [self.cameras[vid]], self.images[vid][None])
        metrics: Dict[str, torch.Tensor] = {"loss": m["loss"],
                                            "l1": m["loss_l1"]}
        if self._densify_after(step):
            with span("train.densify"):
                if densify_noise is not None:
                    self.state, info = self.densify_step(
                        self.state, noise=densify_noise(step))
                else:
                    self.state, info = self.densify_step(
                        self.state, generator=self.generator)
            metrics.update(info)
        if self._reset_after(step):
            with span("recon.reset"):
                reset_opacity(self.state.scene)
                self.optim.replace_param(self.state.opt_state, "opacity_raw")
        if callback is not None:
            callback(step, metrics)
