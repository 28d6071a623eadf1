"""Per-group Adam with the exponential xyz learning rate and per-slot
moment resets.

Counterpart of `gaussianeditor_tpu/train/optim.py` (`OptimConfig`,
`expon_lr`, `AdamState`, `GaussianAdam`). The moments live at full
capacity; densification zeroes the moments of the slots it writes
(`reset_slots`) instead of resizing them. `torch.optim.Adam` is not used:
it has no gradient mask, no per-slot reset, and puts eps elsewhere. The
update is written out on tensors and applied in place under `no_grad`
(parameters and moments are overwritten; nothing else is allocated but
the step's temporaries).

Learning rates are computed on the host in float32, with the JAX
package's float32 arithmetic, and enter the update as Python scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """The reference's optimisation parameters; the editing systems
    scale the learning rates before building it."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0125
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    spatial_lr_scale: float = 1.0  # = cameras_extent
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear learning-rate interpolation with an optional sine
    delay, in float32."""
    step = f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                       f32(1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    out = f32(delay_rate * log_lerp)
    return 0.0 if step < 0 else float(out)


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int  # global step, shared by all groups

    def clone(self) -> "AdamState":
        return AdamState(mu={k: v.clone() for k, v in self.mu.items()},
                         nu={k: v.clone() for k, v in self.nu.items()},
                         count=self.count)


@dataclasses.dataclass(frozen=True)
class GaussianAdam:
    config: OptimConfig = OptimConfig()

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        def zeros():
            return {k: torch.zeros_like(params[k].detach())
                    for k in PARAM_NAMES}

        return AdamState(mu=zeros(), nu=zeros(), count=0)

    def group_lrs(self, step) -> Dict[str, float]:
        """Per-group learning rates at `step`."""
        c = self.config
        xyz_lr = expon_lr(step, c.position_lr_init * c.spatial_lr_scale,
                          c.position_lr_final * c.spatial_lr_scale,
                          lr_delay_mult=c.position_lr_delay_mult,
                          max_steps=c.position_lr_max_steps)
        return dict(xyz=xyz_lr, features_dc=float(f32(c.feature_lr)),
                    features_rest=float(f32(c.feature_lr / 20.0)),
                    opacity_raw=float(f32(c.opacity_lr)),
                    log_scales=float(f32(c.scaling_lr)),
                    quats=float(f32(c.rotation_lr)))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState, *,
             grad_mask: Optional[torch.Tensor] = None,
             step_override: Optional[int] = None) -> AdamState:
        """One Adam update, in place on `params` and on the moments of
        `state` (whose count it advances); returns `state`. `grad_mask`
        [C] zeroes the gradients outside the semantic edit mask in every
        group except the rotation."""
        c = self.config
        count = state.count + 1
        lrs = self.group_lrs(state.count if step_override is None
                             else step_override)
        t = f32(count)
        bc1 = float(f32(1) - f32(c.beta1) ** t)
        bc2 = float(f32(1) - f32(c.beta2) ** t)
        b1, b2 = float(f32(c.beta1)), float(f32(c.beta2))
        m = None if grad_mask is None else grad_mask.to(torch.float32)
        for name in PARAM_NAMES:
            g = grads[name]
            if m is not None and name != "quats":
                g = g * m.reshape((-1,) + (1,) * (g.dim() - 1))
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_(float(f32(1 - c.beta1)) * g)
            nu.mul_(b2).add_(float(f32(1 - c.beta2)) * g * g)
            # eps after the square root, as the reference
            step_val = lrs[name] * (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
            params[name].sub_(step_val)
        state.count = count
        return state

    @torch.no_grad()
    def reset_slots(self, state: AdamState,
                    reset_mask: torch.Tensor) -> AdamState:
        """Zero the moments of the slots in `reset_mask`, in place."""
        for moments in (state.mu, state.nu):
            for x in moments.values():
                x.masked_fill_(
                    reset_mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
        return state

    @torch.no_grad()
    def replace_param(self, state: AdamState, name: str) -> AdamState:
        """Zero all moments of one group (opacity reset), in place."""
        state.mu[name].zero_()
        state.nu[name].zero_()
        return state
