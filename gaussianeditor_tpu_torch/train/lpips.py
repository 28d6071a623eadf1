"""LPIPS perceptual distance in PyTorch.

Counterpart of `gaussianeditor_tpu/train/lpips_jax.py` (`random_weights`,
`save_weights`, `load_weights`, `find_weights`, `convert_torch_vgg16`,
`vgg16_features`, `lpips`, `make_perceptual`): the VGG16 feature stack
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), channel-unit-normalised
feature differences squared, nonnegative 1x1 linear heads, the spatial
mean, summed over the five stages. The weight file is the JAX package's
npz (HWIO convolutions), so one file serves both packages;
`torch_weights` transposes the convolutions to OIHW once per device and
`LPIPS` keeps that copy.

The convolutions are `F.conv2d`, as the JAX package computes them with
`lax.conv_general_dilated` outside any Pallas kernel. Precision and
determinism: every convolution, forward and backward, runs in full
float32 (TF32 off) with cuDNN's deterministic algorithms, whatever the
process-wide cuDNN flags say (`losses.exact_conv_flags`, as SSIM's
blurs), so that a train step with LPIPS repeats bitwise on the card. The
backward is taken explicitly (`_Conv`) because cuDNN reads its flags
when the backward runs; it returns the gradient of the input only (the
weights are constants).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussianeditor_tpu_torch.train.losses import exact_conv_flags
from gaussianeditor_tpu_torch.utils.profiling import sync

# VGG16 `features` conv plan: (out_channels, pool_before) per conv layer
# (torchvision cfg "D": 64,64,M,128,128,M,256,256,256,M,512,512,512,M,
# 512,512,512).
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# conv indices after which LPIPS taps features: relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3
_TAPS = [1, 3, 6, 9, 12]
_STAGE_CH = [64, 128, 256, 512, 512]

# LPIPS's scaling layer: (2x - 1 - shift) / scale
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS_ENV = "GSEDIT_LPIPS_WEIGHTS"


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random He-initialised VGG16 and nonnegative linear heads (for tests
    and as a stand-in); the same numbers as the JAX package's."""
    rng = np.random.RandomState(seed)
    w: Dict[str, np.ndarray] = {}
    cin = 3
    for i, (cout, _) in enumerate(_VGG_PLAN):
        fan_in = 3 * 3 * cin
        w[f"conv{i}_w"] = (
            rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        w[f"conv{i}_b"] = np.zeros((cout,), np.float32)
        cin = cout
    for j, c in enumerate(_STAGE_CH):
        w[f"lin{j}_w"] = rng.rand(c).astype(np.float32) / c
    return w


def save_weights(path: str, weights: Dict[str, np.ndarray]) -> None:
    np.savez(path, **weights)


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """The npz's arrays (HWIO convolutions), as numpy."""
    data = np.load(path)
    return {k: np.asarray(data[k]) for k in data.files}


def find_weights(path: Optional[str] = None
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Resolve LPIPS weights: explicit path > $GSEDIT_LPIPS_WEIGHTS >
    ~/.cache/gsedit/lpips_vgg16.npz. None if absent."""
    candidates = [
        path,
        os.environ.get(DEFAULT_WEIGHTS_ENV),
        os.path.expanduser("~/.cache/gsedit/lpips_vgg16.npz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return load_weights(c)
    return None


def convert_torch_vgg16(vgg_features, lin_heads=None) -> Dict[str, np.ndarray]:
    """Convert a torch `vgg16().features` module (and optionally the five
    LPIPS 1x1 linear-head weight tensors [1, C, 1, 1]) to the npz layout."""
    out: Dict[str, np.ndarray] = {}
    i = 0
    for layer in vgg_features:
        if layer.__class__.__name__ == "Conv2d":
            # OIHW -> HWIO
            out[f"conv{i}_w"] = (
                layer.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)
            )
            out[f"conv{i}_b"] = layer.bias.detach().cpu().numpy()
            i += 1
    assert i == 13, f"expected 13 convs, got {i}"
    for j, c in enumerate(_STAGE_CH):
        if lin_heads is not None:
            out[f"lin{j}_w"] = (
                np.asarray(lin_heads[j]).reshape(-1).astype(np.float32)
            )
        else:
            out[f"lin{j}_w"] = np.full((c,), 1.0 / c, np.float32)
    return out


def torch_weights(weights: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """The npz layout as float32 tensors on `device`, the convolutions
    transposed HWIO -> OIHW."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v, np.float32)
        if k.endswith("_w") and k.startswith("conv"):
            v = v.transpose(3, 2, 0, 1)
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
    return out


class _Conv(torch.autograd.Function):
    """3x3 'SAME' convolution whose forward and backward both run under
    the deterministic, full-float32 cuDNN flags."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(w)
        ctx.x_shape = x.shape
        with exact_conv_flags():
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with exact_conv_flags():
            gx = torch.nn.grad.conv2d_input(ctx.x_shape, w, g, padding=1)
        return gx, None, None


def vgg16_features(tw: Dict[str, torch.Tensor], x: torch.Tensor):
    """x [B, H, W, 3] in [0, 1] -> the five tap activations [B, C, h, w];
    `tw` from `torch_weights`."""
    dev = x.device
    # two host constants copied to the device: the copy waits for the
    # stream
    with sync("lpips_consts"):
        shift = torch.as_tensor(_SHIFT, device=dev)
        scale = torch.as_tensor(_SCALE, device=dev)
    x = (2.0 * x - 1.0 - shift) / scale
    x = x.permute(0, 3, 1, 2)
    taps = []
    for i, (_, pool_before) in enumerate(_VGG_PLAN):
        if pool_before:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(_Conv.apply(x, tw[f"conv{i}_w"], tw[f"conv{i}_b"]))
        if i in _TAPS:
            taps.append(x)
    return taps


def lpips(tw: Dict[str, torch.Tensor], pred: torch.Tensor,
          target: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between [H, W, 3] (or [B, H, W, 3]) images in
    [0, 1]: per stage, unit-normalise the channels, square the
    difference, apply the nonnegative 1x1 head, take the mean over batch
    and space; sum the stages. `tw` from `torch_weights`."""
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    fa = vgg16_features(tw, pred)
    fb = vgg16_features(tw, target)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for j, (a, b) in enumerate(zip(fa, fb)):
        na = a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2
        head = torch.clamp_min(tw[f"lin{j}_w"], 0.0)  # nonnegative heads
        total = total + torch.mean(torch.sum(d * head[None, :, None, None],
                                             dim=1))
    return total


class LPIPS:
    """The perceptual term (pred [H, W, 3], target [H, W, 3]) -> scalar
    over numpy weights in the npz layout, moved to each input's device
    (and transposed) once."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        self.weights = weights
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch_weights(self.weights, device)
        return self._on[device]

    def __call__(self, pred: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        return lpips(self.tensors(pred.device), pred, target)


def make_perceptual(weights_path: Optional[str] = None):
    """The perceptual term of the train step: LPIPS when weights exist,
    else the multiscale-gradient proxy (`train/perceptual.py`), with a
    warning. Always returns a callable."""
    w = find_weights(weights_path)
    if w is not None:
        return LPIPS(w)
    import warnings

    warnings.warn(
        "LPIPS weights not found (checked explicit path, "
        f"${DEFAULT_WEIGHTS_ENV}, ~/.cache/gsedit/lpips_vgg16.npz); "
        "the perceptual term falls back to the multiscale-gradient proxy. "
        "Training behavior will differ from the reference's learned LPIPS "
        "(lambda_p=10). Convert the official torchvision VGG16 + LPIPS "
        "linear heads once with "
        "gaussianeditor_tpu_torch.train.lpips.convert_torch_vgg16 + "
        "save_weights.",
        stacklevel=2,
    )
    from gaussianeditor_tpu_torch.train.perceptual import (
        multiscale_gradient_loss,
    )

    return multiscale_gradient_loss
