"""Monocular depth estimation for the Add pipeline's depth alignment.

Counterpart of `gaussianeditor_tpu/edit/dpt_adapter.py`. The reference
vendors a DPT-hybrid network and loads the omnidata checkpoint
(`threestudio/utils/dpt.py`, used from `GassuianEditorAdd.py:182-186`);
this adapter drives the same architecture through the `transformers`
library's DPT, frozen inference on an explicit device:

  * `DPTDepthEstimator(pretrained="Intel/dpt-hybrid-midas")` loads the
    published checkpoint when its weights are available locally;
  * `DPTDepthEstimator(pretrained=None)` builds the architecture from a
    small config with random weights, which tests use to hold the
    image -> tensor -> model -> resized-depth plumbing without weights.

Output: float32 [H, W], an inverse-depth-like map resized to the input's
size; `align_depth_scale` (edit/add_system.py) fits a * x + b against the
rendered depth, so the affine ambiguity of monocular depth does not
matter. Without `transformers` the constructor raises ImportError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device


class DPTDepthEstimator:
    """`DepthEstimator` over transformers' DPT, on `device`."""

    def __init__(self, pretrained: Optional[str] = "Intel/dpt-hybrid-midas",
                 device="cuda", image_size: int = 384):
        try:
            from transformers import DPTConfig, DPTForDepthEstimation
        except ImportError as e:
            raise ImportError(
                "the 'transformers' package is required for DPT depth "
                "estimation (DPTDepthEstimator)") from e
        self.device = resolve_device(device)
        self.image_size = image_size
        if pretrained:
            self.model = DPTForDepthEstimation.from_pretrained(pretrained)
        else:
            # the architecture only, with random weights
            cfg = DPTConfig(
                image_size=image_size,
                hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                intermediate_size=128, fusion_hidden_size=32,
                neck_hidden_sizes=[16, 32, 48, 64],
                backbone_out_indices=[0, 1, 2, 3],
            )
            self.model = DPTForDepthEstimation(cfg)
        self.model.eval().to(self.device)

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        img = np.clip(np.asarray(image, np.float32), 0, 1)
        H, W = img.shape[:2]
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        x = x.permute(2, 0, 1)[None]
        # ImageNet normalization (the omnidata DPT preprocessing)
        mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)
        x = (x - mean) / std
        x = torch.nn.functional.interpolate(
            x, (self.image_size, self.image_size), mode="bilinear",
            align_corners=False,
        )
        depth = self.model(pixel_values=x).predicted_depth  # [1, h, w]
        depth = torch.nn.functional.interpolate(
            depth[:, None], (H, W), mode="bilinear", align_corners=False
        )[0, 0]
        return depth.float().cpu().numpy()
