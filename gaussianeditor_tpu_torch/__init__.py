"""PyTorch/CUDA port of gaussianeditor_tpu for NVIDIA Hopper (H100).

The JAX package `gaussianeditor_tpu` is the reference; every module here
names its counterpart there. This package imports neither JAX nor the
JAX package. Entry points run on the CUDA device unless the caller asks
for the CPU; asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, raising if it names CUDA and none exists.

    Never falls back to the CPU: a caller that wants the CPU says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev
