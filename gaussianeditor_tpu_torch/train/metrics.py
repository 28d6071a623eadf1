"""Quantitative evaluation: PSNR, SSIM and LPIPS over image sets.

Counterpart of `gaussianeditor_tpu/train/metrics.py`
(`compute_image_metrics`, `evaluate_dirs`, `main`): per-image PSNR,
SSIM and LPIPS averaged over a renders/ and gt/ directory pair. PSNR and
SSIM are `train/losses.py`'s; LPIPS is `train/lpips.py`'s over the
weights `find_weights` resolves, and is reported as None when there are
none (no other distance stands in). Images load with Pillow. The
metrics run on `device` (default "cuda"; the CPU only when asked).

    python -m gaussianeditor_tpu_torch.train.metrics RENDERS GT [--out F]
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device
from gaussianeditor_tpu_torch.train.losses import psnr, ssim


def _metric_fns(lpips_weights_path: Optional[str] = None):
    from gaussianeditor_tpu_torch.train.lpips import LPIPS, find_weights

    fns = {"psnr": psnr, "ssim": ssim}
    w = find_weights(lpips_weights_path)
    if w is not None:
        fns["lpips"] = LPIPS(w)
    return fns


@torch.no_grad()
def compute_image_metrics(
    preds: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    lpips_weights_path: Optional[str] = None,
    device="cuda",
) -> Dict[str, Optional[float]]:
    """Mean PSNR, SSIM (and LPIPS) over [H, W, 3] image pairs."""
    assert len(preds) == len(gts) and len(preds) > 0
    dev = resolve_device(device)
    fns = _metric_fns(lpips_weights_path)
    sums = {k: 0.0 for k in fns}
    for p, g in zip(preds, gts):
        pa = torch.as_tensor(np.asarray(p, np.float32), device=dev)
        ga = torch.as_tensor(np.asarray(g, np.float32), device=dev)
        for k, f in fns.items():
            sums[k] += float(f(pa, ga))
    out: Dict[str, Optional[float]] = {
        k: v / len(preds) for k, v in sums.items()
    }
    if "lpips" not in out:
        out["lpips"] = None
    return out


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def evaluate_dirs(renders_dir: str, gt_dir: str,
                  lpips_weights_path: Optional[str] = None,
                  device="cuda") -> Dict:
    """Metrics of the images of `renders_dir` against the same names in
    `gt_dir`, paired by sorted name."""
    names = sorted(
        f for f in os.listdir(renders_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not names:
        raise ValueError(f"no images in {renders_dir}")
    preds, gts = [], []
    for n in names:
        gt_path = os.path.join(gt_dir, n)
        if not os.path.exists(gt_path):
            raise FileNotFoundError(f"missing ground truth for {n}")
        preds.append(_load_image(os.path.join(renders_dir, n)))
        gts.append(_load_image(gt_path))
    result = compute_image_metrics(preds, gts, lpips_weights_path, device)
    result["n_images"] = len(names)
    return result


def main(argv=None) -> None:
    """CLI: `<renders_dir> <gt_dir> [--out metrics.json]
    [--lpips_weights F] [--device cuda|cpu]`."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("renders_dir")
    p.add_argument("gt_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = evaluate_dirs(args.renders_dir, args.gt_dir,
                           args.lpips_weights, args.device)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)


if __name__ == "__main__":
    main()
