"""Work counts: the least time of a kernel and of a whole train step at
the H100's published peaks, from shapes and from the reference's own
preprocess and walk on the same inputs (`reference.Trainer.work`).

Nothing here reads a counter of the program, so no change to the
program moves the yardstick. Where work depends on the data, only what
these inputs need is counted: ranks, pairs walked and pairs that
contribute, as the reference's walk finds them. Per-Gaussian work is
counted over alive Gaussians, not slots, so work spent on dead slots
shows as a lower share.

The kernel counts are frozen copies of `chip_smoke.py`'s:
`b1_bytes` and the B2, B3 and B4 operation and byte counts of
`check_kernels` and `phase_backward`. A new kernel's count is a new
module of `benchmark/ext/` (its `KERNELS`), at the peak its arithmetic
runs at; `kernel` finds it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

from benchmark import ext

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CH = 3                   # colour channels composited
PAYLOAD = 7 + CH         # B1's payload rows; B3's gradient rows
B2_OPS_EVALUATED = 19    # per pair walked: power, exp, alpha, the tests
B2_OPS_CONTRIB = 1 + 2 * (CH + 1)   # per contributing pair: w, colour, depth
B3_OPS_EVALUATED = 19    # per pair up to n_contrib: alpha again
B3_OPS_CONTRIB = 50      # per contributing pair: the gradient terms
N_PARAMS = 59            # floats a Gaussian trains at SH degree 3
PROJECTED = 17           # floats preprocess writes a Gaussian
PROJ_GRADS = 9           # d mean2d, d conic, d opacity, d colour


def least_s(flops: float, nbytes: float) -> float:
    """The larger of the two bounds, in seconds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def b1(w: dict) -> float:
    """B1 (binning keys): b_incl up to the last rank's owner, the fields
    of each visible slot among those, a 4-byte key and the payload a
    rank (`chip_smoke.b1_bytes`)."""
    return least_s(0, 4 * w["last_slot"] + w["visible"] * 4 * (10 + CH)
                   + w["n"] * (4 + 4 * PAYLOAD))


def sort(w: dict) -> float:
    """The key sort and the payload's gather: each key read and each
    rank's index written once, the payload read and written once."""
    return least_s(0, 12 * w["n"] + 8 * PAYLOAD * w["n"])


def b2(w: dict) -> float:
    """B2 (forward walk)."""
    T = w["tiles"]
    return least_s(B2_OPS_EVALUATED * w["pairs"]
                   + B2_OPS_CONTRIB * w["contrib"],
                   4 * PAYLOAD * w["n"] + 4 * (T + 1)
                   + 4 * T * 256 * (CH + 3))


def b3(w: dict) -> float:
    """B3 (backward walk): payload and rank read, 11 values a pixel
    read, the gradient rows written."""
    T = w["tiles"]
    return least_s(B3_OPS_EVALUATED * w["sum_nc"]
                   + B3_OPS_CONTRIB * w["contrib"],
                   8 * PAYLOAD * w["n"] + 8 * w["n"] + 4 * 11 * T * 256)


def b4(w: dict) -> float:
    """B4 (per-Gaussian sums of the gradient rows), over alive
    Gaussians."""
    a = w["alive"]
    return least_s(0, 4 * PAYLOAD * w["n"] + 8 * a + 4 * PAYLOAD * a)


def preprocess(w: dict) -> float:
    """Projection forward and backward over the alive Gaussians."""
    a = w["alive"]
    return (least_s(0, 4 * (N_PARAMS + PROJECTED) * a)
            + least_s(0, 4 * (PROJ_GRADS + 2 * N_PARAMS) * a))


def conv_flops(height: int, width: int) -> float:
    """FLOPs of VGG16's 13 3x3 convolutions (LPIPS's trunk) on one
    image, an FMA as two."""
    from benchmark.scene import VGG_PLAN

    flops, cin, h, wd = 0.0, 3, height, width
    for cout, pool in VGG_PLAN:
        if pool:
            h, wd = h // 2, wd // 2
        flops += 2.0 * 9 * cin * cout * h * wd
        cin = cout
    return flops


def view_losses(w: dict, perceptual: str) -> float:
    """L1 and the perceptual term of one view, forward and backward.
    LPIPS: the trunk over the render and the target, and its input
    gradient for the render. SSIM: five 11 x 11 blurs forward, three
    back, separable."""
    px = w["pixels"]
    t = least_s(4 * px, 3 * 4 * 3 * px)
    if perceptual == "lpips":
        t += least_s(3 * conv_flops(w["height"], w["width"]),
                     2 * 4 * 3 * px)
    else:
        t += least_s((5 + 3) * 3 * px * 2 * 11 * 2, 3 * 4 * 3 * px)
    return t


def step_least_s(views: Sequence[dict], views_per_step: int,
                 perceptual: str, anchors: bool) -> float:
    """The least time of one train step: every view's render forward
    and backward and its losses (the mean over `views`, the reference's
    own), times the views a step renders, then the parameter-wide work
    once: the anchor terms and Adam over the alive Gaussians."""
    per_view = sum(b1(w) + sort(w) + b2(w) + b3(w) + b4(w) + preprocess(w)
                   + view_losses(w, perceptual) for w in views) / len(views)
    a = views[0]["alive"]
    t = views_per_step * per_view + least_s(0, 7 * 4 * N_PARAMS * a)
    if anchors:
        t += least_s(0, 3 * 4 * N_PARAMS * a)
    return t


KERNELS: Dict[str, Callable[[dict], float]] = {
    "b1": b1, "b2": b2, "b3": b3, "b4": b4}


def kernel(name: str) -> Callable[[dict], float]:
    """The count `name`, of `KERNELS` or of a module of `benchmark/ext/`;
    `LookupError` for a name neither defines."""
    return ext.lookup("KERNELS", name, KERNELS)
