#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gaussianeditor_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure exits non-zero:
  1. device: a CUDA device is present; its name and power limit.
  2. build: nvcc compiles every kernel of the render path from csrc/,
     and g++ the host KNN of native/ (the scipy fallback must not be
     taken).
  3. kernel vs plain, at full width: a 1,000,000-Gaussian SH-degree-3
     scene (bench.py's recipe, seed 0) written to a PLY and loaded the way
     the viewer loads it, at 4x capacity; one 512x512 view, rendered both
     ways a served frame renders it: the color view (ch = 3) and the
     overlay's mask view (ch = 1); B1's and B2's registers, spills and
     shared memory are printed first. Kernel B1's 32-bit keys, payload
     and sort order must equal its plain version's bit for bit; kernel
     B2's images must meet the JAX suite's image bounds and its n_contrib
     must equal the plain version's on every pixel.
     Each kernel is timed with CUDA events (median of 20 samples), beside
     its plain version on the color view (1 sample for B2's, which
     takes seconds a call). On the color view `sorted_bin` is timed whole
     and in its parts (the cumsum with its host read, B1, the sort, the
     payload gather, the tile bounds), beside `torch.sort` of the same
     keys as int64 and as int32, in turns.
  4. the main path: the viewer's state is built as its `main` builds it
     (the PLY plus a synthetic COLMAP workspace) and served over HTTP;
     GET /render answers two orbit views, one client pose, one overlay
     frame and a sweep of 16 orbit views at 512x512, one request at a
     time. The launch counts, zeroed just before, must show both kernels,
     and the pose frame must match the plain render of the same view.
  5. one warm frame under torch.profiler: device time by kernel and the
     device's idle share.
  6. the backward kernels against their plain versions, at full width:
     phase 3's color view and a seeded cotangent (g_color, g_depth,
     g_final_T). First the rows per tile (max, mean, the longest tile's
     rows before its largest n_contrib) and each B3 instance's, and
     B4's, registers, spills, shared memory and blocks per SM. Kernel
     B3's rank-ordered gradient rows must meet the JAX suite's gradient
     tolerance (atol 1e-3, rtol 1e-2) against its plain version, kernel
     B4's per-Gaussian sums 1e-5 of each column's RMS against its plain
     version, and B3 followed by B4 must repeat bitwise. Timed with
     CUDA events (median of 20 samples; the plain versions once),
     beside `torch.segment_reduce`, the one PyTorch call that computes
     B4's function.
  7. the train path: the edit train step at full width (the scene of
     phase 3, two 512x512 orbit views, the edit config's loss weights and
     learning-rate scalers, the multiscale-gradient perceptual term),
     the targets the port's own renders of those views, color-shifted.
     With the launch counts zeroed: 10 steps, one densify step (its
     gradient threshold the 99.9th percentile of the accumulated
     gradients, so that it clones or splits) and 2 more steps. Each of
     B1-B4 must have launched 2 x 12 times, loss_l1 must fall, every
     parameter, moment and statistic must stay finite on every slot.
     Then one step twice from a copied state must give bitwise equal
     gradients and parameters, and one step runs under torch.profiler.
  8. the dense route's kernels against their plain versions, at full
     width (run after phase 6, on phase 3's view, before phase 7 trains
     the scene): the color view (ch = 3) and an 8- and a 32-channel
     feature render of the same view, binned by `dense_bin` at the
     default budget; each B5 and B6 instance's registers, spills, shared
     memory and blocks per SM are printed first.
     Kernel B5's images must meet the JAX suite's image bounds and its
     n_contrib agree on >= 99.9% of pixels; on the color view its color,
     depth, final_T and n_contrib must equal B2's bit for bit. Kernel B6's aligned rows must meet atol 1e-3 /
     rtol 1e-2 against its plain version; gathered into rank order
     (`rows_by_rank`) and summed by B4, they must be within 1e-5 of each
     column's RMS of B4's plain version on the same rows, within 3e-4 of
     each column's max of B3 then B4 and bitwise equal to it, and repeat
     bitwise. Timed as phase 6 times B3 (B6 at each width, and B4 and
     the gather on B6's rows), beside `dense_bin` and `sorted_bin`.
  9. the train path through the dense route: the scene loaded again
     from the PLY, phase 7's optimizer, cameras and targets, 6 steps of
     `make_train_step(..., impl="pallas4")` with the launch counts zeroed
     (B5, B6 and B4 2 x 6 times each, B1-B3 never); loss_l1 must fall
     and everything stay finite, and its losses are printed beside phase
     7's first 6; one step twice from a copied state bitwise equal; one
     step profiled.
 10. the edit loop at full width: the scene loaded again from the PLY at
     4x capacity, 8 orbit views at 512x512, `EditSystem` with
     configs/edit.yaml's `system` values (hard-coded: PyYAML is not
     needed) for 30 steps at batch 2, a densify step at step 10 (its
     gradient threshold, by phase 7's rule, the 99.9th percentile of the
     accumulated gradients, here over the traced Gaussians), a
     checkpoint at step 20, the fake guidance, semantic tracing with a
     fake segmentor whose reference color is view 0's centre (its radius
     bisected until 10-50% of the Gaussians are traced), and LPIPS with
     random weights. With the launch
     counts zeroed before each part: the origin renders (B1, B2), the
     tracing (B1, B4) and the steps (B1-B4) must launch their kernels and
     B5 and B6 none. The mask must select 1-99% of the alive Gaussians;
     tracing twice must repeat bitwise, and B4's per-Gaussian sums of the
     tracing rows must equal an int64 `index_add_` on the counts and
     come within 1e-5 of each column's RMS of a float64 one on the
     weights. The callback must fire 30 times in order, with the densify
     info at step 10; the mean loss_l1 of the last 5 steps must be below
     that of the first 5; everything finite. A second system resumed from
     the step-20 checkpoint must end its 10 steps bitwise equal to the
     uninterrupted run. Printed: on_fit_start's time (origin renders,
     tracing per view), step medians (refresh and plain steps apart), the
     densify step, the checkpoint's size, write and load times, the peak
     device memory, and a profile of one tracing view and of one step.
 11. click tracing and the 'tiled' route: the PLY loaded again at 4x
     capacity. `render(impl="tiled")` of phase 3's view must launch B1
     and B2 once each and nothing else, equal `sorted_bin` at 32 -
     tile_bits depth bits then B2 bit for bit on all four outputs, and
     meet the image bounds against the default route (printed: whether
     it is bitwise equal, and a 128x128 view where the cuts differ).
     `trace_from_click` on the 8 orbit views at view 0's centre pixel
     with `FakePointSegmentor` (its radius bisected, as phase 10's, until
     10-50% of the alive Gaussians are traced): B1 once per render and per
     tracing view, B2 once per render, B4 once per tracing view; twice
     bitwise equal. `point_cloud_render` of the alive centres: finite,
     with white pixels.
 12. Delete: the PLY loaded again, `DelSystem` with configs/del.yaml's
     `system` values (hard-coded), the 8 orbit views, phase 10's
     segmentor, `FakeInpainter` and LPIPS with random weights.
     `on_fit_start` split into origin renders, tracing (per view), the
     shell search, the mask renders with dilate and fill, the re-renders
     and inpainting (if the shell is empty at inpaint_scale 0.25 it is
     doubled until it is not, and the value used is printed); then 10
     steps. Launches per part: set-up B1 4 x 8, B2 3 x 8, B4 8; steps
     B1-B4 2 x 10; B5, B6 none. The alive count must fall by the traced
     count exactly, the shell be non-empty, nothing but the rotations
     move outside the shell (the mask gates every group but the
     rotation, as the reference's hooks do), the losses stay finite and
     the caller's scene stay bitwise as it was.
 13. Add and the object path: the PLY loaded again, `AddSystem.run()`
     with anchor view 0, bbox (160, 160, 352, 352), `FakeInpainter`,
     `FakeObjectGenerator(n_points=2000)` and no depth estimator: B1 and
     B2 once; the merged scene must hold 1,002,000 slots with the mask on
     exactly the last 2,000, and the caller's scene be unchanged. B4 is
     held against its plain version at that capacity (1e-5 of each
     column's RMS) and timed. Then 10 refinement steps with
     `FakeGuidance` and LPIPS: the base's parameters but its rotations
     bitwise unchanged, the object's moved; one step profiled. Then
     `fit_colorless_mesh` on a 2,208-face sphere made in numpy, 200,000
     surface samples, 16 views at 256x256, 20 steps (B1-B4 2 x 20): the
     L1 over the 16 views against the rasterizer's targets must be lower
     after the fit than before it.
 14. reconstruction and the CLI at full width: a COLMAP workspace made
     from the PLY's scene (48 PINHOLE cameras at 1297x840 on two rings of
     24, the port's renders as 8-bit PNGs, 150,000 SfM points: a seeded
     subsample of the centres jittered by N(0, 0.01), coloured by the SH
     DC term). First SSIM and its gradient on two targets under both
     values of cuDNN's allow_tf32: a plain `F.conv2d` blur beside the
     float64 value (printed), then `train.losses.ssim`, which must be
     bitwise the same under either and repeat bitwise. Then
     `launch.main(["--config", ..., "--train", "--test", "--export"])` in
     this process, with torch's default TF32 flags and the launch counts
     zeroed: recon from the points into 600,000 slots at SH degree 3, 300
     steps (densify after 100 and 200, opacity reset after 250, SH one-up
     at 75, 150 and 225), a 16-view turntable. B1 and B2 must launch 300
     + 16 times, B3 and B4 300, B5 and B6 never; metrics.jsonl 300 finite
     rows, the loss of the last 20 below the first 20's; last.ply at SH
     degree 3 with an alive count other than 150,000; the PSNR of the
     exported scene over 4 training views above the initial scene's; the
     turntable 16 frames. At training view 0 of the result, B1-B4 against
     their plain versions as phases 3 and 6 hold them (timed there, with
     phase 3's split of `sorted_bin`), and
     B2's n_contrib against the plain version's at views 0, 12, 24 and
     36, a pixel that differs decided by replaying its walk: both counts
     must be the float64 walk's within one float32 tie (the count printed
     and in the JSON line); one plain step profiled; two fresh 40-step `ReconTrainer` fits through
     every event bitwise equal. Then, as users start them, `python -m
     gaussianeditor_tpu_torch.apps.launch` for edit (--train --validate
     --export, LPIPS with random weights), del (--train --export) and add
     (--train, 3 refinement steps), 3 steps each on the PLY at 512x512,
     and `python -m gaussianeditor_tpu_torch.train.metrics` on 8 renders
     of the result against their targets: each exits 0 and leaves its
     files. Printed: the set-up parts, step medians by kind, the densify
     requests and grants, peak memory, the turntable's and the export's
     times, and each subprocess's wall time.
 15. the web UI's editing session over HTTP at full width (after 14):
     the viewer's state as `main` builds it (the PLY at 4x capacity, the
     8-view workspace at 512x512) with phase 10's segmentor and edit
     config (no semantic prompt), `FakeInpainter`, `FakeObjectGenerator`
     and phase 11's point segmentor, served on a free port. In order:
     GET /render x 20 at idle; POST /trace (mask and cached weights
     bitwise those of `update_mask_from_views` driven in process on the
     same renders; B1 2 x 8, B2 8, B4 8); GET /groups; POST /threshold
     at 0.3 and 0.7 (the mask `weights > t & alive`, no launch); POST
     /click at view 0's centre (bitwise `trace_from_click` in process);
     POST /group back to the trace (its mask restored bitwise); POST
     /config with a good update and an unknown key; POST /edit, 30 steps,
     while GET /render serves phase 3's view in a closed loop with GET
     /status and GET /editframe: every frame bitwise a render of the
     scene after some whole step, in step order, and the served scene at
     the end bitwise that of the same `EditSystem.fit` run in process;
     a second POST /edit stopped by POST /stop within a step of the
     request; POST /edit in mode del (10 steps; phase 12's launches);
     POST /add (the alive count up by 2,000; B1, B2 once); POST /save
     (the PLY loaded again renders bitwise as the served scene); GET
     /poses (finite, one frustum a camera); the bad requests of
     tests/test_webui.py with the JAX codes. Printed: /render median and
     max at idle and during the edit, the served and in-process steps per
     second, each endpoint's time, the peak memory, each part's launches.
 16. SDS and DDS score guidance (after 15): the PLY loaded again,
     `EditSystem(guidance=None)` with `SDSGuidance` and `DDSGuidance` over
     `FakeLatentModel` on the card (lambda_sds 1, lambda_dds 0.5), 8
     orbit views, batch 2: one SDS call against the fake encoder's VJP in
     closed form in float64 (1e-5 of the largest entry); 10 steps (B1, B2
     4 x 10, B3, B4 2 x 10) that must move the parameters with a nonzero
     injected loss; 3 steps twice bitwise equal. Printed: the step
     median, the score pass with its host round trip.
 17. multi-device training and the oracle (after 16), from the PLY
     loaded again; the launch counts zeroed before each part. (a) Phase
     3's view as 4 strips of 8 tile rows (`render_strip`, B1-B4 each 4
     times with the strips' backward) against the whole render: the
     image bounds (the max abs difference and the pixels beyond 1e-5
     printed) and the summed strip gradients of a seeded probe plus
     0.05 sum(final_T) at normalised atol 1e-3 (the strips keep the whole
     image's depth cut; at the strip grid's own cut, the JAX strips', the
     difference is printed); B1-B4 against their plain versions at strip
     1's grid (256 tiles) as phases 3 and 6 hold them;
     the strips' forward and backward times beside the whole render's.
     (b) `make_sharded_train_step` at world size 1 under NCCL in this
     process, 3 steps against `make_train_step` from the same state
     (phase 7's optimizer, views, targets and weights): xyz atol 1e-5 /
     rtol 1e-4, the gradient accumulator rtol 1e-3, max radii exact, loss
     rtol 1e-5; whether they are bitwise equal and the step medians
     printed. (c) Two spawned ranks sharing the card under gloo with CUDA
     tensors (gloo stages them through the host), each loading the PLY:
     one view-sharded step at world 2, one 2-D step on a 1x2 (view x tile)
     mesh with 1 - SSIM through `gather_rows`, a 2-strip
     `make_tile_sharded_render` and `ssim_sharded` on two random 512x512
     images; rank 0 holds each against its single-process counterpart (the
     tolerances of tests/test_parallel.py and tests/test_mesh2d.py, the
     image bounds, rtol 1e-6 and gradient atol 1e-6), the ranks'
     parameters must be bitwise equal after each step, and each rank's
     launches, collectives' time, step time and peak memory are printed.
     (d) `render(impl="ref")` on a 2,000-Gaussian cut of the bench recipe
     at 128x128 against the sorted route (image bounds), in float64
     against float32, no compositor kernel launched (the float64 scene's
     preprocess takes the plain version), timed.
 18. the preprocess kernels (`csrc/preprocess.cu`) against their plain
     versions at the benchmark's scenes: 4M slots (1M alive) at 512x512
     and 3M alive at 1297x840, SH degree 3, the densify offset. The
     forward's integer fields and num_rendered equal on every slot, each
     float field's differing slots and largest ulp gap printed (also for
     a 1-channel override and a strip of tile rows); the backward within
     1e-5 of each gradient's largest entry of autograd on the plain
     version and zero on every invisible slot; one launch each; both
     timed beside their byte bounds and the plain versions' times. Every
     phase's launch counts hold one preprocess forward a render or
     tracing view and one backward a render's backward.
Each phase prints its times beside the card's name and power limit;
the script prints each phase's wall time and its total. Then it prints
the kernels' JSON line (with each kernel's launches on every path), the
card's name and power limit, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

N_GAUSSIANS = 1_000_000
SH_DEGREE = 3
SIZE = 512
SEED = 0
RUNS = 20
PLAIN_RUNS = 1               # samples of a plain version's time (seconds
                             # a call; one keeps the script near 400 s)
SWEEP = 16                   # extra orbit frames served after the 4 named ones
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12      # FP32 outside the tensor cores, same sheet
B2_OPS_EVALUATED = 19        # f32 ops (one exp counted as 1) per evaluated pair
B2_OPS_CONTRIB_BASE = 1      # + per contributing pair: w = alpha*T, then a
                             # multiply-add (2) per channel and for depth
B3_OPS_EVALUATED = 19        # f32 ops to rebuild alpha for a row before n_contrib
B3_OPS_CONTRIB = 50          # + per contributing pair: c_hat 8, w 1, prefix 2,
                             # dpower 7, the 10 partials 20, T 2, their sum 10
TRAIN_STEPS = (10, 2)        # train steps before and after the densify step
DENSE_STEPS = 6              # train steps on the dense route (phase 9)
FEATURE_CH = 8               # channels of phase 8's feature render
WIDE_CH = 32                 # and of its widest one (B5's and B6's limit)
COLOR_SHIFT = (1.2, 0.8, 0.8)
# configs/edit.yaml: learning-rate scalers and max_steps
LR_SCALERS = dict(gs_lr_scaler=3.0, gs_final_lr_scaler=2.0,
                  color_lr_scaler=3.0, opacity_lr_scaler=2.0,
                  scaling_lr_scaler=2.0, rotation_lr_scaler=2.0)
EDIT_MAX_STEPS = 2000
# phase 10: the edit loop
EDIT_VIEWS = 8
EDIT_STEPS = 30              # max_steps and edit_until_step
EDIT_REFRESH = 10            # per_editing_step and densification_interval
EDIT_DENSIFY_UNTIL = 20      # one densify step, at step 10
EDIT_CHECKPOINT = 20         # checkpoint_every: one checkpoint, after step 19
EDIT_PROMPT = "Turn him into a clown"   # configs/edit.yaml


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_scene_arrays(n: int, seed: int) -> dict:
    """bench.py's synthetic scene: uniform xyz in [-1, 1]^3, splat size
    0.012 * (1e5 / n)^(1/3), SH degree 3 with zero rest features."""
    rng = np.random.RandomState(seed)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    size = 0.012 * (100_000 / n) ** (1 / 3)
    return dict(
        xyz=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        features_dc=(rng.randn(n, 1, 3).astype(np.float32) * 0.3),
        features_rest=np.zeros((n, 15, 3), np.float32),
        opacity_raw=rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32),
        log_scales=np.log(rng.uniform(size / 3, size * 5 / 3, (n, 3))
                          ).astype(np.float32),
        quats=quats,
    )


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a proper rotation matrix."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2,
                      R[2, 1] - R[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2,
                      R[0, 2] - R[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2,
                      R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def write_workspace(root: str, n_views: int = 8) -> None:
    """A COLMAP sparse model of `n_views` PINHOLE 512x512 cameras on a
    ring of radius 4 around the origin (fov 0.8)."""
    from gaussianeditor_tpu_torch.core.cameras import fov2focal, lookat_c2w
    from gaussianeditor_tpu_torch.data.colmap import (
        ColmapCamera,
        ColmapImage,
        write_colmap_model_bin,
    )

    f = fov2focal(0.8, SIZE)
    cams = {1: ColmapCamera(1, "PINHOLE", SIZE, SIZE,
                            np.array([f, f, SIZE / 2, SIZE / 2]))}
    imgs = {}
    for i in range(n_views):
        th = 2 * math.pi * i / n_views
        eye = 4.0 * np.array([math.cos(th), 0.3, math.sin(th)])
        w2c = np.linalg.inv(lookat_c2w(eye, np.zeros(3), (0.0, 1.0, 0.0)))
        imgs[i + 1] = ColmapImage(i + 1, _rotmat_to_qvec(w2c[:3, :3]),
                                  w2c[:3, 3], 1, f"view{i:03d}.png")
    write_colmap_model_bin(os.path.join(root, "sparse", "0"), cams, imgs)


def view_pose() -> list:
    """The camera-to-world pose (16 floats) of phase 3's view."""
    from gaussianeditor_tpu_torch.core.cameras import lookat_c2w

    c2w = lookat_c2w((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    return [float(v) for v in c2w.reshape(-1)]


def time_ms(fn, runs: int = RUNS, sample_ms: float = 2.0) -> float:
    """Median over `runs` samples of `fn`'s time per call, by CUDA events.
    Each sample times back-to-back calls (as many as fill about
    `sample_ms`), so that the host's launch cost overlaps the device's
    work instead of being counted as device time."""
    import torch

    def sample(reps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    fn()
    torch.cuda.synchronize()
    reps = max(1, min(50, math.ceil(sample_ms / max(sample(1), 1e-3))))
    return statistics.median(sample(reps) for _ in range(runs))


def kernel_resources(name: str, channels) -> None:
    """Print each instance's registers, spills and static shared memory
    from the compiler's report (`_kernels.BUILD_LOG`), and the dynamic
    shared memory and blocks per SM of the instance taking each of
    `channels`, from the kernel's `<name>_occupancy`. A block is the
    source's kThreads threads where it defines one (B1), else 256 (a
    pixel or a slot a thread)."""
    import re

    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.testing import kernel_constants

    threads = kernel_constants(f"{name}.cu").get("kThreads", 256)

    inst = ""
    for line in _kernels.BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"ILi(\d+)E", m.group(1))
            inst = f"<{k.group(1)}>" if k else ""
        elif "spill" in line or "registers" in line:
            print(f"  {name}{inst}: {line.split(':', 1)[-1].strip()}")
    for ch in channels:
        smem, blocks = _kernels.occupancy(name, ch)
        print(f"  {name} at ch {ch}: {smem} bytes of dynamic shared memory, "
              f"{blocks} blocks of {threads} threads per SM", flush=True)


def row_stats(bounds, n_contrib, label: str, per: int = 1) -> dict:
    """Rows per tile (max, mean) and the longest tile's rows before its
    largest n_contrib: the rows the backward walks (`per` rows per unit
    of `bounds`: 128 for chunks). Printed and returned."""
    cnt = (bounds[1:] - bounds[:-1]).long() * per
    max_nc = n_contrib.long().max(dim=1).values
    out = dict(rows_max=int(cnt.max()), rows_mean=float(cnt.float().mean()),
               longest_tile_rows_before_nc=int(max_nc[int(cnt.argmax())]),
               max_nc_max=int(max_nc.max()),
               max_nc_mean=float(max_nc.float().mean()),
               rows_walked=int(max_nc.sum()), rows_total=int(cnt.sum()))
    print(f"rows per tile, {label}: max {out['rows_max']}, mean "
          f"{out['rows_mean']:.1f}; the longest tile's rows before its "
          f"largest n_contrib {out['longest_tile_rows_before_nc']}; a tile's "
          f"largest n_contrib: max {out['max_nc_max']}, mean "
          f"{out['max_nc_mean']:.1f}; rows walked {out['rows_walked']} of "
          f"{out['rows_total']}", flush=True)
    return out


# a threshold decision within this relative distance is a float32 tie:
# T is a product over up to ~1,500 rows, whose float32 rounding reaches
# ~1e-6 relative (1.25e-6 seen on the card at row 960)
TIE_REL = 1e-4


def replay_nc_flips(sb, tk, tp, gx: int, label: str, limit: int = 64,
                    device: str = "cuda") -> tuple:
    """The pixels (at most `limit`) whose n_contrib differs between B2 and
    its plain version, each walked again one row at a time with the plain
    version's expressions: in float32 on the card (the plain version's
    own evaluation, which must reproduce its n_contrib), in float32 on
    the host and in float64. A row of the float64 walk is a tie when its
    alpha or T (1 - alpha) lies within `TIE_REL` of 1/255 or T_MIN: there
    float32 rounding alone (the kernel's FMA contractions, the card's
    elementwise exp) can take the other decision. A pixel is decided when
    the card's walk reproduces the plain version and both the kernel's
    and the plain version's n_contrib are that of the float64 walk or of
    the float64 walk with one tie decided the other way. Prints each
    walk's n_contrib, the ties and the counts they reach. Returns the
    number of pixels that differ and the number not decided: all of them
    when more than `limit` pixels differ."""
    import torch

    from gaussianeditor_tpu_torch.ops.composite import (
        ALPHA_MAX,
        ALPHA_MIN,
        T_MIN,
    )

    def walk(r, px, py, flip=None):
        """n_contrib and the (decision, alpha, T (1 - alpha)) of each row
        walked; the decision at row `flip` taken the other way."""
        T = torch.ones((), dtype=r.dtype, device=r.device)
        last, log = 0, []
        for i in range(r.shape[1]):
            x, y, a, b, c, op = (r[k, i] for k in range(6))
            dx, dy = x - px, y - py
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
            test_T = T * (1 - alpha)
            d = ("skip" if power > 0 or alpha < ALPHA_MIN
                 else "stop" if test_T < T_MIN else "add")
            if i == flip:
                near_alpha = (abs(float(alpha) - ALPHA_MIN) / ALPHA_MIN
                              < abs(float(test_T) - T_MIN) / T_MIN)
                d = ("add" if d != "add" else
                     "skip" if near_alpha else "stop")
            log.append((d, float(alpha), float(test_T)))
            if d == "stop":
                break
            if d == "add":
                T, last = test_T, i + 1
        return last, log

    bad = (tk.n_contrib != tp.n_contrib).nonzero().tolist()
    print(f"B2 {label}: n_contrib differs from the plain version on "
          f"{len(bad)} pixels", flush=True)
    if len(bad) > limit:
        return len(bad), len(bad)
    unexplained = 0
    for t, p in bad:
        s, e = int(sb.tile_bounds[t]), int(sb.tile_bounds[t + 1])
        px = float((t % gx) * 16 + p % 16)
        py = float((t // gx) * 16 + p // 16)
        rows = sb.payload[:, s:e].detach()
        r64 = rows.to(device="cpu", dtype=torch.float64)
        nc = walk(rows.to(device=device, dtype=torch.float32), px, py)[0]
        nh = walk(rows.to(device="cpu", dtype=torch.float32), px, py)[0]
        n64, l64 = walk(r64, px, py)
        ties = [i for i, (d, alpha, test_T) in enumerate(l64)
                if min(abs(alpha - ALPHA_MIN) / ALPHA_MIN,
                       abs(test_T - T_MIN) / T_MIN) < TIE_REL]
        reach = {n64} | {walk(r64, px, py, flip=i)[0] for i in ties}
        nk, npl = int(tk.n_contrib[t, p]), int(tp.n_contrib[t, p])
        ok = nc == npl and nk in reach and npl in reach
        unexplained += not ok
        tie_text = "; ".join(
            f"row {i} {l64[i][0]} (alpha {l64[i][1]!r}, T (1 - alpha) "
            f"{l64[i][2]!r})" for i in ties) or "none"
        print(f"  tile {t} pixel {p} ({px:.0f}, {py:.0f}): kernel {nk}, "
              f"plain {npl}; walks: card float32 {nc}, host float32 {nh}, "
              f"float64 {n64}; float64 ties (1/255 {ALPHA_MIN!r}, T_MIN "
              f"{T_MIN!r}): {tie_text}; n_contrib within one tie "
              f"{sorted(reach)}; decided: {ok}", flush=True)
    return len(bad), unexplained


def replay_b3_ties(args, rows, rows_plain, beyond, limit: int = 8,
                   max_ties: int = 12) -> int:
    """The tiles (at most `limit`) of the ranks whose B3 rows differ from
    the plain version's beyond tolerance (`beyond`, [G, n]), each walked
    again in float64 on the host with the plain version's expressions,
    all 256 pixels at once. A pixel's row is a tie when, in the float64
    walk, alpha lies within `TIE_REL` of 1/255, alpha_raw within it of
    the 0.99 cap, or power within it (of its terms) of 0: there the
    float32 evaluations (the kernel's FMA contractions and expf, the
    card's elementwise exp) may take the other branch, and a pixel that
    takes it walks the rest of the tile with another T and prefix. The
    tile's rows are then the sum over its pixels of each pixel's walk,
    with at most one of its ties decided the other way. A tile is
    decided when the kernel's rows and the plain version's each lie
    within B3's tolerance (atol 1e-3, rtol 1e-2) of the float64 rows of
    some such choice. Prints each tile's ties and the choices that
    reach each version. Returns the number of tiles not decided: all of
    them when more than `limit` tiles, or more than `max_ties` ties in
    a tile, are involved."""
    import itertools

    import torch

    from gaussianeditor_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN

    bounds, payload, rank, tiles, g_color, g_depth, g_T, gx, ch = args
    n, G = payload.shape[1], payload.shape[0]
    bad_rank = beyond.any(dim=0).nonzero().flatten()
    pos = torch.empty_like(rank)
    pos[rank.long()] = torch.arange(n, device=rank.device, dtype=rank.dtype)
    tile_of = torch.searchsorted(bounds.long(), pos[bad_rank].long(),
                                 right=True) - 1
    bad_tiles = sorted(set(tile_of.tolist()))
    print(f"B3: {int(beyond.sum())} entries in {bad_rank.numel()} ranks "
          f"beyond tolerance, in tiles {bad_tiles[:2 * limit]}", flush=True)
    if len(bad_tiles) > limit:
        return len(bad_tiles)
    f64 = dict(dtype=torch.float64, device="cpu")
    p = torch.arange(256)
    undecided = 0
    for t in bad_tiles:
        s, e = int(bounds[t]), int(bounds[t + 1])
        cols = rank[s:e].long()
        got_k = rows[:, cols].to(**f64)
        got_p = rows_plain[:, cols].to(**f64)
        P = payload[:, s:e].to(**f64)
        px = ((t % gx) * 16 + p % 16).to(**f64)
        py = ((t // gx) * 16 + p // 16).to(**f64)
        gc = g_color[t].to(**f64)
        gd = g_depth[t].to(**f64)
        S = g_T[t].to(**f64) * tiles.final_T[t].to(**f64)
        for c in range(ch):
            S = S + gc[:, c] * tiles.color[t, :, c].to(**f64)
        S = S + gd * tiles.depth[t].to(**f64)
        nc = tiles.n_contrib[t].long().cpu()
        m = min(e - s, int(nc.max()))

        def walk(lane, flip_row=None, flip_cap=None):
            """Each lane's per-row parts [m, lanes, G]: lane k walks pixel
            lane[k], taking the other branch at row flip_row[k] (the cap's
            when flip_cap[k], else the skip's); and the ties of the walk
            as (row, lane, cap, float64 value)."""
            X, Y, c_, d_, S_, n_ = (px[lane], py[lane], gc[lane], gd[lane],
                                    S[lane], nc[lane])
            trans = torch.ones(lane.numel(), **f64)
            prefix = torch.zeros(lane.numel(), **f64)
            parts = torch.zeros((m, lane.numel(), G), **f64)
            ties = []
            for i in range(m):
                xs, ys, ca, cb, cc, op, dep = (P[k, i] for k in range(7))
                dx, dy = xs - X, ys - Y
                quad = 0.5 * (ca * dx * dx + cc * dy * dy)
                power = -quad - cb * dx * dy
                alpha_raw = op * torch.exp(power)
                alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
                live = i < n_
                on = live & ~(power > 0.0) & ~(alpha < ALPHA_MIN)
                below = alpha_raw < ALPHA_MAX
                near_min = live & ((alpha - ALPHA_MIN).abs()
                                   < TIE_REL * ALPHA_MIN)
                near_zero = live & (power.abs() <= TIE_REL * (
                    quad.abs() + (cb * dx * dy).abs()))
                near_cap = on & ((alpha_raw - ALPHA_MAX).abs()
                                 < TIE_REL * ALPHA_MAX)
                for k in (near_min | near_zero).nonzero().flatten().tolist():
                    ties.append((i, k, False, float(alpha[k])))
                for k in near_cap.nonzero().flatten().tolist():
                    ties.append((i, k, True, float(alpha_raw[k])))
                if flip_row is not None:
                    at = flip_row == i
                    on = torch.where(at & ~flip_cap, ~on, on)
                    below = torch.where(at & flip_cap, ~below, below)
                w = torch.where(on, alpha * trans, 0.0)
                c_hat = d_ * dep + (c_ * P[7:7 + ch, i]).sum(-1)
                prefix = prefix + w * c_hat
                amc = torch.where(below, alpha, 0.0)
                dpower = torch.where(
                    on, amc * (trans * c_hat - (S_ - prefix) / (1.0 - alpha)),
                    0.0)
                parts[i] = torch.stack(
                    [-dpower * (ca * dx + cb * dy),
                     -dpower * (cc * dy + cb * dx), -0.5 * dpower * dx * dx,
                     -dpower * dx * dy, -0.5 * dpower * dy * dy, dpower]
                    + [c_[:, c] * w for c in range(ch)] + [d_ * w], dim=-1)
                trans = torch.where(on, trans * (1.0 - alpha), trans)
            return parts, ties

        base, ties = walk(p)
        text = "; ".join(
            f"row {i} pixel {k} {'cap (alpha_raw' if cap else 'skip (alpha'}"
            f" {v!r})" for i, k, cap, v in ties) or "none"
        if not ties or len(ties) > max_ties:
            print(f"  tile {t}: {e - s} rows, walked {m}; float64 ties: "
                  f"{text}; decided: False", flush=True)
            undecided += 1
            continue
        lane = torch.tensor([k for _, k, _, _ in ties])
        flipped, _ = walk(lane, torch.tensor([i for i, _, _, _ in ties]),
                          torch.tensor([cap for _, _, cap, _ in ties]))
        # a tie decided the other way changes its pixel's parts alone
        delta = flipped - base[:, lane]                       # [m, J, G]
        scale = torch.where(P[5, :m] > 0.0, 1.0 / P[5, :m], 0.0)
        by_pixel = {}
        for j, k in enumerate(lane.tolist()):
            by_pixel.setdefault(k, []).append(j)
        options = [[None] + js for js in by_pixel.values()]
        total = base.sum(dim=1)                               # [m, G]

        def reach(got):
            """The first choice of ties whose float64 rows hold `got`,
            and how far `got` lies from the rows of no flip."""
            first = None
            for choice in itertools.product(*options):
                ref = total.clone()
                for j in choice:
                    if j is not None:
                        ref += delta[:, j]
                ref[:, 5] *= scale
                ref = ref.T                                   # [G, m]
                err = (got[:, :m] - ref).abs()
                if first is None:
                    first = float(err.max())
                if bool((err <= 1e-3 + 1e-2 * ref.abs()).all()):
                    return [ties[j][:3] for j in choice if j is not None], \
                        first
            return None, first

        rest_zero = bool((got_k[:, m:] == 0).all()
                         and (got_p[:, m:] == 0).all())
        k_choice, k_err = reach(got_k)
        p_choice, p_err = reach(got_p)
        ok = rest_zero and k_choice is not None and p_choice is not None
        undecided += not ok
        print(f"  tile {t}: {e - s} rows, walked {m}; float64 ties: {text}; "
              f"kernel rows within tolerance of the float64 walk with ties "
              f"decided the other way (row, pixel, cap): {k_choice} (max "
              f"abs err with none {k_err:.3g}); plain rows: {p_choice} "
              f"({p_err:.3g}); decided: {ok}", flush=True)
    return undecided


def b1_bytes(b_incl, tiles_touched, n: int, ch: int,
             key_bytes: int = 4) -> tuple:
    """(bytes, slots, visible): what kernel B1 must move for ranks
    [0, n) of this data. It reads b_incl up to the owner of rank n - 1
    (the `slots` after it own no rank below n: at 4x capacity most of
    them are a dead tail) and, of each `visible` slot among those, the
    fields it cannot derive: rect_min, rect_max.x, mean2d, conic,
    opacity, depth and color, 4 (10 + ch) bytes (tiles_touched is b_incl's
    difference; rect_max.y follows from it). It writes a key of
    `key_bytes` and 4 (7 + ch) payload bytes a rank."""
    import torch

    C = b_incl.shape[0]
    last = torch.searchsorted(
        b_incl, torch.tensor([n - 1], dtype=b_incl.dtype,
                             device=b_incl.device), right=True)
    slots = min(int(last[0]), C - 1) + 1
    visible = int((tiles_touched[:slots] > 0).sum())
    return (4 * slots + visible * 4 * (10 + ch)
            + n * (key_bytes + 4 * (7 + ch)), slots, visible)


def check_kernels(proc, gx: int, gy: int, budget: int, label: str,
                  time_plain: bool, replay_flips: bool = False,
                  depth_bits=None, split: bool = False) -> dict:
    """B1 and B2 on one view's preprocessed inputs, each against its plain
    version; returns their errors, times and bounds, and B2's plain tiles.
    The plain versions are timed only when `time_plain` is set; with
    `split`, `sorted_bin` is timed in its parts (`sorted_bin_split`). B2's
    n_contrib must equal the plain version's on every pixel; with
    `replay_flips`, a pixel where they differ passes if that pixel's
    walk replayed on the card reproduces the plain version's, and both
    counts are the float64 walk's within one float32 tie
    (`replay_nc_flips`). depth_bits: the key's depth cut, the grid's
    default when None."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        binning_key,
        binning_key_plain,
        key_depth_bits,
        ranks_kept,
        sorted_bin,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        forward_tiles,
        forward_tiles_plain,
    )
    from gaussianeditor_tpu_torch.testing import (
        assert_images_close,
        fraction_equal,
    )

    T = gx * gy
    C = proc.tiles_touched.shape[0]
    ch = proc.color.shape[1]
    P = 7 + ch
    out = {"ch": ch}

    # --- B1 ---
    b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
    total = int(b_incl[-1])
    n = ranks_kept(total, budget)
    kdb = key_depth_bits(T) if depth_bits is None else depth_bits
    key_args = (b_incl, proc.tiles_touched, proc.rect_min, proc.rect_max,
                proc.mean2d, proc.conic, proc.opacity, proc.depth,
                proc.color, n, total, gx, kdb)

    def b1():
        return binning_key(proc, b_incl, n, total, gx, kdb)

    def b1_plain():
        return binning_key_plain(*key_args)

    key_k, pay_k = b1()
    key_p, pay_p = b1_plain()
    torch.cuda.synchronize()
    assert key_k.dtype == torch.int32, f"B1 {label}: key {key_k.dtype}"
    assert torch.equal(key_k, key_p), f"B1 {label}: keys differ from plain"
    assert torch.equal(pay_k.view(torch.int32), pay_p.view(torch.int32)), \
        f"B1 {label}: payload differs"
    rank_k = torch.sort(key_k, stable=True)[1]
    rank_p = torch.sort(key_p, stable=True)[1]
    assert torch.equal(rank_k, rank_p), f"B1 {label}: sort order differs"
    out["b1_err"] = float((key_k.to(torch.int64) - key_p).abs().max())
    out["b1_ms"] = time_ms(b1)
    out["b1_plain_ms"] = time_ms(b1_plain) if time_plain else None
    b1_b, slots, n_vis = b1_bytes(b_incl, proc.tiles_touched, n, ch)
    out["b1_bound"] = 1e3 * b1_b / H100_BYTES_PER_S
    print(f"B1 binning_key, {label} (ch {ch}): n={n} (num_rendered {total}, "
          f"budget {budget}), visible {n_vis} of slots [0, {slots}) ({C} "
          f"in all); keys, payload and sort "
          f"order bitwise equal; kernel {out['b1_ms']:.4f} ms, plain "
          f"{out['b1_plain_ms'] or float('nan'):.4f} ms, bound "
          f"{out['b1_bound']:.4f} ms (bytes), "
          f"{out['b1_bound'] / out['b1_ms']:.0%} of it", flush=True)
    if split:
        out["sorted_bin_split"] = sorted_bin_split(proc, gx, gy, budget, kdb,
                                                   label)

    # --- B2 ---
    with torch.no_grad():
        sb = sorted_bin(proc, gx, gy, budget, depth_bits=kdb)
    assert not bool(sb.overflow)
    tk = forward_tiles(sb, gx, ch)
    tp, evaluated, contributed = forward_tiles_plain(sb.tile_bounds,
                                                     sb.payload, gx, ch)
    torch.cuda.synchronize()
    for name, a, b, loose in (("color", tk.color, tp.color, 6e-3),
                              ("depth", tk.depth, tp.depth, 2e-2),
                              ("final_T", tk.final_T, tp.final_T, 6e-3)):
        assert torch.isfinite(a).all(), f"B2 {label}: {name} not finite"
        assert_images_close(a, b, loose=loose, name=f"B2 {label} {name}")
    nc_eq = fraction_equal(tk.n_contrib, tp.n_contrib)
    out["nc_replayed"] = 0
    if replay_flips and nc_eq != 1.0:
        # where the plain version's float32 arithmetic on the card parts
        # from the kernel, the same walk in float32 on the host and in
        # float64 decides
        out["nc_replayed"], unexplained = replay_nc_flips(sb, tk, tp, gx,
                                                          label)
        assert unexplained == 0, \
            f"B2 {label}: n_contrib differs on {unexplained} pixels"
    else:
        assert nc_eq == 1.0, \
            f"B2 {label}: n_contrib equal on only {nc_eq:.6f}"
    out["b2_err"] = max(float((tk.color - tp.color).abs().max()),
                        float((tk.depth - tp.depth).abs().max()),
                        float((tk.final_T - tp.final_T).abs().max()))
    out["b2_ms"] = time_ms(lambda: forward_tiles(sb, gx, ch))
    # the plain version takes seconds per call: one sample suffices
    out["b2_plain_ms"] = time_ms(lambda: forward_tiles_plain(
        sb.tile_bounds, sb.payload, gx, ch),
        runs=PLAIN_RUNS) if time_plain else None
    pairs = int(evaluated.sum())
    contrib = int(contributed.sum())
    b2_ops = B2_OPS_EVALUATED * pairs + (B2_OPS_CONTRIB_BASE + 2 * (ch + 1)) * contrib
    b2_bytes = 4 * P * n + 4 * (T + 1) + 4 * T * 256 * (ch + 3)
    b2_bound_ops = 1e3 * b2_ops / H100_FP32_PER_S
    b2_bound_bytes = 1e3 * b2_bytes / H100_BYTES_PER_S
    out["b2_bound"] = max(b2_bound_ops, b2_bound_bytes)
    out["b2_by"] = "operations" if b2_bound_ops >= b2_bound_bytes else "bytes"
    cnt = sb.tile_bounds[1:] - sb.tile_bounds[:-1]
    print(f"B2 forward_tile, {label} (ch {ch}): {T} tiles, rows/tile max "
          f"{int(cnt.max())} mean {float(cnt.float().mean()):.1f}, evaluated "
          f"pairs {pairs}, contributing {contrib}; n_contrib equal on "
          f"{nc_eq:.6f}, max abs err {out['b2_err']:.3g}; kernel "
          f"{out['b2_ms']:.4f} ms, plain "
          f"{out['b2_plain_ms'] or float('nan'):.4f} ms, bound "
          f"{out['b2_bound']:.4f} ms ({out['b2_by']}; ops {b2_bound_ops:.4f}, "
          f"bytes {b2_bound_bytes:.4f})", flush=True)
    out["plain_tiles"] = tp
    out.update(sb=sb, tiles=tk, contrib=contrib)
    return out


def sorted_bin_split(proc, gx: int, gy: int, budget: int, kdb: int,
                     label: str) -> dict:
    """`sorted_bin` timed whole and in its parts, each by CUDA events
    (`time_ms`): the cumsum with its host read, B1, the sort, the payload
    gather and the tile bounds; beside them `torch.sort` of the same n
    keys as int64 (unbiased) and as int32, in turns."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        KEY_BIAS,
        binning_key,
        ranks_kept,
        sorted_bin,
        tile_bounds_of,
    )

    T = gx * gy
    tt = proc.tiles_touched

    def host():
        b = torch.cumsum(tt, 0, dtype=torch.int32)
        return b, int(b[-1])

    b_incl, total = host()
    n = ranks_kept(total, budget)
    key, payload = binning_key(proc, b_incl, n, total, gx, kdb)
    skey, rank = torch.sort(key, stable=True)
    key64 = key.to(torch.int64) + KEY_BIAS
    with torch.no_grad():
        ms = {
            "whole": time_ms(lambda: sorted_bin(proc, gx, gy, budget,
                                                depth_bits=kdb)),
            "cumsum_host_read": time_ms(host),
            "b1": time_ms(lambda: binning_key(proc, b_incl, n, total, gx,
                                              kdb)),
            "sort": time_ms(lambda: torch.sort(key, stable=True)),
            "gather": time_ms(lambda: payload[:, rank]),
            "tile_bounds": time_ms(lambda: tile_bounds_of(skey, T, kdb)),
        }
        # the two key widths in turns: int64, int32, int32, int64
        t = [time_ms(lambda k=k: torch.sort(k, stable=True))
             for k in (key64, key, key, key64)]
    ms["sort_int64"], ms["sort_int32"] = [t[0], t[3]], [t[1], t[2]]
    parts = ("cumsum_host_read", "b1", "sort", "gather", "tile_bounds")
    print(f"sorted_bin split, {label}: n={n}, {T} tiles; whole "
          f"{ms['whole']:.4f} ms = " + " + ".join(
              f"{k} {ms[k]:.4f}" for k in parts)
          + f" (sum {sum(ms[k] for k in parts):.4f}) ms; torch.sort of the "
          f"{n} keys as int64 {t[0]:.4f} / {t[3]:.4f} ms, as int32 "
          f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    return ms


def phase_kernels(scene, device) -> list:
    """Phase 3: each kernel against its plain version at full width, on
    both renders a served frame makes: the color view (ch = 3) and the
    overlay's mask view (ch = 1). The JSON line carries the color view's
    times and bounds, and the larger error of the two views."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )

    cam = lookat_camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, 0.8, SIZE, SIZE, device=device)
    gx = gy = SIZE // 16
    budget = default_max_instances(scene.capacity)
    with torch.no_grad():
        color_proc = preprocess_scene(scene, cam)
        # the overlay's second render (webui `_render`): the mask as color
        mask_proc = preprocess_scene(
            scene, cam, override_color=scene.mask[:, None].to(torch.float32))
    kernel_resources("binning_key", (3,))
    kernel_resources("forward_tile", ())
    main = check_kernels(color_proc, gx, gy, budget, "color view", True,
                         split=True)
    overlay = check_kernels(mask_proc, gx, gy, budget, "overlay mask view",
                            False)
    assert main["ch"] == 3 and overlay["ch"] == 1

    plain_img = torch.clamp(
        tiles_to_image(main["plain_tiles"].color, gx, gy, SIZE, SIZE), 0.0, 1.0)
    view = dict(proc=color_proc, sb=main["sb"], tiles=main["tiles"],
                contrib=main["contrib"], gx=gx, gy=gy, budget=budget)
    return cam, plain_img.cpu().numpy(), view, [
        dict(name="B1 binning_key", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/binning_key.cu",
             replaces="gaussianeditor_tpu/ops/binning_sorted.py:150",
             max_abs_err=max(main["b1_err"], overlay["b1_err"]),
             ms=main["b1_ms"], plain_ms=main["b1_plain_ms"],
             bound_ms=main["b1_bound"], bound_by="bytes", library_ms=None,
             sorted_bin_split=main["sorted_bin_split"]),
        dict(name="B2 forward_tile", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/forward_tile.cu",
             replaces="gaussianeditor_tpu/ops/pallas_composite.py:599",
             max_abs_err=max(main["b2_err"], overlay["b2_err"]),
             ms=main["b2_ms"], plain_ms=main["b2_plain_ms"],
             bound_ms=main["b2_bound"], bound_by=main["b2_by"],
             library_ms=None),
    ]


def phase_serve(state, cam, plain_img) -> dict:
    """Phase 4: frames through the viewer's HTTP server; returns the
    launch counts of this phase."""
    from PIL import Image

    from gaussianeditor_tpu_torch.apps.webui import serve
    from gaussianeditor_tpu_torch.ops import _kernels

    pose = ",".join(repr(v) for v in view_pose())
    requests = [
        ("orbit a", "theta=0.6&phi=0.3&radius=4"),
        ("orbit b", "theta=2.2&phi=-0.2&radius=3.5"),
        ("pose", f"pose={pose}&fovx=0.8&fovy=0.8"),
        ("overlay", "theta=0.6&phi=0.3&radius=4&overlay=1"),
    ]
    # a user dragging the view: a sweep of orbit frames, one at a time
    requests += [(f"sweep {i}", f"theta={0.3 * i:.2f}&phi=0.2&radius=4")
                 for i in range(SWEEP)]
    server = serve(state, port=0, block=False)
    try:
        url = f"http://localhost:{server.server_address[1]}"
        _kernels.reset_launch_counts()
        frames, lat = {}, {}
        for name, query in requests:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{url}/render?size={SIZE}&{query}",
                                        timeout=300) as r:
                body, ctype = r.read(), r.headers.get("Content-Type")
            lat[name] = 1e3 * (time.perf_counter() - t0)
            assert ctype == "image/png", ctype
            img = np.asarray(Image.open(io.BytesIO(body)))
            assert img.shape == (SIZE, SIZE, 3), img.shape
            assert img.max() > 0 and img.std() > 1.0, f"{name}: blank frame"
            frames[name] = img
            if not name.startswith("sweep"):
                print(f"GET /render {name}: {lat[name]:.2f} ms, "
                      f"{len(body)} bytes", flush=True)
        counts = _kernels.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
    plain = sorted(v for k, v in lat.items() if k != "overlay")
    print(f"GET /render latency over {len(plain)} plain frames (first one "
          f"included): median {statistics.median(plain):.2f} ms, min "
          f"{plain[0]:.2f} ms, max {plain[-1]:.2f} ms", flush=True)
    print(f"launches while serving: {counts}", flush=True)
    for k in ("binning_key", "forward_tile"):
        assert counts[k] >= 1, f"kernel {k} was not launched on the main path"
    # the pose frame is the phase-3 view: it must match the plain render
    want = (plain_img * 255).astype(np.uint8).astype(int)
    diff = np.abs(frames["pose"].astype(int) - want)
    ok = float(np.mean(diff <= 2))
    assert ok >= 0.995, f"served frame vs plain render: {ok:.4f} within 2/255"
    assert (frames["overlay"] != frames["orbit a"]).any(), "overlay not drawn"
    print(f"served pose frame vs plain render: {ok:.6f} of values within "
          f"2/255 (max diff {int(diff.max())})", flush=True)
    return counts


def profile_once(fn, label: str, top: int = 10) -> None:
    """Run `fn` once (warm) under torch.profiler and print its wall time,
    the device's busy and idle shares, and device time by host op and by
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side rows (kernels, copies) carry the device time once; host
    # op rows (aten::...) carry the device time of the kernels they launch
    ops, kernels = [], []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            on_host = e.device_type == DeviceType.CPU
            (ops if on_host else kernels).append(
                (e.self_device_time_total / 1e3, e.count, e.key))
    dev_ms = sum(r[0] for r in kernels)
    print(f"profile of {label}: wall {wall_ms:.2f} ms, "
          f"device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - dev_ms / wall_ms):.1f}%", flush=True)
    for title, rows in (("by host op", ops), ("by kernel", kernels)):
        print(f" device time {title}:")
        for ms, count, key in sorted(rows, reverse=True)[:top]:
            print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")


def phase_profile(state) -> None:
    """Phase 5: where one frame's time goes. A warm `render_frame` of the
    phase-3 view under torch.profiler: device time by kernel and the
    device's busy share of the frame's wall time."""
    import torch

    def frame():
        return state.render_frame(0.0, 0.0, 0.0, SIZE, False,
                                  pose=view_pose(), fovx=0.8, fovy=0.8)

    frame()
    torch.cuda.synchronize()
    profile_once(frame, "one warm frame (render + PNG)")

    # the same frame split on the host clock, profiler off: the render to
    # a host image, then the PNG encode (median of 5 each)
    from gaussianeditor_tpu_torch.apps.webui import encode_png
    from gaussianeditor_tpu_torch.core.cameras import Camera

    cam = Camera.from_c2w(np.asarray(view_pose()).reshape(4, 4), 0.8, 0.8,
                          SIZE, SIZE, device=state.scene.device)
    split = {"render": [], "png": []}
    for _ in range(5):
        t0 = time.perf_counter()
        img = state._render(cam, False)
        t1 = time.perf_counter()
        encode_png((img * 255).astype(np.uint8))
        split["render"].append(1e3 * (t1 - t0))
        split["png"].append(1e3 * (time.perf_counter() - t1))
    print("frame split on the host clock: " + ", ".join(
        f"{k} {statistics.median(v):.2f} ms" for k, v in split.items()),
        flush=True)


def phase_backward(view, time_plain: bool = True) -> list:
    """Phase 6: kernels B3 and B4 against their plain versions on phase
    3's color view (or another view's, as phase 14 holds them), with a
    seeded cotangent; B3's rows beyond tolerance must be decided by a tie
    (`replay_b3_ties`). Returns their JSON rows. The plain versions are
    timed only when `time_plain` is set."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        rank_segment_sum,
        rank_segment_sum_plain,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        backward_tiles,
        backward_tiles_plain,
    )

    proc, sb, tiles, gx = view["proc"], view["sb"], view["tiles"], view["gx"]
    T = gx * view["gy"]
    C = proc.tiles_touched.shape[0]
    n = sb.payload.shape[1]
    G = sb.payload.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    g_color = torch.randn((T, 256, 3), generator=gen, device="cuda")
    g_depth = 0.1 * torch.randn((T, 256), generator=gen, device="cuda")
    g_T = 0.05 * torch.randn((T, 256), generator=gen, device="cuda")
    args = (sb.tile_bounds, sb.payload, sb.rank, tiles, g_color, g_depth,
            g_T, gx, 3)
    b_incl, tt = sb.b_incl, proc.tiles_touched

    # --- B3 ---
    row_stats(sb.tile_bounds, tiles.n_contrib, "sorted route")
    kernel_resources("backward_tile", (1, 2, 3))
    rows = backward_tiles(*args)
    rows_plain = backward_tiles_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(rows).all(), "B3: rows not finite"
    err = (rows - rows_plain).abs()
    ok = err <= 1e-3 + 1e-2 * rows_plain.abs()
    b3_err = float(err.max())
    print(f"B3 backward_tile: {n} rows x {G} fields; max abs err vs plain "
          f"{b3_err:.3g}, {float(ok.float().mean()):.7f} of entries within "
          f"atol 1e-3 / rtol 1e-2; rows max |.| "
          f"{float(rows_plain.abs().max()):.4g}", flush=True)
    if not bool(ok.all()):
        # a pixel whose float32 walks branch apart at a tie: decided by
        # replaying the tiles in float64
        undecided = replay_b3_ties(args, rows, rows_plain, ~ok)
        assert undecided == 0, (f"B3: rows differ from plain beyond "
                                f"atol/rtol in {undecided} tiles not "
                                f"decided by a tie")

    # --- B4 ---
    kernel_resources("rank_segment_sum", (3,))
    d = rank_segment_sum(rows, b_incl, tt, C)
    d_plain = rank_segment_sum_plain(rows, b_incl, tt, C)
    torch.cuda.synchronize()
    rms = d_plain.pow(2).mean(dim=0).sqrt()
    b4_err = float((d - d_plain).abs().max())
    rel = float(((d - d_plain).abs() / rms).max())
    print(f"B4 rank_segment_sum: {C} slots x {G} fields; max abs err vs "
          f"plain {b4_err:.3g}, max {rel:.3g} of the column RMS", flush=True)
    assert rel <= 1e-5, f"B4: {rel} of the column RMS"
    assert not d[tt == 0].any(), "B4: a slot without ranks got a sum"

    # --- B3 then B4, again: bitwise ---
    rows2 = backward_tiles(*args)
    d2 = rank_segment_sum(rows2, b_incl, tt, C)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2), "B3 is not bitwise repeatable"
    assert torch.equal(d, d2), "B4 is not bitwise repeatable"
    print("B3 then B4 run twice: bitwise equal", flush=True)

    # --- times and bounds ---
    b3_ms = time_ms(lambda: backward_tiles(*args))
    b4_ms = time_ms(lambda: rank_segment_sum(rows, b_incl, tt, C))
    b3_plain_ms = b4_plain_ms = None
    if time_plain:
        b3_plain_ms = time_ms(lambda: backward_tiles_plain(*args),
                              runs=PLAIN_RUNS)
        b4_plain_ms = time_ms(
            lambda: rank_segment_sum_plain(rows, b_incl, tt, C),
            runs=PLAIN_RUNS)
    # the library's segmented sum over rank-major rows, segments cut at n
    lengths = (torch.clamp(b_incl.long(), max=n)
               - torch.clamp(b_incl.long() - tt.long(), max=n))
    rows_t = rows.T.contiguous()
    lib = torch.segment_reduce(rows_t, "sum", lengths=lengths, axis=0)
    lib_err = float((lib - d_plain).abs().max())
    lib_ms = time_ms(lambda: torch.segment_reduce(rows_t, "sum",
                                                  lengths=lengths, axis=0))
    sum_nc = int(tiles.n_contrib.long().sum())
    contrib = view["contrib"]
    b3_ops = B3_OPS_EVALUATED * sum_nc + B3_OPS_CONTRIB * contrib
    # payload and rank read, 11 per-pixel values read, rows written
    b3_bytes = 4 * G * n + 8 * n + 4 * 11 * T * 256 + 4 * G * n
    b3_bound_ops = 1e3 * b3_ops / H100_FP32_PER_S
    b3_bound_bytes = 1e3 * b3_bytes / H100_BYTES_PER_S
    b3_bound = max(b3_bound_ops, b3_bound_bytes)
    b3_by = "operations" if b3_bound_ops >= b3_bound_bytes else "bytes"
    b4_bytes = 4 * G * n + 8 * C + 4 * G * C
    b4_bound = 1e3 * b4_bytes / H100_BYTES_PER_S
    print(f"B3 backward_tile: rows before n_contrib {sum_nc}, contributing "
          f"pairs {contrib}; kernel {b3_ms:.4f} ms, plain "
          f"{b3_plain_ms or float('nan'):.4f} ms, bound {b3_bound:.4f} ms "
          f"({b3_by}; ops {b3_bound_ops:.4f}, bytes {b3_bound_bytes:.4f})",
          flush=True)
    print(f"B4 rank_segment_sum: kernel {b4_ms:.4f} ms, plain "
          f"{b4_plain_ms or float('nan'):.4f} ms, torch.segment_reduce "
          f"{lib_ms:.4f} ms (max "
          f"abs err vs plain {lib_err:.3g}), bound {b4_bound:.4f} ms (bytes, "
          f"{b4_bytes} B)", flush=True)
    return [
        dict(name="B3 backward_tile", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/backward_tile.cu",
             replaces="gaussianeditor_tpu/ops/pallas_composite.py:873",
             max_abs_err=b3_err, ms=b3_ms, plain_ms=b3_plain_ms,
             bound_ms=b3_bound, bound_by=b3_by, library_ms=None),
        dict(name="B4 rank_segment_sum", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/rank_segment_sum.cu",
             replaces="gaussianeditor_tpu/ops/binning_sorted.py:205",
             max_abs_err=b4_err, ms=b4_ms, plain_ms=b4_plain_ms,
             bound_ms=b4_bound, bound_by="bytes", library_ms=lib_ms),
    ]


def feature_views(scene, cam):
    """Phase 8's seeded 8- and 32-channel feature renders of the view:
    their preprocess outputs."""
    import torch

    from gaussianeditor_tpu_torch.ops.render import preprocess_scene

    C = scene.capacity
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    feat = torch.rand((C, FEATURE_CH), generator=gen, device="cuda")
    wide = torch.rand((C, WIDE_CH), generator=gen, device="cuda")
    with torch.no_grad():
        return (preprocess_scene(scene, cam, override_color=feat),
                preprocess_scene(scene, cam, override_color=wide))


def phase_dense(view, scene, cam, budget: int):
    """Phase 8: kernels B5 and B6 against their plain versions on phase
    3's color view and an 8-channel feature render of it, B5 against B2
    and B6 then B4 against B3 then B4; returns their JSON rows and B4's
    time on B6's rows."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        rank_segment_sum,
        rank_segment_sum_plain,
        sorted_bin,
    )
    from gaussianeditor_tpu_torch.ops.dense_composite import (
        backward_chunks,
        backward_chunks_plain,
        forward_chunks,
        forward_chunks_plain,
        pack_instances,
        rows_by_rank,
        tile_chunk_bounds,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import backward_tiles
    from gaussianeditor_tpu_torch.testing import (
        assert_images_close,
        fraction_equal,
    )

    proc, sb, b2_tiles, gx = view["proc"], view["sb"], view["tiles"], view["gx"]
    T = gx * gx
    C = proc.tiles_touched.shape[0]
    tt = proc.tiles_touched
    feat_proc, wide_proc = feature_views(scene, cam)
    kernel_resources("forward_chunk", (1, 3, FEATURE_CH, WIDE_CH))
    kernel_resources("backward_chunk", (1, 3, FEATURE_CH, WIDE_CH))

    with torch.no_grad():
        dense_ms = time_ms(lambda: dense_bin(proc, gx, gx, budget))
        sorted_ms = time_ms(lambda: sorted_bin(proc, gx, gx, budget))
    print(f"binning the color view: dense_bin {dense_ms:.4f} ms, sorted_bin "
          f"{sorted_ms:.4f} ms (CUDA events around each call, its one host "
          f"read included)", flush=True)

    res = {}
    for label, p in (("color view", proc), ("feature view", feat_proc),
                     ("wide feature view", wide_proc)):
        ch = p.color.shape[1]
        with torch.no_grad():
            db = dense_bin(p, gx, gx, budget)
        assert not bool(db.overflow), f"{label}: overflow"
        NC = db.chunk_tile.shape[0]
        inst = pack_instances(p.mean2d, p.conic, p.opacity, p.color, p.depth,
                              db)
        # --- B5 ---
        tk = forward_chunks(inst, db, gx)
        tp, evaluated, contributed = forward_chunks_plain(inst, db, gx)
        torch.cuda.synchronize()
        for name, a, b, loose in (("color", tk.color, tp.color, 6e-3),
                                  ("depth", tk.depth, tp.depth, 2e-2),
                                  ("final_T", tk.final_T, tp.final_T, 6e-3)):
            assert torch.isfinite(a).all(), f"B5 {label}: {name} not finite"
            assert_images_close(a, b, loose=loose, name=f"B5 {label} {name}")
        nc_eq = fraction_equal(tk.n_contrib, tp.n_contrib)
        assert nc_eq >= 0.999, f"B5 {label}: n_contrib equal on {nc_eq:.5f}"
        b5_err = max(float((tk.color - tp.color).abs().max()),
                     float((tk.depth - tp.depth).abs().max()),
                     float((tk.final_T - tp.final_T).abs().max()))
        b5_ms = time_ms(lambda: forward_chunks(inst, db, gx))
        print(f"B5 forward_chunk, {label} (ch {ch}): {int(db.num_rendered)} "
              f"ranks in {int((db.chunk_nvalid > 0).sum())} live of {NC} "
              f"chunks; n_contrib equal to plain on {nc_eq:.6f}, max abs "
              f"err {b5_err:.3g}; kernel {b5_ms:.4f} ms", flush=True)

        # --- B6 ---
        g = torch.Generator(device="cuda").manual_seed(SEED + 3 + ch)
        cot = (torch.randn((T, 256, ch), generator=g, device="cuda"),
               0.1 * torch.randn((T, 256), generator=g, device="cuda"),
               0.05 * torch.randn((T, 256), generator=g, device="cuda"))
        bargs = (inst, db, tk) + cot + (gx,)
        grows = backward_chunks(*bargs)
        grows_plain = backward_chunks_plain(*bargs)
        torch.cuda.synchronize()
        assert torch.isfinite(grows).all(), f"B6 {label}: rows not finite"
        err = (grows - grows_plain).abs()
        ok = err <= 1e-3 + 1e-2 * grows_plain.abs()
        b6_err = float(err.max())
        b6_ms = time_ms(lambda: backward_chunks(*bargs))
        print(f"B6 backward_chunk, {label} (ch {ch}): {NC} chunks x "
              f"{grows.shape[1]} fields; max abs err vs plain {b6_err:.3g}, "
              f"{float(ok.float().mean()):.7f} of entries within atol 1e-3 / "
              f"rtol 1e-2; rows max |.| {float(grows_plain.abs().max()):.4g}; "
              f"kernel {b6_ms:.4f} ms", flush=True)
        assert bool(ok.all()), f"B6 {label}: rows differ from plain"
        if ch == 3:
            row_stats(tile_chunk_bounds(db), tk.n_contrib,
                      "dense route (chunks)", per=128)
        res[ch] = dict(db=db, inst=inst, tk=tk, grows=grows, cot=cot,
                       pairs=int(evaluated.sum()),
                       contrib=int(contributed.sum()), b5_err=b5_err,
                       b5_ms=b5_ms, b6_err=b6_err, b6_ms=b6_ms)
        if ch != 3:     # the color view's tensors are used below
            del res[ch]["db"], res[ch]["inst"], res[ch]["tk"], res[ch]["grows"]
        del tp, grows_plain
    assert set(res) == {3, FEATURE_CH, WIDE_CH}
    print("B6 backward_chunk by width: " + ", ".join(
        f"ch {k} {res[k]['b6_ms']:.4f} ms" for k in sorted(res)), flush=True)

    # --- B5 against B2, the color view: the same rows in the same order,
    # through the same walk (composite_forward.cuh) ---
    r = res[3]
    tk, db, inst = r["tk"], r["db"], r["inst"]
    for name in tk._fields:
        assert torch.equal(getattr(tk, name), getattr(b2_tiles, name)), \
            f"B5 and B2 {name} differ"
    print("B5 vs B2 on the color view: color, depth, final_T and n_contrib "
          "bitwise equal", flush=True)

    # --- B6 then B4 against B3 then B4, the color view ---
    g_color, g_depth, g_T = r["cot"]
    gathered = rows_by_rank(r["grows"], db.a_by_rank)
    d_dense = rank_segment_sum(gathered, db.b_incl, tt, C)
    d_plain = rank_segment_sum_plain(gathered, db.b_incl, tt, C)
    rows3 = backward_tiles(sb.tile_bounds, sb.payload, sb.rank, b2_tiles,
                           g_color, g_depth, g_T, gx, 3)
    d_sorted = rank_segment_sum(rows3, sb.b_incl, tt, C)
    torch.cuda.synchronize()
    rms = d_plain.pow(2).mean(dim=0).sqrt()
    rel_plain = float(((d_dense - d_plain).abs() / rms).max())
    print(f"B4 over B6's rows gathered into rank order: max {rel_plain:.3g} "
          f"of the column RMS vs plain", flush=True)
    assert rel_plain <= 1e-5, f"B4 on B6's rows: {rel_plain} of the column RMS"
    col_max = d_sorted.abs().max(dim=0).values
    rel = float(((d_dense - d_sorted).abs() / (col_max + 1e-30)).max())
    print(f"B6 then B4 vs B3 then B4: max {rel:.3g} of each column's max",
          flush=True)
    assert rel <= 3e-4, f"dense gradients off by {rel} of a column's max"
    assert torch.equal(d_dense, d_sorted), \
        "B6 then B4 is not bitwise equal to B3 then B4"
    print("B6 then B4 and B3 then B4: bitwise equal", flush=True)
    grows2 = backward_chunks(inst, db, tk, g_color, g_depth, g_T, gx)
    d2 = rank_segment_sum(rows_by_rank(grows2, db.a_by_rank), db.b_incl, tt,
                          C)
    torch.cuda.synchronize()
    assert torch.equal(r["grows"], grows2), "B6 is not bitwise repeatable"
    assert torch.equal(d_dense, d2), "B6 then B4 is not bitwise repeatable"
    b4_dense_ms = time_ms(lambda: rank_segment_sum(gathered, db.b_incl, tt,
                                                   C))
    gather_ms = time_ms(lambda: rows_by_rank(r["grows"], db.a_by_rank))
    print(f"B6 then B4 run twice: bitwise equal; B4 over B6's gathered rows "
          f"{b4_dense_ms:.4f} ms, the gather (rows_by_rank) {gather_ms:.4f} "
          f"ms", flush=True)
    del gathered, d_plain

    # --- times and bounds, the color view ---
    bargs = (inst, db, tk, g_color, g_depth, g_T, gx)
    b5_plain_ms = time_ms(lambda: forward_chunks_plain(inst, db, gx),
                          runs=PLAIN_RUNS)
    b6_plain_ms = time_ms(lambda: backward_chunks_plain(*bargs),
                          runs=PLAIN_RUNS)
    total = int(db.num_rendered)
    NC, P, _ = inst.shape
    G = P       # gradient fields: 2 + 3 + 1 + ch + 1
    ch = P - 7
    b5_ops = B2_OPS_EVALUATED * r["pairs"] + (
        B2_OPS_CONTRIB_BASE + 2 * (ch + 1)) * r["contrib"]
    # live instance rows, chunk n_valid and offset, bounds, the outputs
    b5_bytes = 4 * P * total + 8 * NC + 4 * (T + 1) + 4 * T * 256 * (ch + 3)
    sum_nc = int(tk.n_contrib.long().sum())
    b6_ops = B3_OPS_EVALUATED * sum_nc + B3_OPS_CONTRIB * r["contrib"]
    # live instance rows and metadata read, 11 per-pixel values read, the
    # aligned rows written
    b6_bytes = (4 * P * total + 8 * NC + 4 * (T + 1) + 4 * 11 * T * 256
                + 4 * G * NC * 128)
    out = []
    for name, ops, nbytes, ms, plain_ms, err, src, line in (
            ("B5 forward_chunk", b5_ops, b5_bytes, r["b5_ms"], b5_plain_ms,
             max(res[k]["b5_err"] for k in res), "forward_chunk.cu", 292),
            ("B6 backward_chunk", b6_ops, b6_bytes, r["b6_ms"], b6_plain_ms,
             max(res[k]["b6_err"] for k in res), "backward_chunk.cu", 459)):
        b_ops = 1e3 * ops / H100_FP32_PER_S
        b_bytes = 1e3 * nbytes / H100_BYTES_PER_S
        by = "operations" if b_ops >= b_bytes else "bytes"
        key = name[:2].lower() + "_ms"
        print(f"{name}, color view: kernel {ms:.4f} ms (ch {FEATURE_CH}: "
              f"{res[FEATURE_CH][key]:.4f} ms, ch {WIDE_CH}: "
              f"{res[WIDE_CH][key]:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {max(b_ops, b_bytes):.4f} ms ({by}; "
              f"ops {b_ops:.4f}, bytes {b_bytes:.4f}, {nbytes} B)", flush=True)
        out.append(dict(name=name, route="cuda",
                        source=f"gaussianeditor_tpu_torch/csrc/{src}",
                        replaces=f"gaussianeditor_tpu/ops/pallas_composite.py:{line}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(b_ops, b_bytes), bound_by=by,
                        library_ms=None,
                        ms_by_ch={k: res[k][key] for k in sorted(res)}))
    print(f"evaluated pairs {r['pairs']}, contributing {r['contrib']}, rows "
          f"before n_contrib {sum_nc}", flush=True)
    return out, b4_dense_ms


def run_steps(step, state, cams, targets, k: int):
    """`k` train steps, each timed on the host clock up to a synchronize;
    returns the state and [(ms, metrics)]."""
    import torch

    hist = []
    for _ in range(k):
        t0 = time.perf_counter()
        state, m = step(state, cams, targets)
        torch.cuda.synchronize()
        hist.append((1e3 * (time.perf_counter() - t0), m))
    return state, hist


def check_steps(state, hist, label: str) -> dict:
    """loss_l1 falls, no overflow, every loss term, parameter, moment and
    statistic finite on every slot; prints and returns the step times and
    the peak device memory."""
    import torch

    l1 = [float(m["loss_l1"]) for _, m in hist]
    print(f"{label}: loss_l1 by step: " + ", ".join(f"{v:.6f}" for v in l1),
          flush=True)
    last = hist[-1][1]
    print("last step: " + ", ".join(f"{k} {float(v):.6g}"
                                    for k, v in last.items()), flush=True)
    assert l1[-1] < l1[0], f"{label}: loss_l1 did not fall"
    assert not any(bool(m["overflow"]) for _, m in hist), "overflow"
    for _, m in hist:
        assert all(bool(torch.isfinite(v).all()) for k, v in m.items()
                   if k != "overflow"), "a loss term is not finite"
    for k, v in state.scene.params().items():
        assert torch.isfinite(v).all(), f"{k} not finite"
        assert torch.isfinite(state.opt_state.mu[k]).all(), f"mu {k}"
        assert torch.isfinite(state.opt_state.nu[k]).all(), f"nu {k}"
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert torch.isfinite(getattr(state.stats, f)).all(), f
    ms = [t for t, _ in hist]
    stats = dict(median=statistics.median(ms),
                 peak=torch.cuda.max_memory_allocated() / 2**30)
    print(f"{label}: ms per step (host clock, synchronized): median "
          f"{stats['median']:.2f}, first {ms[0]:.2f}, min {min(ms):.2f}, max "
          f"{max(ms):.2f}; peak device memory {stats['peak']:.2f} GiB",
          flush=True)
    return stats


def check_repeat(step, state, cams, targets, label: str) -> None:
    """One step twice from a copied state: bitwise equal; then one more
    step under torch.profiler."""
    import torch

    copy = state.clone()
    g1, g2 = {}, {}
    s1, m1 = step(state, cams, targets, grads=g1)
    s2, m2 = step(copy, cams, targets, grads=g2)
    torch.cuda.synchronize()
    assert torch.equal(m1["loss"], m2["loss"]), "loss differs"
    for k in g1:
        assert torch.isfinite(g1[k]).all(), f"gradient of {k} not finite"
        assert torch.equal(g1[k], g2[k]), f"gradient of {k} differs"
        assert torch.equal(getattr(s1.scene, k), getattr(s2.scene, k)), k
        assert torch.equal(s1.opt_state.nu[k], s2.opt_state.nu[k]), k
    print(f"{label}: one step twice from a copied state: gradients (finite "
          "on every slot), parameters and moments bitwise equal", flush=True)
    del copy, s2, g1, g2
    profile_once(lambda: step(state, cams, targets), f"one {label} step",
                 top=15)


def phase_train(scene, cameras_extent: float) -> dict:
    """Phase 7: the edit train step at full width; returns the launch
    counts of its 12 steps and densify step, its step times and losses,
    and what phase 9 takes over (optimizer, cameras, targets)."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.train.densify import DensifyConfig
    from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
    from gaussianeditor_tpu_torch.train.perceptual import (
        multiscale_gradient_loss,
    )
    from gaussianeditor_tpu_torch.train.trainer import (
        LossWeights,
        init_train_state,
        make_densify_step,
        make_train_step,
    )

    cams = orbit_cameras(2, 4.0, 0.8, 0.8, SIZE, SIZE, device="cuda")
    shift = torch.tensor(COLOR_SHIFT, device="cuda")
    with torch.no_grad():
        targets = torch.stack([
            torch.clamp(render(scene, c, torch.zeros(3, device="cuda")).color
                        * shift, 0.0, 1.0) for c in cams])
    base = OptimConfig()
    sc = LR_SCALERS
    optim = GaussianAdam(OptimConfig(
        position_lr_init=base.position_lr_init * sc["gs_lr_scaler"],
        position_lr_final=base.position_lr_final * sc["gs_final_lr_scaler"],
        position_lr_max_steps=EDIT_MAX_STEPS,
        feature_lr=base.feature_lr * sc["color_lr_scaler"],
        opacity_lr=base.opacity_lr * sc["opacity_lr_scaler"],
        scaling_lr=base.scaling_lr * sc["scaling_lr_scaler"],
        rotation_lr=base.rotation_lr * sc["rotation_lr_scaler"],
        spatial_lr_scale=cameras_extent))
    step = make_train_step(optim, LossWeights(),
                           perceptual=multiscale_gradient_loss)
    state = init_train_state(scene, optim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _kernels.reset_launch_counts()
    state, hist = run_steps(step, state, cams, targets, TRAIN_STEPS[0])
    st = state.stats
    seen = st.denom > 0
    thres = float(torch.quantile(st.xyz_gradient_accum[seen] / st.denom[seen],
                                 0.999))
    densify = make_densify_step(
        optim, DensifyConfig(max_grad=thres, max_densify_percent=0.01,
                             min_opacity=0.005, max_screen_size=5.0,
                             percent_dense=optim.config.percent_dense),
        cameras_extent, 0.1, 1.3)
    n_alive0 = int(scene.n_alive)
    t0 = time.perf_counter()
    state, info = densify(state, generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    densify_ms = 1e3 * (time.perf_counter() - t0)
    state, more = run_steps(step, state, cams, targets, TRAIN_STEPS[1])
    hist += more
    counts = _kernels.launch_counts()
    info = {k: int(v) for k, v in info.items()}
    print(f"train: {len(hist)} steps at batch 2, {SIZE}x{SIZE}, "
          f"{scene.capacity} slots; densify at step {TRAIN_STEPS[0]} "
          f"(threshold {thres:.4g}, the 99.9th percentile over "
          f"{int(seen.sum())} seen Gaussians): {info}, alive {n_alive0} -> "
          f"{int(scene.n_alive)}, {densify_ms:.1f} ms", flush=True)
    print(f"launches over the 12 steps and the densify step: {counts}",
          flush=True)
    for k in ("binning_key", "forward_tile", "backward_tile",
              "rank_segment_sum", "preprocess_forward",
              "preprocess_backward"):
        assert counts[k] == 2 * len(hist), f"{k} launched {counts[k]} times"
    stats = check_steps(state, hist, "train")
    assert info["n_cloned"] + info["n_split"] > 0, "densify did nothing"
    check_repeat(step, state, cams, targets, "train")
    return dict(counts=counts, stats=stats, optim=optim, cams=cams,
                targets=targets, l1=[float(m["loss_l1"]) for _, m in hist],
                thres=thres)


def phase_train_dense(tr: dict, ply: str) -> dict:
    """Phase 9: the train step through the dense route, from the scene as
    the PLY loads it (phase 7 trained its copy past the point where the
    loss still falls) with phase 7's optimizer, cameras and targets;
    returns the launch counts of its steps."""
    import torch

    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.train.perceptual import (
        multiscale_gradient_loss,
    )
    from gaussianeditor_tpu_torch.train.trainer import (
        LossWeights,
        init_train_state,
        make_train_step,
    )

    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device="cuda")
    step = make_train_step(tr["optim"], LossWeights(),
                           perceptual=multiscale_gradient_loss,
                           impl="pallas4")
    cams, targets = tr["cams"], tr["targets"]
    state = init_train_state(scene, tr["optim"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    state, hist = run_steps(step, state, cams, targets, DENSE_STEPS)
    counts = _kernels.launch_counts()
    print(f"dense-route launches over {DENSE_STEPS} steps at batch 2: "
          f"{counts}", flush=True)
    for k in ("forward_chunk", "backward_chunk", "rank_segment_sum"):
        assert counts[k] == 2 * DENSE_STEPS, f"{k} launched {counts[k]} times"
    for k in ("binning_key", "forward_tile", "backward_tile"):
        assert counts[k] == 0, f"{k} launched on the dense route"
    stats = check_steps(state, hist, "train (dense route)")
    # the same scene, optimizer, views and targets as phase 7's first steps
    l1 = [float(m["loss_l1"]) for _, m in hist]
    diff = max(abs(a - b) for a, b in zip(l1, tr["l1"]))
    print(f"loss_l1 of the dense route's {DENSE_STEPS} steps against the "
          f"sorted route's first {DENSE_STEPS} (phase 7): max abs difference "
          f"{diff:.3g} (equal: {l1 == tr['l1'][:DENSE_STEPS]})", flush=True)
    print(f"step median: dense route {stats['median']:.2f} ms, sorted route "
          f"(phase 7) {tr['stats']['median']:.2f} ms; peak device memory "
          f"{stats['peak']:.2f} GiB against {tr['stats']['peak']:.2f} GiB",
          flush=True)
    check_repeat(step, state, cams, targets, "train (dense route)")
    return counts


def edit_config(thres: float, cameras_extent: float, ckpt_dir: str = ""):
    """configs/edit.yaml's `system` block, written out (PyYAML is not
    needed), with phase 10's changes: 30 steps with targets refreshed
    every 10 until step 30, one densify step (at step 10, gradient
    threshold `thres`), a checkpoint every 20 steps when `ckpt_dir` is
    set, a semantic prompt, synchronous guidance and the per-step loop."""
    from gaussianeditor_tpu_torch.edit.edit_system import EditConfig
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    return EditConfig(
        prompt=EDIT_PROMPT, seg_prompt="the object", mask_thres=0.5,
        batch_size=2, max_steps=EDIT_STEPS, per_editing_step=EDIT_REFRESH,
        edit_begin_step=0, edit_until_step=EDIT_STEPS,
        densify_until_step=EDIT_DENSIFY_UNTIL,
        densification_interval=EDIT_REFRESH, densify_grad_threshold=thres,
        max_densify_percent=0.01, anchor_weight_init_g0=0.05,
        anchor_weight_init=0.1, anchor_weight_multiplier=1.3,
        loss=LossWeights(lambda_l1=10.0, lambda_p=10.0,
                         lambda_anchor_color=5.0, lambda_anchor_geo=50.0,
                         lambda_anchor_scale=50.0,
                         lambda_anchor_opacity=50.0),
        cameras_extent=cameras_extent, seed=SEED,
        checkpoint_every=EDIT_CHECKPOINT if ckpt_dir else 0,
        checkpoint_dir=ckpt_dir, async_guidance=False, dispatch_burst=1,
        **LR_SCALERS)


def assert_launches(counts: dict, want: dict, label: str) -> None:
    """Every kernel's launches in `counts` as `want` gives them (0 where
    it names none). Where `want` names no preprocess kernel, every render
    and tracing view preprocesses once for its one binning (B1 or B5)
    and every backward of a render takes one preprocess backward (with
    B3 or B6)."""
    want = dict(want)
    want.setdefault("preprocess_forward", want.get("binning_key", 0)
                    + want.get("forward_chunk", 0))
    want.setdefault("preprocess_backward", want.get("backward_tile", 0)
                    + want.get("backward_chunk", 0))
    for k, v in counts.items():
        assert v == want.get(k, 0), f"{label}: {k} launched {v} times, " \
            f"expected {want.get(k, 0)}"


def phase_edit(ply: str, thres: float, cameras_extent: float, tmp: str,
               device: str = "cuda", size: int = SIZE) -> dict:
    """Phase 10: `EditSystem` at full width (see the module docstring);
    returns the launch counts of each part, and B4's time on the tracing
    rows."""
    import numpy as np
    import torch

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit import edit_system, tracing
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeGuidance,
        FakeSegmentor,
    )
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.apply_weights import apply_weights
    from gaussianeditor_tpu_torch.ops.binning_sorted import rank_segment_sum
    from gaussianeditor_tpu_torch.train.densify import DensifyConfig
    from gaussianeditor_tpu_torch.train.lpips import LPIPS, random_weights
    from gaussianeditor_tpu_torch.train.trainer import make_densify_step

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    timers = {"apply_weights": [], "save": [], "load": [], "densify": []}

    def timed(key, fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            timers[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    class CountingGuidance(FakeGuidance):
        calls = 0

        def __call__(self, rgb, cond_rgb, prompt):
            CountingGuidance.calls += 1
            return super().__call__(rgb, cond_rgb, prompt)

    patched = [(tracing, "apply_weights"), (edit_system, "save_train_state"),
               (edit_system, "load_train_state")]
    saved = [getattr(m, a) for m, a in patched]
    tracing.apply_weights = timed("apply_weights", saved[0])
    edit_system.save_train_state = timed("save", saved[1])
    edit_system.load_train_state = timed("load", saved[2])
    try:
        scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
        cams = orbit_cameras(EDIT_VIEWS, 4.0, 0.8, 0.8, size, size,
                             device=dev)
        lp = LPIPS(random_weights(0))
        ckpt_dir = os.path.join(tmp, "edit_checkpoints")
        seg = FakeSegmentor()
        sys_a = edit_system.EditSystem(
            scene, cams, edit_config(thres, cameras_extent, ckpt_dir),
            guidance=CountingGuidance(), segmentor=seg, perceptual=lp)
        densify_at = {}

        def densify_at_own_threshold(state, **kw):
            # phase 7's rule on this run's statistics: the 99.9th
            # percentile of the traced Gaussians' mean gradients (phase
            # 7's own value, from other targets and all Gaussians, let
            # none of them through in a first run)
            st = state.stats
            seen = (st.denom > 0) & state.scene.mask & state.scene.alive
            g = st.xyz_gradient_accum[seen] / st.denom[seen]
            densify_at.update(thres=float(torch.quantile(g, 0.999)),
                              max=float(g.max()), seen=int(seen.sum()))
            sys_a.cfg.densify_grad_threshold = densify_at["thres"]
            cfg = sys_a.cfg
            return make_densify_step(
                sys_a.optim, DensifyConfig(
                    max_grad=cfg.densify_grad_threshold,
                    max_densify_percent=cfg.max_densify_percent,
                    min_opacity=cfg.min_opacity,
                    max_screen_size=cfg.max_screen_size,
                    percent_dense=sys_a.optim.config.percent_dense),
                cfg.cameras_extent, cfg.anchor_weight_init,
                cfg.anchor_weight_multiplier)(state, **kw)

        sys_a.densify_step = timed("densify", densify_at_own_threshold)
        V, C = EDIT_VIEWS, scene.capacity
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        # --- on_fit_start: the origin renders, then the tracing ---
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sys_a.render_all_views()
        sync()
        origin_ms = 1e3 * (time.perf_counter() - t0)
        c_origin = _kernels.launch_counts()
        # the segmentor's reference: view 0's centre colour. Its radius, a
        # percentile of the distances to it over view 0's covered pixels,
        # is bisected until tracing selects 10-50% of the alive Gaussians
        # (the selection grows with the radius, and steeply: the opaque
        # middle of a view is close to its centre's colour, the
        # translucent rim is not)
        f0 = sys_a.origin_frames[0]
        seg.ref_color = f0[size // 2, size // 2].copy()
        dist = np.linalg.norm(f0 - seg.ref_color, axis=-1)[f0.sum(-1) > 0]
        alive = sys_a.scene.alive
        lo, hi, q = 0.0, 100.0, 50.0
        for _ in range(8):
            seg.radius = float(np.percentile(dist, q))
            w, c = tracing.accumulate_view_weights(
                sys_a.scene, cams,
                [seg(sys_a.origin_frames[i], "") for i in range(V)])
            sel = ((w[:, 0] / (c.float() + 1e-7) > 0.5) & alive).sum()
            share = int(sel) / int(alive.sum())
            print(f"edit: segmentor radius {seg.radius:.4g} (percentile "
                  f"{q:.2f}) traces {share:.4f} of the alive Gaussians",
                  flush=True)
            if 0.1 <= share <= 0.5:
                break
            lo, hi = (q, hi) if share < 0.1 else (lo, q)
            q = (lo + hi) / 2
        del w, c
        timers["apply_weights"].clear()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sys_a.on_fit_start()
        sync()
        start_ms = 1e3 * (time.perf_counter() - t0)
        c_trace = _kernels.launch_counts()
        selected = int((sys_a.scene.mask & alive).sum())
        frac = selected / int(alive.sum())
        masks = [seg(sys_a.origin_frames[i], "the object") for i in range(V)]
        px_in = [float(m.mean()) for m in masks]
        trace_view_ms = list(timers["apply_weights"])
        print(f"edit: {int(alive.sum())} alive of {C} slots, {V} views at "
              f"{size}x{size}; on_fit_start {origin_ms + start_ms:.1f} ms: "
              f"origin renders {origin_ms:.1f} ms, tracing and the state's "
              f"copy {start_ms:.1f} ms, tracing per view (ms) "
              + ", ".join(f"{t:.1f}" for t in trace_view_ms), flush=True)
        print(f"edit: segmentor radius {seg.radius:.4f} around "
              f"{np.round(seg.ref_color, 4).tolist()}; share of pixels in the "
              "mask by view " + ", ".join(f"{v:.3f}" for v in px_in)
              + f"; the traced mask selects {selected} Gaussians, "
              f"{frac:.4f} of the alive ones", flush=True)
        print(f"edit launches: origin renders {c_origin}; tracing {c_trace}",
              flush=True)
        assert_launches(c_origin, dict(binning_key=V, forward_tile=V),
                        "origin renders")
        assert_launches(c_trace, dict(binning_key=V, rank_segment_sum=V),
                        "tracing")
        assert 0.01 <= frac <= 0.99, f"the traced mask selects {frac}"

        # --- tracing: bitwise repeat, and B4 against index_add_ ---
        w1, c1 = tracing.accumulate_view_weights(sys_a.scene, cams, masks)
        w2, c2 = tracing.accumulate_view_weights(sys_a.scene, cams, masks)
        sync()
        assert torch.equal(w1, w2) and torch.equal(c1, c2), \
            "tracing is not bitwise repeatable"
        rows = {}
        wv, cv, _ = apply_weights(
            sys_a.scene, cams[0], torch.as_tensor(masks[0], device=dev)[..., None],
            torch.zeros((C, 1), device=dev),
            torch.zeros((C,), dtype=torch.int32, device=dev), rows=rows)
        r, b_incl, tt = rows["rows"], rows["b_incl"], rows["tiles_touched"]
        n = r.shape[1]
        g = torch.searchsorted(b_incl, torch.arange(n, dtype=torch.int32,
                                                    device=dev), right=True)
        live = g < C
        ref64 = torch.zeros((C, 2), dtype=torch.float64, device=dev)
        ref64.index_add_(0, g[live], r.T[live].double())
        cnt64 = torch.zeros((C,), dtype=torch.int64, device=dev)
        cnt64.index_add_(0, g[live], r[1][live].long())
        rms = ref64[:, 0].pow(2).mean().sqrt()
        rel = float(((wv[:, 0].double() - ref64[:, 0]).abs() / rms).max())
        assert torch.equal(cv.long(), cnt64), "tracing counts != index_add_"
        assert rel <= 1e-5, f"tracing weights: {rel} of the column RMS"
        b4_ms = lib_ms = None
        if dev.type == "cuda":
            b4_ms = time_ms(lambda: rank_segment_sum(r, b_incl, tt, C))
            gl, rl = g[live], r.T[live].double()
            lib_ms = time_ms(lambda: torch.zeros(
                (C, 2), dtype=torch.float64, device=dev).index_add_(0, gl, rl))
        print(f"edit tracing: two passes over the {V} views bitwise equal; "
              f"view 0's {n} rank rows: B4 counts equal an int64 index_add_, "
              f"weights within {rel:.3g} of the column RMS of a float64 one; "
              f"B4 on these rows (GF 2) {b4_ms} ms, float64 index_add_ "
              f"{lib_ms} ms", flush=True)
        del w1, w2, c1, c2, wv, cv, rows, r, ref64, cnt64, g, live
        if dev.type == "cuda":
            m0 = torch.as_tensor(masks[0], device=dev)[..., None]
            profile_once(lambda: apply_weights(
                sys_a.scene, cams[0], m0, torch.zeros((C, 1), device=dev),
                torch.zeros((C,), dtype=torch.int32, device=dev)),
                "one tracing view (view 0)", top=12)

        # --- 30 steps ---
        rec = []
        guided = [CountingGuidance.calls]
        last = [time.perf_counter()]

        def callback(step, m):
            sync()
            now = time.perf_counter()
            rec.append(dict(step=step, ms=1e3 * (now - last[0]),
                            refresh=CountingGuidance.calls > guided[0],
                            m={k: float(v) for k, v in m.items()}))
            guided[0] = CountingGuidance.calls
            last[0] = time.perf_counter()

        calls0 = CountingGuidance.calls
        _kernels.reset_launch_counts()
        last[0] = time.perf_counter()
        state = sys_a.fit(callback=callback)
        sync()
        c_steps = _kernels.launch_counts()
        refresh_renders = CountingGuidance.calls - calls0
        print(f"edit launches over {EDIT_STEPS} steps ({refresh_renders} "
              f"target refreshes, each one render): {c_steps}", flush=True)
        assert_launches(c_steps, dict(
            binning_key=2 * EDIT_STEPS + refresh_renders,
            forward_tile=2 * EDIT_STEPS + refresh_renders,
            backward_tile=2 * EDIT_STEPS, rank_segment_sum=2 * EDIT_STEPS),
            "steps")
        assert [x["step"] for x in rec] == list(range(EDIT_STEPS)), \
            "the callback did not fire once a step, in order"
        dkeys = ("n_cloned", "n_split", "n_pruned", "n_dropped")
        for x in rec:
            has = all(k in x["m"] for k in dkeys)
            assert has == (x["step"] == EDIT_REFRESH), \
                f"densify info at step {x['step']}: {has}"
            assert all(math.isfinite(v) for v in x["m"].values()), x["step"]
            assert x["m"]["overflow"] == 0.0, f"overflow at {x['step']}"
        dinfo = {k: int(rec[EDIT_REFRESH]["m"][k]) for k in dkeys}
        l1 = [x["m"]["loss_l1"] for x in rec]
        for k, v in state.scene.params().items():
            assert torch.isfinite(v).all(), f"{k} not finite"
            assert torch.isfinite(state.opt_state.mu[k]).all(), f"mu {k}"
            assert torch.isfinite(state.opt_state.nu[k]).all(), f"nu {k}"
        for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
            assert torch.isfinite(getattr(state.stats, f)).all(), f
        ckpt = os.path.join(ckpt_dir, f"state_{EDIT_CHECKPOINT:06d}.npz")
        ckpt_bytes = os.path.getsize(ckpt)
        step_ms = {x["step"]: x["ms"] for x in rec}
        step_ms[EDIT_REFRESH] -= timers["densify"][0]
        step_ms[EDIT_CHECKPOINT] -= timers["save"][0]
        refresh = [step_ms[x["step"]] for x in rec if x["refresh"]]
        plain = [step_ms[x["step"]] for x in rec if not x["refresh"]]
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if dev.type == "cuda" else float("nan"))
        print("edit: loss_l1 by step: " + ", ".join(f"{v:.6f}" for v in l1),
              flush=True)
        print("edit: loss_p by step: " + ", ".join(
            f"{x['m']['loss_p']:.6f}" for x in rec), flush=True)
        print(f"edit: ms per step (host clock, synchronised; the densify "
              f"and the checkpoint taken out): refresh steps ({len(refresh)}) "
              f"median {statistics.median(refresh):.2f}, plain steps "
              f"({len(plain)}) median {statistics.median(plain):.2f}; first "
              f"step {step_ms[0]:.2f}; every step: " + ", ".join(
                  f"{step_ms[s]:.1f}" for s in range(EDIT_STEPS)), flush=True)
        print(f"edit: densify at step {EDIT_REFRESH} {timers['densify'][0]:.1f}"
              f" ms (threshold {densify_at['thres']:.4g} over "
              f"{densify_at['seen']} traced Gaussians seen, largest "
              f"{densify_at['max']:.4g}; phase 7's {thres:.4g}), {dinfo}; "
              f"checkpoint {ckpt_bytes} bytes "
              f"({ckpt_bytes / 2**30:.3f} GiB), written in "
              f"{timers['save'][0]:.1f} ms; peak device memory {peak:.2f} GiB",
              flush=True)
        assert dinfo["n_cloned"] + dinfo["n_split"] > 0, "densify did nothing"
        assert statistics.mean(l1[-5:]) < statistics.mean(l1[:5]), \
            "loss_l1 did not fall"

        # --- a second system resumed from the step-20 checkpoint ---
        sys_b = edit_system.EditSystem(
            scene, cams, edit_config(thres, cameras_extent),
            guidance=FakeGuidance(), segmentor=seg, perceptual=lp)
        sys_b.resume(ckpt)
        assert sys_b.state.step == EDIT_CHECKPOINT
        sys_b.fit(n_steps=EDIT_STEPS - EDIT_CHECKPOINT)
        sync()
        a, b = sys_a.state, sys_b.state
        assert b.step == a.step == EDIT_STEPS
        assert b.opt_state.count == a.opt_state.count
        for k in a.scene.params():
            for x, y, what in ((getattr(a.scene, k), getattr(b.scene, k), ""),
                               (a.opt_state.mu[k], b.opt_state.mu[k], "mu "),
                               (a.opt_state.nu[k], b.opt_state.nu[k], "nu ")):
                assert torch.equal(x, y), f"resumed run: {what}{k} differs"
        for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
            assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f
        for f in ("mask", "alive", "generation"):
            assert torch.equal(getattr(a.scene, f), getattr(b.scene, f)), f
        print(f"edit: resumed from {os.path.basename(ckpt)} (load "
              f"{timers['load'][0]:.1f} ms) and ran "
              f"{EDIT_STEPS - EDIT_CHECKPOINT} steps: parameters, moments, "
              "statistics, mask and step bitwise equal to the uninterrupted "
              "run", flush=True)
        if dev.type == "cuda":
            profile_once(lambda: sys_b.fit(n_steps=1),
                         "one plain edit step (step 30, resumed system)",
                         top=15)
            print(f"edit: the numbers above on {nvidia_smi()}", flush=True)
        os.remove(ckpt)
    finally:
        for (m, a), fn in zip(patched, saved):
            setattr(m, a, fn)
    return dict(origin=c_origin, tracing=c_trace, steps=c_steps,
                b4_tracing_ms=b4_ms, index_add_ms=lib_ms,
                seg=(seg.ref_color.copy(), seg.radius))


# phases 11-13: click tracing, Delete and Add
DEL_STEPS = 10               # Del's steps (phase 12)
ADD_BBOX = (160, 160, 352, 352)  # inside 512x512 (configs/add.yaml's is
                                 # for a larger image)
ADD_POINTS = 2000            # FakeObjectGenerator's default
ADD_STEPS = 10               # refinement steps (phase 13)
MESH_SAMPLES = 200_000       # the reference's count (mesh_to_gs.py:82)
MESH_VIEWS, MESH_HW, MESH_STEPS = 16, 256, 20
SPHERE = (24, 48)            # latitude bands, longitude segments


def snapshot(scene) -> dict:
    """Copies of every parameter and buffer of a scene."""
    return {k: v.detach().clone() for k, v in
            list(scene.named_parameters()) + list(scene.named_buffers())}


def assert_unchanged(scene, before: dict, label: str) -> None:
    import torch

    for k, v in snapshot(scene).items():
        assert torch.equal(v, before[k]), f"{label}: {k} changed"


class Timers:
    """Host-clock timings (synchronised) of wrapped callables, by name."""

    def __init__(self, dev):
        self.dev = dev
        self.ms = {}

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def wrap(self, key, fn):
        def run(*a, **k):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.sync()
            self.ms.setdefault(key, []).append(
                1e3 * (time.perf_counter() - t0))
            return out
        return run

    def total(self, key) -> float:
        return sum(self.ms.get(key, []))


def phase_click(ply: str, device: str = "cuda", size: int = SIZE) -> dict:
    """Phase 11: the 'tiled' route and click tracing (see the module
    docstring); returns the launch counts of each part and its times."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import (
        lookat_camera,
        orbit_cameras,
    )
    from gaussianeditor_tpu_torch.edit import tracing
    from gaussianeditor_tpu_torch.guidance.fake import FakePointSegmentor
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        key_depth_bits,
        sorted_bin,
        tiled_depth_bits,
    )
    from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        point_cloud_render,
        preprocess_scene,
        render,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import forward_tiles
    from gaussianeditor_tpu_torch.testing import (
        assert_images_close,
        fraction_equal,
    )

    dev = torch.device(device)
    tm = Timers(dev)
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
    C = scene.capacity
    alive = scene.alive
    n_alive = int(alive.sum())

    # --- render(impl="tiled") of phase 3's view ---
    cam = lookat_camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, 0.8, size, size, device=dev)
    gx = gy = size // 16
    bits = tiled_depth_bits(gx * gy)
    tm.sync()
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = tm.wrap("tiled", render)(scene, cam, impl="tiled")
    c_tiled = _kernels.launch_counts()
    assert_launches(c_tiled, dict(binning_key=1, forward_tile=1),
                    "tiled render")
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
        sb = sorted_bin(proc, gx, gy, default_max_instances(C),
                        depth_bits=bits)
        tiles = forward_tiles(sb, gx, 3)
        default = render(scene, cam)
    for f, t in zip(("color", "depth", "final_T", "n_contrib"), tiles):
        assert torch.equal(getattr(out, f),
                           tiles_to_image(t, gx, gy, size, size)), \
            f"tiled render: {f} differs from sorted_bin({bits} bits) then B2"
    for f in ("color", "depth", "final_T"):
        assert_images_close(getattr(out, f), getattr(default, f),
                            name=f"tiled against the default route: {f}")
    same = all(torch.equal(getattr(out, f), getattr(default, f))
               for f in ("color", "depth", "final_T", "n_contrib"))
    assert not bool(out.overflow)
    # a 128x128 view of 64 tiles, where the cuts differ (25 and 24 bits)
    small = cam.rescale(128, 128)
    with torch.no_grad():
        s_t, s_d = render(scene, small, impl="tiled"), render(scene, small)
    s_diff = float((s_t.color - s_d.color).abs().max())
    print(f"click: tiled render of phase 3's view {tm.total('tiled'):.2f} ms "
          f"(host clock, one call), {int(out.num_rendered)} instances; "
          f"equal bit for bit to sorted_bin at {bits} depth bits then B2; "
          f"the default route cuts at {key_depth_bits(gx * gy)} bits and is "
          f"{'bitwise equal' if same else 'within the image bounds'}; at "
          f"128x128 (64 tiles: {tiled_depth_bits(64)} against "
          f"{key_depth_bits(64)} bits) max color diff "
          f"{s_diff:.3g}, n_contrib equal on "
          f"{fraction_equal(s_t.n_contrib, s_d.n_contrib):.5f} of pixels; "
          f"launches {c_tiled}", flush=True)
    del proc, sb, tiles, default, s_t, s_d

    # --- click tracing on the 8 orbit views ---
    cams = orbit_cameras(EDIT_VIEWS, 4.0, 0.8, 0.8, size, size, device=dev)
    click = (size / 2 - 0.5, size / 2 - 0.5)
    cache = {}

    def cached_render(s, c):
        # the bisection's renders: the scene does not change
        if id(c) not in cache:
            with torch.no_grad():
                cache[id(c)] = render(s, c)
        return cache[id(c)]

    f0 = cached_render(scene, cams[0]).color.cpu().numpy()
    ref = f0[int(click[1]), int(click[0])]
    dist = np.linalg.norm(f0 - ref, axis=-1)[f0.sum(-1) > 0]
    seg = FakePointSegmentor()
    lo, hi, q = 0.0, 100.0, 50.0
    for _ in range(8):
        seg.radius = float(np.percentile(dist, q))
        tracing.trace_from_click(scene, cams, 0, click, seg,
                                 render_fn=cached_render)
        share = int((scene.mask & alive).sum()) / n_alive
        print(f"click: point segmentor radius {seg.radius:.4g} (percentile "
              f"{q:.2f}) traces {share:.4f} of the alive Gaussians",
              flush=True)
        if 0.1 <= share <= 0.5:
            break
        lo, hi = (q, hi) if share < 0.1 else (lo, q)
        q = (lo + hi) / 2
    cache.clear()

    seen = []

    def counting_seg(img, pts):
        seen.append(np.asarray(pts)[0].tolist())
        return seg(img, pts)

    saved, saved_aw = tracing.render, tracing.apply_weights
    tracing.render = tm.wrap("click_render", saved)
    tracing.apply_weights = tm.wrap("click_trace", saved_aw)
    try:
        _kernels.reset_launch_counts()
        tm.sync()
        t0 = time.perf_counter()
        _, norm1 = tracing.trace_from_click(scene, cams, 0, click,
                                            counting_seg)
        tm.sync()
        click_ms = 1e3 * (time.perf_counter() - t0)
        c_click = _kernels.launch_counts()
    finally:
        tracing.render = saved
        tracing.apply_weights = saved_aw
    mask1 = scene.mask.clone()
    n_views_seen = len(seen)
    renders = len(tm.ms["click_render"])
    assert renders == n_views_seen >= 1, (renders, n_views_seen)
    assert_launches(c_click, dict(binning_key=renders + EDIT_VIEWS,
                                  forward_tile=renders,
                                  rank_segment_sum=EDIT_VIEWS), "click")
    traced = int((mask1 & alive).sum())
    share = traced / n_alive
    assert 0.01 <= share <= 0.99, f"the click traces {share}"
    _, norm2 = tracing.trace_from_click(scene, cams, 0, click, seg)
    tm.sync()
    assert torch.equal(norm1, norm2) and torch.equal(scene.mask, mask1), \
        "click tracing is not bitwise repeatable"
    assert torch.isfinite(norm1).all()
    print(f"click: trace_from_click at {click} on {EDIT_VIEWS} views "
          f"{click_ms:.1f} ms: {renders} renders "
          f"({tm.total('click_render'):.1f} ms), tracing per view (ms) "
          + ", ".join(f"{t:.1f}" for t in tm.ms["click_trace"])
          + f"; the point projects into {n_views_seen} views at "
          + "; ".join(f"({x:.1f}, {y:.1f})" for x, y in seen)
          + f"; traced {traced} of {n_alive} alive Gaussians ({share:.4f}); "
          f"bitwise equal twice; launches {c_click}", flush=True)
    del norm1, norm2, mask1

    # --- point_cloud_render of the alive centres ---
    xyz = scene.xyz.detach()[alive]
    _kernels.reset_launch_counts()
    pcr = tm.wrap("pcr", point_cloud_render)(xyz, cam)
    c_pcr = _kernels.launch_counts()
    assert_launches(c_pcr, dict(binning_key=1, forward_tile=1),
                    "point_cloud_render")
    assert torch.isfinite(pcr.color).all()
    white = int((pcr.color > 0.9).all(dim=-1).sum())
    assert white > 0, "point_cloud_render: no white pixel"
    print(f"click: point_cloud_render of {xyz.shape[0]} centres "
          f"{tm.total('pcr'):.2f} ms (host clock, one call, first at this "
          f"size), {int(pcr.num_rendered)} instances, {white} white pixels "
          f"of {size * size}; launches {c_pcr}", flush=True)
    if dev.type == "cuda":
        print(f"click: the numbers above on {nvidia_smi()}", flush=True)
    return dict(click=c_click, tiled=c_tiled, pcr=c_pcr, click_ms=click_ms,
                point_radius=seg.radius)


def phase_del(ply: str, cameras_extent: float, seg_ref, seg_radius: float,
              device: str = "cuda", size: int = SIZE) -> dict:
    """Phase 12: `DelSystem` at full width (see the module docstring);
    returns the launch counts of its set-up and of its steps."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit import del_system, tracing
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeInpainter,
        FakeSegmentor,
    )
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.train.lpips import LPIPS, random_weights
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    dev = torch.device(device)
    tm = Timers(dev)
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
    before = snapshot(scene)
    cams = orbit_cameras(EDIT_VIEWS, 4.0, 0.8, 0.8, size, size, device=dev)
    # configs/del.yaml's `system` block, written out
    cfg = del_system.DelConfig(
        seg_prompt="the bear", inpaint_prompt="", mask_thres=0.5,
        fix_holes=True, mask_dilate=5, inpaint_scale=0.25, batch_size=2,
        max_steps=1000, densify_until_step=800, densification_interval=100,
        loss=LossWeights(lambda_l1=10.0, lambda_p=10.0,
                         lambda_anchor_color=5.0, lambda_anchor_geo=50.0,
                         lambda_anchor_scale=50.0,
                         lambda_anchor_opacity=50.0),
        cameras_extent=cameras_extent, seed=SEED)
    sys_ = del_system.DelSystem(
        scene, cams, cfg, inpainter=tm.wrap("inpaint", FakeInpainter()),
        segmentor=FakeSegmentor(seg_ref, seg_radius),
        perceptual=LPIPS(random_weights(0)))
    alive0 = int(scene.alive.sum())
    rec = {}
    saved_near = del_system.near_gaussians_by_mask
    saved_aw = tracing.apply_weights

    def near_doubling(xyz, mask, alive, dist):
        # the shell at inpaint_scale, doubled until it is not empty
        factor = 1.0
        shell = tm.wrap("shell", saved_near)(xyz, mask, alive, dist)
        while not shell.any() and factor < 1024:
            factor *= 2
            shell = tm.wrap("shell", saved_near)(xyz, mask, alive,
                                                 dist * factor)
        rec.update(scale=cfg.inpaint_scale * factor, dist=dist * factor,
                   shell=int(shell.sum()), obj=int((mask & alive).sum()))
        return shell

    update_mask = sys_.update_mask

    def traced_update_mask():
        update_mask()
        rec["traced"] = int((sys_.scene.mask & sys_.scene.alive).sum())

    sys_.update_mask = tm.wrap("tracing", traced_update_mask)
    sys_.render_all_views = tm.wrap("renders", sys_.render_all_views)
    view_masks = {}

    def keep_masks(fn):
        def run():
            view_masks.update(fn())
            return view_masks
        return run

    sys_.render_view_masks = tm.wrap("hole_masks",
                                     keep_masks(sys_.render_view_masks))
    del_system.near_gaussians_by_mask = near_doubling
    tracing.apply_weights = tm.wrap("trace_view", saved_aw)
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        tm.sync()
        t0 = time.perf_counter()
        sys_.on_fit_start()
        tm.sync()
        setup_ms = 1e3 * (time.perf_counter() - t0)
        c_setup = _kernels.launch_counts()
    finally:
        del_system.near_gaussians_by_mask = saved_near
        tracing.apply_weights = saved_aw
    pruned = sys_.scene
    V = EDIT_VIEWS
    assert_launches(c_setup, dict(binning_key=4 * V, forward_tile=3 * V,
                                  rank_segment_sum=V), "Del set-up")
    alive1 = int(pruned.alive.sum())
    shell = int((pruned.mask & pruned.alive).sum())
    assert alive1 == alive0 - rec["traced"], (alive0, alive1, rec)
    assert 0.01 <= rec["traced"] / alive0 <= 0.99, rec
    assert shell == rec["shell"] > 0, rec
    r = tm.ms["renders"]   # origin, update_mask's (cached), re-renders
    holes = [float(view_masks[i].mean()) for i in range(V)]
    print(f"del: {alive0} alive of {scene.capacity} slots, {V} views at "
          f"{size}x{size}; on_fit_start {setup_ms:.1f} ms: origin renders "
          f"{r[0]:.1f}, tracing {tm.total('tracing'):.1f} (per view "
          + ", ".join(f"{t:.1f}" for t in tm.ms["trace_view"])
          + f"), shell search {tm.total('shell'):.1f} "
          f"({len(tm.ms['shell'])} calls), mask renders with dilate and fill "
          f"{tm.total('hole_masks'):.1f}, re-renders {r[-1]:.1f}, inpainting "
          f"{tm.total('inpaint'):.1f} ms", flush=True)
    print(f"del: traced {rec['traced']} Gaussians "
          f"({rec['traced'] / alive0:.4f}"
          f" of the alive ones), pruned: {alive1} alive; shell {shell} "
          f"Gaussians within {rec['dist']:.4g} (inpaint_scale "
          f"{rec['scale']:g}, cameras_extent {cameras_extent:.4g}); hole "
          "share of pixels by view " + ", ".join(f"{h:.3f}" for h in holes)
          + f"; launches {c_setup}", flush=True)

    # --- the steps ---
    rec_steps = []
    last = [0.0]

    def callback(step, m):
        tm.sync()
        now = time.perf_counter()
        rec_steps.append(dict(ms=1e3 * (now - last[0]),
                              m={k: float(v) for k, v in m.items()}))
        last[0] = time.perf_counter()

    _kernels.reset_launch_counts()
    tm.sync()
    last[0] = time.perf_counter()
    state = sys_.fit(n_steps=DEL_STEPS, callback=callback)
    tm.sync()
    c_steps = _kernels.launch_counts()
    n = 2 * DEL_STEPS
    assert_launches(c_steps, dict(binning_key=n, forward_tile=n,
                                  backward_tile=n, rank_segment_sum=n),
                    "Del steps")
    assert len(rec_steps) == DEL_STEPS
    for x in rec_steps:
        assert all(math.isfinite(v) for v in x["m"].values()), x
    # the mask gates every group but the rotation (the reference's
    # apply_grad_mask hooks), so outside the shell nothing else moves
    out = state.scene
    moved = torch.zeros_like(pruned.mask)
    for k, v in pruned.params().items():
        d = (getattr(out, k) != v).reshape(v.shape[0], -1).any(dim=1)
        if k != "quats":
            assert not (d & ~pruned.mask).any(), f"{k} moved outside the shell"
            moved |= d
    assert moved.any(), "nothing in the shell moved"
    assert torch.equal(out.alive, pruned.alive)
    assert_unchanged(scene, before, "Del: the caller's scene")
    ms = [x["ms"] for x in rec_steps]
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    print("del: loss_l1 by step: " + ", ".join(
        f"{x['m']['loss_l1']:.6f}" for x in rec_steps), flush=True)
    print(f"del: {DEL_STEPS} steps, ms per step (host clock, synchronised): "
          f"median {statistics.median(ms):.2f}, first {ms[0]:.2f}; every "
          "step: " + ", ".join(f"{t:.1f}" for t in ms)
          + f"; {int(moved.sum())} shell Gaussians moved; peak device memory "
          f"{peak:.2f} GiB; launches {c_steps}", flush=True)
    if dev.type == "cuda":
        print(f"del: the numbers above on {nvidia_smi()}", flush=True)
    return dict(setup=c_setup, steps=c_steps, setup_ms=setup_ms,
                step_ms=statistics.median(ms))


def uv_sphere(n_lat: int, n_lon: int, radius: float = 0.5):
    """A closed UV sphere: (verts [V, 3] float32, faces [F, 3] int32),
    2 * n_lon * (n_lat - 1) triangles."""
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                     np.cos(th)[:, None] * np.ones_like(ph)[None],
                     np.sin(th)[:, None] * np.sin(ph)[None]], axis=-1)
    verts = np.concatenate([[[0, 1, 0]], ring.reshape(-1, 3), [[0, -1, 0]]])
    idx = 1 + np.arange((n_lat - 1) * n_lon).reshape(n_lat - 1, n_lon)
    nxt = np.roll(idx, -1, axis=1)
    faces = [np.stack([np.zeros(n_lon, int), nxt[0], idx[0]], axis=1)]
    for i in range(n_lat - 2):
        faces.append(np.stack([idx[i], nxt[i], nxt[i + 1]], axis=1))
        faces.append(np.stack([idx[i], nxt[i + 1], idx[i + 1]], axis=1))
    faces.append(np.stack([np.full(n_lon, len(verts) - 1), idx[-1], nxt[-1]],
                          axis=1))
    return ((radius * verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32))


def phase_add(ply: str, cameras_extent: float, device: str = "cuda",
              size: int = SIZE) -> dict:
    """Phase 13: `AddSystem.run()`, its refinement and the mesh object's
    fit at full width (see the module docstring); returns the launch
    counts of each part and B4's time at the merged capacity."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit import add_system, mesh_to_gs
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeGuidance,
        FakeInpainter,
        FakeObjectGenerator,
    )
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        rank_segment_sum,
        rank_segment_sum_plain,
        sorted_bin,
    )
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        backward_tiles,
        forward_tiles,
    )
    from gaussianeditor_tpu_torch.train.lpips import LPIPS, random_weights

    dev = torch.device(device)
    tm = Timers(dev)
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
    before = snapshot(scene)
    nb = int(scene.alive.sum())
    cams = orbit_cameras(EDIT_VIEWS, 4.0, 0.8, 0.8, size, size, device=dev)
    bbox = tuple(int(v * size // SIZE) for v in ADD_BBOX)
    # configs/add.yaml's `system` block, with the bbox and anchor view of
    # this scene and the refinement's steps
    cfg = add_system.AddConfig(
        inpaint_prompt="a teddy bear", anchor_view_id=0, bbox=bbox,
        refine_steps=ADD_STEPS, cameras_extent=cameras_extent, seed=SEED)
    sys_ = add_system.AddSystem(
        scene, cams, cfg, inpainter=tm.wrap("inpaint", FakeInpainter()),
        object_generator=tm.wrap("object", FakeObjectGenerator(
            ADD_POINTS, device=dev)),
        perceptual=LPIPS(random_weights(0)))
    patched = [(add_system, "render"), (add_system, "place_object_in_scene"),
               (add_system, "concat_scenes")]
    saved = [getattr(m, a) for m, a in patched]
    for (m, a), fn in zip(patched, saved):
        setattr(m, a, tm.wrap(a, fn))
    try:
        _kernels.reset_launch_counts()
        tm.sync()
        t0 = time.perf_counter()
        merged = sys_.run()
        tm.sync()
        run_ms = 1e3 * (time.perf_counter() - t0)
        c_run = _kernels.launch_counts()
    finally:
        for (m, a), fn in zip(patched, saved):
            setattr(m, a, fn)
    C = merged.capacity
    assert_launches(c_run, dict(binning_key=1, forward_tile=1), "Add run")
    assert C == nb + ADD_POINTS, (C, nb)
    assert merged.alive.all()
    assert not merged.mask[:nb].any() and merged.mask[nb:].all(), \
        "the merged mask must mark exactly the object"
    assert_unchanged(scene, before, "Add: the caller's scene")
    print(f"add: run() {run_ms:.1f} ms: tiled render {tm.total('render'):.1f},"
          f" inpaint {tm.total('inpaint'):.1f}, object "
          f"{tm.total('object'):.1f}, placement "
          f"{tm.total('place_object_in_scene'):.1f}, concat_scenes "
          f"{tm.total('concat_scenes'):.1f} ms; merged scene {C} slots "
          f"({nb} + {ADD_POINTS}), the mask marks the last {ADD_POINTS}; "
          f"launches {c_run}", flush=True)

    # --- B4 at C = nb + ADD_POINTS, against its plain version ---
    with torch.no_grad():
        proc = preprocess_scene(merged, cams[0])
        gx = gy = size // 16
        sb = sorted_bin(proc, gx, gy, default_max_instances(C))
        tiles = forward_tiles(sb, gx, 3)
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        g = [torch.randn((gx * gy, 256, 3), generator=gen, device=dev),
             0.1 * torch.randn((gx * gy, 256), generator=gen, device=dev),
             0.05 * torch.randn((gx * gy, 256), generator=gen, device=dev)]
        rows = backward_tiles(sb.tile_bounds, sb.payload, sb.rank, tiles,
                              *g, gx, 3)
        b_incl, tt = sb.b_incl, proc.tiles_touched
        d = rank_segment_sum(rows, b_incl, tt, C)
        d_plain = rank_segment_sum_plain(rows, b_incl, tt, C)
    rms = d_plain.pow(2).mean(dim=0).sqrt()
    rel = float(((d - d_plain).abs() / rms).max())
    assert rel <= 1e-5, f"B4 at C = {C}: {rel} of the column RMS"
    b4_ms = b4_base_ms = None
    if dev.type == "cuda":
        b4_ms = time_ms(lambda: rank_segment_sum(rows, b_incl, tt, C))
        # the same view's rows from the caller's scene (4x capacity)
        with torch.no_grad():
            p4 = preprocess_scene(scene, cams[0])
            s4 = sorted_bin(p4, gx, gy, default_max_instances(scene.capacity))
            r4 = backward_tiles(s4.tile_bounds, s4.payload, s4.rank,
                                forward_tiles(s4, gx, 3), *g, gx, 3)
        b4_base_ms = time_ms(lambda: rank_segment_sum(
            r4, s4.b_incl, p4.tiles_touched, scene.capacity))
        del p4, s4, r4
    print(f"add: B4 at C = {C} ({C % 256} slots in its last block), "
          f"{rows.shape[1]} rows x {rows.shape[0]} fields: max abs err vs "
          f"plain {float((d - d_plain).abs().max()):.3g} ({rel:.3g} of the "
          f"column RMS); {b4_ms} ms, and {b4_base_ms} ms on the same view's "
          f"rows of the {scene.capacity}-slot scene", flush=True)
    del proc, sb, tiles, g, rows, d, d_plain

    # --- the refinement (apps/launch.py's, after run()) ---
    class CountingGuidance(FakeGuidance):
        calls = 0

        def __call__(self, rgb, cond_rgb, prompt):
            CountingGuidance.calls += 1
            return super().__call__(rgb, cond_rgb, prompt)

    sys_.guidance = CountingGuidance()
    rec = []
    last = [0.0]

    def callback(step, m):
        tm.sync()
        now = time.perf_counter()
        rec.append(dict(ms=1e3 * (now - last[0]),
                        m={k: float(v) for k, v in m.items()}))
        last[0] = time.perf_counter()

    sys_.render_all_views = tm.wrap("origin", sys_.render_all_views)
    start = {k: v.detach().clone() for k, v in merged.params().items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    tm.sync()
    last[0] = time.perf_counter()
    state = sys_.fit(n_steps=ADD_STEPS, callback=callback)
    tm.sync()
    c_refine = _kernels.launch_counts()
    refresh = CountingGuidance.calls
    n = 2 * ADD_STEPS
    assert_launches(c_refine, dict(
        binning_key=EDIT_VIEWS + n + refresh,
        forward_tile=EDIT_VIEWS + n + refresh,
        backward_tile=n, rank_segment_sum=n), "Add refinement")
    out = state.scene
    for k, v in start.items():
        if k != "quats":   # the rotation is not gated by the mask
            assert torch.equal(getattr(out, k)[:nb], v[:nb]), \
                f"refinement moved the base's {k}"
        assert torch.isfinite(getattr(out, k)).all(), k
    moved = (out.xyz[nb:] != start["xyz"][nb:]).any(dim=1)
    assert moved.any() and (out.features_dc[nb:]
                            != start["features_dc"][nb:]).any(), \
        "the object did not move"
    for x in rec:
        assert all(math.isfinite(v) for v in x["m"].values()), x
    ms = [x["ms"] for x in rec]
    # the first step holds the origin renders of on_fit_start
    ms[0] -= tm.total("origin")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    print("add: refinement loss by step: " + ", ".join(
        f"{x['m']['loss']:.6f}" for x in rec), flush=True)
    print(f"add: {ADD_STEPS} refinement steps over {C} slots ({refresh} "
          f"target refreshes): ms per step (host clock, synchronised; the "
          f"origin renders, {tm.total('origin'):.1f} ms, taken out) median "
          f"{statistics.median(ms):.2f}, every step: "
          + ", ".join(f"{t:.1f}" for t in ms)
          + f"; {int(moved.sum())} of {ADD_POINTS} object Gaussians moved, "
          f"the base's parameters but its rotations bitwise unchanged; "
          f"peak device memory {peak:.2f} GiB; launches {c_refine}",
          flush=True)
    if dev.type == "cuda":
        sys_.fit(n_steps=1)   # step 10 refreshes its targets; 11 does not
        profile_once(lambda: sys_.fit(n_steps=1),
                     f"one plain Add refinement step (step 11, {C} slots)",
                     top=12)
    del sys_, merged, state, out, start

    # --- the mesh object: fit_colorless_mesh on a sphere ---
    verts, faces = uv_sphere(*SPHERE)
    losses = []
    targets = []
    saved_raster = mesh_to_gs.render_mesh_lambertian

    def keep_target(*a, **k):
        targets.append(saved_raster(*a, **k))
        return targets[-1]

    mesh_to_gs.render_mesh_lambertian = tm.wrap("raster", keep_target)
    saved_pf = mesh_to_gs.photometric_fit
    mesh_to_gs.photometric_fit = tm.wrap("fit", saved_pf)
    mesh_step = []
    last = [0.0]

    def mesh_cb(step, m):
        tm.sync()
        now = time.perf_counter()
        if step > 0:
            mesh_step.append(1e3 * (now - last[0]))
        losses.append(float(m["loss"]))
        last[0] = time.perf_counter()

    hw = MESH_HW * size // SIZE
    try:
        _kernels.reset_launch_counts()
        tm.sync()
        t0 = time.perf_counter()
        obj = mesh_to_gs.fit_colorless_mesh(
            (verts, faces), n_samples=MESH_SAMPLES, n_views=MESH_VIEWS,
            hw=hw, steps=MESH_STEPS, seed=SEED, device=dev, callback=mesh_cb)
        tm.sync()
        mesh_ms = 1e3 * (time.perf_counter() - t0)
        c_mesh = _kernels.launch_counts()
    finally:
        mesh_to_gs.render_mesh_lambertian = saved_raster
        mesh_to_gs.photometric_fit = saved_pf
    n = 2 * MESH_STEPS
    assert_launches(c_mesh, dict(binning_key=n, forward_tile=n,
                                 backward_tile=n, rank_segment_sum=n),
                    "mesh fit")
    assert obj.capacity == MESH_SAMPLES
    assert len(losses) == MESH_STEPS and all(map(math.isfinite, losses))
    # the loss falling: L1 over all the views against their targets, of
    # the fitted object and of the same object before the fit (each
    # step's loss covers 2 random views, and its noise from view to view
    # is of the order of what 20 steps take off)
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.ops.render import render

    pts, cols = mesh_to_gs.sample_mesh_surface(verts, faces, MESH_SAMPLES,
                                               None, SEED)
    init = GaussianScene.from_points(pts, cols, max_sh_degree=0, device=dev)
    mcams, _ = mesh_to_gs._orbit_around(verts, MESH_VIEWS, 2.5, hw, dev)
    err = {}
    with torch.no_grad():
        for name, scn in (("init", init), ("fitted", obj)):
            err[name] = statistics.mean(
                float((render(scn, c).color
                       - torch.as_tensor(t, device=dev)).abs().mean())
                for c, t in zip(mcams, targets))
    assert err["fitted"] < err["init"], \
        f"the mesh fit's loss did not fall: {err}"
    print(f"add: fit_colorless_mesh on a {len(faces)}-face sphere, "
          f"{MESH_SAMPLES} samples, {MESH_VIEWS} views at {hw}x{hw}, "
          f"{MESH_STEPS} steps: {mesh_ms:.1f} ms, of which rasterizing "
          f"{tm.total('raster'):.1f} ms, the fit {tm.total('fit'):.1f} ms "
          f"(step median {statistics.median(mesh_step):.2f} ms after the "
          f"first); loss by step " + ", ".join(f"{v:.5f}" for v in losses)
          + f"; L1 over the {MESH_VIEWS} views {err['init']:.5f} before the "
          f"fit, {err['fitted']:.5f} after; launches {c_mesh}", flush=True)
    if dev.type == "cuda":
        print(f"add: the numbers above on {nvidia_smi()}", flush=True)
    return dict(add=c_run, add_refine=c_refine, mesh_fit=c_mesh,
                b4_add_ms=b4_ms, run_ms=run_ms,
                refine_ms=statistics.median(ms))


# phase 14: reconstruction and the CLI
RECON_W, RECON_H = 1297, 840   # a Mip-NeRF 360 training view's size
RECON_VIEWS = 48             # two rings of 24 (garden has 185)
RECON_POINTS = 150_000       # the order of a Mip-NeRF 360 SfM cloud
RECON_TEST_VIEWS = 16
# 300 steps where the reference runs 30,000, the intervals cut so that
# densify runs twice (after steps 100 and 200), the opacity resets once
# (after 250) and the SH degree goes up three times (75, 150, 225)
RECON_SYSTEM = dict(max_steps=300, densify_from_step=100,
                    densification_interval=100, opacity_reset_interval=250,
                    oneup_sh_every=75)
REPEAT_SYSTEM = dict(max_steps=40, densify_from_step=10,
                     densification_interval=10, opacity_reset_interval=30,
                     oneup_sh_every=20)
PSNR_VIEWS = 4               # training views the exported scene is scored on
METRIC_VIEWS = 8             # renders the metrics CLI scores
# B2's n_contrib held against the plain version's: the kernels' view (0)
# and three more, spread over both rings
NC_SURVEY_VIEWS = (0, 12, 24, 36)
CLI_STEPS = 3


def write_recon_workspace(root: str, scene, size, n_views: int,
                          n_points: int) -> dict:
    """A COLMAP workspace of `n_views` PINHOLE cameras at `size` (w, h),
    on two rings around the origin (radius 4, heights +-1.2, horizontal
    fov 0.8): `images/` holds the port's renders of `scene` (sorted
    route) as 8-bit PNGs written by Pillow, `sparse/0/points3D.bin` a
    seeded subsample of the alive centres jittered by N(0, 0.01), coloured
    by the SH DC term. Returns the times of its parts (ms)."""
    import torch
    from PIL import Image

    from gaussianeditor_tpu_torch.core.cameras import fov2focal, lookat_c2w
    from gaussianeditor_tpu_torch.core.sh import C0
    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.data.colmap import (
        ColmapCamera,
        ColmapImage,
        write_colmap_model_bin,
    )
    from gaussianeditor_tpu_torch.ops.render import render

    ms = {}
    w, h = size
    f = fov2focal(0.8, w)
    cams = {1: ColmapCamera(1, "PINHOLE", w, h,
                            np.array([f, f, w / 2, h / 2]))}
    imgs = {}
    per_ring = n_views // 2
    for i in range(n_views):
        ring, j = divmod(i, per_ring)
        th = 2 * math.pi * (j + 0.5 * ring) / per_ring
        eye = np.array([4.0 * math.cos(th), 1.2 if ring else -1.2,
                        4.0 * math.sin(th)])
        w2c = np.linalg.inv(lookat_c2w(eye, np.zeros(3), (0.0, 1.0, 0.0)))
        imgs[i + 1] = ColmapImage(i + 1, _rotmat_to_qvec(w2c[:3, :3]),
                                  w2c[:3, 3], 1, f"view{i:03d}.png")
    sparse = os.path.join(root, "sparse", "0")
    write_colmap_model_bin(sparse, cams, imgs)

    t0 = time.perf_counter()
    alive = scene.alive
    xyz = scene.xyz.detach()[alive].cpu().numpy()
    dc = scene.features_dc.detach()[alive][:, 0].cpu().numpy()
    rng = np.random.RandomState(SEED)
    idx = np.sort(rng.choice(len(xyz), n_points, replace=False))
    pts = xyz[idx].astype(np.float64) + rng.normal(0, 0.01, (n_points, 3))
    rgb = np.round(np.clip(0.5 + C0 * dc[idx], 0, 1) * 255).astype(np.uint8)
    rec = np.zeros(n_points, np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(n_points)
    rec["xyz"] = pts
    rec["rgb"] = rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(np.uint64(n_points).tobytes())
        fh.write(rec.tobytes())
    ms["points"] = 1e3 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "images"))
    sc = CamScene(root, h=h, w=w, device=scene.device)
    bg = torch.zeros(3, device=scene.device)
    for cam, name in zip(sc.cameras, sc.image_names):
        with torch.no_grad():
            img = render(scene, cam, bg).color
        u8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(u8).save(os.path.join(root, "images", name),
                                 compress_level=1)
    ms["images"] = 1e3 * (time.perf_counter() - t0)
    return ms


def ssim_flags(a, b) -> None:
    """SSIM and its gradient on a full-size image pair under both values
    of `torch.backends.cudnn.allow_tf32`: first the blur as a plain
    `F.conv2d` under the process's flags computes it, against the float64
    value on the host; then `train.losses.ssim`, which must be bitwise the
    same under either setting and repeat bitwise."""
    import torch
    import torch.nn.functional as F

    from gaussianeditor_tpu_torch.train import losses

    def plain_ssim(x, y):
        win = torch.as_tensor(losses._gaussian_window(11), device=x.device,
                              dtype=x.dtype)

        def blur(z):
            hh, ww, c = z.shape
            z = z.permute(2, 0, 1).reshape(c, 1, hh, ww)
            z = F.conv2d(z, win.view(1, 1, -1, 1), padding=(5, 0))
            z = F.conv2d(z, win.view(1, 1, 1, -1), padding=(0, 5))
            return z.reshape(c, hh, ww).permute(1, 2, 0)

        mu1, mu2 = blur(x), blur(y)
        s1 = blur(x * x) - mu1 * mu1
        s2 = blur(y * y) - mu2 * mu2
        s12 = blur(x * y) - mu1 * mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                          / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))

    def value_grad(fn, x, y):
        x = x.clone().requires_grad_(True)
        v = fn(x, y)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    ref_v, ref_g = value_grad(plain_ssim, a.double().cpu(), b.double().cpu())
    saved = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            for name, fn in (("plain F.conv2d", plain_ssim),
                             ("losses.ssim", losses.ssim)):
                out[name, tf32] = [value_grad(fn, a, b) for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for name in ("plain F.conv2d", "losses.ssim"):
        for tf32 in (True, False):
            (v, g), (v2, g2) = out[name, tf32]
            dv = abs(float(v.double().cpu() - ref_v))
            dg = float((g.double().cpu() - ref_g).abs().max())
            print(f"SSIM via {name}, allow_tf32={tf32}: value {float(v):.9f} "
                  f"(float64 {float(ref_v):.9f}, |diff| {dv:.3g}), gradient "
                  f"max |diff| vs float64 {dg:.3g} (max |grad| "
                  f"{float(ref_g.abs().max()):.3g}); repeat bitwise: "
                  f"{torch.equal(v, v2) and torch.equal(g, g2)}", flush=True)
        (v_on, g_on), (v_off, g_off) = out[name, True][0], out[name, False][0]
        same = torch.equal(v_on, v_off) and torch.equal(g_on, g_off)
        print(f"SSIM via {name}: allow_tf32 True vs False bitwise equal: "
              f"{same}; value |diff| {abs(float(v_on - v_off)):.3g}, gradient "
              f"max |diff| {float((g_on - g_off).abs().max()):.3g}",
              flush=True)
    for tf32 in (True, False):
        (v, g), (v2, g2) = out["losses.ssim", tf32]
        assert torch.equal(v, v2) and torch.equal(g, g2), \
            f"losses.ssim does not repeat bitwise (allow_tf32={tf32})"
    assert all(torch.equal(x, y) for x, y in zip(
        out["losses.ssim", True][0], out["losses.ssim", False][0])), \
        "losses.ssim depends on allow_tf32"


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _printed_json(text: str, prefix: str) -> dict:
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return json.loads(line[len(prefix):])


def _trial_dir(out_dir: str) -> str:
    trials = os.listdir(out_dir)
    assert len(trials) == 1, f"{out_dir}: {trials}"
    return os.path.join(out_dir, trials[0])


def _yaml_config(path: str, cfg: dict) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_cli(module: str, args: list, label: str, env: dict,
            timeout: float = 300) -> str:
    """`python -m module args` as a user starts it, from the repository
    root; must exit 0. Returns its standard output."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    print(f"CLI {label}: exit {proc.returncode}, wall {wall:.2f} s",
          flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    assert proc.returncode == 0, f"CLI {label} exited {proc.returncode}"
    return proc.stdout


def nc_survey(scene, cams, budget: int) -> dict:
    """B2's n_contrib against its plain version's on every pixel of each
    of `cams`, a differing pixel decided by `replay_nc_flips`; returns
    the views, tile pixels and replayed pixels counted."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
    from gaussianeditor_tpu_torch.ops.render import preprocess_scene
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        forward_tiles,
        forward_tiles_plain,
    )

    t0 = time.perf_counter()
    pixels = replayed = 0
    for cam in cams:
        gx, gy = -(-cam.width // 16), -(-cam.height // 16)
        with torch.no_grad():
            proc = preprocess_scene(scene, cam)
            sb = sorted_bin(proc, gx, gy, budget)
            assert not bool(sb.overflow)
            ch = proc.color.shape[1]
            tk = forward_tiles(sb, gx, ch)
            tp = forward_tiles_plain(sb.tile_bounds, sb.payload, gx, ch)[0]
        n, unexplained = replay_nc_flips(sb, tk, tp, gx,
                                         f"recon survey view {cam.width}x"
                                         f"{cam.height}")
        assert unexplained == 0, \
            f"B2 recon survey: n_contrib differs on {unexplained} pixels"
        pixels += gx * gy * 256
        replayed += n
    print(f"B2 n_contrib over {len(cams)} more recon views: {replayed} of "
          f"{pixels} tile pixels differ from the plain version, each decided"
          f" by the replay; {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(views=len(cams), pixels=pixels, replayed=replayed)


def recon_view_kernels(scene, cams, cap: int) -> dict:
    """B1-B4 against their plain versions at the first view of `cams`,
    as phases 3 and 6 hold them, and B2's n_contrib at the others
    (`nc_survey`); returns each kernel's time, bound and error at the
    first view, and B2's replayed pixels over all of them."""
    import torch

    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )

    cam = cams[0]
    w, h = cam.width, cam.height
    gx, gy = -(-w // 16), -(-h // 16)
    budget = default_max_instances(cap)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
    kv = check_kernels(proc, gx, gy, budget, f"recon view {w}x{h}", False,
                       replay_flips=True, split=True)
    view = dict(proc=proc, sb=kv["sb"], tiles=kv["tiles"],
                contrib=kv["contrib"], gx=gx, gy=gy, budget=budget)
    kv_replayed = kv["nc_replayed"]
    rows_bw = phase_backward(view, time_plain=False)
    out = {
        "B1 binning_key": dict(ms=kv["b1_ms"], bound_ms=kv["b1_bound"],
                               bound_by="bytes", max_abs_err=kv["b1_err"],
                               sorted_bin_split=kv["sorted_bin_split"]),
        "B2 forward_tile": dict(ms=kv["b2_ms"], bound_ms=kv["b2_bound"],
                                bound_by=kv["b2_by"],
                                max_abs_err=kv["b2_err"]),
        **{r["name"]: {k2: r[k2] for k2 in ("ms", "bound_ms", "bound_by",
                                           "max_abs_err")}
           for r in rows_bw}}
    for v in out.values():
        v.update(tiles=gx * gy, ranks=int(kv["sb"].payload.shape[1]))
    del view, kv, proc
    survey = nc_survey(scene, cams[1:], budget)
    out["B2 forward_tile"]["nc_replayed"] = dict(
        views=1 + survey["views"], pixels=gx * gy * 256 + survey["pixels"],
        replayed=kv_replayed + survey["replayed"])
    return out


def phase_recon(ply: str, colmap: str, tmp: str, device: str = "cuda",
                size=(RECON_W, RECON_H), n_views: int = RECON_VIEWS,
                n_points: int = RECON_POINTS, system: dict = RECON_SYSTEM,
                repeat_system: dict = REPEAT_SYSTEM,
                test_views: int = RECON_TEST_VIEWS,
                cli_size: int = SIZE) -> dict:
    """Phase 14: reconstruction through `launch.main` at full width, the
    kernels at its view, a bitwise repeat, and the CLI's other modes as
    subprocesses (see the module docstring). Returns the launch counts of
    each part and B1-B4's numbers at the reconstruction's view."""
    import torch

    from gaussianeditor_tpu_torch.apps import launch
    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import load_ply
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.train.losses import psnr
    from gaussianeditor_tpu_torch.train.recon import ReconConfig, ReconTrainer

    dev = torch.device(device)
    w, h = size
    steps = system["max_steps"]
    out = {}

    # --- the workspace, from the bench scene ---
    t0 = time.perf_counter()
    bench = load_ply(ply, device=dev)
    ws = os.path.join(tmp, "recon_ws")
    parts = write_recon_workspace(ws, bench, size, n_views, n_points)
    del bench
    print(f"recon workspace: {n_views} views at {w}x{h}, {n_points} SfM "
          f"points; {1e3 * (time.perf_counter() - t0):.1f} ms (points "
          f"{parts['points']:.1f}, {n_views} renders and PNG writes "
          f"{parts['images']:.1f})", flush=True)
    sc = CamScene(ws, h=h, w=w, device=dev)
    host_images = launch._load_posed_images(os.path.join(ws, "images"), sc)
    targets = [torch.from_numpy(im).to(dev) for im in host_images]

    # --- SSIM under both TF32 settings, on two of the targets ---
    ssim_flags(targets[0], targets[1])

    # --- recon through the CLI's entry point, in this process ---
    cap = 4 * n_points
    cfg = dict(mode="recon", colmap_dir=ws, height=h, width=w,
               capacity_multiplier=4, sh_degree=SH_DEGREE, device=device,
               test_views=test_views, output_dir=os.path.join(tmp, "recon"),
               system=dict(system))
    cfg_path = _yaml_config(os.path.join(tmp, "recon.yaml"), cfg)
    stamps = []

    class TimedLogger(launch.MetricsLogger):
        def __call__(self, step, metrics):
            super().__call__(step, metrics)   # reads the loss: a sync
            stamps.append(time.perf_counter())

    turntable_counts = {}
    turntable = launch._turntable

    def counted_turntable(*a, **k):
        before = _kernels.launch_counts()
        try:
            return turntable(*a, **k)
        finally:
            after = _kernels.launch_counts()
            turntable_counts.update({n: after[n] - before[n] for n in after})

    tee = _Tee(sys.stdout)
    launch.MetricsLogger, launch._turntable = TimedLogger, counted_turntable
    # the CLI sees what a user's process sees: torch's default TF32 flags
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(tee):
            launch.main(["--config", cfg_path, "--train", "--test",
                         "--export"])
    finally:
        launch.MetricsLogger, launch._turntable = TimedLogger.__base__, turntable
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    counts = _kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    timings = _printed_json(tee.buf.getvalue(), "timings: ")
    assert _printed_json(tee.buf.getvalue(), "launches: ") == counts
    out["recon_test"] = turntable_counts
    out["recon_steps"] = {k: counts[k] - turntable_counts[k] for k in counts}
    assert_launches(out["recon_steps"], dict(
        binning_key=steps, forward_tile=steps, backward_tile=steps,
        rank_segment_sum=steps), "recon steps")
    assert_launches(turntable_counts, dict(
        binning_key=test_views, forward_tile=test_views), "recon turntable")
    trial = _trial_dir(cfg["output_dir"])

    # --- what the run left ---
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == list(range(steps)), "metrics rows"
    loss = np.array([r["loss"] for r in rows])
    assert np.isfinite(loss).all(), "recon: a loss is not finite"
    k = min(20, steps // 2)
    print(f"recon loss: first {k} mean {loss[:k].mean():.6f}, last {k} mean "
          f"{loss[-k:].mean():.6f}", flush=True)
    assert loss[-k:].mean() < loss[:k].mean(), "recon: the loss did not fall"
    for r in rows:
        if "n_split" in r:
            grants = int(r["n_cloned"] + r["n_split"])
            print(f"densify after step {r['step']}: requests "
                  f"{grants + int(r['n_dropped'])}, granted {grants} "
                  f"(cloned {int(r['n_cloned'])}, split {int(r['n_split'])},"
                  f" dropped {int(r['n_dropped'])}), pruned "
                  f"{int(r['n_pruned'])}", flush=True)
    assert sum("n_split" in r for r in rows) == len(
        [s for s in range(steps)
         if s >= system["densify_from_step"] and s > 0
         and s % system["densification_interval"] == 0]), "densify steps"
    final = load_ply(os.path.join(trial, "last.ply"), capacity=cap,
                     device=dev)
    n_final = int(final.n_alive)
    print(f"last.ply: {n_final} alive Gaussians (from {n_points} SfM "
          f"points, {cap} slots), SH degree {final.max_sh_degree}",
          flush=True)
    assert n_final != n_points, "densify and prune changed nothing"
    assert final.max_sh_degree == SH_DEGREE, "last.ply lost its SH degree"
    turn = [f for f in os.listdir(trial) if f.startswith("turntable")]
    assert len(turn) == 1, f"turntable files: {turn}"
    if turn[0].endswith(".gif"):
        from PIL import Image

        with Image.open(os.path.join(trial, turn[0])) as im:
            n_frames = im.n_frames
    else:
        n_frames = int(subprocess.run(
            ["ffprobe", "-v", "error", "-count_frames", "-select_streams",
             "v:0", "-show_entries", "stream=nb_read_frames", "-of",
             "csv=p=0", os.path.join(trial, turn[0])],
            capture_output=True, text=True, check=True).stdout)
    assert n_frames == test_views, f"turntable holds {n_frames} frames"

    # step times by kind: the logger's clock after each step's loss read
    first_ms = timings["train"] - 1e3 * (stamps[-1] - stamps[0])
    dt = {s: 1e3 * (stamps[s] - stamps[s - 1]) for s in range(1, steps)}

    def every(key, s):
        return system[key] > 0 and s % system[key] == 0

    def kind(s):
        if every("oneup_sh_every", s):
            return "SH one-up"
        if s >= system["densify_from_step"] and every(
                "densification_interval", s):
            return "densify"
        if every("opacity_reset_interval", s):
            return "opacity reset"
        return "plain"

    by_kind = {}
    for s, v in dt.items():
        by_kind.setdefault(kind(s), []).append(v)
    print(f"recon set-up (ms): CamScene {timings['cameras']:.1f}, image "
          f"load {timings['images']:.1f}, from_points (points3D read, "
          f"native KNN, upload) {timings['scene']:.1f}, trainer init "
          f"{timings['system']:.1f}", flush=True)
    print(f"recon steps ({steps}, {w}x{h}): first {first_ms:.2f} ms; "
          + "; ".join(f"{kd} median {statistics.median(v):.2f} ms "
                      f"(n={len(v)}, min {min(v):.2f}, max {max(v):.2f})"
                      for kd, v in by_kind.items())
          + f"; fit {timings['train']:.1f} ms; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"recon turntable: {test_views} renders {timings['test_render']:.1f}"
          f" ms, write ({turn[0]}) {timings['test_write']:.1f} ms; export "
          f"(last.ply) {timings['export']:.1f} ms", flush=True)
    out["plain_step_ms"] = statistics.median(by_kind["plain"])

    # --- PSNR on training views: the exported scene against the initial ---
    t0 = time.perf_counter()
    xyz, rgb = sc.load_points()
    init = GaussianScene.from_points(xyz, rgb, max_sh_degree=SH_DEGREE,
                                     capacity=cap, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"from_points on {len(xyz)} points (native KNN, upload): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
    bg = torch.zeros(3, device=dev)

    def mean_psnr(scene):
        with torch.no_grad():
            return float(np.mean([float(psnr(render(scene, sc.cameras[i],
                                                    bg).color, targets[i]))
                                  for i in range(PSNR_VIEWS)]))

    p0, p1 = mean_psnr(init), mean_psnr(final)
    print(f"PSNR over {PSNR_VIEWS} training views: initial {p0:.3f} dB, "
          f"exported {p1:.3f} dB", flush=True)
    assert p1 > p0, "recon: the exported scene is no closer to the targets"

    # --- one plain step profiled, on the exported scene ---
    rcfg = ReconConfig(**dict(system, cameras_extent=sc.cameras_extent,
                              max_steps=steps, densify_from_step=10 ** 9,
                              opacity_reset_interval=0, oneup_sh_every=0))
    tr = ReconTrainer(final, sc.cameras, host_images, rcfg)
    tr.fit(n_steps=2)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        profile_once(lambda: tr.fit(n_steps=1),
                     f"one plain recon step ({w}x{h}, {n_final} alive of "
                     f"{cap} slots)")
    del tr, final

    # --- a bitwise repeat of a short fit through every event ---
    rep = ReconConfig(**dict(repeat_system,
                             cameras_extent=sc.cameras_extent))

    def run_repeat():
        tr = ReconTrainer(init, sc.cameras, host_images, rep)
        tr.fit()
        return tr.scene

    a, b = run_repeat(), run_repeat()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for name, v in a.named_parameters():
        assert torch.equal(v, getattr(b, name)), f"repeat: {name} differs"
    assert torch.equal(a.alive, b.alive), "repeat: alive differs"
    print(f"recon repeat: {rep.max_steps} steps twice from {n_points} "
          f"points (densify at {rep.densify_from_step}, every "
          f"{rep.densification_interval}; opacity reset "
          f"{rep.opacity_reset_interval}; SH one-up every "
          f"{rep.oneup_sh_every}): every parameter and the alive mask "
          f"bitwise equal ({int(a.n_alive)} alive)", flush=True)
    del a, b, init, targets

    # --- the CLI as users start it ---
    out["cli_modes"] = dict.fromkeys(counts, 0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cli_modes(ply, colmap, tmp, ws, sc, device, cli_size, out["cli_modes"])

    # --- each kernel against its plain version at one view, B2's
    # n_contrib at four (the card) ---
    out["recon_view"] = {}
    if dev.type == "cuda":
        final = load_ply(os.path.join(trial, "last.ply"), capacity=cap,
                         device=dev)
        out["recon_view"] = recon_view_kernels(
            final, [sc.cameras[i] for i in NC_SURVEY_VIEWS], cap)
    return out


def cli_modes(ply: str, colmap: str, tmp: str, ws: str, sc, device: str,
              cli_size: int, launches_sum: dict) -> None:
    """Phase 14's subprocesses: the CLI's edit, del and add modes on the
    PLY, then the metrics CLI on renders of the reconstruction (in
    `tmp/recon`) against their targets in the workspace `ws`; adds each
    mode's kernel launches to `launches_sum`."""
    import torch
    from PIL import Image

    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.train.lpips import random_weights, save_weights

    dev = torch.device(device)
    root = os.path.dirname(os.path.abspath(__file__))
    lp_path = os.path.join(tmp, "lpips_random.npz")
    save_weights(lp_path, random_weights(0))
    env = dict(os.environ, PYTHONPATH=root, GSEDIT_LPIPS_WEIGHTS=lp_path)
    n_ply = ply_vertex_count(ply)
    base = dict(gs_source=ply, colmap_dir=colmap, height=cli_size,
                width=cli_size, device=device, n_val_views=2)
    bbox = [int(v * cli_size // SIZE) for v in ADD_BBOX]
    modes = {
        "edit": (dict(mode="edit", guidance="fake", system=dict(
            prompt=EDIT_PROMPT, batch_size=2, max_steps=EDIT_STEPS,
            densify_until_step=0)),
            ["--train", "--validate", "--export",
             f"system.max_steps={CLI_STEPS}"]),
        "del": (dict(mode="del", segmentor="fake", inpainter="fake",
                     system=dict(seg_prompt="the bear", batch_size=2,
                                 max_steps=CLI_STEPS, densify_until_step=0)),
                ["--train", "--export"]),
        "add": (dict(mode="add", inpainter="fake", system=dict(
            inpaint_prompt="a teddy bear", bbox=bbox, batch_size=2,
            densify_until_step=0)),
            ["--train", f"system.refine_steps={CLI_STEPS}"]),
    }
    for mode, (extra, args) in modes.items():
        cfg = dict(base, output_dir=os.path.join(tmp, "cli_" + mode), **extra)
        path = _yaml_config(os.path.join(tmp, f"cli_{mode}.yaml"), cfg)
        stdout = run_cli("gaussianeditor_tpu_torch.apps.launch",
                         ["--config", path, *args], mode, env)
        launches = _printed_json(stdout, "launches: ")
        for name in launches_sum:
            launches_sum[name] += launches[name]
        assert_launches({k2: launches[k2] for k2 in (
            "backward_tile", "forward_chunk", "backward_chunk")},
            dict(backward_tile=2 * CLI_STEPS), f"CLI {mode}")
        trial = _trial_dir(cfg["output_dir"])
        want = ["parsed.yaml", "cmd.txt", "code.zip", "metrics.jsonl"]
        want += {"edit": ["last.ply", "validation/metrics.json"],
                 "del": ["last.ply"], "add": ["merged.ply", "last.ply"]}[mode]
        for f in want:
            assert os.path.exists(os.path.join(trial, f)), f"{mode}: {f}"
        with open(os.path.join(trial, "metrics.jsonl")) as f:
            assert len(f.readlines()) == CLI_STEPS, f"{mode}: metrics rows"
        if mode == "edit":
            with open(os.path.join(trial, "validation", "metrics.json")) as f:
                val = json.load(f)
            assert all(np.isfinite(val[k2]) for k2 in ("psnr", "ssim",
                                                       "lpips")), val
            print(f"CLI edit validation: {val}", flush=True)
        n_alive = ply_vertex_count(os.path.join(
            trial, "merged.ply" if mode == "add" else "last.ply"))
        print(f"CLI {mode}: {n_alive} Gaussians written (from {n_ply}); "
              f"launches {launches}", flush=True)

    # the metrics CLI on renders of the reconstruction against targets
    bg = torch.zeros(3, device=dev)
    final = load_ply(os.path.join(_trial_dir(os.path.join(tmp, "recon")),
                                  "last.ply"), device=dev)
    rdir = os.path.join(tmp, "recon_renders")
    os.makedirs(rdir)
    n_metric = min(METRIC_VIEWS, len(sc.cameras))
    for i in range(n_metric):
        with torch.no_grad():
            img = render(final, sc.cameras[i], bg).color
        Image.fromarray((img.clamp(0, 1) * 255).to(torch.uint8).cpu()
                        .numpy()).save(os.path.join(rdir, sc.image_names[i]))
    del final
    m_path = os.path.join(tmp, "recon_metrics.json")
    run_cli("gaussianeditor_tpu_torch.train.metrics",
            [rdir, os.path.join(ws, "images"), "--out", m_path, "--device",
             device], "metrics", env)
    with open(m_path) as f:
        m = json.load(f)
    assert m["n_images"] == n_metric and all(
        np.isfinite(m[k2]) for k2 in ("psnr", "ssim", "lpips")), m
    print(f"metrics CLI on {n_metric} renders of the reconstruction: {m}",
          flush=True)



# phases 15-16: the web UI's editing session and score guidance
WEBUI_STEPS = 30             # the served edit (as phase 10's fit)
WEBUI_PROMPT = "the object"  # the traced group
SCORE_STEPS = 10             # phase 16's steps at batch 2
SCORE_REPEAT = 3             # steps of its bitwise repeat


def _http(url: str, payload=None, raw: bytes = None, timeout: float = 300):
    """(status, body, ms) of a GET (no payload) or a POST, over HTTP."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, 1e3 * (time.perf_counter() - t0)


def phase_webui(ply: str, colmap: str, thres: float, seg_ref,
                seg_radius: float, point_radius: float, tmp: str,
                device: str = "cuda", size: int = SIZE) -> dict:
    """Phase 15: the web UI's editing session over HTTP (see the module
    docstring); returns the launch counts of each endpoint's work."""
    import copy
    import dataclasses

    import torch
    from PIL import Image

    from gaussianeditor_tpu_torch.apps.webui import build_state, serve
    from gaussianeditor_tpu_torch.edit.tracing import (
        trace_from_click,
        update_mask_from_views,
    )
    from gaussianeditor_tpu_torch.guidance.fake import (
        FakeGuidance,
        FakeInpainter,
        FakeObjectGenerator,
        FakePointSegmentor,
        FakeSegmentor,
    )
    from gaussianeditor_tpu_torch.models.ply import load_ply
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.testing import (
        whole_step_frames,
        whole_step_index,
    )

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def decode(body: bytes) -> np.ndarray:
        return np.asarray(Image.open(io.BytesIO(body)))

    class CountingGuidance(FakeGuidance):
        calls = 0

        def __call__(self, rgb, cond_rgb, prompt):
            CountingGuidance.calls += 1
            return super().__call__(rgb, cond_rgb, prompt)

    t0 = time.perf_counter()
    seg = FakeSegmentor(seg_ref, seg_radius)
    point_seg = FakePointSegmentor(point_radius)
    state = build_state(
        ply, colmap, dev, size=size, guidance=CountingGuidance(),
        segmentor=seg,
        inpainter=FakeInpainter(),
        object_generator=FakeObjectGenerator(n_points=ADD_POINTS, device=dev),
        point_segmentor=point_seg)
    extent = state.cameras_extent
    state.edit_config = dataclasses.replace(edit_config(thres, extent),
                                            seg_prompt="")
    cfg, cams = state.edit_config, state.cameras
    V = len(cams)
    server = serve(state, port=0, block=False)
    url = f"http://localhost:{server.server_address[1]}"
    sync()
    print(f"webui: state built and served ({V} views at {size}x{size}, "
          f"capacity {state.scene.capacity}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ep_ms, counts = {}, {}

    def call(name, path, payload=None, raw=None, code=200):
        c, body, ms = _http(url + path, payload, raw)
        assert c == code, f"{name}: HTTP {c} ({body[:200]!r}), expected {code}"
        ep_ms.setdefault(name, []).append(ms)
        return json.loads(body) if body[:1] == b"{" else body

    def counted(name, fn):
        _kernels.reset_launch_counts()
        out = fn()
        counts[name] = _kernels.launch_counts()
        return out

    pose = ",".join(repr(v) for v in view_pose())
    render_q = f"/render?size={size}&pose={pose}&fovx=0.8&fovy=0.8"
    try:
        # 1. frames at idle: phase 4's 20 requests
        idle = [("orbit a", "theta=0.6&phi=0.3&radius=4"),
                ("orbit b", "theta=2.2&phi=-0.2&radius=3.5"),
                ("pose", f"pose={pose}&fovx=0.8&fovy=0.8"),
                ("overlay", "theta=0.6&phi=0.3&radius=4&overlay=1")]
        idle += [(f"sweep {i}", f"theta={0.3 * i:.2f}&phi=0.2&radius=4")
                 for i in range(SWEEP)]
        for name, q in idle:
            img = decode(call("GET /render (idle)",
                              f"/render?size={size}&{q}"))
            assert img.shape == (size, size, 3) and img.std() > 1.0, name

        # 2. the trace, held bitwise against update_mask_from_views driven
        # in process on the same renders
        with state.lock:
            before = copy.deepcopy(state.scene)
        out = counted("webui_trace", lambda: call(
            "POST /trace", "/trace", {"prompt": WEBUI_PROMPT,
                                      "threshold": cfg.mask_thres}))
        with torch.no_grad():
            masks = [seg(render(before, c, torch.zeros(3, device=dev),
                                max_instances=cfg.max_instances
                                ).color.cpu().numpy(), WEBUI_PROMPT)
                     for c in cams]
        ref, norm = update_mask_from_views(before, cams, masks,
                                           cfg.mask_thres,
                                           tile_cap=cfg.tile_cap,
                                           chunk=cfg.chunk)
        assert torch.equal(state.scene.mask, ref.mask), "trace: mask"
        weights = state.semantic_weights[WEBUI_PROMPT]
        assert torch.equal(weights, norm), "trace: cached weights"
        n_alive = int(state.scene.n_alive)
        assert out["selected"] == int(ref.mask.sum()) and \
            out["total"] == n_alive, out
        share = out["selected"] / n_alive
        assert 0.01 <= share <= 0.99, f"trace selects {share}"
        assert_launches(counts["webui_trace"], dict(
            binning_key=2 * V, forward_tile=V, rank_segment_sum=V), "trace")
        del before, ref, norm, masks

        # 3. the groups
        g = call("GET /groups", "/groups")
        assert g == {"groups": [WEBUI_PROMPT], "active": WEBUI_PROMPT}, g

        # 4. a new threshold, twice: `weights > t & alive`, no splat
        sel = {}
        for t in (0.3, 0.7):
            out = counted("webui_threshold", lambda: call(
                "POST /threshold", "/threshold", {"threshold": t}))
            want = (weights > t) & state.scene.alive
            assert torch.equal(state.scene.mask, want), f"threshold {t}"
            assert out["selected"] == int(want.sum()), out
            assert_launches(counts["webui_threshold"], {}, "threshold")
            sel[t] = out["selected"]
        t_mask = state.scene.mask.clone()

        # 5. a click at view 0's centre, bitwise trace_from_click in process
        click = (size / 2, size / 2)
        with state.lock:
            before = copy.deepcopy(state.scene)
        out = counted("webui_click", lambda: call(
            "POST /click", "/click", {"view": 0, "x": click[0], "y": click[1],
                                      "threshold": cfg.mask_thres,
                                      "group": "click"}))
        renders = []

        def render_fn(s, c):
            renders.append(c)
            with torch.no_grad():
                return render(s, c)

        ref, norm = trace_from_click(before, cams, 0, click, point_seg,
                                     cfg.mask_thres, render_fn=render_fn,
                                     tile_cap=cfg.tile_cap, chunk=cfg.chunk)
        assert torch.equal(state.scene.mask, ref.mask), "click: mask"
        assert torch.equal(state.semantic_weights["click"], norm), \
            "click: cached weights"
        assert out["selected"] == int(ref.mask.sum()) > 0, out
        assert_launches(counts["webui_click"], dict(
            binning_key=len(renders) + V, forward_tile=len(renders),
            rank_segment_sum=V), "click")
        del before, ref, norm

        # 6. back to the traced group: its mask restored bitwise
        out = call("POST /group", "/group", {"name": WEBUI_PROMPT})
        assert torch.equal(state.scene.mask, t_mask), "group: mask"
        assert out["selected"] == sel[0.7], out

        # 7. the config: one good update, one unknown key
        good = {"densification_interval": cfg.densification_interval,
                "loss.lambda_anchor_color": cfg.loss.lambda_anchor_color}
        out = call("POST /config", "/config", good)
        assert out["densification_interval"] == EDIT_REFRESH and \
            out["loss"]["lambda_anchor_color"] == 5.0, out
        out = call("POST /config", "/config", {"no_such_knob": 1})
        assert out == {"error": "unknown config keys: ['no_such_knob']"}, out
        assert state.edit_config == cfg

        # 8. the served edit: frames in a closed loop while it trains, each
        # bitwise a render of some whole step; then the in-process fit
        with state.lock:
            scene0 = copy.deepcopy(state.scene)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        frames, render_ms, status_ms = [], [], []
        calls0 = CountingGuidance.calls
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = call("POST /edit", "/edit", {"prompt": EDIT_PROMPT,
                                           "steps": WEBUI_STEPS,
                                           "mode": "edit"})
        assert out == {"started": True, "mode": "edit",
                       "steps": WEBUI_STEPS}, out
        editframe = None
        while True:
            st = call("GET /status", "/status")
            status_ms.append(ep_ms["GET /status"][-1])
            if not st["training"]:
                break
            if editframe is None and st.get("step", -1) >= 0:
                editframe = decode(call("GET /editframe", "/editframe?view=0"))
            for _ in range(4):
                frames.append(decode(call("GET /render (training)",
                                          render_q)))
                render_ms.append(ep_ms["GET /render (training)"][-1])
        served_s = time.perf_counter() - t0
        assert state.join(600)
        c_edit = _kernels.launch_counts()
        refreshes = CountingGuidance.calls - calls0
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        assert "error" not in st and st["step"] == WEBUI_STEPS - 1, st
        assert editframe is not None and editframe.shape == (size, size, 3)
        n_frames = len(frames)
        counts["webui_edit"] = c_edit
        # the fit's origin renders, steps and target refreshes (one render
        # each), and the frames served meanwhile
        renders = 2 * WEBUI_STEPS + V + refreshes + n_frames
        assert_launches(c_edit, dict(
            binning_key=renders, forward_tile=renders,
            backward_tile=2 * WEBUI_STEPS, rank_segment_sum=2 * WEBUI_STEPS),
            "served edit")
        sync()
        t0 = time.perf_counter()
        want, system = whole_step_frames(
            scene0, cams, dataclasses.replace(cfg, prompt=EDIT_PROMPT,
                                              max_steps=WEBUI_STEPS),
            view_pose(), size, state.guidance, state.segmentor)
        sync()
        inproc_s = time.perf_counter() - t0
        want8 = [(np.clip(w, 0, 1) * 255).astype(np.uint8) for w in want]
        idx = [whole_step_index(f, want8) for f in frames]
        assert n_frames >= 2 and min(idx) >= 0, f"torn frames: {idx}"
        assert idx == sorted(idx), f"frames out of step order: {idx}"
        assert_unchanged(state.scene, snapshot(system.scene),
                         "the served edit against the in-process fit")
        del scene0, want, want8, system
        slow = sorted(zip(render_ms, idx), reverse=True)[:3]
        print("webui edit: the slowest frames during it (ms, the step they "
              "show; 0 is the scene before the first step): " + ", ".join(
                  f"{ms:.1f} (step {i})" for ms, i in slow), flush=True)
        print(f"webui edit: {WEBUI_STEPS} steps served in {served_s:.2f} s "
              f"({WEBUI_STEPS / served_s:.3f} steps/s, {n_frames} frames "
              f"served meanwhile), in process {inproc_s:.2f} s "
              f"({WEBUI_STEPS / inproc_s:.3f} steps/s, one frame rendered "
              f"a step); every served frame bitwise a whole step's (steps "
              f"{sorted(set(idx))}); the served scene bitwise the in-process "
              f"fit's; peak device memory {peak:.2f} GiB", flush=True)

        # 9. a second edit, stopped after a few steps
        prev = state.last_metrics   # the first run's, until a step ends
        call("POST /edit", "/edit", {"prompt": EDIT_PROMPT,
                                     "steps": WEBUI_STEPS, "mode": "edit"})
        deadline = time.perf_counter() + 600
        while state.last_metrics is prev or state.last_metrics["step"] < 2:
            assert state.training and time.perf_counter() < deadline
            time.sleep(0.005)
        k = call("GET /status", "/status")["step"]
        t0 = time.perf_counter()
        assert call("POST /stop", "/stop", {}) == {"stopping": True}
        assert state.join(600)
        stop_ms = 1e3 * (time.perf_counter() - t0)
        st = call("GET /status", "/status")
        assert st["training"] is False and k <= st["step"] <= k + 2, (k, st)
        print(f"webui stop: requested after step {k}, ended after step "
              f"{st['step']}, {stop_ms:.1f} ms from POST /stop to the end "
              "of the run", flush=True)

        # 10. delete the traced object: 10 steps
        n0 = int(state.scene.n_alive)
        t0 = time.perf_counter()
        out = counted("webui_del", lambda: (call(
            "POST /edit (del)", "/edit", {"prompt": WEBUI_PROMPT,
                                          "steps": DEL_STEPS, "mode": "del",
                                          "inpaint_prompt": ""}),
            state.join(600))[0])
        del_s = time.perf_counter() - t0
        assert out == {"started": True, "mode": "del", "steps": DEL_STEPS}
        st = call("GET /status", "/status")
        assert "error" not in st and st["step"] == DEL_STEPS - 1, st
        n1 = int(state.scene.n_alive)
        assert 0 < n1 < n0, (n0, n1)
        # phase 12's set-up (origin renders, tracing, mask renders,
        # renders of the pruned scene) and steps
        assert_launches(counts["webui_del"], dict(
            binning_key=4 * V + 2 * DEL_STEPS,
            forward_tile=3 * V + 2 * DEL_STEPS,
            backward_tile=2 * DEL_STEPS, rank_segment_sum=V + 2 * DEL_STEPS),
            "served delete")

        # 11. add an object
        t0 = time.perf_counter()
        out = counted("webui_add", lambda: (call(
            "POST /add", "/add", {"prompt": "a stone statue",
                                  "bbox": list(ADD_BBOX), "view": 0}),
            state.join(600))[0])
        add_s = time.perf_counter() - t0
        assert out == {"started": True, "mode": "add"}, out
        st = call("GET /status", "/status")
        assert st == {"training": False, "added": True,
                      "n_alive": n1 + ADD_POINTS}, st
        assert_launches(counts["webui_add"], dict(
            binning_key=1, forward_tile=1), "add")
        print(f"webui del: {n0} -> {n1} alive, {del_s:.2f} s for set-up and "
              f"{DEL_STEPS} steps; add: {n1} -> {n1 + ADD_POINTS} alive in "
              f"{add_s:.2f} s", flush=True)

        # 12. save: the PLY renders bitwise as the served scene
        path = os.path.join(tmp, "webui.ply")
        out = call("POST /save", "/save", {"path": path})
        assert out == {"saved": path}
        with state.lock:
            served = copy.deepcopy(state.scene)
        loaded = load_ply(path, capacity=served.capacity, device=dev)
        cam = cams[0]
        with torch.no_grad():
            a = render(served, cam, torch.zeros(3, device=dev)).color
            b = render(loaded, cam, torch.zeros(3, device=dev)).color
        assert torch.equal(a, b), "the saved PLY renders otherwise"
        ply_mb = os.path.getsize(path) / 2**20
        os.remove(path)
        del served, loaded

        # 13. the poses
        p = call("GET /poses", f"/poses?theta=0.6&phi=0.3&radius=4"
                 f"&size={size}")
        assert len(p["frustums"]) == V and any(f["visible"]
                                               for f in p["frustums"])
        for f in p["frustums"]:
            assert all(math.isfinite(v) for s in f["segments"] for v in s)

        # 14. the bad requests of tests/test_webui.py, with the JAX codes
        call("GET /nope", "/nope", code=404)
        call("POST /trace (not json)", "/trace", raw=b"not json", code=400)
        call("GET /render (bad pose)", f"/render?size={size}&pose=1,2,3",
             code=400)
    finally:
        state.stop_flag = True
        state.join(600)
        server.shutdown()
        server.server_close()

    def med(v):
        return statistics.median(v)

    idle_ms = ep_ms["GET /render (idle)"]
    print(f"webui GET /render: idle median {med(idle_ms):.2f} ms, max "
          f"{max(idle_ms):.2f} ms over {len(idle_ms)}; during the served edit "
          f"median {med(render_ms):.2f} ms, max {max(render_ms):.2f} ms over "
          f"{len(render_ms)}; GET /status during it median "
          f"{med(status_ms):.2f} ms", flush=True)
    print("webui endpoint times (ms): " + "; ".join(
        f"{k} " + (f"{v[0]:.1f}" if len(v) == 1 else
                   f"median {med(v):.1f} over {len(v)}")
        for k, v in ep_ms.items() if not k.startswith("GET /render"))
        + f"; the PLY {ply_mb:.1f} MiB", flush=True)
    print("webui launches: " + "; ".join(f"{k} {v}" for k, v in
                                          counts.items()), flush=True)
    if cuda:
        print(f"webui: the numbers above on {nvidia_smi()}", flush=True)
    return counts


def phase_score(ply: str, cameras_extent: float, device: str = "cuda",
                size: int = SIZE) -> dict:
    """Phase 16: SDS and DDS score guidance in `EditSystem` (see the
    module docstring); returns the launch counts of its steps."""
    import copy
    import dataclasses

    import torch

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.edit.edit_system import EditSystem
    from gaussianeditor_tpu_torch.guidance import score
    from gaussianeditor_tpu_torch.guidance.fake import FakeLatentModel
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.train.trainer import LossWeights

    dev = torch.device(device)
    tm = Timers(dev)
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
    cams = orbit_cameras(EDIT_VIEWS, 4.0, 0.8, 0.8, size, size, device=dev)
    model = FakeLatentModel(device=dev)
    sds, dds = score.SDSGuidance(model), score.DDSGuidance(model)
    cfg = dataclasses.replace(
        edit_config(0.0, cameras_extent), seg_prompt="",
        max_steps=SCORE_STEPS, densify_until_step=0,
        loss=LossWeights(lambda_l1=10.0, lambda_p=0.0,
                         lambda_anchor_color=5.0, lambda_anchor_geo=50.0,
                         lambda_anchor_scale=50.0, lambda_anchor_opacity=50.0,
                         lambda_sds=1.0, lambda_dds=0.5))

    def system(s):
        return EditSystem(s, cams, cfg, guidance=None, perceptual=None,
                          sds_guidance=sds, dds_guidance=dds,
                          dds_prompts=(EDIT_PROMPT, "a statue"))

    # one SDS call against the fake encoder's VJP in closed form: grad @
    # proj^T / 64 over each 8x8 block, in float64
    with torch.no_grad():
        from gaussianeditor_tpu_torch.ops.render import render

        imgs = torch.stack([render(scene, c, torch.zeros(3, device=dev)
                                   ).color for c in cams[:2]])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.randint(20, 981, (2,), generator=gen, device=dev)
    noise = torch.randn((2, size // 8, size // 8, 4), generator=gen,
                        device=dev)
    g, info = sds(imgs, imgs.flip(0), EDIT_PROMPT, step=0, t=t, noise=noise)
    with torch.no_grad():
        lat, clat = model.encode(imgs), model.encode(imgs.flip(0))
        tb = t[:, None, None, None]
        noisy = sds.sched.add_noise(lat, noise, tb)
        pred = score.cfg_combine3(
            model.unet(noisy, t, EDIT_PROMPT, clat),
            model.unet(noisy, t, "", clat),
            model.unet(noisy, t, "", torch.zeros_like(clat)), 7.5, 1.5)
        grad = (sds.sched.w(tb) * (pred - noise)).double() / 2
        per_block = grad @ model.proj.double().T / 64.0
        want = per_block.repeat_interleave(8, 1).repeat_interleave(8, 2)
    err = float((g.double() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= 1e-5 * scale, f"SDS VJP: {err} against {scale}"
    print(f"score: SDS image gradient against the closed-form VJP in "
          f"float64: max abs error {err:.3g} (largest |g| {scale:.3g}); "
          f"grad_norm {float(info['grad_norm']):.4g}", flush=True)
    del imgs, g, want, per_block, grad

    # 10 steps, the score pass timed with its host round trip
    sys_a = system(copy.deepcopy(scene))
    sys_a._score_inject = tm.wrap("score", sys_a._score_inject)
    rec, last = [], [0.0]

    def callback(step, m):
        tm.sync()
        now = time.perf_counter()
        rec.append((step, 1e3 * (now - last[0]),
                    {k: float(v) for k, v in m.items()}))
        last[0] = time.perf_counter()

    sys_a.on_fit_start()
    before = sys_a.state.scene.features_dc.detach().clone()
    xyz0 = sys_a.state.scene.xyz.detach().clone()
    _kernels.reset_launch_counts()
    tm.sync()
    last[0] = time.perf_counter()
    sys_a.fit(callback=callback)
    tm.sync()
    c_steps = _kernels.launch_counts()
    print(f"score launches over {SCORE_STEPS} steps: {c_steps}", flush=True)
    assert_launches(c_steps, dict(
        binning_key=4 * SCORE_STEPS, forward_tile=4 * SCORE_STEPS,
        backward_tile=2 * SCORE_STEPS, rank_segment_sum=2 * SCORE_STEPS),
        "score steps")
    st = sys_a.state.scene
    moved = float((st.features_dc.detach() - before).abs().max())
    moved_xyz = float((st.xyz.detach() - xyz0).abs().max())
    assert moved > 0 and moved_xyz > 0, "the parameters did not move"
    for _, _, m in rec:
        assert all(math.isfinite(v) for v in m.values()), m
        assert m["loss_inject"] != 0.0, m
    step_ms = [ms for _, ms, _ in rec]
    score_ms = tm.ms["score"]

    # 3 steps twice from the same scene and seeds: bitwise equal
    runs = []
    for _ in range(2):
        s = system(copy.deepcopy(scene))
        s.fit(n_steps=SCORE_REPEAT)
        runs.append(s)
    assert_unchanged(runs[0].state.scene, snapshot(runs[1].state.scene),
                     "score repeat")
    for k in runs[0].state.opt_state.mu:
        assert torch.equal(runs[0].state.opt_state.mu[k],
                           runs[1].state.opt_state.mu[k]), k
    print(f"score: {SCORE_STEPS} steps (SDS 1.0 and DDS 0.5, batch 2, "
          f"{scene.capacity} slots): ms per step median "
          f"{statistics.median(step_ms[1:]):.2f} (first {step_ms[0]:.2f}), "
          f"the score pass with its host round trip median "
          f"{statistics.median(score_ms[1:]):.2f} ms; features_dc moved up "
          f"to {moved:.3g}, xyz {moved_xyz:.3g}; loss_inject "
          + ", ".join(f"{m['loss_inject']:.4g}" for _, _, m in rec)
          + f"; {SCORE_REPEAT} steps repeated bitwise", flush=True)
    if dev.type == "cuda":
        print(f"score: the numbers above on {nvidia_smi()}", flush=True)
    return dict(score_steps=c_steps)


# phase 17: multi-device training and the oracle
STRIPS = 4                   # (a): the 32 tile rows as 4 strips of 8
WORLD1_STEPS = 3             # (b): view-sharded steps at world size 1
ORACLE_N = 2000              # (d): the oracle's scene, a cut of bench.py's
ORACLE_SIZE = 128
GLOO_TIMEOUT = 600.0         # (c): the two spawned ranks' deadline


def _grad_params(scene) -> list:
    from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES

    return [getattr(scene, k) for k in PARAM_NAMES]


def compare_states(got, want, label: str, param_atol=None,
                   accum_rtol=None) -> None:
    """`got`'s parameters and densify statistics against `want`'s, at the
    JAX tests' tolerances: xyz at atol 1e-5 / rtol 1e-4
    (tests/test_parallel.py), or every parameter at atol `param_atol`
    when given (tests/test_mesh2d.py); the gradient accumulator at rtol
    `accum_rtol` when given; max radii exactly. Prints each check's
    largest error and the entries beyond it, then asserts."""
    import torch

    from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES

    bad = {}

    def check(name, a, b, atol, rtol):
        err = (a - b).abs()
        over = int((err > atol + rtol * b.abs()).sum())
        print(f"  {label} {name}: max abs diff {float(err.max()):.3g}, "
              f"{over} entries beyond atol {atol:g} / rtol {rtol:g}",
              flush=True)
        if over:
            bad[name] = over

    if param_atol is None:
        check("xyz", got.scene.xyz.detach(), want.scene.xyz.detach(), 1e-5,
              1e-4)
    else:
        for k in PARAM_NAMES:
            check(k, getattr(got.scene, k).detach(),
                  getattr(want.scene, k).detach(), param_atol, 0.0)
    if accum_rtol is not None:
        check("xyz_gradient_accum", got.stats.xyz_gradient_accum,
              want.stats.xyz_gradient_accum, 1e-5, accum_rtol)
    radii_eq = torch.equal(got.stats.max_radii2d, want.stats.max_radii2d)
    print(f"  {label} max_radii2d equal: {radii_eq}", flush=True)
    assert radii_eq, f"{label}: max radii differ"
    assert not bad, f"{label}: beyond tolerance {bad}"


def states_equal(a, b) -> bool:
    import torch

    from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES

    return (all(torch.equal(getattr(a.scene, k), getattr(b.scene, k))
                for k in PARAM_NAMES)
            and all(torch.equal(getattr(a.stats, f), getattr(b.stats, f))
                    for f in ("xyz_gradient_accum", "denom", "max_radii2d")))


def phase_strips(scene, budget: int, device: str = "cuda",
                 size: int = SIZE) -> dict:
    """Phase 17 (a): phase 3's view as STRIPS tile-row strips in one
    process, against the whole render (image bounds; gradients of a
    seeded probe, normalised atol 1e-3); B1-B4 against their plain
    versions at strip 1's grid; the launches and the times."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        key_depth_bits,
        sorted_bin,
    )
    from gaussianeditor_tpu_torch.ops.composite import tiles_to_image
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.ops.tile_composite import forward_tiles
    from gaussianeditor_tpu_torch.parallel.tile_sharded import (
        preprocess_strip,
        render_strip,
    )
    from gaussianeditor_tpu_torch.testing import assert_images_close

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cam = lookat_camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, 0.8, size, size, device=dev)
    gx = gy = size // 16
    gyl = gy // STRIPS
    hs = gyl * 16
    params = _grad_params(scene)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    probe = torch.randn((size, size, 3), generator=gen, device=dev)

    def strips():
        return [render_strip(scene, cam, i * gyl, gyl, max_instances=budget)
                for i in range(STRIPS)]

    def strips_grad():
        outs = strips()
        loss = sum(torch.sum(o.color * probe[i * hs:(i + 1) * hs])
                   + 0.05 * torch.sum(o.final_T) for i, o in enumerate(outs))
        return outs, torch.autograd.grad(loss, params)

    def full():
        return render(scene, cam, torch.zeros(3, device=dev),
                      max_instances=budget)

    def full_grad():
        out = full()
        loss = torch.sum(out.color * probe) + 0.05 * torch.sum(out.final_T)
        return out, torch.autograd.grad(loss, params)

    _kernels.reset_launch_counts()
    outs, g_strips = strips_grad()
    if cuda:
        torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    print(f"strips: launches of {STRIPS} strip renders with their backward: "
          f"{counts}", flush=True)
    if cuda:
        assert_launches(counts, dict(binning_key=STRIPS, forward_tile=STRIPS,
                                     backward_tile=STRIPS,
                                     rank_segment_sum=STRIPS), "strips")
    assert not any(bool(o.overflow) for o in outs), "a strip overflowed"
    whole, g_full = full_grad()
    color = torch.cat([o.color for o in outs])[:size].detach()
    final_T = torch.cat([o.final_T for o in outs])[:size].detach()
    assert_images_close(color, whole.color.detach(), name="strips color")
    assert_images_close(final_T, whole.final_T.detach(),
                        name="strips final_T")
    diff = (color - whole.color.detach()).abs()
    n_px = int((diff > 1e-5).any(dim=-1).sum())
    grad_err = {}
    for k, a, b in zip(PARAM_NAMES, g_strips, g_full):
        den = float(b.abs().max()) + 1e-8
        grad_err[k] = float((a - b).abs().max()) / den
    print(f"strips: {STRIPS} strips of {gyl} tile rows against the whole "
          f"render: color max abs diff {float(diff.max()):.3g}, {n_px} of "
          f"{size * size} pixels beyond 1e-5; summed strip gradients, max "
          f"abs diff over the whole render's largest: "
          + ", ".join(f"{k} {v:.3g}" for k, v in grad_err.items()),
          flush=True)
    assert all(v <= 1e-3 for v in grad_err.values()), grad_err
    # the JAX strips' depth cut, the strip grid's own: ties of quantised
    # depth order otherwise (printed, not held)
    own = key_depth_bits(gx * gyl)
    with torch.no_grad():
        color_own = []
        for i in range(STRIPS):
            proc = preprocess_strip(scene, cam, i * gyl, gyl)
            sb = sorted_bin(proc, gx, gyl, budget, depth_bits=own)
            color_own.append(tiles_to_image(forward_tiles(sb, gx, 3).color,
                                            gx, gyl, hs, size))
        color_own = torch.cat(color_own)[:size]
    diff_own = (color_own - whole.color.detach()).abs()
    n_own = int((diff_own > 1e-5).any(dim=-1).sum())
    print(f"strips: at the strip grid's own depth cut ({own} bits, the "
          f"whole image's {key_depth_bits(gx * gy)}), as the JAX strips "
          f"cut: color max abs diff {float(diff_own.max()):.3g}, {n_own} "
          f"pixels beyond 1e-5", flush=True)
    del outs, g_strips, whole, g_full, color_own

    out = dict(counts=counts, pixels_beyond=n_px, grad_err=grad_err,
               own_cut=dict(bits=own, max_abs_diff=float(diff_own.max()),
                            pixels_beyond=n_own))
    if not cuda:
        return out
    with torch.no_grad():
        t_fwd = time_ms(strips, runs=5)
        t_full = time_ms(full, runs=5)
    t_fb = time_ms(strips_grad, runs=5)
    t_full_fb = time_ms(full_grad, runs=5)
    print(f"strips: forward of the {STRIPS} strips {t_fwd:.2f} ms against the "
          f"whole render's {t_full:.2f} ms ({t_fwd / t_full:.2f}x); backward "
          f"{t_fb - t_fwd:.2f} ms against {t_full_fb - t_full:.2f} ms "
          f"({(t_fb - t_fwd) / (t_full_fb - t_full):.2f}x); forward and "
          f"backward {t_fb:.2f} against {t_full_fb:.2f} ms", flush=True)
    out.update(ms=dict(strips_forward=t_fwd, full_forward=t_full,
                       strips_forward_backward=t_fb,
                       full_forward_backward=t_full_fb))

    # each kernel against its plain version at strip 1's grid
    with torch.no_grad():
        proc = preprocess_strip(scene, cam, gyl, gyl)
    k = check_kernels(proc, gx, gyl, budget, "strip 1", time_plain=False,
                      depth_bits=key_depth_bits(gx * gy))
    rows = phase_backward(dict(proc=proc, sb=k["sb"], tiles=k["tiles"],
                               contrib=k["contrib"], gx=gx, gy=gyl,
                               budget=budget), time_plain=False)
    out["strip_grid"] = {
        "B1 binning_key": dict(ms=k["b1_ms"], max_abs_err=k["b1_err"],
                               bound_ms=k["b1_bound"]),
        "B2 forward_tile": dict(ms=k["b2_ms"], max_abs_err=k["b2_err"],
                                bound_ms=k["b2_bound"]),
        **{r["name"]: dict(ms=r["ms"], max_abs_err=r["max_abs_err"],
                           bound_ms=r["bound_ms"]) for r in rows}}
    for name, v in out["strip_grid"].items():
        v.update(tiles=gx * gyl)
    print(f"strips: the numbers above on {nvidia_smi()}", flush=True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_world1(ply: str, tr: dict, device: str = "cuda") -> dict:
    """Phase 17 (b): the view-sharded step at world size 1 under NCCL (gloo
    on the CPU), in this process, against `make_train_step` from the same
    state (phase 7's optimizer, cameras, targets and weights)."""
    import copy

    import torch
    import torch.distributed as dist

    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )
    from gaussianeditor_tpu_torch.parallel.sharded_step import (
        make_sharded_train_step,
    )
    from gaussianeditor_tpu_torch.train.perceptual import (
        multiscale_gradient_loss,
    )
    from gaussianeditor_tpu_torch.train.trainer import (
        LossWeights,
        init_train_state,
        make_train_step,
    )

    optim, cams, targets = tr["optim"], tr["cams"], tr["targets"]
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=device)
    dev = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device=device)
    try:
        backend = dist.get_backend()
        sharded = make_sharded_train_step(optim, LossWeights(), make_mesh(1),
                                          perceptual=multiscale_gradient_loss)
        single = make_train_step(optim, LossWeights(),
                                 perceptual=multiscale_gradient_loss)
        sa = init_train_state(copy.deepcopy(scene), optim)
        sb = init_train_state(scene, optim)
        _kernels.reset_launch_counts()
        sa, hist_a = run_steps(sharded, sa, cams, targets, WORLD1_STEPS)
        counts = _kernels.launch_counts()
        sb, hist_b = run_steps(single, sb, cams, targets, WORLD1_STEPS)
    finally:
        dist.destroy_process_group()
    print(f"world1: launches over {WORLD1_STEPS} steps: {counts}", flush=True)
    if dev.type == "cuda":
        assert_launches(counts, {k: 2 * WORLD1_STEPS for k in (
            "binning_key", "forward_tile", "backward_tile",
            "rank_segment_sum")}, "world-1 steps")
    compare_states(sa, sb, "world1", accum_rtol=1e-3)
    losses = [(float(ma["loss"]), float(mb["loss"]))
              for (_, ma), (_, mb) in zip(hist_a, hist_b)]
    for a, b in losses:
        assert abs(a - b) <= 1e-5 * abs(b), losses
    bitwise = states_equal(sa, sb) and all(a == b for a, b in losses)
    med_a = statistics.median(t for t, _ in hist_a)
    med_b = statistics.median(t for t, _ in hist_b)
    print(f"world1: {WORLD1_STEPS} view-sharded steps at world size 1 "
          f"({backend}) against make_train_step: losses {losses}; bitwise "
          f"equal: "
          f"{bitwise}; step median {med_a:.2f} ms against {med_b:.2f} ms "
          f"here and {tr['stats']['median']:.2f} ms in phase 7 (ms per "
          f"step, host clock)", flush=True)
    if dev.type == "cuda":
        print(f"world1: the numbers above on {nvidia_smi()}", flush=True)
    return dict(counts=counts, bitwise=bitwise, median_ms=med_a,
                single_median_ms=med_b)


def one_minus_ssim(pred, target):
    from gaussianeditor_tpu_torch.train.losses import ssim

    return 1.0 - ssim(pred, target)


def _gloo_rank(rank: int, world: int, ply: str, optim_config,
               targets: np.ndarray, device: str, size: int) -> dict:
    """Phase 17 (c), one of two ranks sharing cuda:0 under gloo (see
    `phase_gloo`)."""
    import copy

    import torch
    import torch.distributed as dist

    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        render,
    )
    from gaussianeditor_tpu_torch.parallel.halo import ssim_sharded
    from gaussianeditor_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from gaussianeditor_tpu_torch.parallel.mesh2d import make_2d_train_step
    from gaussianeditor_tpu_torch.parallel.sharded_step import (
        make_sharded_train_step,
    )
    from gaussianeditor_tpu_torch.parallel.tile_sharded import (
        make_tile_sharded_render,
    )
    from gaussianeditor_tpu_torch.testing import (
        assert_images_close,
        fingerprint,
    )
    from gaussianeditor_tpu_torch.train.losses import ssim
    from gaussianeditor_tpu_torch.train.optim import GaussianAdam
    from gaussianeditor_tpu_torch.train.perceptual import (
        multiscale_gradient_loss,
    )
    from gaussianeditor_tpu_torch.train.trainer import (
        LossWeights,
        init_train_state,
        make_train_step,
    )

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    scene = load_ply(ply, capacity=4 * ply_vertex_count(ply), device=dev)
    cams = orbit_cameras(2, 4.0, 0.8, 0.8, size, size, device=dev)
    targets = torch.from_numpy(targets).to(dev)
    optim = GaussianAdam(optim_config)
    out = {"backend": dist.get_backend()}

    # the collectives' time: every all_reduce and all_gather timed
    coll = []
    originals = dist.all_reduce, dist.all_gather

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            sync()
            coll.append(1e3 * (time.perf_counter() - t0))
            return res
        return run

    def same_on_both_ranks(state) -> bool:
        fp = fingerprint(list(state.scene.params().values()))
        got = [torch.empty_like(fp) for _ in range(world)]
        originals[1](got, fp)
        return all(torch.equal(got[0], g) for g in got[1:])

    def part(name, fn):
        sync()
        dist.barrier()      # both ranks start the part together
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        coll.clear()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = dict(ms=1e3 * (time.perf_counter() - t0),
                         collectives_ms=sum(coll), collectives=len(coll),
                         launches=_kernels.launch_counts(),
                         peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else 0.0))
        return res

    dist.all_reduce, dist.all_gather = timed(originals[0]), timed(originals[1])
    try:
        # the view-sharded step, one view a rank
        step = make_sharded_train_step(optim, LossWeights(), make_mesh(world),
                                       perceptual=multiscale_gradient_loss)
        st = init_train_state(copy.deepcopy(scene), optim)
        st, m = part("view", lambda: step(st, cams, targets))
        out["view"]["loss"] = float(m["loss"])
        out["view"]["ranks_bitwise"] = same_on_both_ranks(st)
        if rank == 0:
            single = make_train_step(optim, LossWeights(),
                                     perceptual=multiscale_gradient_loss)
            ss, ms = single(init_train_state(copy.deepcopy(scene), optim),
                            cams, targets)
            print("gloo view-sharded step against make_train_step:",
                  flush=True)
            compare_states(st, ss, "gloo view", accum_rtol=1e-3)
            assert abs(float(m["loss"]) - float(ms["loss"])) <= \
                1e-5 * abs(float(ms["loss"])), (float(m["loss"]), ms["loss"])
            out["view"]["bitwise_single"] = states_equal(st, ss)
            del ss
        del st

        # the 2-D step on a 1x2 (view x tile) mesh, 1 - SSIM through
        # gather_rows as the perceptual term
        step2 = make_2d_train_step(optim, LossWeights(), make_mesh_2d((1, 2)),
                                   perceptual=one_minus_ssim)
        st = init_train_state(copy.deepcopy(scene), optim)
        st, m = part("2d", lambda: step2(st, cams, targets))
        out["2d"].update(loss=float(m["loss"]), loss_p=float(m["loss_p"]),
                         overflow=bool(m["overflow"]),
                         ranks_bitwise=same_on_both_ranks(st))
        if rank == 0:
            single = make_train_step(optim, LossWeights(),
                                     perceptual=one_minus_ssim)
            ss, ms = single(init_train_state(copy.deepcopy(scene), optim),
                            cams, targets)
            print("gloo 2-D step against make_train_step:", flush=True)
            compare_states(st, ss, "gloo 2d", param_atol=2e-5)
            for k in ("loss", "loss_p"):
                a, b = float(m[k]), float(ms[k])
                assert abs(a - b) <= 2e-5 * abs(b), (k, a, b)
            assert not bool(m["overflow"])
            del ss
        del st

        # the strip-sharded render, 2 strips
        budget = default_max_instances(scene.capacity)
        fn = make_tile_sharded_render(make_mesh(world, axis="tile"),
                                      scene.capacity, cams[0],
                                      max_instances_per_shard=budget)
        bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
        with torch.no_grad():
            color, ovf = part("strip_render", lambda: fn(scene, bg))
            if rank == 0:
                want = render(scene, cams[0], bg).color
                assert_images_close(color, want, name="gloo strip render")
                out["strip_render"]["max_abs_diff"] = float(
                    (color - want).abs().max())
        assert not bool(ovf)

        # halo SSIM on two random images of the view's size, each rank its
        # rows
        rng = np.random.RandomState(2)
        a = rng.rand(size, size, 3).astype(np.float32)
        b = (rng.rand(size, size, 3) * 0.5 + a * 0.5).astype(np.float32)
        hs = size // world
        ta = torch.from_numpy(a[rank * hs:(rank + 1) * hs]).to(dev)
        ta.requires_grad_(True)
        tb = torch.from_numpy(b[rank * hs:(rank + 1) * hs]).to(dev)
        s = part("ssim", lambda: ssim_sharded(ta, tb))
        (g,) = torch.autograd.grad(s, [ta])
        parts = [torch.empty_like(g) for _ in range(world)]
        originals[1](parts, g.contiguous())
        if rank == 0:
            fa = torch.from_numpy(a).to(dev).requires_grad_(True)
            want = ssim(fa, torch.from_numpy(b).to(dev))
            (gw,) = torch.autograd.grad(want, [fa])
            got_g = torch.cat(parts)
            out["ssim"].update(value=float(s.detach()),
                               want=float(want.detach()),
                               grad_err=float((got_g - gw).abs().max()))
            assert abs(out["ssim"]["value"] - out["ssim"]["want"]) <= \
                1e-6 * abs(out["ssim"]["want"]), out["ssim"]
            assert out["ssim"]["grad_err"] <= 1e-6, out["ssim"]["grad_err"]
    finally:
        dist.all_reduce, dist.all_gather = originals
    return out


def phase_gloo(ply: str, tr: dict, device: str = "cuda:0",
               size: int = SIZE) -> dict:
    """Phase 17 (c): two spawned ranks share cuda:0 under gloo, with CUDA
    tensors (gloo stages them through the host: its transport, printed
    here): one view-sharded step at world 2, one 2-D step on a 1x2 mesh
    with 1 - SSIM through `gather_rows`, a 2-strip render and the halo
    SSIM; rank 0 holds each against its single-process counterpart, and
    both ranks' parameters must be bitwise equal after each step."""
    import torch

    from gaussianeditor_tpu_torch.testing import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(_gloo_rank, 2, ply, tr["optim"].config,
                      tr["targets"].cpu().numpy(), device, size,
                      device=device, backend="gloo", timeout=GLOO_TIMEOUT)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        assert res["backend"] == "gloo", res["backend"]
        for p in ("view", "2d"):
            assert res[p]["ranks_bitwise"], f"rank {r} {p}: ranks differ"
        print(f"gloo rank {r}: " + "; ".join(
            f"{p} {res[p]['ms']:.1f} ms (collectives {res[p]['collectives']}"
            f" calls, {res[p]['collectives_ms']:.1f} ms), peak "
            f"{res[p]['peak_gib']:.2f} GiB, launches {res[p]['launches']}"
            for p in ("view", "2d", "strip_render", "ssim")), flush=True)
    cuda = torch.device(device).type == "cuda"
    for res in ranks if cuda else ():
        for p, n in (("view", 1), ("2d", 2)):
            assert_launches(res[p]["launches"], {k: n for k in (
                "binning_key", "forward_tile", "backward_tile",
                "rank_segment_sum")}, f"gloo {p}")
        assert_launches(res["strip_render"]["launches"],
                        dict(binning_key=1, forward_tile=1),
                        "gloo strip render")
    r0 = ranks[0]
    where = (f"one card ({torch.cuda.get_device_name(0)}), CUDA tensors "
             f"through gloo's host transport" if cuda else "the CPU")
    print(f"gloo: two ranks on {where}: parameters bitwise "
          f"equal across the ranks after each step; view-sharded step "
          f"bitwise make_train_step's: {r0['view']['bitwise_single']}; "
          f"2-D loss {r0['2d']['loss']:.6g}, loss_p {r0['2d']['loss_p']:.6g}; "
          f"2-strip render max abs diff "
          f"{r0['strip_render']['max_abs_diff']:.3g}; halo SSIM "
          f"{r0['ssim']['value']:.7f} against {r0['ssim']['want']:.7f}"
          f" (gradient max abs diff {r0['ssim']['grad_err']:.3g}); the spawn "
          f"{wall:.1f} s", flush=True)
    if cuda:
        print(f"gloo: the numbers above on {nvidia_smi()}", flush=True)
    return dict(ranks=ranks, wall_s=wall)


def phase_oracle(device: str = "cuda") -> None:
    """Phase 17 (d): `render(impl="ref")` on a 2,000-Gaussian cut of the
    bench recipe at 128x128 against the sorted route (image bounds), and
    in float64 against the float32 oracle; the oracle launches no
    compositor kernel, and its float64 preprocess no kernel at all."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import render
    from gaussianeditor_tpu_torch.testing import assert_images_close

    dev = torch.device(device)
    arrays = bench_scene_arrays(ORACLE_N, SEED)
    scene = GaussianScene.create(
        {k: torch.from_numpy(v) for k, v in arrays.items()},
        max_sh_degree=SH_DEGREE, active_sh_degree=SH_DEGREE).to(dev)
    cam = lookat_camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, 0.8, ORACLE_SIZE, ORACLE_SIZE, device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    tm = Timers(dev)
    with torch.no_grad():
        fast = render(scene, cam, bg)
        _kernels.reset_launch_counts()
        ref = tm.wrap("ref", render)(scene, cam, bg, impl="ref")
        ref64 = tm.wrap("ref64", render)(
            scene.to(torch.float64), cam, bg.double(), impl="ref")
    counts = _kernels.launch_counts()
    # no compositor kernel; the float32 scene's preprocess is the kernel,
    # the float64 one's the plain version
    assert_launches(counts, dict(preprocess_forward=1), "the oracle")
    for name, loose in (("color", 6e-3), ("depth", 2e-2), ("final_T", 6e-3)):
        assert_images_close(getattr(fast, name), getattr(ref, name),
                            loose=loose, name=f"oracle {name}")
        assert_images_close(getattr(ref64, name).float(), getattr(ref, name),
                            loose=loose, name=f"oracle float64 {name}")
    n_vis = int(ref.visible.sum())
    print(f"oracle: {ORACLE_N} Gaussians ({n_vis} visible) at "
          f"{ORACLE_SIZE}x{ORACLE_SIZE}: the sorted route within the image "
          f"bounds of render(impl='ref') (color max abs diff "
          f"{float((fast.color - ref.color).abs().max()):.3g}), float64 "
          f"within them of float32 (max abs diff "
          f"{float((ref64.color.float() - ref.color).abs().max()):.3g}); no "
          f"compositor kernel launched; {tm.total('ref'):.0f} ms in float32, "
          f"{tm.total('ref64'):.0f} ms in float64", flush=True)
    if dev.type == "cuda":
        print(f"oracle: the numbers above on {nvidia_smi()}", flush=True)


PRE_SCENES = (   # (label, Gaussians, slots, box, eye, fovx, fovy, H, W)
    ("edit1m", 1_000_000, 4_000_000, 1.0, (0.0, 0.0, -4.0), 0.8, 0.8,
     SIZE, SIZE),
    ("garden-late", 3_000_000, 3_000_000, 1.5,
     (3.2 * math.cos(0.2), 3.2 * math.sin(0.2), 0.0), 0.9931, 0.6732,
     840, 1297),
)


def preprocess_inputs(n: int, cap: int, half: float, seed: int, dev):
    """bench.py's recipe drawn on the device in a box of half-width
    `half` (half that in y for the wide box), `cap` slots with the last
    cap - n dead, SH degree 3 with nonzero rest features (so that their
    gradients are exercised), the densify probe's zero offset:
    (xyz, log_scales, quats, opacity, features_dc, features_rest, alive,
    offset)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    hy = half if half == 1.0 else half / 2
    vol = 8.0 * half * hy * half
    size = 0.012 * (100_000 * vol / 8.0 / n) ** (1 / 3)
    box = torch.tensor([half, hy, half], **f32)
    quats = torch.randn((n, 4), generator=g, **f32)
    quats = quats / torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    u = torch.rand((n, 7), generator=g, **f32)
    arrays = [
        box * (2.0 * u[:, :3] - 1.0),
        torch.log(size / 3 + (size * 4 / 3) * u[:, 4:7]),
        quats,
        torch.sigmoid(2.0 * u[:, 3] - 1.0),
        0.3 * torch.randn((n, 1, 3), generator=g, **f32),
        0.1 * torch.randn((n, 15, 3), generator=g, **f32),
    ]
    out = []
    for a in arrays:
        full = torch.zeros((cap,) + tuple(a.shape[1:]), **f32)
        full[:n] = a
        out.append(full)
    alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
    alive[:n] = True
    out[3] = out[3] * alive
    return (*out, alive, torch.zeros((cap, 2), **f32))


def ulp_gap(a, b) -> tuple:
    """(slots whose bits differ, the largest gap in float32 ulps between
    two float tensors of one shape; NaN == NaN)."""
    import torch

    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    # order the bit patterns as the floats are ordered
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    diff = (ia - ib).abs()
    return int((diff > 0).sum()), int(diff.max()) if diff.numel() else 0


def phase_preprocess(device: str = "cuda") -> list:
    """Phase 18: the preprocess kernels (`csrc/preprocess.cu`) against
    their plain versions on the card at the benchmark's two scenes: 4M
    slots (1M alive) at 512x512 and 3M alive at 1297x840, SH degree 3 with
    the densify offset. The forward's integer fields (radius, rects,
    tiles_touched, visible) and num_rendered must equal the plain
    version's on every slot, and its float fields (mean2d, depth, conic,
    color) bit for bit, in the colour render, a 1-channel override
    render and a strip's; each float field's differing slots and largest
    ulp gap are printed before they are held to that. The backward, from a
    seeded cotangent on the visible slots (zero elsewhere, as the
    compositor leaves it), must be within 1e-5 of each gradient's largest
    entry of autograd on the plain version, and give exact zeros on the
    rest; one launch each. Both kernels are timed (CUDA events, median of
    20) beside their byte bounds and the plain versions' times."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.preprocess import (
        _backward_kernel,
        _Options,
        preprocess,
        preprocess_plain,
    )

    dev = torch.device(device)
    _kernels.build(["preprocess_forward"])
    inst = ""
    for line in _kernels.BUILD_LOG.get("preprocess_forward", "").splitlines():
        if "Compiling entry function" in line:
            inst = line.split("'")[1]
        elif "spill" in line or "registers" in line:
            print(f"  {inst}: {line.split(':', 1)[-1].strip()}")
    rows = []
    for label, n, cap, half, eye, fovx, fovy, H, W in PRE_SCENES:
        xyz, ls, q, op, dc, rest, alive, off = preprocess_inputs(
            n, cap, half, SEED, dev)
        cam = lookat_camera(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), fovx,
                            fovy, H, W, device=dev)
        active = torch.tensor(SH_DEGREE, dtype=torch.int32, device=dev)
        kw = dict(alive=alive, active_sh_degree=active,
                  max_sh_degree=SH_DEGREE)
        gaps = {}
        with torch.no_grad():
            for case, extra in (("color", {}),
                                ("override ch1", dict(override_color=(
                                    alive[:, None].float()))),
                                ("strip", dict(tile_row_range=(8, 16)))):
                _kernels.reset_launch_counts()
                got = preprocess(xyz, ls, q, op, (dc, rest), cam,
                                 mean2d_offset_ndc=off, **kw, **extra)
                counts = _kernels.launch_counts()
                want = preprocess_plain(xyz, ls, q, op, (dc, rest), cam,
                                        mean2d_offset_ndc=off, **kw, **extra)
                torch.cuda.synchronize()
                assert_launches(counts, dict(preprocess_forward=1),
                                f"{label} {case} forward")
                for f in ("radius", "visible", "rect_min", "rect_max",
                          "tiles_touched"):
                    same = torch.equal(getattr(got, f), getattr(want, f))
                    assert same, f"{label} {case}: {f} differs"
                assert int(got.tiles_touched.sum()) == int(
                    want.tiles_touched.sum())
                for f in ("mean2d", "depth", "conic", "color"):
                    gaps[f"{case} {f}"] = ulp_gap(getattr(got, f),
                                                  getattr(want, f))
                if case == "color":
                    vis = want.visible
                    rendered = int(want.tiles_touched.sum())
        print(f"preprocess {label}: {cap} slots, {int(alive.sum())} alive, "
              f"{int(vis.sum())} visible, num_rendered "
              f"{rendered} at {W}x{H}: integer fields "
              f"equal on every slot (color, override ch1, strip rows 8-16); "
              f"float fields (slots differing, largest ulp gap): {gaps}",
              flush=True)
        differ = {k: v for k, v in gaps.items() if v != (0, 0)}
        assert not differ, f"{label}: float fields not bitwise: {differ}"

        # backward against autograd on the plain version
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        m = vis.float()
        cot = dict(mean2d=torch.randn((cap, 2), generator=gen, device=dev),
                   depth=torch.randn((cap,), generator=gen, device=dev),
                   conic=1e-2 * torch.randn((cap, 3), generator=gen,
                                            device=dev),
                   color=torch.randn((cap, 3), generator=gen, device=dev))
        cot = {k: v * (m if v.dim() == 1 else m[:, None])
               for k, v in cot.items()}
        leaves = [t.clone().requires_grad_(True)
                  for t in (xyz, ls, q, dc, rest, off)]

        def grads(fn):
            out = fn(leaves[0], leaves[1], leaves[2], op,
                     (leaves[3], leaves[4]), cam,
                     mean2d_offset_ndc=leaves[5], **kw)
            return torch.autograd.grad([getattr(out, k) for k in cot],
                                       leaves, list(cot.values()))

        _kernels.reset_launch_counts()
        g_k = grads(preprocess)
        counts = _kernels.launch_counts()
        g_p = grads(preprocess_plain)
        torch.cuda.synchronize()
        assert_launches(counts, dict(preprocess_forward=1,
                                     preprocess_backward=1),
                        f"{label} forward and backward")
        errs = {}
        for name, a, b in zip(("xyz", "log_scales", "quats", "features_dc",
                               "features_rest", "offset"), g_k, g_p):
            errs[name] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
            assert errs[name] <= 1e-5, (label, name, errs[name])
            assert not a[~vis].any(), (label, name)
        del g_k, g_p, leaves

        # times and bounds
        opts = _Options(SH_DEGREE, active, 1.0, None)

        def fwd():
            return preprocess(xyz, ls, q, op, (dc, rest), cam,
                              mean2d_offset_ndc=off, **kw)

        def bwd():
            return _backward_kernel(xyz, ls, q, dc, rest, cam, opts,
                                    cot["mean2d"], cot["depth"],
                                    cot["conic"], cot["color"], True)

        with torch.no_grad():
            fwd_ms = time_ms(fwd)
            bwd_ms = time_ms(bwd)
            plain_fwd_ms = time_ms(lambda: preprocess_plain(
                xyz, ls, q, op, (dc, rest), cam, mean2d_offset_ndc=off,
                **kw), runs=3)
        leaves = [t.clone().requires_grad_(True)
                  for t in (xyz, ls, q, dc, rest, off)]
        out = preprocess_plain(leaves[0], leaves[1], leaves[2], op,
                               (leaves[3], leaves[4]), cam,
                               mean2d_offset_ndc=leaves[5], **kw)
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            [getattr(out, k) for k in cot], leaves, list(cot.values()),
            retain_graph=True), runs=3)
        del out, leaves
        # bytes: every input read once and every output written once; the
        # backward reads the parameters of the slots with a nonzero
        # upstream gradient only (the rest need none)
        k_floats = 3 * 16
        params = 4 * (3 + 3 + 4 + k_floats)
        fwd_bytes = cap * (params + 4 * (1 + 2) + 1
                           + 4 * (2 + 1 + 3 + 3 + 1 + 2 + 2 + 1) + 1)
        bwd_bytes = (cap * (4 * (2 + 1 + 3 + 3) + params + 4 * 2)
                     + int(vis.sum()) * params)
        fwd_bound = 1e3 * fwd_bytes / H100_BYTES_PER_S
        bwd_bound = 1e3 * bwd_bytes / H100_BYTES_PER_S
        print(f"preprocess {label}: backward within 1e-5 of the largest "
              f"entry of autograd on the plain version (max |diff| / max "
              f"|ref|: {errs}), zero on every invisible slot; forward "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms, "
              f"{100 * fwd_bound / fwd_ms:.1f}%; plain {plain_fwd_ms:.2f} "
              f"ms), backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f} ms, "
              f"{100 * bwd_bound / bwd_ms:.1f}%; plain autograd "
              f"{plain_bwd_ms:.2f} ms) on {nvidia_smi()}", flush=True)
        rows.append(dict(scene=label, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                         fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound,
                         plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                         grad_err=errs, float_gaps=gaps))
        del xyz, ls, q, op, dc, rest, alive, off, cot
        torch.cuda.empty_cache()
    return [
        dict(name="P1 preprocess_forward", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/preprocess.cu",
             replaces=None, ms=rows[0]["fwd_ms"],
             plain_ms=rows[0]["plain_fwd_ms"],
             bound_ms=rows[0]["fwd_bound_ms"], bound_by="bytes",
             library_ms=None, by_scene=rows),
        dict(name="P2 preprocess_backward", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/preprocess.cu",
             replaces=None, ms=rows[0]["bwd_ms"],
             plain_ms=rows[0]["plain_bwd_ms"],
             bound_ms=rows[0]["bwd_bound_ms"], bound_by="bytes",
             library_ms=None),
    ]


def main() -> int:
    import torch

    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA device", file=sys.stderr)
        return 1
    from gaussianeditor_tpu_torch.apps.webui import build_state
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import (
        load_ply,
        ply_vertex_count,
        save_ply,
    )
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.render import default_max_instances

    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    secs = _kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})",
          flush=True)
    for name, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the host KNN (native/simple_knn.cpp) that from_points takes: built
    # by g++; the scipy fallback must not be taken here
    from gaussianeditor_tpu_torch import native

    t0 = time.perf_counter()
    assert native.get_lib() is not None, "the native KNN did not build"
    print(f"build: native KNN {time.perf_counter() - t0:.2f} s "
          f"({native.lib_path().name})", flush=True)
    walls = {"1-2": time.perf_counter() - t_start}

    with tempfile.TemporaryDirectory() as tmp:
        # the scene as the viewer loads it: a PLY at 4x capacity
        t0 = time.perf_counter()
        arrays = bench_scene_arrays(N_GAUSSIANS, SEED)
        cpu_scene = GaussianScene.create(
            {k: torch.from_numpy(v) for k, v in arrays.items()},
            max_sh_degree=SH_DEGREE, active_sh_degree=SH_DEGREE)
        ply = os.path.join(tmp, "scene.ply")
        save_ply(cpu_scene, ply)
        del cpu_scene, arrays
        write_workspace(os.path.join(tmp, "colmap"))
        state = build_state(ply, os.path.join(tmp, "colmap"), device="cuda")
        print(f"scene: {N_GAUSSIANS} Gaussians, SH {SH_DEGREE}, capacity "
              f"{state.scene.capacity}, {len(state.cameras)} cameras; "
              f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

        # 3. kernel vs plain at full width
        cam, plain_img, view, kernels = phase_kernels(state.scene, "cuda")

        # 4. the main path through the viewer
        serve_counts = phase_serve(state, cam, plain_img)

        # 5. where one frame's time goes
        phase_profile(state)

        # 6. the backward kernels vs plain at full width
        kernels += phase_backward(view)

        # 8. the dense route's kernels vs plain at full width, on phase
        # 3's view before phase 7 trains the scene
        rows, b4_dense_ms = phase_dense(view, state.scene, cam,
                                        view["budget"])
        kernels += rows
        b4 = next(k for k in kernels if k["name"] == "B4 rank_segment_sum")
        b4["ms_by_route"] = {"sorted": b4["ms"], "dense": b4_dense_ms}
        del view

        # 7. the train path
        extent = state.cameras_extent
        tr = phase_train(state.scene, extent)
        train_counts, thres = tr["counts"], tr["thres"]
        del state   # phase 7's trained scene: phase 9 loads the PLY again

        # 9. the train path through the dense route
        dense_counts = phase_train_dense(tr, ply)
        tr17 = {k: tr[k] for k in ("optim", "cams", "targets", "stats")}
        del tr
        torch.cuda.empty_cache()

        walls["3-9"] = time.perf_counter() - t_start - sum(walls.values())

        # 10. the edit loop, from the PLY loaded again
        ed = phase_edit(ply, thres, extent, tmp)
        b4["ms_by_route"]["tracing"] = ed["b4_tracing_ms"]
        b4["index_add_ms_tracing"] = ed["index_add_ms"]
        walls["10"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 11. the tiled route and click tracing
        ck = phase_click(ply)
        walls["11"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 12. Delete, with phase 10's segmentor
        dl = phase_del(ply, extent, *ed["seg"])
        walls["12"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 13. Add, its refinement and the mesh object
        ad = phase_add(ply, extent)
        b4["ms_by_route"]["add"] = ad["b4_add_ms"]
        walls["13"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 14. reconstruction at full width and the CLI
        rc = phase_recon(ply, os.path.join(tmp, "colmap"), tmp)
        walls["14"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 15. the web UI's editing session over HTTP
        wb = phase_webui(ply, os.path.join(tmp, "colmap"), thres, *ed["seg"],
                         ck["point_radius"], tmp)
        walls["15"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 16. SDS and DDS score guidance
        sc = phase_score(ply, extent)
        walls["16"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

        # 17. multi-device training and the oracle: strips in one process,
        # the view-sharded step at world size 1 (NCCL), two ranks sharing
        # the card under gloo, render(impl="ref")
        scene = load_ply(ply, capacity=4 * ply_vertex_count(ply),
                         device="cuda")
        strips = phase_strips(scene, default_max_instances(scene.capacity))
        del scene
        torch.cuda.empty_cache()
        world1 = phase_world1(ply, tr17)
        torch.cuda.empty_cache()
        gloo = phase_gloo(ply, tr17)
        phase_oracle()
        walls["17"] = time.perf_counter() - t_start - sum(walls.values())
        torch.cuda.empty_cache()

    # 18. the preprocess kernels at the benchmark's two scenes
    kernels += phase_preprocess()
    walls["18"] = time.perf_counter() - t_start - sum(walls.values())

    # launches on each kernel's own path: B1 and B2 serve frames (phase
    # 4), B3 and B4 train (phase 7), B5 and B6 train on the dense route
    # (phase 9); every path's counts are listed, the edit loop's (phase
    # 10), the web UI's (phase 15) and the multi-device parts' (phase 17,
    # each gloo rank's) by part
    names = {"B1 binning_key": ("binning_key", serve_counts),
             "B2 forward_tile": ("forward_tile", serve_counts),
             "B3 backward_tile": ("backward_tile", train_counts),
             "B4 rank_segment_sum": ("rank_segment_sum", train_counts),
             "B5 forward_chunk": ("forward_chunk", dense_counts),
             "B6 backward_chunk": ("backward_chunk", dense_counts),
             "P1 preprocess_forward": ("preprocess_forward", serve_counts),
             "P2 preprocess_backward": ("preprocess_backward", train_counts)}
    for k in kernels:
        key, counts = names[k["name"]]
        k["launches"] = counts[key]
        k["launches_by_path"] = {"serve": serve_counts[key],
                                 "train": train_counts[key],
                                 "train_dense": dense_counts[key],
                                 "edit_origin": ed["origin"][key],
                                 "edit_tracing": ed["tracing"][key],
                                 "edit_steps": ed["steps"][key],
                                 "click": ck["click"][key],
                                 "del_setup": dl["setup"][key],
                                 "del_steps": dl["steps"][key],
                                 "add": ad["add"][key],
                                 "add_refine": ad["add_refine"][key],
                                 "mesh_fit": ad["mesh_fit"][key],
                                 "recon_steps": rc["recon_steps"][key],
                                 "recon_test": rc["recon_test"][key],
                                 "cli_modes": rc["cli_modes"][key],
                                 **{p: wb[p][key] for p in (
                                     "webui_trace", "webui_threshold",
                                     "webui_click", "webui_edit",
                                     "webui_del", "webui_add")},
                                 "score_steps": sc["score_steps"][key],
                                 "strips": strips["counts"][key],
                                 "sharded_world1": world1["counts"][key],
                                 **{f"gloo_{p}_rank{r}":
                                    gloo["ranks"][r][p]["launches"][key]
                                    for p in ("view", "2d", "strip_render")
                                    for r in (0, 1)}}
        if k["name"] in rc["recon_view"]:
            k["recon_view"] = rc["recon_view"][k["name"]]
        if k["name"] in strips["strip_grid"]:
            k["strip_grid"] = strips["strip_grid"][k["name"]]
    print("wall time by phase (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
