#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gaussianeditor_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure exits non-zero:
  1. device: a CUDA device is present; its name and power limit.
  2. build: nvcc compiles every kernel of the render path from csrc/.
  3. kernel vs plain, at full width: a 1,000,000-Gaussian SH-degree-3
     scene (bench.py's recipe, seed 0) written to a PLY and loaded the way
     the viewer loads it, at 4x capacity; one 512x512 view, rendered both
     ways a served frame renders it: the color view (ch = 3) and the
     overlay's mask view (ch = 1). Kernel B1's keys and sort order must
     equal its plain version's bit for bit; kernel B2's images must meet
     the JAX suite's image bounds and its n_contrib must agree on >= 99.9%
     of pixels. Each kernel is timed with CUDA events (median of 20
     samples), beside its plain version on the color view (3 samples for
     B2's, which takes seconds a call).
  4. the main path: the viewer's state is built as its `main` builds it
     (the PLY plus a synthetic COLMAP workspace) and served over HTTP;
     GET /render answers two orbit views, one client pose, one overlay
     frame and a sweep of 16 orbit views at 512x512, one request at a
     time. The launch counts, zeroed just before, must show both kernels,
     and the pose frame must match the plain render of the same view.
  5. one warm frame under torch.profiler: device time by kernel and the
     device's idle share.
Then it prints the kernels' JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

N_GAUSSIANS = 1_000_000
SH_DEGREE = 3
SIZE = 512
SEED = 0
RUNS = 20
SWEEP = 16                   # extra orbit frames served after the 4 named ones
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12      # FP32 outside the tensor cores, same sheet
B2_OPS_EVALUATED = 19        # f32 ops (one exp counted as 1) per evaluated pair
B2_OPS_CONTRIB_BASE = 1      # + per contributing pair: w = alpha*T, then a
                             # multiply-add (2) per channel and for depth


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


def check_kernels(proc, gx: int, gy: int, budget: int, label: str,
                  time_plain: bool) -> dict:
    """B1 and B2 on one view's preprocessed inputs, each against its plain
    version; returns their errors, times and bounds, and B2's plain tiles.
    The plain versions are timed only when `time_plain` is set."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        binning_key,
        binning_key_plain,
        key_depth_bits,
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
    n = min(total, -(-budget // 128) * 128)
    kdb = key_depth_bits(T)
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
    assert torch.equal(key_k, key_p), f"B1 {label}: keys differ from plain"
    assert torch.equal(pay_k, pay_p), f"B1 {label}: payload differs"
    rank_k = torch.sort(key_k, stable=True)[1]
    rank_p = torch.sort(key_p, stable=True)[1]
    assert torch.equal(rank_k, rank_p), f"B1 {label}: sort order differs"
    out["b1_err"] = float((key_k - key_p).abs().max())
    out["b1_ms"] = time_ms(b1)
    out["b1_plain_ms"] = time_ms(b1_plain) if time_plain else None
    n_vis = int((proc.tiles_touched > 0).sum())
    # bytes: b_incl once, each visible Gaussian's row (tiles_touched,
    # rect min/max, mean2d, conic, opacity, depth, color), the int64 keys
    # and the payload written
    b1_bytes = 4 * C + n_vis * 4 * (1 + 4 + 2 + 3 + 1 + 1 + ch) + n * (8 + 4 * P)
    out["b1_bound"] = 1e3 * b1_bytes / H100_BYTES_PER_S
    print(f"B1 binning_key, {label} (ch {ch}): n={n} (num_rendered {total}, "
          f"budget {budget}), visible {n_vis}/{C}; keys, payload and sort "
          f"order bitwise equal; kernel {out['b1_ms']:.4f} ms, plain "
          f"{out['b1_plain_ms'] or float('nan'):.4f} ms, bound "
          f"{out['b1_bound']:.4f} ms (bytes)", flush=True)

    # --- B2 ---
    with torch.no_grad():
        sb = sorted_bin(proc, gx, gy, budget)
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
    assert nc_eq >= 0.999, f"B2 {label}: n_contrib equal on only {nc_eq:.5f}"
    out["b2_err"] = max(float((tk.color - tp.color).abs().max()),
                        float((tk.depth - tp.depth).abs().max()),
                        float((tk.final_T - tp.final_T).abs().max()))
    out["b2_ms"] = time_ms(lambda: forward_tiles(sb, gx, ch))
    # the plain version takes seconds per call: a few samples suffice
    out["b2_plain_ms"] = time_ms(lambda: forward_tiles_plain(
        sb.tile_bounds, sb.payload, gx, ch), runs=3) if time_plain else None
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
    return out


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
    main = check_kernels(color_proc, gx, gy, budget, "color view", True)
    overlay = check_kernels(mask_proc, gx, gy, budget, "overlay mask view",
                            False)
    assert main["ch"] == 3 and overlay["ch"] == 1

    plain_img = torch.clamp(
        tiles_to_image(main["plain_tiles"].color, gx, gy, SIZE, SIZE), 0.0, 1.0)
    return cam, plain_img.cpu().numpy(), [
        dict(name="B1 binning_key", route="cuda",
             source="gaussianeditor_tpu_torch/csrc/binning_key.cu",
             replaces="gaussianeditor_tpu/ops/binning_sorted.py:150",
             max_abs_err=max(main["b1_err"], overlay["b1_err"]),
             ms=main["b1_ms"], plain_ms=main["b1_plain_ms"],
             bound_ms=main["b1_bound"], bound_by="bytes", library_ms=None),
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


def phase_profile(state) -> None:
    """Phase 5: where one frame's time goes. A warm `render_frame` of the
    phase-3 view under torch.profiler: device time by kernel and the
    device's busy share of the frame's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def frame():
        return state.render_frame(0.0, 0.0, 0.0, SIZE, False,
                                  pose=view_pose(), fovx=0.8, fovy=0.8)

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
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
    print(f"profile of one warm frame (render + PNG): wall {wall_ms:.2f} ms, "
          f"device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - dev_ms / wall_ms):.1f}%", flush=True)
    for title, rows in (("by host op", ops), ("by kernel", kernels)):
        print(f" device time {title}:")
        for ms, count, key in sorted(rows, reverse=True)[:10]:
            print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")

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


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA device", file=sys.stderr)
        return 1
    from gaussianeditor_tpu_torch.apps.webui import build_state
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import save_ply
    from gaussianeditor_tpu_torch.ops import _kernels

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
        cam, plain_img, kernels = phase_kernels(state.scene, "cuda")

        # 4. the main path through the viewer
        counts = phase_serve(state, cam, plain_img)

        # 5. where one frame's time goes
        phase_profile(state)

    names = {"B1 binning_key": "binning_key", "B2 forward_tile": "forward_tile"}
    for k in kernels:
        k["launches"] = counts[names[k["name"]]]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
