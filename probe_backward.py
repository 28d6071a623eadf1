#!/usr/bin/env python3
"""Time the compositor's backward kernels B3 and B6 at full width, and
split an older build of them into walk, reduction and stores.

    python3 probe_backward.py [--old DIR] [--tune] [--out FILE]   # one card

The inputs are those of `chip_smoke.py` phases 6 and 8: the 1,000,000-
Gaussian SH-3 scene (bench.py's recipe, seed 0) loaded from a PLY at 4x
capacity, the 512x512 view of phase 3 and the same seeded cotangents; B6
also on 8- and 32-channel feature renders of the view. It prints the
rows per tile (max, mean, and the longest tile's rows before its largest
n_contrib), then times the package's B3 (ch 3) and B6 (ch 3, 8, 32) with
CUDA events (median of 20 samples).

`--old DIR` names a directory that holds another version of
`backward_tile.cu` and `backward_chunk.cu` with the same C entry points
(for instance the parent commit's, written there with `git show`). Each
is built four ways: as it is; without the per-row warp-shuffle sum and
its stores to shared memory ("noreduce"); without the output stores
("nostore"); without both ("walk"). A removed part is replaced by a
dependence the compiler cannot drop, so the rest of the work stays. The
unchanged old build and the package's kernel are timed in turns (old,
new, new, old), both through the same C call into the same output
buffer, each checked against the other at atol 1e-3 / rtol 1e-2; the
package's wrapper is timed too. `--tune` also builds the package's
kernels the other ways listed in TUNE (other batch sizes and register
budgets; without the products, or without the warps' sums and stores)
and times each in turns against the package's build. Results go to
stdout and, as JSON, to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

KEEP = "1.2345e-30f"   # a value no sum takes: guards the removed stores

# (name, [(old text, new text), ...]) per variant and source; each old
# text must occur exactly once in the source
_TILE_SHUFFLE = """        if (__any_sync(0xffffffffu, on)) {
#pragma unroll
          for (int k = 0; k < G; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < G; ++k) part[i][warp][k] = v[k];
        }"""
_CHUNK_SHUFFLE = """          if (__any_sync(0xffffffffu, on)) {
#pragma unroll
            for (int k = 0; k < GM; ++k) {
              if (k < G) {
#pragma unroll
                for (int s = 16; s > 0; s >>= 1)
                  v[k] += __shfl_down_sync(0xffffffffu, v[k], s);
              }
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < GM; ++k)
              if (k < G) part[i][warp][k] = v[k];
          }"""
_KEEP_DECL = ("  float prefix = 0.0f;\n",
              "  float prefix = 0.0f;\n  float keep = 0.0f;\n")
NOREDUCE = {
    "backward_tile": [
        _KEEP_DECL,
        (_TILE_SHUFFLE, "        (void)on;\n#pragma unroll\n"
                        "        for (int k = 0; k < G; ++k) keep += v[k];"),
        ("    // the next batch overwrites rows and part\n    __syncthreads();\n  }\n}",
         "    // the next batch overwrites rows and part\n    __syncthreads();\n  }\n"
         f"  if (keep == {KEEP}) out[0] = keep;\n}}"),
    ],
    "backward_chunk": [
        _KEEP_DECL,
        (_CHUNK_SHUFFLE, "          (void)on;\n#pragma unroll\n"
                         "          for (int k = 0; k < GM; ++k) keep += v[k];"),
        ("      if (idx % kChunk >= lim) dst[idx] = 0.0f;\n  }\n}",
         "      if (idx % kChunk >= lim) dst[idx] = 0.0f;\n  }\n"
         f"  if (keep == {KEEP}) out[0] = keep;\n}}"),
    ],
}
NOSTORE = {
    "backward_tile": [
        ("for (int k = 0; k < G; ++k) out[(size_t)k * n + r] = 0.0f;",
         f"for (int k = 0; k < G; ++k) if (r == -7) out[(size_t)k * n + r] = 0.0f;"),
        ("        out[(size_t)k * n + rank[base + i]] = s;",
         f"        if (s == {KEEP}) out[(size_t)k * n + rank[base + i]] = s;"),
        ("        out[(size_t)k * n + rank[base + i]] = 0.0f;",
         "        if (t < 0) out[(size_t)k * n + rank[base + i]] = 0.0f;"),
    ],
    "backward_chunk": [
        ("      out[i] = 0.0f;", "      if (stride == 0) out[i] = 0.0f;"),
        ("          dst[(size_t)k * kChunk + base + i] = s;",
         f"          if (s == {KEEP}) dst[(size_t)k * kChunk + base + i] = s;"),
        ("      if (idx % kChunk >= lim) dst[idx] = 0.0f;",
         "      if (idx % kChunk >= lim && t < 0) dst[idx] = 0.0f;"),
    ],
}


def variant(src: str, name: str, which: str) -> str:
    edits = {"old": [], "noreduce": NOREDUCE[name], "nostore": NOSTORE[name],
             "walk": NOREDUCE[name] + NOSTORE[name]}[which]
    for a, b in edits:
        assert src.count(a) == 1, f"{name} {which}: {a[:60]!r} found " \
                                  f"{src.count(a)} times"
        src = src.replace(a, b)
    return src


# Other builds of the package's B3 and B6, timed against the package's:
# (name, rows a batch, blocks per SM the registers are set for, parts of
# composite_backward.cuh left out: "products" the tensor-core products,
# "finish" the warps' sums, the epilogue and the stores)
TUNE = (
    ("r16_b3", 16, 3, ()),
    ("r16_b4", 16, 4, ()),
    ("r64_b1", 64, 1, ()),
    ("no_products", 32, 2, ("products",)),
    ("no_finish", 32, 2, ("finish",)),
    ("walk_only", 32, 2, ("products", "finish")),
)
_SKIP = {
    "products": ("const float* gw,\n                                              int lane) {\n",
                 "const float* gw,\n                                              int lane) {\n  return;\n"),
    "finish": ("  double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};\n",
               "  return;\n  double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};\n"),
}


def build_libs(jobs: dict, out_dir: Path) -> dict:
    """{key: ctypes function} for jobs {key: (kernel name, {file name:
    text})}: each job's files are written to their own directory under
    `out_dir` and its `<kernel name>.cu` compiled, all in parallel, with
    the package's nvcc flags; the compiler's register and spill lines
    are printed."""
    from gaussianeditor_tpu_torch.ops import _kernels

    procs = {}
    for key, (name, files) in jobs.items():
        d = out_dir / "_".join(key)
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        lib = d / f"lib{name}.so"
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / f"{name}.cu")]
        procs[key] = (name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (name, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {' '.join(key)}: {line.strip()}")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = list(_kernels.SIGNATURES[name])
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def old_jobs(old_dir: Path) -> dict:
    """The four builds of each old source (see `variant`)."""
    return {(name, which): (name, {f"{name}.cu": variant(
                (old_dir / f"{name}.cu").read_text(), name, which)})
            for name in ("backward_tile", "backward_chunk")
            for which in ("old", "noreduce", "nostore", "walk")}


def tune_jobs() -> dict:
    """The TUNE builds of the package's B3 and B6, from edited copies of
    composite_backward.cuh."""
    from gaussianeditor_tpu_torch.ops import _kernels

    csrc = _kernels.CSRC_DIR
    jobs = {}
    for var, rows, blocks, skip in TUNE:
        header = (csrc / "composite_backward.cuh").read_text()
        edits = [("constexpr int kRows = 32;",
                  f"constexpr int kRows = {rows};"),
                 ("constexpr int kMinBlocks = 2;",
                  f"constexpr int kMinBlocks = {blocks};")]
        for a, b in edits + [_SKIP[part] for part in skip]:
            assert header.count(a) == 1, (var, a)
            header = header.replace(a, b)
        for name in ("backward_tile", "backward_chunk"):
            jobs[(var, name)] = (name, {
                f"{name}.cu": (csrc / f"{name}.cu").read_text(),
                "composite_backward.cuh": header})
    return jobs


def call(fn, *args) -> None:
    import torch

    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    code = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"launch failed with {code}"


def new_fn(name: str):
    """The package's build of kernel `name`, as a ctypes function."""
    from gaussianeditor_tpu_torch.ops import _kernels

    return getattr(_kernels._load(name), name)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--tune", action="store_true",
                    help="also time the TUNE builds (B3 at ch 3, B6 at ch 3 "
                         "and 8)")
    ap.add_argument("--out", type=Path,
                    default=Path("build/probe_backward.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_backward: needs a CUDA device", file=sys.stderr)
        return 1
    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import load_ply, save_ply
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
    from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
    from gaussianeditor_tpu_torch.ops.dense_composite import (
        backward_chunks,
        forward_chunks,
        pack_instances,
        tile_chunk_bounds,
    )
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        backward_tiles,
        forward_tiles,
    )

    smi = cs.nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    result = {"device": smi}
    _kernels.build()
    for name in ("backward_tile", "backward_chunk"):
        for line in _kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} new: {line.strip()}")
    jobs = {}
    if args.old:
        jobs.update(old_jobs(args.old))
    if args.tune:
        jobs.update(tune_jobs())
    built = build_libs(jobs, Path("build/probe"))
    fns = built if args.old else {}
    alt = built if args.tune else {}

    with tempfile.TemporaryDirectory() as tmp:
        arrays = cs.bench_scene_arrays(cs.N_GAUSSIANS, cs.SEED)
        cpu_scene = GaussianScene.create(
            {k: torch.from_numpy(v) for k, v in arrays.items()},
            max_sh_degree=cs.SH_DEGREE, active_sh_degree=cs.SH_DEGREE)
        ply = os.path.join(tmp, "scene.ply")
        save_ply(cpu_scene, ply)
        del cpu_scene, arrays
        scene = load_ply(ply, capacity=4 * cs.N_GAUSSIANS, device="cuda")
    cam = lookat_camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, 0.8, cs.SIZE, cs.SIZE, device="cuda")
    gx = cs.SIZE // 16
    T = gx * gx
    budget = default_max_instances(scene.capacity)
    C = scene.capacity

    def turns(label, new_fn, old_fn, wrapper):
        """old, new, new, old, both through the same raw C call into the
        same output buffer; returns the times, the wrapper's time and the
        largest difference."""
        got = new_fn().clone()
        want = old_fn() if old_fn else None
        torch.cuda.synchronize()
        rec = {"wrapper_ms": cs.time_ms(wrapper)}
        if want is not None:
            err = (got - want).abs()
            ok = bool((err <= 1e-3 + 1e-2 * want.abs()).all())
            rec["max_abs_err_new_vs_old"] = float(err.max())
            rec["within_tol"] = ok
            old1 = cs.time_ms(old_fn)
        new1 = cs.time_ms(new_fn)
        new2 = cs.time_ms(new_fn)
        rec["new_ms"] = [new1, new2]
        if want is not None:
            old2 = cs.time_ms(old_fn)
            rec["old_ms"] = [old1, old2]
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in rec.items()),
              flush=True)
        return rec

    def alt_times(label, fn, base_fn, mk_args):
        """another build against the package's, in turns (package, other,
        other, package), and their largest difference"""
        call(base_fn, *mk_args())
        want = mk_args()[-1].clone()
        call(fn, *mk_args())
        torch.cuda.synchronize()
        err = float((mk_args()[-1] - want).abs().max())
        ts = [cs.time_ms(lambda: call(f, *mk_args()))
              for f in (base_fn, fn, fn, base_fn)]
        print(f"{label}: package {ts[0]:.4f} / {ts[3]:.4f} ms, this "
              f"{ts[1]:.4f} / {ts[2]:.4f} ms, max abs difference {err:.3g}",
              flush=True)
        return dict(package_ms=[ts[0], ts[3]], ms=ts[1:3], max_abs_diff=err)

    def variants(label, name, mk_args):
        rec = {}
        for which in ("old", "noreduce", "nostore", "walk"):
            fn = fns[(name, which)]
            rec[which] = cs.time_ms(lambda: call(fn, *mk_args()))
        print(f"{label} split of the old kernel (ms): {rec}", flush=True)
        return rec

    # --- B3, phase 6's inputs ---
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
        sb = sorted_bin(proc, gx, gx, budget)
        tiles = forward_tiles(sb, gx, 3)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    g_color = torch.randn((T, 256, 3), generator=gen, device="cuda")
    g_depth = 0.1 * torch.randn((T, 256), generator=gen, device="cuda")
    g_T = 0.05 * torch.randn((T, 256), generator=gen, device="cuda")
    n = sb.payload.shape[1]
    result["b3_rows"] = cs.row_stats(sb.tile_bounds, tiles.n_contrib,
                                  "sorted route")
    b3_args = (sb.tile_bounds, sb.payload, sb.rank, tiles, g_color, g_depth,
               g_T, gx, 3)
    out3 = torch.empty((10, n), device="cuda")

    def old_b3_args():
        return (sb.tile_bounds, sb.payload, sb.rank, n, T, gx, 3, g_color,
                g_depth, g_T, tiles.color, tiles.depth, tiles.final_T,
                tiles.n_contrib, out3)

    def old_b3():
        call(fns[("backward_tile", "old")], *old_b3_args())
        return out3

    def new_b3():
        out3.zero_()    # as the wrapper does: the kernel skips zero rows
        call(new_fn("backward_tile"), *old_b3_args())
        return out3

    result["b3"] = turns("B3 ch 3", new_b3, old_b3 if fns else None,
                         lambda: backward_tiles(*b3_args))
    if fns:
        result["b3_split"] = variants("B3 ch 3", "backward_tile", old_b3_args)
    for var, *_ in (TUNE if alt else ()):
        result[f"b3_{var}"] = alt_times(
            f"B3 ch 3, {var}", alt[(var, "backward_tile")],
            new_fn("backward_tile"), old_b3_args)
    del sb, out3

    # --- B6, phase 8's inputs, and a 32-channel feature render ---
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    feat8 = torch.rand((C, cs.FEATURE_CH), generator=gen, device="cuda")
    feat32 = torch.rand((C, 32), generator=gen, device="cuda")
    for ch, oc in ((3, None), (cs.FEATURE_CH, feat8), (32, feat32)):
        with torch.no_grad():
            p = proc if oc is None else preprocess_scene(scene, cam,
                                                         override_color=oc)
            db = dense_bin(p, gx, gx, budget)
            inst = pack_instances(p.mean2d, p.conic, p.opacity, p.color,
                                  p.depth, db)
            tk = forward_chunks(inst, db, gx)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3 + ch)
        cot = (torch.randn((T, 256, ch), generator=g, device="cuda"),
               0.1 * torch.randn((T, 256), generator=g, device="cuda"),
               0.05 * torch.randn((T, 256), generator=g, device="cuda"))
        NC = inst.shape[0]
        bounds = tile_chunk_bounds(db)
        if ch == 3:
            result["b6_rows"] = cs.row_stats(bounds, tk.n_contrib,
                                          "dense route (chunks)", per=128)
        out6 = torch.empty_like(inst)

        def old_b6_args():
            return (bounds, db.chunk_nvalid, db.chunk_offset, inst, NC, T, gx,
                    ch, *cot, tk.color, tk.depth, tk.final_T, tk.n_contrib,
                    out6)

        def old_b6():
            call(fns[("backward_chunk", "old")], *old_b6_args())
            return out6

        def new_b6():
            call(new_fn("backward_chunk"), *old_b6_args())
            return out6

        bargs = (inst, db, tk) + cot + (gx,)
        result[f"b6_ch{ch}"] = turns(f"B6 ch {ch}", new_b6,
                                     old_b6 if fns else None,
                                     lambda: backward_chunks(*bargs))
        if fns and ch != 32:
            result[f"b6_ch{ch}_split"] = variants(f"B6 ch {ch}",
                                                  "backward_chunk",
                                                  old_b6_args)
        for var, *_ in (TUNE if alt and ch != 32 else ()):
            result[f"b6_ch{ch}_{var}"] = alt_times(
                f"B6 ch {ch}, {var}", alt[(var, "backward_chunk")],
                new_fn("backward_chunk"), old_b6_args)
        del db, inst, tk, out6, cot
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"probe_backward: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
