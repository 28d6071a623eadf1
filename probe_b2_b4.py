#!/usr/bin/env python3
"""Time kernels B4 (the per-Gaussian gradient sum) and B2 (the forward
tile compositor), or B5 (the forward chunk compositor) and B2, at full
width against another build of them, split that build's time into its
parts, and time the rank-major store layout of B3.

    python3 probe_b2_b4.py --old DIR [--layout] [--out FILE]              # one card
    python3 probe_b2_b4.py --b5 --old DIR [--old-only] [--tune] [--out FILE]

The inputs are those of `chip_smoke.py` phases 3 and 6: the 1,000,000-
Gaussian SH-3 scene (bench.py's recipe, seed 0) loaded from a PLY at 4x
capacity, phase 3's 512x512 view (the color view, ch 3, and the
overlay's mask view, ch 1) and phase 6's seeded cotangent, through the
package's B3 to give B4's rows.

`DIR` holds another version of `rank_segment_sum.cu` and `forward_tile.cu`
(for instance the parent commit's, written there with `git show`; the
copy on the card's machine is not a git repository), with the parent's
C entry points. Each is compiled with the package's nvcc flags (as is
every build here, all in parallel), in several builds:
  B4: as it is; with its output stores replaced by a dependence the
      compiler keeps ("nostore"); with every slot treated as dead, so
      that it only writes ("dead"); beside a plain cudaMemsetAsync of the
      [C, GF] output (the write floor) and torch.segment_reduce timed as
      chip_smoke.py times it.
  B2: as it is, over all tiles; over only the longest tile (a one-block
      grid: the latency floor of the tail); over all tiles with each
      tile's rows cut to the mean walk ("capped": the issue-rate share);
      with expf replaced by __expf ("fastexp"); with the rows read
      straight from global memory instead of staged ("nostage").
It prints the tiles_touched histogram of the live slots, each tile's
walk (the rows until its last pixel is done), the compilers' registers
and spills, the instructions of B2's per-pair loop (cuobjdump -sass of
the ch-3 instance), and the SM clock right after B2 runs (clock64 over
the global timer on every SM, and nvidia-smi's clocks). The unchanged
old build and the package's kernel are timed in turns (old, new, new,
old) through their raw C calls with CUDA events (median of 20 samples,
`chip_smoke.time_ms`), and their outputs must be bitwise equal: B4 on
phase 6's rows and on the dense route's (B6's rows gathered into rank
order by `rows_by_rank`); B2 on both views and on
`testing.adversarial_rows` at ch 1, 2 and 3. On the dense route, the
gather followed by the package's B4 is also timed in turns against a
build of the package's B4 that reads B6's rows in place through
`a_by_rank` ("indexed", no gathered copy), and their sums must be
bitwise equal.

`--layout` builds B3 with an epilogue that writes rank-major rows [n,
GFp] (GF padded to a multiple of 4) and a build of the package's B4
that reads them, and times the pair (zero fill, B3, B4) in turns
against the package's pair over [GF, n]; their sums must be bitwise
equal.

`--b5`: DIR holds another version of `forward_chunk.cu` and
`forward_tile.cu` instead (say the parent commit's), with the parent's C
entry points. On the inputs of `chip_smoke.py` phase 8 (the color view,
ch 3, and the seeded feature renders at ch 8 and 32, `dense_bin` at the
default budget; the walk and the longest tile from the color view) the
old B5 is built as it is, over only its longest tile (a one-block grid),
with each tile's walk cut to the mean walk ("capped") and with `__expf`,
and each build timed at every width; the package's B5 over its longest
tile and capped likewise. It prints the registers, spills and static
shared memory of every instance, the per-pair loop of both ch-3
instances (SASS) and the SM clock after each. The old B5 and the
package's are timed in turns at each width and must be bitwise equal
there and on `testing.adversarial_rows` (laid into chunks by
`testing.dense_from_rows`) at ch 1, 3, 8 and 32; the package's B5 must
be bitwise equal to the package's B2 on the adversarial rows at ch 1 and
3 and on the color view. DIR's B2 is the guard of the shared walk: the
package's B2 must be bitwise equal to it on phase 3's two views and on
the adversarial rows at ch 1-3, and is timed against it in turns.
`--old-only` stops after the old B5's builds are measured (the package's
kernels are neither built nor run). `--tune` also builds the package's B5
with the other group sizes in B5_TUNE and times each in turns against
the package's build, checking that the outputs are bitwise equal.
Results go to stdout and, as JSON, to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs
import probe_backward as pb

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# B4's C entry point: rows, b_incl, tiles_touched, gf, n, C, out, stream
B4_SIG = (_P, _P, _P, _I, _L, _I, _P, _P)
WRITE_FLOOR = """#include <cuda_runtime.h>
extern "C" int write_floor(void* out, long long bytes, void* stream) {
  return (int)cudaMemsetAsync(out, 0, (size_t)bytes, (cudaStream_t)stream);
}
"""
# the SM clock under load: each block spins `cycles` SM cycles and records
# them beside the global timer's nanoseconds
SM_CLOCK = r"""#include <cuda_runtime.h>
__global__ void spin(long long cycles, long long* out) {
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  long long c1 = c0;
  while (c1 - c0 < cycles) c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = c1 - c0;
    out[2 * blockIdx.x + 1] = (long long)(t1 - t0);
  }
}
extern "C" int sm_clock(long long cycles, int blocks, void* out,
                        void* stream) {
  spin<<<blocks, 256, 0, (cudaStream_t)stream>>>(cycles, (long long*)out);
  return (int)cudaGetLastError();
}
"""

# the parent's B4 (csrc/rank_segment_sum.cu) in its builds
B4_EDITS = {
    "old": [],
    "nostore": [
        ("  float* o = out + (size_t)g * gf;\n",
         "  float* o = out + (size_t)g * gf;\n  double keep = 0.0;\n"),
        ("    o[f] = (float)s;\n  }\n}",
         f"    keep += s;\n  }}\n  if (keep == {pb.KEEP[:-1]}) "
         "o[0] = (float)keep;\n}"),
    ],
    "dead": [
        ("  const long long hi = min((long long)b_incl[g], n);\n"
         "  const long long lo = min((long long)b_incl[g] - tiles_touched[g], n);\n",
         "  const long long hi = 0, lo = 0;\n"),
    ],
}
# the parent's B2 (csrc/forward_tile.cu) in its builds; {tile0} and {cap}
# are filled in from the scene
_STAGE = """    const int r = base + p;
    if (r < end) {
#pragma unroll
      for (int f = 0; f < P; ++f) rows[f][p] = payload[(size_t)f * n + r];
    }
"""
B2_EDITS = {
    "old": [],
    "longest": [("  const int t = blockIdx.x;\n",
                 "  const int t = blockIdx.x + {tile0};\n")],
    "capped": [("  const int end = bounds[t + 1];\n",
                "  const int end = min(bounds[t + 1], bounds[t] + {cap});\n")],
    "fastexp": [("expf(power)", "__expf(power)")],
    "nostage": [(_STAGE, ""),
                ("  __shared__ float rows[P][kPx];\n", ""),
                # every other `rows[f][i]` reads the payload itself
                ("rows[", "ROWP("), ("][i]", ")[i]"),
                ("namespace {\n",
                 "#define ROWP(f) (payload + (size_t)(f) * n + base)\n"
                 "namespace {\n")],
}
_REPLACE_ALL = ("rows[", "][i]")


def edit(src: str, edits, label: str, **fill) -> str:
    for a, b in edits:
        if a not in _REPLACE_ALL:
            assert src.count(a) == 1, f"{label}: {a[:60]!r} found " \
                                      f"{src.count(a)} times"
        for k, v in fill.items():
            b = b.replace("{" + k + "}", str(v))
        src = src.replace(a, b)
    return src


def build(jobs: dict, out_dir: Path) -> dict:
    """{key: (ctypes function, library path)} for jobs {key: (symbol,
    argtypes, {file name: text})}: each job's files are written to their
    own directory and its first file compiled with the package's nvcc
    flags, all in parallel; prints the registers and spills."""
    from gaussianeditor_tpu_torch.ops import _kernels

    procs = {}
    for key, (symbol, argtypes, files) in jobs.items():
        d = out_dir / "_".join(key)
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        lib = d / f"lib{symbol}.so"
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / next(iter(files)))]
        procs[key] = (symbol, argtypes, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (symbol, argtypes, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        print_resources(" ".join(key), log)
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        out[key] = (fn, lib)
    return out


def print_resources(label: str, log: str) -> None:
    inst = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"ILi(\d+)E", m.group(1))
            inst = f"<{k.group(1)}>" if k else ""
        elif "registers" in line or "spill" in line:
            print(f"  {label}{inst}: {line.split(':', 1)[-1].strip()}")


def sass_loop(lib: Path, kernel: str) -> dict:
    """The innermost loop around the first MUFU.EX2 of `kernel` (a
    substring of its mangled name) in `cuobjdump -sass` of `lib`: its
    instructions, exps, shared loads and branches, and the instructions
    per exp (per pair). Empty if it cannot be found."""
    from gaussianeditor_tpu_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).with_name("cuobjdump")
    try:
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"  cuobjdump failed: {e}")
        return {}
    ins, labels, inside = [], {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    addr_at = {a: i for i, (a, _) in enumerate(ins)}
    ex2 = [i for i, (_, s) in enumerate(ins) if "MUFU.EX2" in s]
    if not ex2:
        return {}
    best = None
    for i, (_, s) in enumerate(ins):
        if not re.search(r"\bBRA\b", s):
            continue
        m = re.search(r"\(?(\.L_x_\d+)\)?", s)
        tgt = labels.get(m.group(1)) if m else None
        if tgt is None:
            m = re.search(r"0x([0-9a-f]+)", s)
            tgt = addr_at.get(int(m.group(1), 16)) if m else None
        if tgt is not None and tgt <= ex2[0] <= i:
            if best is None or i - tgt < best[1] - best[0]:
                best = (tgt, i)
    if best is None:
        return {}
    body = [s for _, s in ins[best[0]:best[1] + 1]]
    n_ex2 = sum("MUFU.EX2" in s for s in body)
    return dict(instructions=len(body), exps=n_ex2,
                before_first_exp=next(k for k, x in enumerate(body)
                                      if "MUFU.EX2" in x),
                shared_loads=sum(bool(re.search(r"\bLDS\b", s)) for s in body),
                branches=sum(bool(re.search(r"\bBRA\b", s)) for s in body),
                per_pair=len(body) / max(n_ex2, 1))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--layout", action="store_true",
                    help="also time B3 and B4 over rank-major rows")
    ap.add_argument("--b5", action="store_true",
                    help="measure DIR's B5 and B2 against the package's")
    ap.add_argument("--old-only", action="store_true",
                    help="with --b5: measure DIR's B5 builds only")
    ap.add_argument("--tune", action="store_true",
                    help="with --b5: also time the B5_TUNE builds")
    ap.add_argument("--out", type=Path, default=Path("build/probe_b2_b4.json"))
    args = ap.parse_args()
    if (args.old_only or args.tune) and not args.b5:
        ap.error("--old-only and --tune go with --b5")
    if not torch.cuda.is_available():
        print("probe_b2_b4: needs a CUDA device", file=sys.stderr)
        return 1
    if args.b5:
        return main_b5(args)
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
    from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
    from gaussianeditor_tpu_torch.ops.dense_composite import (
        backward_chunks,
        forward_chunks,
        pack_instances,
        rows_by_rank,
    )
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )
    from gaussianeditor_tpu_torch.ops.tile_composite import (
        backward_tiles,
        forward_tiles,
        forward_tiles_plain,
    )

    smi = cs.nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    result = {"device": smi}
    _kernels.build()
    for name in ("forward_tile", "rank_segment_sum"):
        print_resources(f"{name} new", _kernels.BUILD_LOG.get(name, ""))
    work = Path("build/probe_b2_b4")
    old_b4 = (args.old / "rank_segment_sum.cu").read_text()
    old_b2 = (args.old / "forward_tile.cu").read_text()
    jobs = {("b4", v): ("rank_segment_sum", B4_SIG,
                        {"rank_segment_sum.cu": edit(old_b4, e, f"B4 {v}")})
            for v, e in B4_EDITS.items()}
    jobs[("floor",)] = ("write_floor", (_P, _L, _P),
                        {"write_floor.cu": WRITE_FLOOR})
    jobs[("clock",)] = ("sm_clock", (_L, _I, _P, _P),
                        {"sm_clock.cu": SM_CLOCK})
    jobs.update(b4_read_jobs())
    if args.layout:
        jobs.update(layout_jobs())
    libs = build(jobs, work)

    scene, cam = phase3_scene()
    gx = cs.SIZE // 16
    T = gx * gx
    budget = default_max_instances(scene.capacity)
    C = scene.capacity
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
        mask_proc = preprocess_scene(
            scene, cam, override_color=scene.mask[:, None].to(torch.float32))
        sb = sorted_bin(proc, gx, gx, budget)
        sb1 = sorted_bin(mask_proc, gx, gx, budget)
    n = sb.payload.shape[1]
    tt = proc.tiles_touched

    # ---------------- B4 ----------------
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    g_color = torch.randn((T, 256, 3), generator=gen, device="cuda")
    g_depth = 0.1 * torch.randn((T, 256), generator=gen, device="cuda")
    g_T = 0.05 * torch.randn((T, 256), generator=gen, device="cuda")
    with torch.no_grad():
        tiles = forward_tiles(sb, gx, 3)
    b3_args = (sb.tile_bounds, sb.payload, sb.rank, tiles, g_color, g_depth,
               g_T, gx, 3)
    rows = backward_tiles(*b3_args)
    GF = rows.shape[0]
    live = tt[tt > 0].float()
    hist = dict(n=n, C=C, GF=GF, live_slots=int(live.numel()),
                tt_max=int(live.max()),
                tt_p99=float(torch.quantile(live, 0.99)),
                tt_mean=float(live.mean()),
                tt_over={k: int((live > k).sum()) for k in (16, 64, 256, 512)},
                ranks_in_segments_over_256=int(live[live > 256].sum()))
    print(f"B4 inputs: n={n} ranks, C={C} slots, GF={GF}, live slots "
          f"{hist['live_slots']}; tiles_touched over live slots: max "
          f"{hist['tt_max']}, p99 {hist['tt_p99']:.1f}, mean "
          f"{hist['tt_mean']:.3f}; slots over 16/64/256/512 tiles "
          f"{hist['tt_over']}; ranks in segments over 256 "
          f"{hist['ranks_in_segments_over_256']}", flush=True)
    result["b4_inputs"] = hist
    out_old = torch.empty((C, GF), device="cuda")
    out_new = torch.empty((C, GF), device="cuda")
    b_incl = sb.b_incl

    def b4_variant(v):
        fn = libs[("b4", v)][0]
        return lambda: pb.call(fn, rows, b_incl, tt, GF, n, C, out_old)

    def b4_new():
        _new_b4(rows, b_incl, tt, C, out_new)

    b4_variant("old")()
    b4_new()
    torch.cuda.synchronize()
    eq = torch.equal(out_old, out_new)
    print(f"B4 new vs old on phase 6's rows: bitwise equal {eq}", flush=True)
    rec = dict(bitwise_equal=eq)
    rec["turns"] = in_turns("B4 whole", b4_variant("old"), b4_new)
    floor = libs[("floor",)][0]
    rec["split_ms"] = {v: cs.time_ms(b4_variant(v)) for v in B4_EDITS}
    rec["split_ms"]["memset"] = cs.time_ms(
        lambda: pb.call(floor, out_old, out_old.numel() * 4))
    lengths = (torch.clamp(b_incl.long(), max=n)
               - torch.clamp(b_incl.long() - tt.long(), max=n))
    rows_t = rows.T.contiguous()
    rec["split_ms"]["segment_reduce"] = cs.time_ms(
        lambda: torch.segment_reduce(rows_t, "sum", lengths=lengths, axis=0))
    b4_bytes = 4 * GF * n + 8 * C + 4 * GF * C
    rec["bound_ms"] = 1e3 * b4_bytes / cs.H100_BYTES_PER_S
    print(f"B4 split of the old kernel (ms): {rec['split_ms']}; bound "
          f"{rec['bound_ms']:.4f} ms ({b4_bytes} B)", flush=True)
    result["b4"] = rec
    del rows_t

    # the dense route: B6's aligned rows gathered into rank order
    # (rows_by_rank), then B4; against B4 reading B6's rows in place
    # through a_by_rank ("indexed", a build of the package's B4)
    with torch.no_grad():
        db = dense_bin(proc, gx, gx, budget)
        inst = pack_instances(proc.mean2d, proc.conic, proc.opacity,
                              proc.color, proc.depth, db)
        tk = forward_chunks(inst, db, gx)
    grows = backward_chunks(inst, db, tk, g_color, g_depth, g_T, gx)
    gathered = rows_by_rank(grows, db.a_by_rank)
    rd = gathered.shape[1]
    out_idx = torch.empty((C, GF), device="cuda")

    def b4_dense_old():
        pb.call(libs[("b4", "old")][0], gathered, db.b_incl, tt, GF, rd, C,
                out_old)

    def b4_dense_new():
        _new_b4(gathered, db.b_incl, tt, C, out_new)

    def gather_b4_new():
        _new_b4(rows_by_rank(grows, db.a_by_rank), db.b_incl, tt, C, out_new)

    def b4_indexed():
        pb.call(libs[("b4x", "indexed")][0], grows, db.a_by_rank, db.b_incl,
                tt, GF, rd, C, out_idx)

    b4_dense_old()
    b4_dense_new()
    b4_indexed()
    torch.cuda.synchronize()
    eq = torch.equal(out_old, out_new)
    eq_idx = torch.equal(out_idx, out_new)
    print(f"B4 dense route, over B6's gathered rows: new vs old bitwise equal "
          f"{eq}; B4 reading B6's rows through a_by_rank bitwise equal "
          f"{eq_idx}", flush=True)
    result["b4_dense"] = dict(
        bitwise_equal=eq, indexed_bitwise_equal=eq_idx,
        turns=in_turns("B4 dense route, over B6's gathered rows",
                       b4_dense_old, b4_dense_new),
        gather_then_b4_vs_indexed=in_turns(
            "B4 dense route, gather + new B4 (old) vs B4 reading B6's rows "
            "through a_by_rank (new)", gather_b4_new, b4_indexed),
        gather_ms=cs.time_ms(lambda: rows_by_rank(grows, db.a_by_rank)))
    print(f"  the gather (rows_by_rank): "
          f"{result['b4_dense']['gather_ms']:.4f} ms", flush=True)
    del db, inst, tk, grows, gathered, out_idx

    if args.layout:
        result["layout"] = time_layout(libs, b3_args, rows, b_incl, tt, C,
                                       in_turns)
    del rows, out_old, out_new

    # ---------------- B2 ----------------
    _, evaluated, contributed = forward_tiles_plain(sb.tile_bounds,
                                                    sb.payload, gx, 3)
    walk = evaluated.max(dim=1).values            # rows until the tile is done
    cnt = (sb.tile_bounds[1:] - sb.tile_bounds[:-1]).long()
    tile0 = int(walk.argmax())
    cap = int(round(float(walk.float().mean())))
    result["b2_walk"] = dict(
        walk_max=int(walk.max()), walk_p99=float(torch.quantile(
            walk.float(), 0.99)), walk_mean=float(walk.float().mean()),
        longest_tile=tile0, longest_tile_rows=int(cnt[tile0]),
        rows_max=int(cnt.max()), rows_mean=float(cnt.float().mean()),
        pairs_evaluated=int(evaluated.sum()),
        pairs_contributing=int(contributed.sum()))
    print(f"B2 walk per tile (rows until its last pixel is done): "
          f"{result['b2_walk']}", flush=True)
    del evaluated, contributed
    sig = _kernels.SIGNATURES["forward_tile"]
    b2_jobs = {("b2", v): ("forward_tile", sig,
                           {"forward_tile.cu": edit(old_b2, e, f"B2 {v}",
                                                    tile0=tile0, cap=cap)})
               for v, e in B2_EDITS.items()}
    # the package's B2 over the longest tile and capped, likewise
    new_b2_src = (_kernels.CSRC_DIR / "forward_tile.cu").read_text()
    b2_jobs.update({("b2new", v): ("forward_tile", sig, package_files(
        "forward_tile", edit(new_b2_src, B2_EDITS[v], f"new B2 {v}",
                             tile0=tile0, cap=cap)))
        for v in ("longest", "capped")})
    b2_libs = build(b2_jobs, work)
    result["b2_sass_old"] = sass_loop(b2_libs[("b2", "old")][1],
                                      "forward_tile_kernelILi3E")
    result["b2_sass_new"] = sass_loop(
        _kernels._lib_path("forward_tile"), "forward_tile_kernelILi3E")
    print(f"B2 ch 3 per-pair loop (SASS): old {result['b2_sass_old']}, new "
          f"{result['b2_sass_new']}", flush=True)

    new_b2 = pb.new_fn("forward_tile")
    result.update(b2_against(b2_libs[("b2", "old")][0], new_b2, sb, sb1, gx))
    rec = result["b2_ch3"]

    def b2_cut(key, v):
        return cs.time_ms(b2_call(b2_libs[(key, v)][0], sb.tile_bounds,
                                  sb.payload, 1 if v == "longest" else T, gx,
                                  3, b2_outputs(3, T)))

    rec["split_ms"] = {v: b2_cut("b2", v) for v in B2_EDITS}
    print(f"B2 split of the old kernel, color view (ms; longest tile "
          f"{tile0}, {int(walk[tile0])} rows walked; cap {cap} rows): "
          f"{rec['split_ms']}", flush=True)
    rec["new_split_ms"] = {v: b2_cut("b2new", v) for v in ("longest", "capped")}
    print(f"B2 the package's kernel over the longest tile and capped (ms): "
          f"{rec['new_split_ms']}", flush=True)
    rec["sm_clock"] = sm_clock(libs[("clock",)][0], b2_call(
        new_b2, sb.tile_bounds, sb.payload, T, gx, 3, b2_outputs(3, T)))
    adv = result["b2_adversarial_bitwise_equal"]

    ok = (result["b4"]["bitwise_equal"] and result["b4_dense"]["bitwise_equal"]
          and result["b4_dense"]["indexed_bitwise_equal"]
          and result.get("layout", {}).get("bitwise_equal", True)
          and result["b2_ch3"]["bitwise_equal"]
          and result["b2_ch1"]["bitwise_equal"] and all(adv.values()))
    return finish(args, result, ok)


def phase3_scene():
    """`chip_smoke.py`'s scene as the viewer loads it (a PLY at 4x
    capacity) on the card, and phase 3's view."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.models.ply import load_ply, save_ply

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
    return scene, cam


# the parent's B5 (csrc/forward_chunk.cu) in its builds, and the same cuts
# of the package's B5; {tile0} and {cap} are filled in from the scene
_C1 = "  const int c1 = bounds[t + 1];\n"
_C1_CAPPED = ("  const int c1 = min(bounds[t + 1], bounds[t] + ({cap} + kChunk - 1)"
              " / kChunk);\n")
B5_EDITS = {
    "old": [],
    "longest": B2_EDITS["longest"],
    "capped": [(_C1, _C1_CAPPED),
               ("    const int nv = nvalid[c];\n",
                "    const int nv = min(nvalid[c], {cap} - (c - bounds[t]) * "
                "kChunk);\n")],
    "fastexp": [("expf(power)", "__expf(power)")],
}
B5_NEW_EDITS = {
    "longest": B2_EDITS["longest"],
    "capped": [(_C1, _C1_CAPPED),
               ("  auto live = [&](int c) { return c < c1 ? nvalid[c] : 0; };\n",
                "  auto live = [&](int c) {\n    return c < c1 ? max(0, min("
                "nvalid[c], {cap} - (c - c0) * kChunk)) : 0;\n  };\n")],
}
# other group sizes of the package's B5: (name, constant, value); one
# equal to the source's own value is skipped
B5_TUNE = (("g4", "kGroup", 4), ("g16", "kGroup", 16),
           ("mid_g4", "kGroupMid", 4), ("mid_g8", "kGroupMid", 8),
           ("wide_g4", "kGroupWide", 4), ("wide_g8", "kGroupWide", 8))


def b5_tune_jobs(src: str) -> dict:
    from gaussianeditor_tpu_torch.ops import _kernels

    jobs = {}
    for var, name, value in B5_TUNE:
        line = re.search(rf"constexpr int {name} = (\d+);", src)
        if int(line.group(1)) == value:
            continue
        jobs[("tune", var)] = ("forward_chunk",
                               _kernels.SIGNATURES["forward_chunk"],
                               package_files("forward_chunk", src.replace(
                                   line.group(0),
                                   f"constexpr int {name} = {value};")))
    return jobs


def main_b5(args) -> int:
    """The B5 part (`--b5`): see the module's docstring."""
    import torch

    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_dense import dense_bin
    from gaussianeditor_tpu_torch.ops.binning_sorted import sorted_bin
    from gaussianeditor_tpu_torch.ops.dense_composite import (
        forward_chunks_plain,
        pack_instances,
        tile_chunk_bounds,
    )
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )
    from gaussianeditor_tpu_torch.testing import (
        adversarial_rows,
        dense_from_rows,
    )

    smi = cs.nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    result = {"device": smi}
    old_b5 = (args.old / "forward_chunk.cu").read_text()
    old_b2 = (args.old / "forward_tile.cu").read_text()

    scene, cam = phase3_scene()
    gx = cs.SIZE // 16
    T = gx * gx
    budget = default_max_instances(scene.capacity)
    views = {}          # ch: (dense binning, instances, chunk bounds)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
        for p in (proc, *cs.feature_views(scene, cam)):
            db = dense_bin(p, gx, gx, budget)
            assert not bool(db.overflow)
            inst = pack_instances(p.mean2d, p.conic, p.opacity, p.color,
                                  p.depth, db)
            views[inst.shape[1] - 7] = (db, inst, tile_chunk_bounds(db))

    # the walk: rows until a tile's last pixel is done
    db3, inst3, bounds3 = views[3]
    _, evaluated, contributed = forward_chunks_plain(inst3, db3, gx)
    walk = evaluated.max(dim=1).values
    tile0 = int(walk.argmax())
    cap = int(round(float(walk.float().mean())))
    chunks = (bounds3[1:] - bounds3[:-1]).long()
    result["b5_walk"] = dict(
        walk_max=int(walk.max()), walk_p99=float(torch.quantile(
            walk.float(), 0.99)), walk_mean=float(walk.float().mean()),
        longest_tile=tile0, longest_tile_chunks=int(chunks[tile0]),
        chunks_max=int(chunks.max()), chunks_mean=float(chunks.float().mean()),
        pairs_evaluated=int(evaluated.sum()),
        pairs_contributing=int(contributed.sum()))
    print(f"B5 walk per tile (rows until its last pixel is done): "
          f"{result['b5_walk']}", flush=True)
    del evaluated, contributed

    sig = _kernels.SIGNATURES["forward_chunk"]
    jobs = {("b5", v): ("forward_chunk", sig, {
        "forward_chunk.cu": edit(old_b5, e, f"B5 {v}", tile0=tile0, cap=cap)})
        for v, e in B5_EDITS.items()}
    jobs[("clock",)] = ("sm_clock", (_L, _I, _P, _P),
                        {"sm_clock.cu": SM_CLOCK})
    new_src = (_kernels.CSRC_DIR / "forward_chunk.cu").read_text()
    if not args.old_only:
        jobs.update({("b5new", v): ("forward_chunk", sig, package_files(
            "forward_chunk", edit(new_src, e, f"new B5 {v}", tile0=tile0,
                                  cap=cap)))
            for v, e in B5_NEW_EDITS.items()})
        jobs[("b2", "old")] = ("forward_tile",
                               _kernels.SIGNATURES["forward_tile"],
                               {"forward_tile.cu": old_b2})
        if args.tune:
            jobs.update(b5_tune_jobs(new_src))
    libs = build(jobs, Path("build/probe_b5"))
    clock = libs[("clock",)][0]

    def b5(fn, ch, outs, grid=T):
        db, inst, bounds = views[ch]
        return lambda: pb.call(fn, bounds, db.chunk_nvalid, db.chunk_offset,
                               inst, grid, gx, ch, *outs)

    def cuts(key, variants):
        out = {ch: {v: cs.time_ms(b5(libs[(key, v)][0], ch, b2_outputs(ch, T),
                                     1 if v == "longest" else T))
                    for v in variants} for ch in views}
        print(f"B5 {key} builds by width (ms; longest tile {tile0}, "
              f"{int(walk[tile0])} rows walked; cap {cap} rows): {out}",
              flush=True)
        return out

    result["b5_sass_old"] = sass_loop(libs[("b5", "old")][1],
                                      "forward_chunk_kernelILi3E")
    print(f"B5 ch 3 per-pair loop (SASS), old: {result['b5_sass_old']}",
          flush=True)
    result["b5_split_ms"] = cuts("b5", B5_EDITS)
    result["b5_sm_clock_old"] = sm_clock(
        clock, b5(libs[("b5", "old")][0], 3, b2_outputs(3, T)), "the old B5")
    if args.old_only:
        return finish(args, result, True)

    _kernels.build()
    for name in ("forward_chunk", "forward_tile"):
        print_resources(f"{name} new", _kernels.BUILD_LOG.get(name, ""))
    result["b5_sass_new"] = sass_loop(_kernels._lib_path("forward_chunk"),
                                      "forward_chunk_kernelILi3E")
    print(f"B5 ch 3 per-pair loop (SASS), new: {result['b5_sass_new']}",
          flush=True)
    new_b5 = pb.new_fn("forward_chunk")
    new_b2 = pb.new_fn("forward_tile")
    with torch.no_grad():
        mask_proc = preprocess_scene(
            scene, cam, override_color=scene.mask[:, None].to(torch.float32))
        sb = sorted_bin(proc, gx, gx, budget)
        sb1 = sorted_bin(mask_proc, gx, gx, budget)
    ok = True
    for ch in views:
        o_old, o_new = b2_outputs(ch, T), b2_outputs(ch, T)
        f_old = b5(libs[("b5", "old")][0], ch, o_old)
        f_new = b5(new_b5, ch, o_new)
        f_old()
        f_new()
        torch.cuda.synchronize()
        eq = equal_outputs(o_old, o_new)
        ok &= eq
        print(f"B5 ch {ch} new vs old: color, depth, final_T and n_contrib "
              f"bitwise equal {eq}", flush=True)
        result[f"b5_ch{ch}"] = dict(
            bitwise_equal=eq, turns=in_turns(f"B5 ch {ch}", f_old, f_new))
        if ch == 3:
            # B2 on the same view's sorted rows, through the same walk
            o_b2 = b2_outputs(3, T)
            b2_call(new_b2, sb.tile_bounds, sb.payload, T, gx, 3, o_b2)()
            torch.cuda.synchronize()
            eq = equal_outputs(o_new, o_b2)
            ok &= eq
            print(f"B5 vs B2 on the color view: bitwise equal {eq}",
                  flush=True)
            result["b5_vs_b2_color_view_bitwise_equal"] = eq
    result["b5_new_split_ms"] = cuts("b5new", B5_NEW_EDITS)
    result["b5_sm_clock_new"] = sm_clock(
        clock, b5(new_b5, 3, b2_outputs(3, T)), "the package's B5")

    adv = {}
    for ch in (1, 3, 8, 32):
        start, cnt, payload, agx = adversarial_rows(60 + ch, ch,
                                                    device="cuda")
        inst, db = dense_from_rows(start, cnt, payload)
        bounds = tile_chunk_bounds(db)
        nt = start.shape[0]
        outs = {k: b2_outputs(ch, nt) for k in ("old", "new", "b2")}
        for k, fn in (("old", libs[("b5", "old")][0]), ("new", new_b5)):
            pb.call(fn, bounds, db.chunk_nvalid, db.chunk_offset, inst, nt,
                    agx, ch, *outs[k])
        if ch <= 3:
            b2_call(new_b2, torch.cat([start, start[-1:] + cnt[-1:]]).to(
                torch.int32), payload, nt, agx, ch, outs["b2"])()
        torch.cuda.synchronize()
        adv[ch] = dict(vs_old=equal_outputs(outs["old"], outs["new"]))
        if ch <= 3:
            adv[ch]["vs_b2"] = equal_outputs(outs["b2"], outs["new"])
        ok &= all(adv[ch].values())
    print(f"B5 new vs old (and vs B2 at ch <= 3) on adversarial_rows, "
          f"bitwise equal by ch: {adv}", flush=True)
    result["b5_adversarial_bitwise_equal"] = adv

    # the guard of the shared walk: B2 against DIR's
    result.update(b2_against(libs[("b2", "old")][0], new_b2, sb, sb1, gx))
    ok &= (result["b2_ch3"]["bitwise_equal"] and result["b2_ch1"]["bitwise_equal"]
           and all(result["b2_adversarial_bitwise_equal"].values()))

    for var, *_ in B5_TUNE:
        if ("tune", var) not in libs:
            continue
        rec = {}
        for ch in views:
            o_pkg, o_var = b2_outputs(ch, T), b2_outputs(ch, T)
            f_pkg = b5(new_b5, ch, o_pkg)
            f_var = b5(libs[("tune", var)][0], ch, o_var)
            f_pkg()
            f_var()
            torch.cuda.synchronize()
            ts = [cs.time_ms(f) for f in (f_pkg, f_var, f_var, f_pkg)]
            rec[ch] = dict(bitwise_equal=equal_outputs(o_pkg, o_var),
                           package_ms=[ts[0], ts[3]], ms=ts[1:3])
        print(f"B5 {var} against the package's build: {rec}", flush=True)
        result[f"b5_tune_{var}"] = rec
    return finish(args, result, ok)


def finish(args, result: dict, ok: bool) -> int:
    """Write `result` to `--out` and stdout; 0 if every check held."""
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 2


def in_turns(label, old_fn, new_fn) -> dict:
    """`old_fn` and `new_fn` timed in turns: old, new, new, old."""
    ts = [cs.time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    rec = dict(old_ms=[ts[0], ts[3]], new_ms=[ts[1], ts[2]])
    print(f"{label}: old {ts[0]:.4f} / {ts[3]:.4f} ms, new {ts[1]:.4f} "
          f"/ {ts[2]:.4f} ms", flush=True)
    return rec


def sm_clock(fn, load, label: str = "B2") -> dict:
    """The SM clock in MHz: `fn` (SM_CLOCK) spinning on every SM right
    after 200 calls of `load`, from clock64 over the global timer; and
    nvidia-smi's clocks.sm and clocks.max.sm read just after."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(2 * sms, dtype=torch.int64, device="cuda")
    for _ in range(200):
        load()
    pb.call(fn, 20_000_000, sms, out)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    v = out.view(sms, 2).double()
    mhz = v[:, 0] / v[:, 1] * 1e3
    rec = dict(measured_mhz_min=float(mhz.min()),
               measured_mhz_median=float(mhz.median()), nvidia_smi=smi)
    print(f"SM clock after {label}: {rec}", flush=True)
    return rec


def b2_outputs(ch, ntiles):
    """Empty color, depth, final_T and n_contrib of `ntiles` tiles."""
    import torch

    return [torch.empty((ntiles * 256, ch), device="cuda"),
            torch.empty(ntiles * 256, device="cuda"),
            torch.empty(ntiles * 256, device="cuda"),
            torch.empty(ntiles * 256, dtype=torch.int32, device="cuda")]


def b2_call(fn, bounds, payload, ntiles, grid_x, ch, outs):
    """A B2 build's raw C call over `ntiles` tiles, into `outs`."""
    return lambda: pb.call(fn, bounds, payload, payload.shape[1], ntiles,
                           grid_x, ch, *outs)


def equal_outputs(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def b2_against(old_fn, new_fn, sb, sb1, gx) -> dict:
    """B2 builds `old_fn` and `new_fn` on phase 3's color view `sb` (ch 3)
    and mask view `sb1` (ch 1): bitwise equal, timed in turns; and bitwise
    equal on `adversarial_rows` at ch 1, 2 and 3."""
    import torch

    from gaussianeditor_tpu_torch.testing import adversarial_rows

    T = gx * gx
    out = {}
    for label, b, ch in (("color view", sb, 3), ("mask view", sb1, 1)):
        o_old, o_new = b2_outputs(ch, T), b2_outputs(ch, T)
        f_old = b2_call(old_fn, b.tile_bounds, b.payload, T, gx, ch, o_old)
        f_new = b2_call(new_fn, b.tile_bounds, b.payload, T, gx, ch, o_new)
        f_old()
        f_new()
        torch.cuda.synchronize()
        eq = equal_outputs(o_old, o_new)
        print(f"B2 {label} (ch {ch}) new vs old: color, depth, final_T and "
              f"n_contrib bitwise equal {eq}", flush=True)
        out[f"b2_ch{ch}"] = dict(
            bitwise_equal=eq,
            turns=in_turns(f"B2 {label} (ch {ch})", f_old, f_new))
    adv = {}
    for ch in (1, 2, 3):
        start, cnt, payload, agx = adversarial_rows(20 + ch, ch,
                                                    device="cuda")
        bounds = torch.cat([start, start[-1:] + cnt[-1:]]).to(torch.int32)
        nt = start.shape[0]
        o_old, o_new = b2_outputs(ch, nt), b2_outputs(ch, nt)
        b2_call(old_fn, bounds, payload, nt, agx, ch, o_old)()
        b2_call(new_fn, bounds, payload, nt, agx, ch, o_new)()
        torch.cuda.synchronize()
        adv[ch] = equal_outputs(o_old, o_new)
    print(f"B2 new vs old on adversarial_rows, bitwise equal by ch: {adv}",
          flush=True)
    out["b2_adversarial_bitwise_equal"] = adv
    return out


def package_files(name: str, src: str) -> dict:
    """The files of a build of the package's kernel `name` from source
    `src`: the source first, then every header of `csrc/`."""
    from gaussianeditor_tpu_torch.ops import _kernels

    files = {f"{name}.cu": src}
    files.update({h.name: h.read_text()
                  for h in sorted(_kernels.CSRC_DIR.glob("*.cuh"))})
    return files


def _new_b4(rows, b_incl, tt, C, out):
    """The package's B4 through its raw C call, into `out`."""
    GF, n = rows.shape
    pb.call(pb.new_fn("rank_segment_sum"), rows, b_incl, tt, GF, n, C, out)


# The package's B4 reading its rows another way, in builds of its own:
# "indexed" reads rank q's row at aligned slot col_index[q] of B6's rows
# [NC, GF, 128] (an extra int64 argument after rows); "rank_major" reads
# rank-major rows [n, GFP] (GFP = GF rounded up to a multiple of 4, the
# layout B3's rank-major epilogue writes)
_B4_LOAD = """          const float* src = rows + (size_t)f0 * n + p0 + r;
#pragma unroll
          for (int k = 0; k < kFields; ++k)
            if (k < nf) stage[k * kPiece + r] = src[(size_t)k * n];"""
_B4_INDEXED = [
    ("    const float* __restrict__ rows, const int* __restrict__ b_incl,\n",
     "    const float* __restrict__ rows,\n"
     "    const long long* __restrict__ col_index,\n"
     "    const int* __restrict__ b_incl,\n"),
    (_B4_LOAD, """          const long long c = col_index[p0 + r];
          const float* src = rows + (c >> 7) * (128LL * gf) + (c & 127) +
                             f0 * 128;
#pragma unroll
          for (int k = 0; k < kFields; ++k)
            if (k < nf) stage[k * kPiece + r] = src[k * 128];"""),
    ('extern "C" int rank_segment_sum(const void* rows, const void* b_incl,',
     'extern "C" int rank_segment_sum(const void* rows, const void* col_index,'
     ' const void* b_incl,'),
    ("      (const float*)rows, (const int*)b_incl,",
     "      (const float*)rows, (const long long*)col_index, "
     "(const int*)b_incl,"),
]
_B4_RANK_MAJOR = [
    (_B4_LOAD, """          const float* src = rows + (size_t)(p0 + r) * {gfp} + f0;
#pragma unroll
          for (int k = 0; k < kFields; ++k)
            if (k < nf) stage[k * kPiece + r] = src[k];"""),
]


def b4_read_jobs(gf: int = 10) -> dict:
    """The "indexed" and "rank_major" builds of the package's B4, for
    rows of `gf` fields (10: the color view's)."""
    from gaussianeditor_tpu_torch.ops import _kernels

    src = (_kernels.CSRC_DIR / "rank_segment_sum.cu").read_text()
    return {
        ("b4x", "indexed"): ("rank_segment_sum", (_P,) * 4 + B4_SIG[3:], {
            "rank_segment_sum.cu": edit(src, _B4_INDEXED, "B4 indexed")}),
        ("b4x", "rank_major"): ("rank_segment_sum", B4_SIG, {
            "rank_segment_sum.cu": edit(src, _B4_RANK_MAJOR,
                                        "B4 rank-major",
                                        gfp=-(-gf // 4) * 4)}),
    }


# B3's epilogue writing rank-major rows [n, GFp], GFp = GF rounded up to
# a multiple of 4
_B3_STORE = "[&](int k, float v) { out[(size_t)k * n + r] = v; });"
_B3_STORE_RM = "[&](int k, float v) { out[(size_t)r * ((P + 3) & ~3) + k] = v; });"


def layout_jobs() -> dict:
    from gaussianeditor_tpu_torch.ops import _kernels

    csrc = _kernels.CSRC_DIR
    src = edit((csrc / "backward_tile.cu").read_text(),
               [(_B3_STORE, _B3_STORE_RM)], "B3 rank-major")
    return {("b3", "rank_major"): (
        "backward_tile", _kernels.SIGNATURES["backward_tile"],
        package_files("backward_tile", src))}


def time_layout(libs, b3_args, rows, b_incl, tt, C, in_turns) -> dict:
    """zero fill, B3 and B4 over [GF, n] (the package's) against the same
    over rank-major [n, GFp], in turns; and each part alone."""
    import torch

    bounds, payload, rank, tiles, g_color, g_depth, g_T, gx, ch = b3_args
    GF, n = rows.shape
    GFp = -(-GF // 4) * 4
    T = bounds.shape[0] - 1
    fm = torch.empty((GF, n), device="cuda")
    rm = torch.empty((n, GFp), device="cuda")
    out_fm = torch.empty((C, GF), device="cuda")
    out_rm = torch.empty((C, GF), device="cuda")

    def b3(fn, out):
        pb.call(fn, bounds, payload, rank, n, T, gx, ch, g_color, g_depth,
                g_T, tiles.color, tiles.depth, tiles.final_T,
                tiles.n_contrib, out)

    fm_b3 = pb.new_fn("backward_tile")
    rm_b3 = libs[("b3", "rank_major")][0]
    rm_b4 = libs[("b4x", "rank_major")][0]
    parts = {
        "fm_b3": lambda: (fm.zero_(), b3(fm_b3, fm)),
        "rm_b3": lambda: (rm.zero_(), b3(rm_b3, rm)),
        "fm_b4": lambda: _new_b4(fm, b_incl, tt, C, out_fm),
        "rm_b4": lambda: pb.call(rm_b4, rm, b_incl, tt, GF, n, C, out_rm),
    }

    def pair_fm():
        parts["fm_b3"]()
        parts["fm_b4"]()

    def pair_rm():
        parts["rm_b3"]()
        parts["rm_b4"]()

    pair_fm()
    pair_rm()
    torch.cuda.synchronize()
    eq = torch.equal(out_fm, out_rm) and torch.equal(fm, rm[:, :GF].T)
    print(f"B3+B4 over rank-major rows vs over [GF, n]: rows and sums "
          f"bitwise equal {eq}", flush=True)
    rec = dict(bitwise_equal=eq,
               turns=in_turns("B3+B4 pair, [GF, n] (old) vs rank-major [n, "
                              "GFp] (new)", pair_fm, pair_rm),
               parts_ms={k: cs.time_ms(f) for k, f in parts.items()})
    print(f"  parts (ms): {rec['parts_ms']}", flush=True)
    return rec


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"probe_b2_b4: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
