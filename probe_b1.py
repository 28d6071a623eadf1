#!/usr/bin/env python3
"""Time kernel B1 (the sorted binning's key kernel) against another build
of it, and `sorted_bin` whole against the route that build served.

    python3 probe_b1.py --old DIR [--split] [--out FILE]   # one card

`DIR` holds another version of `binning_key.cu` with the parent's C entry
point (the same arguments; int64 keys, 2^32 - 1 for a dead rank), for
instance the parent commit's, written there with `git show` (the copy on
the card's machine is not a git repository):

    mkdir -p build/old
    git show HEAD~1:gaussianeditor_tpu_torch/csrc/binning_key.cu \\
        > build/old/binning_key.cu

It is compiled with the package's nvcc flags. Three views, those of
`chip_smoke.py`'s B1 rows:
  512:    phase 3's color view: the 1,000,000-Gaussian SH-3 scene
          (bench.py's recipe, seed 0) from a PLY at 4x capacity, 512x512,
          1024 tiles, ch 3;
  recon:  the recon grid, 1297x840 (82 x 53 tiles; live keys set bit
          31): view 0 of phase 14's camera rig on a scene as recon starts
          it, 150,000 of the scene's centres (seeded, jittered by N(0,
          0.01)) through `GaussianScene.from_points` into 600,000 slots
          (phase 14 times B1 on the scene after its 300 steps instead);
  strip:  strip 1 of phase 3's view, 8 tile rows (256 tiles), at the
          whole image's depth cut, as phase 17 takes it.
At each view the old and the package's B1 run through their raw C calls
into outputs allocated once, in turns (old, new, new, old; median of 20
samples, `chip_smoke.time_ms`); then `sorted_bin` whole, in turns: the
parent's route (the old kernel, `torch.sort` of its int64 keys, the
payload gather, `searchsorted` of the sorted keys' tiles) against the
package's. The old key must equal the new key plus 2^31, the two payloads
must be bitwise equal, and both routes must give the same sort order,
sorted payload and tile_bounds. It prints each view's ranks and B1's
bound (bytes, `chip_smoke.check_kernels`' count, the key at 4 bytes; the
parent's key at 8, `chip_smoke.b1_bytes`), the registers, spills and
shared memory of both builds and the new kernel's blocks per SM. Results
go to stdout and, as JSON, to `--out`.

`--split` also builds the package's B1 without parts and times each in
turns against the package's build (package, cut, cut, package) at every
view: "search" stops after the owner of the block's first rank is found;
"keys" writes the keys and no payload; "nostore" computes every
word but stores none (a dependence the compiler keeps); "owners" stops
after the owners are numbered (the search, the walk and the scan: the
chain of latencies before the first store). With each view's blocks and
the waves they take at the kernel's blocks per SM. The cuts are edits of
the kernel's source text (SPLIT): an exploration tool, which stops at the
first edit whose text it cannot find once the source changes, and is
edited with it.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
import probe_b2_b4 as p24
import probe_backward as pb

RECON_SLOTS = 600_000
# the package's B1 without parts (--split): edits of csrc/binning_key.cu
_STORES = (
    """    reinterpret_cast<uint4*>(base)[tid] = make_uint4(w0, w1, w2, w3);
""",
    """    if ((w0 ^ w1 ^ w2 ^ w3) == 0x9E3779B9u) base[4 * tid] = w0;
""")
_SCAN_END = ("  reinterpret_cast<int4*>(own)[tid] = make_int4(num[0], num[1], "
             "num[2], num[3]);\n  __syncthreads();\n")
_SEARCH_END = "  if (tid == 0) own[0] = g_first;\n"
SPLIT = {
    "search": [(_SEARCH_END, _SEARCH_END + "  if (g_first == -7) key[q0] = 1u;"
                                           "\n  return;\n")],
    "keys": [("  const int P = 7 + ch;\n", "  const int P = 0;\n")],
    "nostore": [_STORES],
    "owners": [(_SCAN_END, _SCAN_END + "  if (own[tid] == -7) key[q0] = K;\n"
                                       "  return;\n")],
}


def recon_view(device="cuda"):
    """Phase 14's grid: a scene as recon starts it, and view 0 of its
    camera rig."""
    import torch

    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.core.sh import C0
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.ops.render import preprocess_scene

    arrays = cs.bench_scene_arrays(cs.N_GAUSSIANS, cs.SEED)
    xyz, dc = arrays["xyz"], arrays["features_dc"][:, 0]
    rng = np.random.RandomState(cs.SEED)
    idx = np.sort(rng.choice(len(xyz), cs.RECON_POINTS, replace=False))
    pts = xyz[idx].astype(np.float64) + rng.normal(0, 0.01,
                                                   (cs.RECON_POINTS, 3))
    rgb = np.round(np.clip(0.5 + C0 * dc[idx], 0, 1) * 255) / 255
    scene = GaussianScene.from_points(pts, rgb, max_sh_degree=cs.SH_DEGREE,
                                      capacity=RECON_SLOTS, device=device)
    w, h = cs.RECON_W, cs.RECON_H
    fovy = 2 * math.atan(h * math.tan(0.4) / w)
    cam = lookat_camera((4.0, -1.2, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        0.8, fovy, h, w, device=device)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)
    return proc, scene.capacity, -(-w // 16), -(-h // 16)


def inputs(proc):
    """B1's input tensors, contiguous, in the C call's order."""
    return [t.contiguous() for t in (
        proc.tiles_touched, proc.rect_min, proc.rect_max, proc.mean2d,
        proc.conic, proc.opacity, proc.depth, proc.color)]


def cut_jobs(src: str) -> dict:
    """Builds of the package's B1 source `src` without parts (SPLIT)."""
    from gaussianeditor_tpu_torch.ops import _kernels

    sig = _kernels.SIGNATURES["binning_key"]
    return {("cut", var): ("binning_key", sig, {
        "binning_key.cu": p24.edit(src, edits, f"B1 {var}")})
        for var, edits in SPLIT.items()}


def measure(label, proc, gx, gy, budget, kdb, old_fn, new_fn, cuts) -> dict:
    """Both B1s and both routes at one view: bitwise checks and turns;
    then each of `cuts` ({key: ctypes function}) in turns against the
    package's B1."""
    import torch

    from gaussianeditor_tpu_torch.ops.binning_sorted import (
        KEY_BIAS,
        ranks_kept,
        sorted_bin,
    )

    T = gx * gy
    C, ch = proc.color.shape
    P = 7 + ch
    ins = inputs(proc)
    b_incl = torch.cumsum(ins[0], 0, dtype=torch.int32)
    total = int(b_incl[-1])
    n = ranks_kept(total, budget)
    bound = {}
    for name, key_bytes in (("new", 4), ("old", 8)):
        nbytes, slots, n_vis = cs.b1_bytes(b_incl, ins[0], n, ch, key_bytes)
        bound[name] = 1e3 * nbytes / cs.H100_BYTES_PER_S
    key_old = torch.empty(n, dtype=torch.int64, device="cuda")
    key_new = torch.empty(n, dtype=torch.int32, device="cuda")
    pay_old = torch.empty((P, n), device="cuda")
    pay_new = torch.empty((P, n), device="cuda")

    def b1(fn, key, pay):
        return lambda: pb.call(fn, b_incl, *ins, C, ch, n, total, gx, kdb,
                               key, pay)

    f_old, f_new = b1(old_fn, key_old, pay_old), b1(new_fn, key_new, pay_new)
    f_old()
    f_new()
    torch.cuda.synchronize()
    keys_eq = torch.equal(key_old, key_new.to(torch.int64) + KEY_BIAS)
    pay_eq = torch.equal(pay_old.view(torch.int32), pay_new.view(torch.int32))
    print(f"{label}: {T} tiles, n={n} ranks (num_rendered {total}), visible "
          f"{n_vis} of slots [0, {slots}) ({C} in all), ch {ch}; old key == new key + 2^31 {keys_eq}, "
          f"payload bitwise equal {pay_eq}; bound (bytes) new "
          f"{bound['new']:.4f} ms, old {bound['old']:.4f} ms", flush=True)
    turns = p24.in_turns(f"B1 {label}", f_old, f_new)

    def old_route():
        bi = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
        tot = int(bi[-1])
        m = ranks_kept(tot, budget)
        key = torch.empty(m, dtype=torch.int64, device="cuda")
        pay = torch.empty((P, m), device="cuda")
        pb.call(old_fn, bi, *ins, C, ch, m, tot, gx, kdb, key, pay)
        skey, rank = torch.sort(key, stable=True)
        bounds = torch.searchsorted(
            skey >> kdb, torch.arange(T + 1, dtype=torch.int64,
                                      device="cuda"),
            side="left").to(torch.int32)
        return pay[:, rank], rank, bounds

    def new_route():
        return sorted_bin(proc, gx, gy, budget, depth_bits=kdb)

    with torch.no_grad():
        o_pay, o_rank, o_bounds = old_route()
        sb = new_route()
        torch.cuda.synchronize()
        route_eq = dict(
            rank=torch.equal(o_rank, sb.rank),
            payload=torch.equal(o_pay.view(torch.int32),
                                sb.payload.view(torch.int32)),
            tile_bounds=torch.equal(o_bounds, sb.tile_bounds))
        print(f"{label}: sorted_bin, parent's route against the package's, "
              f"bitwise equal: {route_eq}", flush=True)
        route_turns = p24.in_turns(f"sorted_bin {label}", old_route,
                                   new_route)
    new_ms = route_turns["new_ms"]
    share = bound["new"] / min(turns["new_ms"])
    print(f"{label}: new B1 {min(turns['new_ms']):.4f} ms, {share:.0%} of its "
          f"bound; sorted_bin {min(new_ms):.4f} ms", flush=True)
    rec = dict(tiles=T, ranks=n, num_rendered=total, visible=n_vis,
               slots=slots, C=C,
               ch=ch, bound_ms=bound, keys_equal=keys_eq,
               payload_equal=pay_eq, b1=turns, route_equal=route_eq,
               sorted_bin=route_turns,
               ok=keys_eq and pay_eq and all(route_eq.values()))
    for (kind, var), fn in cuts.items():
        f_cut = b1(fn, torch.empty_like(key_new), torch.empty_like(pay_new))
        f_cut()
        torch.cuda.synchronize()
        rec[f"{kind}_{var}"] = dict(turns=p24.in_turns(
            f"B1 {label} {kind} {var}", f_new, f_cut))
    return rec


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--split", action="store_true",
                    help="also time the package's B1 without parts")
    ap.add_argument("--out", type=Path, default=Path("build/probe_b1.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_b1: needs a CUDA device", file=sys.stderr)
        return 1
    from gaussianeditor_tpu_torch.ops import _kernels
    from gaussianeditor_tpu_torch.ops.binning_sorted import key_depth_bits
    from gaussianeditor_tpu_torch.ops.render import (
        default_max_instances,
        preprocess_scene,
    )
    from gaussianeditor_tpu_torch.parallel.tile_sharded import (
        preprocess_strip,
    )
    from gaussianeditor_tpu_torch.testing import kernel_constants

    smi = cs.nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    result = {"device": smi}
    _kernels.build(["binning_key"])
    p24.print_resources("binning_key new",
                        _kernels.BUILD_LOG.get("binning_key", ""))
    new_src = (_kernels.CSRC_DIR / "binning_key.cu").read_text()
    k = kernel_constants("binning_key.cu")
    smem, blocks = _kernels.occupancy("binning_key", 3)
    print(f"  binning_key new: {smem} bytes of dynamic shared memory, "
          f"{blocks} blocks of {k['kThreads']} threads per SM", flush=True)
    result["new_blocks_per_sm"] = blocks
    old_src = (args.old / "binning_key.cu").read_text()
    jobs = {("b1", "old"): ("binning_key", _kernels.SIGNATURES["binning_key"],
                            {"binning_key.cu": old_src})}
    if args.split:
        jobs.update(cut_jobs(new_src))
    libs = p24.build(jobs, Path("build/probe_b1"))
    old_fn = libs.pop(("b1", "old"))[0]
    cuts = {key: fn for key, (fn, _) in libs.items()}
    new_fn = pb.new_fn("binning_key")
    k_ranks = k["kRanks"]
    resident = blocks * torch.cuda.get_device_properties(0).multi_processor_count

    scene, cam = p24.phase3_scene()
    gx = gy = cs.SIZE // 16
    budget = default_max_instances(scene.capacity)
    with torch.no_grad():
        proc = preprocess_scene(scene, cam)

    def view(key, label, proc, vgx, vgy, vbudget, kdb):
        result[key] = measure(label, proc, vgx, vgy, vbudget, kdb, old_fn,
                              new_fn, cuts)
        n = result[key]["ranks"]
        blk = -(-n // k_ranks)
        result[key].update(blocks=blk, waves=blk / resident)
        print(f"{label}: {blk} blocks of {k_ranks} ranks, "
              f"{blk / resident:.2f} waves of {resident}", flush=True)

    view("512", "512x512 color view", proc, gx, gy, budget,
         key_depth_bits(gx * gy))
    gyl = gy // cs.STRIPS
    with torch.no_grad():
        proc = preprocess_strip(scene, cam, gyl, gyl)
    view("strip", "strip 1", proc, gx, gyl, budget, key_depth_bits(gx * gy))
    del scene, proc
    torch.cuda.empty_cache()
    proc, cap, rgx, rgy = recon_view()
    view("recon", "recon grid 1297x840", proc, rgx, rgy,
         default_max_instances(cap), key_depth_bits(rgx * rgy))
    ok = all(result[v]["ok"] for v in ("512", "strip", "recon"))
    print(f"probe_b1: every check held: {ok}; on {smi}", flush=True)
    return p24.finish(args, result, ok)


if __name__ == "__main__":
    sys.exit(main())
