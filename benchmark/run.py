"""Entry point: run one cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of `BENCHMARK.json`'s
`workloads`; its configuration, traffic mix, limits and metrics are the
JSON files `benchmark/{configs,traffic,cells,metrics}/<name>.json`,
found by name. A traffic file names its `driver`, and a metric file its
`kind` and the kind's parameters (a `roofline` metric its kernel
`count`). Drivers, kinds and counts are the harness's own
(`workload.DRIVERS`, `KINDS` below and `spans.KINDS`,
`counts.KERNELS`) or those of the modules of `benchmark/ext/`, merged
by name (the docstring of `benchmark/ext/__init__.py`).

What a new configuration adds, then, is new files and new entries, and
no edit of a file the benchmark has: its configuration file
(`configs/`), a traffic file (`traffic/`) and a cell file with its
limits (`cells/`) for each cell, a metric file for each new metric
(`metrics/`), and where the built-ins do not serve, one module of
`benchmark/ext/` with its driver (set-up, window and the reference
checks that decide `correct`), its metric kinds and its kernel counts;
then its entries in `BENCHMARK.json`'s `configs`, `workloads` and
`per_layer`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit; the same
numbers end standard error. With `--trace 1` the program's spans and
counters are recorded over the profiled window only (`tracing.py`) and
read by `spans.py`, whose readings are also `info` lines. It exits with
3 and prints no result without the chips the cell asks for, with 4 if
JAX or the JAX package was loaded, and with 5 for a driver, kind or
kernel count that no file defines.

Two more modes, which the benchmark's own runs do not use:
`--control 1` puts the reference, in TF32, in the program's place (it
must come out not correct); `--check-seeds a,b,..` runs set-up and the
check for each seed in one process, without a window, and prints one
line of readings a seed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from benchmark import counts, ext, spans, workload  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianeditor_tpu"}


def load(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str, root: Path = HERE) -> tuple:
    """(workload entry, configuration, traffic, cell file) of a cell."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return (w, load("configs", w["config"], root),
                    load("traffic", w["traffic"], root),
                    load("cells", name, root))
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, traced: bool) -> list:
    """The cell's metrics, in `BENCHMARK.json`'s order: its end-to-end
    ones, or with a trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def _roofline(run, m):
    if run.trace is None or not run.work or not run.steps:
        return None
    spent = run.trace.seconds(m["pattern"]) / run.steps
    if spent <= 0:
        return None
    kernel = counts.kernel(m["count"])
    bound = run.views_per_step * sum(map(kernel, run.work)) / len(run.work)
    return 100.0 * bound / spent


def _mfu(run, m):
    if not run.work or not run.steps:
        return None
    least = counts.step_least_s(run.work, run.views_per_step,
                                run.perceptual, run.anchors) \
        + run.extra_least_s
    return 100.0 * least / (run.window_s / run.steps)


def _trace_ms(run, m):
    if run.trace is None or not run.steps:
        return None
    return 1e3 * run.trace.seconds(m["pattern"]) / run.steps


KINDS = {
    "setup": lambda run, m: run.setup_s,
    "window_per_step": lambda run, m: (
        None if not run.steps else 1e3 * run.window_s / run.steps),
    "percentile": lambda run, m: workload.percentile(run.latencies_ms,
                                                     m["q"]),
    "idle_pct": lambda run, m: None if run.trace is None else (
        100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)),
    "kernel_ms_per_step": _trace_ms,
    "launches_per_step": lambda run, m: (
        None if run.trace is None or not run.steps
        else run.trace.kernels / run.steps),
    "roofline": _roofline,
    "mfu": _mfu,
}


def kind(name: str):
    """The metric kind `name`: of `KINDS`, `spans.KINDS` or a module of
    `benchmark/ext/`; `LookupError` for a name none defines."""
    return ext.lookup("KINDS", name, KINDS, spans.KINDS)


def resolve(bench: dict, name: str, traced: bool, root: Path = HERE) -> list:
    """(name, unit, kind, metric file) of each of the cell's metrics;
    `LookupError` for a kind or kernel count that no file defines."""
    out = []
    for m in metrics_of(bench, name, traced):
        f = load("metrics", m["name"], root)
        if "count" in f:
            counts.kernel(f["count"])
        out.append((m["name"], m["unit"], kind(f["kind"]), f))
    return out


def values(metrics: list, run) -> dict:
    """The result line's `metrics`: each of `resolve`'s metrics that the
    run has something to read for."""
    out = {}
    for name, unit, k, f in metrics:
        v = k(run, f)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def judge(run, limits: dict, optional=()) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and no number missing but an `optional` one the run did not
    reach (edit1m's densify event falls in the window only when it
    reaches step 100)."""
    checks = {k: {"value": run.checks.get(k), "limit": lim}
              for k, lim in limits.items()
              if k in run.checks or k not in optional}
    ok = all(c["value"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--check-seeds", default="")
    args = p.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry, cfg, traffic, cellf = cell_files(bench, args.workload)
    try:
        drive = workload.driver(traffic["driver"])
        metrics = resolve(bench, args.workload, bool(args.trace))
    except LookupError as e:
        print(f"benchmark: {e.args[0]}", file=sys.stderr)
        return 5
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    def cell(seed, t_start, window=True):
        return workload.Cell(
            name=args.workload, cfg=cfg, traffic=traffic,
            limits=cellf["limits"], seed=seed, seconds=args.seconds,
            trace=bool(args.trace), device=device, t_start=t_start,
            control=bool(args.control), window=window)

    if args.check_seeds:
        for s in args.check_seeds.split(","):
            t0 = time.perf_counter()
            run = drive(cell(int(s), t0, window=False))
            ok, checks = judge(run, cellf["limits"],
                               cellf.get("optional", ()))
            print(json.dumps({"seed": int(s), "control": bool(args.control),
                              "correct": ok, "checks": checks,
                              "setup_s": run.setup_s, "check_s": run.check_s,
                              "peak": torch.cuda.max_memory_allocated(device),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        return 0

    run = drive(cell(args.seed, T_START))
    ok, checks = judge(run, cellf["limits"], cellf.get("optional", ()))
    spans.read(run)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
           "metrics": values(metrics, run), "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"steps {run.steps} in {run.window_s:.3f} s; set-up "
          f"{run.setup_s:.3f} s; check {run.check_s:.3f} s",
          file=sys.stderr)
    for k, v in run.info.items():
        print(f"info {k}: {v!r}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
