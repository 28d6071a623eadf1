"""Extensions: the code a new configuration brings, as new files.

The harness imports every module of this package and merges three dicts
that a module may define with its own:

  * `DRIVERS`: a traffic file's `driver` -> `drive(cell: workload.Cell)
    -> workload.Run`. A driver builds the program from the cell's files
    and the seed, runs set-up, times the window (`workload.timed`, or
    `tracing.profiler` and `tracing.Trace` when `cell.trace`), and holds
    what the program produced to a reference in `run.checks`, judged
    against the cell file's `limits`. It may set `run.extra_least_s`,
    the least seconds a step of the work it adds beyond the render,
    losses and Adam that `counts.step_least_s` counts.
  * `KINDS`: a metric file's `kind` -> `kind(run, metric) -> value or
    None`, `metric` the metric file's dict; None where the run has
    nothing to read.
  * `KERNELS`: a `roofline` metric's `count` -> `least_s(work) ->
    seconds`, the least time of one view's kernel for one of the run's
    `work` dicts, at the peak that kernel's arithmetic runs at.

A module may import `benchmark.workload`, `counts`, `reference`,
`scene`, `spans` and `tracing`, and the program inside its driver. A name
defined twice, by two modules or by a module and the harness, raises
`ValueError` when the harness first looks a name up.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil
from typing import Dict

TABLES = ("DRIVERS", "KINDS", "KERNELS")


@functools.lru_cache(maxsize=None)
def load() -> Dict[str, dict]:
    """Every module's `DRIVERS`, `KINDS` and `KERNELS`, merged."""
    out: Dict[str, dict] = {t: {} for t in TABLES}
    owner: Dict[tuple, str] = {}
    for info in sorted(pkgutil.iter_modules(__path__), key=lambda i: i.name):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for t in TABLES:
            for name, value in getattr(mod, t, {}).items():
                if (t, name) in owner:
                    raise ValueError(f"{t} {name!r} is defined by both "
                                     f"{owner[t, name]} and {info.name}")
                owner[t, name] = info.name
                out[t][name] = value
    return out


def lookup(table: str, name: str, *own: dict):
    """`name` in the harness's own dicts of `table` (`own`) and the
    modules'; `ValueError` for a name two of them define, `LookupError`,
    with the names there are, for one none defines."""
    known: dict = {}
    for d in own + (load()[table],):
        clash = sorted(known.keys() & d.keys())
        if clash:
            raise ValueError(f"{table} {clash} defined twice")
        known.update(d)
    if name not in known:
        raise LookupError(f"no {table[:-1].lower()} {name!r} in the harness "
                          f"or benchmark/ext; known: {sorted(known)}")
    return known[name]
