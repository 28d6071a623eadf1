"""Profiling: step timers, the program's spans and its host-sync counters.

Counterpart of `gaussianeditor_tpu/utils/profiling.py` (`StepTimer`).
`StepTimer` is copied. The JAX package's `jax_trace` and `throughput`
have no counterpart: `write_trace` writes what the spans below recorded.

Spans. `with span(name, rid=None):` marks a phase of the program. With
tracing off (the default) it returns one shared object whose
`__enter__` and `__exit__` do nothing, so the cost is one global check.
With tracing on (`tracing(True)`), each span appends a `Span` to a list
in memory when it closes: its name, its start and end, its own id and
its parent's (the innermost span open on the same thread), the OS
thread id and the low 32 bits of the thread's pthread id (the
profiler's runtime events name a thread by one or the other), and its
request id (the step number of a step's spans, a request number of a
frame's), which children inherit. Past `SPAN_LIMIT` records, spans are
dropped and counted in `COUNTERS["spans_dropped"]`.
`take_spans()` returns the list and clears it; nothing is written to
disk until `write_trace` is called.

The clock is `time.time_ns()`, Unix-epoch nanoseconds, the clock of
`torch.profiler`'s events (`_KinetoEvent.start_ns()`): a device kernel
can be given to the span open on the thread that launched it, through
the runtime event that shares its correlation id. The program records
no `torch.profiler.record_function` ranges, which would add annotation
events to the profiler's device timeline.

Counters. `COUNTERS` holds, for the life of the process:
  * `host_syncs`: site -> the number of times the host waited for the
    device there. `with sync(site):` wraps each such point on the hot
    path; it counts whether tracing is on or off, and with tracing on it
    also records a span `sync.<site>`. One block is one wait: copies
    inside it after the first find the stream drained.
  * `h2d_bytes`, `d2h_bytes`: bytes copied host to device by
    `train/trainer.py::upload_images` and device to host at the sync
    sites that copy data back.
  * `spans_dropped`.
  * `unet_evals`: the diffusion UNet's calls (`count`), one per batch of
    the guidance's 3-way classifier-free guidance
    (`guidance/diffusers_adapters.py`), whether tracing is on or off.
`counters()` returns a copy; a reader takes the difference of two.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

SPAN_LIMIT = 1 << 20

COUNTERS: Dict = {"host_syncs": {}, "h2d_bytes": 0, "d2h_bytes": 0,
                  "spans_dropped": 0, "unet_evals": 0}


class StepTimer:
    """Collects wall-times per named phase; `summary()` gives
    count/mean/p50/p90/max in milliseconds."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            s = sorted(ts)
            n = len(s)
            out[name] = {
                "count": n,
                "mean_ms": 1e3 * sum(s) / n,
                "p50_ms": 1e3 * s[n // 2],
                "p90_ms": 1e3 * s[min(n - 1, int(0.9 * n))],
                "max_ms": 1e3 * s[-1],
            }
        return out


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    tid: int                # threading.get_native_id()
    ident: int              # threading.get_ident(), cut to 32 bits
    rid: Optional[int]


_on = False
_spans: List[Span] = []
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    __slots__ = ("name", "rid", "id", "parent", "start")

    def __init__(self, name: str, rid: Optional[int]):
        self.name = name
        self.rid = rid

    def __enter__(self):
        thread = getattr(_local, "thread", None)
        if thread is None:
            # read once a thread: the native id is a system call
            thread = _local.thread = ([], threading.get_native_id(),
                                      threading.get_ident() & 0xFFFFFFFF)
        stack = thread[0]
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.rid is None and top is not None:
            self.rid = top.rid
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack, tid, ident = _local.thread
        stack.pop()
        rec = Span(self.name, self.start, end, self.id, self.parent, tid,
                   ident, self.rid)
        with _lock:
            if len(_spans) < SPAN_LIMIT:
                _spans.append(rec)
            else:
                COUNTERS["spans_dropped"] += 1
        return False


def span(name: str, rid: Optional[int] = None):
    """A context manager that records the block as span `name` while
    tracing is on; `rid` defaults to the enclosing span's."""
    if not _on:
        return _NULL
    return _Open(name, rid)


def sync(site: str, d2h_bytes: int = 0):
    """Count one host wait for the device at `site` (and `d2h_bytes`
    copied back); a context manager around the wait, recorded as span
    `sync.<site>` while tracing is on."""
    with _lock:
        h = COUNTERS["host_syncs"]
        h[site] = h.get(site, 0) + 1
        COUNTERS["d2h_bytes"] += d2h_bytes
    return span("sync." + site) if _on else _NULL


def add_h2d_bytes(n: int) -> None:
    with _lock:
        COUNTERS["h2d_bytes"] += int(n)


def count(name: str) -> None:
    """Add one to the counter `name`."""
    with _lock:
        COUNTERS[name] += 1


def tracing(on: bool = True) -> None:
    """Switch span recording on or off."""
    global _on
    _on = bool(on)


def take_spans() -> List[Span]:
    """The spans recorded so far, in the order they closed; clears them."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def counters() -> Dict:
    """A copy of `COUNTERS`."""
    with _lock:
        return {**COUNTERS, "host_syncs": dict(COUNTERS["host_syncs"])}


def write_trace(path: str) -> None:
    """Write the spans kept so far (`take_spans()`) and the counters as
    Chrome-trace JSON, which Perfetto and chrome://tracing open: one `X`
    event a span (microseconds; `args` carries its rid, id and parent)
    on its thread, and `C` events for the counters at the end."""
    spans = take_spans()
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
               "tid": s.tid, "args": {"rid": s.rid, "id": s.id,
                                      "parent": s.parent}}
              for s in spans]
    end = max((s.end_ns for s in spans), default=time.time_ns()) / 1e3
    c = counters()
    events.append({"name": "host_syncs", "ph": "C", "ts": end, "pid": pid,
                   "args": c["host_syncs"]})
    events.append({"name": "bytes", "ph": "C", "ts": end, "pid": pid,
                   "args": {k: c[k] for k in ("h2d_bytes", "d2h_bytes")}})
    events.append({"name": "spans_dropped", "ph": "C", "ts": end,
                   "pid": pid, "args": {"spans": c["spans_dropped"]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
