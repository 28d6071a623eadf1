"""The program's own spans and counters, read against the profiler's
events.

A `--trace 1` run of `python3 -m benchmark.run` records the program's
spans and counters (`gaussianeditor_tpu_torch/utils/profiling.py`) over
its profiled window (`tracing.profiler`), and `read` gives the run their
`Spans`: the per-layer metrics of the kinds in `KINDS` read it, and
`info` lines on standard error add the share of device time given to a
span, the device's idle time by span, device and elementwise ms by span,
the window's host syncs by site, B1's launches against `bin.key`, and a
web UI frame's parts. `python3 -m benchmark.spans --workload <cell>
--seed <n> --seconds <s>` is that run.

Each device event is given to a program span: the runtime event that
shares its correlation id names the launching thread (by OS thread id,
or by the low 32 bits of the pthread id for a thread whose operators
the profiler did not record: `device_resource_id()`) and the launch's
time; the innermost program span open on that thread at that time takes
it. Autograd runs a CUDA backward on its own device thread, where no
span of the step is open: a launch there, from no span or from one of
`BACKWARD_SPANS` (the compositor's backward, which opens its own), goes
on to the `train.backward` span open at its time.
"""

from __future__ import annotations

import bisect
import heapq
import json
import re
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from benchmark.workload import percentile

BACKWARD = "train.backward"
BACKWARD_SPANS = ("composite.backward", "composite.reduce")
NO_SPAN = "(no span)"
# a frame's parts: the camera's upload, the lock wait, render and PNG
FRAME_PARTS = ("sync.camera", "webui.lock_wait", "webui.render",
               "webui.png")

# the metric kinds, called as `benchmark.run.KINDS` calls its own: with
# the run (its `spans` a `Spans`, or None without a trace) and the
# metric file's parameters; None where there is nothing to read
KINDS = {
    "span_device_ms_per_step": lambda run, m: (
        None if run.spans is None or not run.steps
        else run.spans.device_ms(m["span"]) / run.steps),
    "counter_per_step": lambda run, m: (
        None if run.spans is None or not run.steps
        else run.spans.count(m["counter"]) / run.steps),
    "idle_in_sync_pct": lambda run, m: (
        None if run.spans is None
        else run.spans.idle_in_sync_pct(m["thread_span"])),
    "frame_queue_ms": lambda run, m: (
        None if run.spans is None
        else percentile(run.spans.frame_queue_ms(), m["q"])),
    "span_ms": lambda run, m: (
        None if run.spans is None
        else percentile(run.spans.durations_ms(m["span"]), m["q"])),
}


def elementwise_pattern() -> str:
    """The kernels `elementwise_ms.*` reads, split by span in `info`."""
    path = Path(__file__).resolve().parent / "metrics" / \
        "elementwise_ms.edit.json"
    return json.loads(path.read_text())["pattern"]


def read(run) -> None:
    """Give `run` the `Spans` of its traced window, where its trace
    recorded the program's, and add their readings to `run.info`."""
    program = getattr(run.trace, "program", None)
    if program is None:
        return
    run.spans = Spans(*program, run.trace.events)
    run.info.update(run.spans.info(run.steps, run.latencies_ms))


def main(argv=None) -> int:
    """`python3 -m benchmark.run ... --trace 1`."""
    from benchmark import run

    return run.main(list(sys.argv[1:] if argv is None else argv)
                    + ["--trace", "1"])


class Spans:
    """A window's program spans against its device events."""

    def __init__(self, spans: list, counters: dict, events):
        """`events`: the window's `tracing.Events`."""
        self.spans = list(spans)
        self.counters = counters
        self.by_id = {s.id: s for s in self.spans}
        # per thread key (OS tid and pthread id alike), spans by start
        self.threads: Dict[int, list] = {}
        for s in sorted(self.spans, key=lambda s: s.start_ns):
            for k in {s.tid, s.ident}:
                self.threads.setdefault(k, []).append(s)
        self.starts = {k: [s.start_ns for s in v]
                       for k, v in self.threads.items()}
        self.backward = sorted((s for s in self.spans if s.name == BACKWARD),
                               key=lambda s: s.start_ns)
        self.backward_starts = [s.start_ns for s in self.backward]
        # the window as `tracing.Trace` takes it
        self.t0, self.t1 = events.t0, events.t1
        self.dev: List[Tuple[int, int, str, Optional[tuple], int, int]] = []
        memo: Dict[Optional[int], tuple] = {}
        for a, b, c, name in events.dev:
            ls, key = events.launch.get(c, (None, None))
            chain = None
            if ls is not None:
                chain = self._chain(ls, key, memo)
            self.dev.append((a, b, name, chain,
                             -1 if ls is None else ls,
                             -1 if key is None else key))

    # --- span lookup ---

    def innermost(self, key, t: int):
        """The innermost span open at time t on the thread `key`."""
        spans = self.threads.get(key)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[key], t) - 1
        s = spans[i] if i >= 0 else None
        while s is not None and s.end_ns < t:
            s = self.by_id.get(s.parent)
        return s

    def _names(self, s) -> tuple:
        out = []
        while s is not None:
            out.append(s.name)
            s = self.by_id.get(s.parent)
        return tuple(out)

    def _chain(self, t: int, key, memo: dict) -> tuple:
        """The names of the spans a launch at time t on thread `key` is
        under, innermost first; () for none."""
        s = self.innermost(key, t)
        sid = None if s is None else s.id
        names = memo.get(sid)
        if names is None:
            names = memo[sid] = self._names(s)
        if not names or names[-1] in BACKWARD_SPANS:
            b = self._open_backward(t)
            if b is not None:
                names = names + self._names(b)
        return names

    def _open_backward(self, t: int):
        i = bisect.bisect_right(self.backward_starts, t) - 1
        if i >= 0 and self.backward[i].end_ns >= t:
            return self.backward[i]
        return None

    # --- readings ---

    def device_ms(self, name: str) -> float:
        """Device time (ms) of the events launched under span `name`."""
        return 1e-6 * sum(b - a for a, b, _, ch, _, _ in self.dev
                          if ch and name in ch)

    def count(self, counter: str) -> float:
        v = self.counters.get(counter, 0)
        return float(sum(v.values()) if isinstance(v, dict) else v)

    def durations_ms(self, name: str) -> List[float]:
        return [1e-6 * (s.end_ns - s.start_ns) for s in self.spans
                if s.name == name]

    def busy(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for a, b, *_ in self.dev:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals in the window, as
        `device_idle_pct` counts them."""
        out, prev = [], self.t0
        for a, b in self.busy() + [(self.t1, self.t1)]:
            if a > prev:
                out.append((prev, a))
            prev = max(prev, b)
        return out

    def idle_in_sync_pct(self, thread_span: str) -> Optional[float]:
        """The share of the device's idle time during which the thread
        that runs `thread_span` is inside a `sync.*` span."""
        tids = {s.tid for s in self.spans if s.name == thread_span}
        syncs = sorted((s.start_ns, s.end_ns) for s in self.spans
                       if s.tid in tids and s.name.startswith("sync."))
        gaps = self.gaps()
        idle = sum(b - a for a, b in gaps)
        if not tids or idle <= 0:
            return None
        both, j = 0, 0
        for a, b in gaps:
            while j < len(syncs) and syncs[j][1] <= a:
                j += 1
            k = j
            while k < len(syncs) and syncs[k][0] < b:
                both += max(0, min(b, syncs[k][1]) - max(a, syncs[k][0]))
                k += 1
        return 100.0 * both / idle

    def frame_queue_ms(self) -> List[float]:
        """For each `webui.render` span, the time from the launch of the
        first device work under it to that work's start (ms)."""
        first: Dict[int, list] = {}
        for a, _, _, _, ls, key in self.dev:
            if ls >= 0:
                first.setdefault(key, []).append((ls, a))
        for v in first.values():
            v.sort()
        out = []
        for s in self.spans:
            if s.name != "webui.render":
                continue
            for key in {s.tid, s.ident}:
                lst = first.get(key, [])
                i = bisect.bisect_left(lst, (s.start_ns, -1))
                if i < len(lst) and lst[i][0] <= s.end_ns:
                    out.append(1e-6 * (lst[i][1] - lst[i][0]))
                    break
        return out

    # --- summaries for `info` ---

    def idle_by_span(self) -> list:
        """The window's idle time split by the innermost program span
        open on any thread at each gap's middle: [name, ms], longest
        first, `(no span)` last."""
        by: Dict[str, int] = {}
        # each thread's first start and last end: a gap looks only at the
        # threads whose spans reach it (the web UI's handler threads are
        # one a request)
        reach: Dict[int, list] = {}
        for s in self.spans:
            r = reach.setdefault(s.tid, [s.start_ns, s.end_ns])
            r[0], r[1] = min(r[0], s.start_ns), max(r[1], s.end_ns)
        todo = sorted((a, b, k) for k, (a, b) in reach.items())
        live: List[Tuple[int, int]] = []    # (last end, thread)
        i = 0
        for a, b in self.gaps():
            mid = (a + b) // 2
            while i < len(todo) and todo[i][0] <= mid:
                heapq.heappush(live, (todo[i][1], todo[i][2]))
                i += 1
            while live and live[0][0] < mid:
                heapq.heappop(live)
            inner = [s for s in (self.innermost(k, mid) for _, k in live)
                     if s is not None]
            name = (min(inner, key=lambda s: s.end_ns - s.start_ns).name
                    if inner else NO_SPAN)
            by[name] = by.get(name, 0) + (b - a)
        rest = by.pop(NO_SPAN, 0)
        out = [[n, 1e-6 * v] for n, v in sorted(by.items(),
                                                key=lambda x: -x[1])]
        return out + [[NO_SPAN, 1e-6 * rest]]

    def by_innermost(self, steps: int, pattern: Optional[str] = None,
                     k: int = 12) -> list:
        """Device ms a step by the innermost span it was launched under
        (`(no span)` where none), the `k` largest."""
        rx = re.compile(pattern) if pattern else None
        by: Dict[str, int] = {}
        for a, b, n, ch, _, _ in self.dev:
            if rx is None or rx.search(n):
                name = ch[0] if ch else NO_SPAN
                by[name] = by.get(name, 0) + (b - a)
        return [[n, 1e-6 * v / max(steps, 1)]
                for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def cover_pct(self) -> Optional[float]:
        """The share of the window's summed device-event time that some
        program span was given."""
        total = sum(b - a for a, b, *_ in self.dev)
        if total <= 0:
            return None
        return 100.0 * sum(b - a for a, b, _, ch, _, _ in self.dev
                           if ch) / total

    def b1_in_bin_key(self) -> dict:
        """B1's launches against the `bin.key` span open on their thread:
        how many, how many inside one, and the least margin (ns) from a
        launch to its span's nearer edge."""
        n, inside, margin = 0, 0, None
        for _, _, name, _, ls, key in self.dev:
            if "binning_key" not in name or ls < 0:
                continue
            n += 1
            s = self.innermost(key, ls)
            while s is not None and s.name != "bin.key":
                s = self.by_id.get(s.parent)
            if s is not None:
                inside += 1
                m = min(ls - s.start_ns, s.end_ns - ls)
                margin = m if margin is None else min(margin, m)
        return {"launches": n, "inside": inside, "least_margin_ns": margin}

    def frames(self, latencies_ms: List[float]) -> dict:
        """Web UI frames: the client's latency less the `webui.frame`
        span's duration, and the share of the span its `FRAME_PARTS`
        cover, medians over the window's frames in order."""
        frames = sorted((s for s in self.spans if s.name == "webui.frame"),
                        key=lambda s: s.start_ns)
        if not frames:
            return {}
        parts: Dict[int, int] = {}
        mean: Dict[str, float] = {}
        ids = {f.id for f in frames}
        for s in self.spans:
            if s.parent not in ids:
                continue
            d = s.end_ns - s.start_ns
            mean[s.name] = mean.get(s.name, 0.0) + 1e-6 * d / len(frames)
            if s.name in FRAME_PARTS:
                parts[s.parent] = parts.get(s.parent, 0) + d
        dur = [f.end_ns - f.start_ns for f in frames]
        mean["webui.frame"] = 1e-6 * sum(dur) / len(frames)
        gap = [lat - 1e-6 * d for lat, d in zip(latencies_ms, dur)]
        render = self.durations_ms("webui.render")
        return {
            "frames_traced": len(frames),
            "frame_client_less_span_ms_p50": (statistics.median(gap)
                                              if gap else None),
            "frame_parts_cover_pct_p50": statistics.median(
                100.0 * parts.get(f.id, 0) / max(d, 1)
                for f, d in zip(frames, dur)),
            "frame_render_span_ms_p50": (statistics.median(render)
                                         if render else None),
            "frame_render_device_ms": self.device_ms("webui.render")
            / len(frames),
            "frame_parts_ms_mean": mean,
        }

    def info(self, steps: int, latencies_ms: List[float]) -> dict:
        return {
            "span_cover_pct": self.cover_pct(),
            "idle_by_span": self.idle_by_span(),
            "device_ms_by_span": self.by_innermost(steps),
            "elementwise_ms_by_span": self.by_innermost(
                steps, elementwise_pattern()),
            "host_syncs": self.counters.get("host_syncs", {}),
            "bytes": {k: self.counters.get(k) for k in
                      ("h2d_bytes", "d2h_bytes", "spans_dropped")},
            "b1_in_bin_key": self.b1_in_bin_key(),
            **self.frames(latencies_ms),
        }


if __name__ == "__main__":
    sys.exit(main())
