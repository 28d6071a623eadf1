"""The trace reader: `torch.profiler` over the measured window, read as
plain intervals, with the program's span recorder on over the same
window.

Device events (kernels, copies, fills) give the busy time (the union of
their intervals), kernel time by name pattern and the kernel count; host
events name what the host was doing in the device's longest idle gaps.
The events are read once (`Events`), from the profiler's raw results,
not from its `key_averages()`, which builds an object per event and
takes minutes on a window of a few hundred thousand launches; `Trace`
and `spans.Spans` share what was read.

The program's spans and counters (`gaussianeditor_tpu_torch/utils/
profiling.py`) are recorded over the profiled window only: `profiler`
switches the recorder on as it starts and off as it ends, and leaves the
window's spans and the counters' change on the profiler, for `Trace` to
keep and `spans.read` to read. Untraced runs never switch it on.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gaussianeditor_tpu_torch.utils import profiling


def counter_delta(before: dict, after: dict) -> dict:
    """`after` less `before`, site by site for `host_syncs`."""
    out = {k: after[k] - before.get(k, 0) for k in after
           if k != "host_syncs"}
    hs = {k: v - before["host_syncs"].get(k, 0)
          for k, v in after["host_syncs"].items()}
    out["host_syncs"] = {k: v for k, v in hs.items() if v}
    return out


def activities() -> list:
    """What the profiler records: the host, and the card where there is
    one."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiler():
    """A profiler of host and device activity, started by `with`, with
    the program's span recorder on inside it. On exit the profiler
    carries `program`: the window's spans and the counters' change."""
    acts = activities()
    profiling.take_spans()
    before = profiling.counters()
    profiling.tracing(True)
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        profiling.tracing(False)
    prof.program = (profiling.take_spans(),
                    counter_delta(before, profiling.counters()))


def _key(e) -> Optional[int]:
    """The launching thread of a runtime event: its OS thread id, or the
    low 32 bits of its pthread id, which the profiler gives as a signed
    32-bit number."""
    f = getattr(e, "device_resource_id", None)
    return None if f is None else int(f()) & 0xFFFFFFFF


class Events:
    """A window's profiler events, read once, in nanoseconds of the
    profiler's clock: `dev`, the device's (start, end, correlation id,
    name) by start; `host`, the host's (start, end, name) that last;
    `launch`, each runtime call's (`cu...`) correlation id -> (start,
    launching thread); the window's `t0` and `t1`; and `kernels`, the
    device events that are kernels (not copies or fills)."""

    def __init__(self, events):
        dev, host, launch, kernels = [], [], {}, 0
        for e in events:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append((s, s + d, e.correlation_id(), name))
                if not name.startswith(("Memcpy", "Memset", "[memory]")):
                    kernels += 1
                continue
            if d > 0:
                host.append((s, s + d, name))
            if name.startswith("cu"):
                launch[e.correlation_id()] = (s, _key(e))
        dev.sort()
        self.dev, self.host, self.launch, self.kernels = dev, host, launch, \
            kernels
        self.t0 = min([x[0] for x in dev] + [x[0] for x in host], default=0)
        self.t1 = max([x[1] for x in dev] + [x[1] for x in host], default=0)


class Trace:
    """The intervals of one profiled window, in seconds from its start;
    `events`, the window's `Events`, and `program`, its spans and
    counters (None from a profiler that did not record them), for
    `spans.Spans`."""

    def __init__(self, prof):
        ev = self.events = Events(prof.profiler.kineto_results.events())
        self.program = getattr(prof, "program", None)
        t0 = ev.t0
        self.window_s = (ev.t1 - t0) * 1e-9
        self.dev = [((a - t0) * 1e-9, (b - t0) * 1e-9, n)
                    for a, b, _, n in ev.dev]
        self.host = [((a - t0) * 1e-9, (b - t0) * 1e-9, n)
                     for a, b, n in ev.host]
        self.kernels = ev.kernels
        # device seconds by event name: a pattern is tried once a name
        self.by_name: Dict[str, float] = {}
        for a, b, n in self.dev:
            self.by_name[n] = self.by_name.get(n, 0.0) + (b - a)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, in order."""
        out: List[Tuple[float, float]] = []
        for a, b, _ in self.dev:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def seconds(self, pattern: str) -> float:
        """Device time of the events whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(v for n, v in self.by_name.items() if rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        return [[n[:120], s] for n, s in
                sorted(self.by_name.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The `k` longest device idle gaps, each named by the innermost
        host event that spans its middle."""
        gaps, prev = [], 0.0
        for a, b in self.busy() + [(self.window_s, self.window_s)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            inner: Optional[tuple] = None
            for h in self.host:
                if h[0] <= mid <= h[1] and (inner is None or
                                            h[1] - h[0] < inner[1] - inner[0]):
                    inner = h
            out.append([inner[2][:120] if inner else "(no host event)",
                        b - a])
        return out
