"""The trace reader: `torch.profiler` over the measured window, read as
plain intervals.

Device events (kernels, copies, fills) give the busy time (the union of
their intervals), kernel time by name pattern and the kernel count; host
events name what the host was doing in the device's longest idle gaps.
The events are read from the profiler's raw results, not from its
`key_averages()`, which builds an object per event and takes minutes on
a window of a few hundred thousand launches.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


def profiler():
    """A profiler of host and device activity, started by `with`."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Trace:
    """The intervals of one profiled window, in seconds from its start."""

    def __init__(self, prof):
        dev, host, kernels = [], [], 0
        for e in prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                name = e.name()
                dev.append((s, s + d, name))
                if not name.startswith(("Memcpy", "Memset", "[memory]")):
                    kernels += 1
            elif d > 0:
                host.append((s, s + d, e.name()))
        t0 = min([x[0] for x in dev + host], default=0)
        t1 = max([x[1] for x in dev + host], default=0)
        self.window_s = (t1 - t0) * 1e-9
        self.dev = sorted(((a - t0) * 1e-9, (b - t0) * 1e-9, n)
                          for a, b, n in dev)
        self.host = [((a - t0) * 1e-9, (b - t0) * 1e-9, n)
                     for a, b, n in host]
        self.kernels = kernels

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
        return sum(b - a for a, b, n in self.dev if rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for a, b, n in self.dev:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n[:120], s] for n, s in
                sorted(by.items(), key=lambda x: -x[1])[:k]]

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
