"""Profiling: step timers, a profiler trace context, a throughput helper.

Counterpart of `gaussianeditor_tpu/utils/profiling.py` (`StepTimer`,
`jax_trace`, `throughput`). `StepTimer` is copied; `torch_trace` takes
the place of `jax_trace` (a `torch.profiler` trace of the host and, where
there is one, the CUDA device, written for TensorBoard); `throughput`
synchronises the device before each clock read, because a PyTorch call
returns before the device has finished.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


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


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """`torch.profiler.profile` over the block, its trace written to
    `log_dir` by `tensorboard_trace_handler`; does nothing when `log_dir`
    is None. The CUDA activity is traced where a device exists."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def throughput(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Calls/sec of `fn(*args)`, the device synchronised before the clock
    starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return iters / (time.perf_counter() - t0)
