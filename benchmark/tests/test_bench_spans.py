"""The span reader (`benchmark/spans.py`) on hand-made spans and
profiler events: the innermost span on the launching thread, the
autograd-thread rule, the idle time spent in host syncs, a frame's
queue wait, no reading without a trace, and the entry point that runs a
cell with the recorder on over its window."""

import ast
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import spans, tracing, workload
from gaussianeditor_tpu_torch.utils import profiling
from gaussianeditor_tpu_torch.utils.profiling import Span

MAIN, IDENT, AUTOGRAD, HANDLER = 100, 0x7F00AA, 101, 0xA79FF6C0


class Ev:
    """A `_KinetoEvent` stand-in."""

    def __init__(self, name, start, dur, dev, corr, key):
        self._v = (name, start, dur, dev, corr, key)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def kernel(name, launch_at, key, start, dur, corr):
    """A runtime launch on thread `key` and the device work it starts."""
    return [Ev("cudaLaunchKernel", launch_at, 5, False, corr, key),
            Ev(name, start, dur, True, corr, 7)]


def sp(name, start, end, id, parent=None, tid=MAIN, ident=IDENT, rid=0):
    return Span(name, start, end, id, parent, tid, ident, rid)


def step_spans():
    return [
        sp("edit.step", 0, 1000, 1),
        sp("train.step", 10, 900, 2, 1),
        sp("render", 20, 200, 3, 2),
        sp("render.bin", 50, 150, 4, 3),
        sp("sync.num_rendered", 60, 100, 5, 4),
        sp("train.backward", 300, 600, 6, 2),
        sp("composite.backward", 350, 380, 7, None, AUTOGRAD, 0x99),
        sp("train.optim", 650, 850, 8, 2),
        sp("bin.key", 105, 145, 9, 4),
    ]


def test_innermost_span_on_the_launching_thread():
    ev = (kernel("binning_key_kernel", 120, MAIN, 130, 10, 1)
          + kernel("adam", 700, IDENT, 710, 30, 2)     # by pthread id
          + kernel("fill", 205, MAIN, 210, 4, 3)        # render has ended
          + kernel("other_thread", 120, 555, 220, 6, 4)
          + [Ev("Memset", 900, 2, True, 99, 7)])        # no launch seen
    s = spans.Spans(step_spans(), {}, ev)
    assert s.device_ms("render.bin") == pytest.approx(10e-6)
    assert s.device_ms("render") == pytest.approx(10e-6)
    assert s.device_ms("train.optim") == pytest.approx(30e-6)
    assert s.device_ms("train.step") == pytest.approx(44e-6)
    assert s.device_ms("edit.step") == pytest.approx(44e-6)
    assert s.cover_pct() == pytest.approx(100.0 * 44 / 52)
    assert [n for n, _ in s.by_innermost(1)] == [
        "train.optim", "bin.key", "(no span)", "train.step"]
    assert s.b1_in_bin_key() == {"launches": 1, "inside": 1,
                                 "least_margin_ns": 15}


def test_autograd_thread_launches_go_to_the_open_backward():
    ev = (kernel("mul_backward", 320, AUTOGRAD, 330, 8, 1)
          + kernel("backward_tile_kernel", 360, 0x99, 370, 20, 2)
          + kernel("late", 650, AUTOGRAD, 655, 3, 3))   # backward ended
    s = spans.Spans(step_spans(), {}, ev)
    assert s.device_ms("train.backward") == pytest.approx(28e-6)
    assert s.device_ms("composite.backward") == pytest.approx(20e-6)
    assert s.device_ms("edit.step") == pytest.approx(28e-6)
    assert s.device_ms("train.optim") == 0.0
    assert s.cover_pct() == pytest.approx(100.0 * 28 / 31)


def test_idle_in_sync_pct_on_hand_made_gaps():
    # busy [0, 40) and [100, 200): idle [40, 100) and [200, 250), the
    # window ending at a host event; the step's thread syncs in [60, 130)
    ev = (kernel("a", 0, MAIN, 0, 40, 1) + kernel("b", 90, MAIN, 100, 100, 2)
          + [Ev("aten::copy_", 240, 10, False, 0, MAIN)])
    sps = [sp("edit.step", 0, 250, 1), sp("sync.x", 60, 130, 2, 1),
           sp("sync.y", 0, 300, 3, None, tid=HANDLER, ident=HANDLER)]
    s = spans.Spans(sps, {}, ev)
    assert (s.t0, s.t1) == (0, 250)
    assert s.gaps() == [(40, 100), (200, 250)]
    assert s.idle_in_sync_pct("edit.step") == pytest.approx(100.0 * 40 / 110)
    assert s.idle_in_sync_pct("recon.step") is None
    assert s.idle_by_span() == [["sync.x", pytest.approx(60e-6)],
                                ["edit.step", pytest.approx(50e-6)],
                                ["(no span)", 0.0]]


def test_frame_queue_wait():
    sps = [sp("webui.frame", 0, 1000, 1, tid=300, ident=HANDLER, rid=4),
           sp("sync.camera", 2, 10, 6, 1, 300, HANDLER),
           sp("webui.lock_wait", 10, 100, 2, 1, 300, HANDLER),
           sp("webui.render", 100, 700, 3, 1, 300, HANDLER),
           sp("webui.png", 700, 990, 4, 1, 300, HANDLER),
           sp("edit.step", 0, 2000, 5)]
    signed = HANDLER - (1 << 32)    # the profiler's int32 of the pthread id
    ev = (kernel("step_work", 110, MAIN, 115, 400, 1)
          + kernel("preprocess", 150, signed, 515, 10, 2)
          + kernel("b2", 160, signed, 530, 10, 3))
    s = spans.Spans(sps, {}, ev)
    assert s.frame_queue_ms() == [pytest.approx(365e-6)]
    assert s.durations_ms("webui.lock_wait") == [pytest.approx(90e-6)]
    info = s.frames([0.0012])
    assert info["frame_client_less_span_ms_p50"] == pytest.approx(2e-4)
    assert info["frame_parts_cover_pct_p50"] == pytest.approx(98.8)
    assert info["frame_parts_ms_mean"]["webui.png"] == pytest.approx(29e-5)


def test_counters_over_the_window():
    before = {"host_syncs": {"a": 3}, "h2d_bytes": 10, "d2h_bytes": 0,
              "spans_dropped": 0}
    after = {"host_syncs": {"a": 7, "b": 2}, "h2d_bytes": 30,
             "d2h_bytes": 8, "spans_dropped": 0}
    d = spans.counter_delta(before, after)
    assert d["host_syncs"] == {"a": 4, "b": 2} and d["h2d_bytes"] == 20
    s = spans.Spans([], d, [])
    assert s.count("host_syncs") == 6 and s.count("d2h_bytes") == 8


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_each_new_kind_is_none_without_a_trace(name):
    m = spans.METRICS[name]
    r = workload.Run(steps=10, window_s=1.0, latencies_ms=[1.0] * 20)
    assert spans.KINDS[m["kind"]](r, m) is None


def _driver_with_spans(cell):
    """A driver whose window runs two steps of program spans on the CPU,
    with a host sync before the window that the window does not count."""
    r = workload.Run(setup_s=1.0, steps=2, attempted=2, latencies_ms=[1.0])
    r.checks = {k: 0.0 for k in cell.limits}
    with profiling.sync("setup"):
        pass
    with tracing.profiler() as prof:
        for step in range(2):
            with profiling.span("edit.step", rid=step):
                with profiling.span("train.optim"):
                    torch.ones(8).add_(1)
                with profiling.sync("x"):
                    pass
    r.trace = tracing.Trace(prof)
    return r


def test_main_reads_the_window_spans(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setitem(workload.DRIVERS, "edit", _driver_with_spans)
    # the host's profiler alone: there is no card behind is_available
    monkeypatch.setattr(tracing, "profiler", lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    plain = tracing.profiler
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = spans.main(["--workload", "edit1m", "--seed", "1"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and "breakdown" in line
    info = {k: v for k, _, v in (
        ln[len("info "):].partition(": ") for ln in
        err.getvalue().splitlines() if ln.startswith("info "))}
    got = ast.literal_eval(info["span_metrics"])
    assert set(got) == {n for n, m in spans.METRICS.items()
                        if m["cell"] == "edit1m"}
    assert got["host_syncs_per_step.edit"] == 1.0
    assert got["adam_ms.edit"] == 0.0          # no device on the CPU
    assert ast.literal_eval(info["host_syncs"]) == {"x": 2}
    # the recorder is off and the harness as it was
    assert profiling.take_spans() == []
    assert tracing.profiler is plain
    assert workload.DRIVERS["edit"] is _driver_with_spans
