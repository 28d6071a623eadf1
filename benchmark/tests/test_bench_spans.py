"""The span reader (`benchmark/spans.py`) on hand-made spans and
profiler events: the innermost span on the launching thread, the
autograd-thread rule, the idle time spent in host syncs, a frame's
queue wait, no reading without a trace, and the entry point that runs a
cell with the recorder on over its window."""

import ast
import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import run, spans, tracing, workload
from conftest import (
    AUTOGRAD,
    HANDLER,
    MAIN,
    Ev,
    kernel,
    sp,
    step_events,
    step_spans,
)
from gaussianeditor_tpu_torch.utils import profiling


def test_innermost_span_on_the_launching_thread():
    s = spans.Spans(step_spans(), {}, tracing.Events(step_events()))
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
    s = spans.Spans(step_spans(), {}, tracing.Events(ev))
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
    s = spans.Spans(sps, {}, tracing.Events(ev))
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
    s = spans.Spans(sps, {}, tracing.Events(ev))
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
    d = tracing.counter_delta(before, after)
    assert d["host_syncs"] == {"a": 4, "b": 2} and d["h2d_bytes"] == 20
    s = spans.Spans([], d, tracing.Events([]))
    assert s.count("host_syncs") == 6 and s.count("d2h_bytes") == 8


def bench():
    with open(run.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def span_metrics(cell=None) -> dict:
    """The per-layer metrics of the span kinds: name -> metric file,
    those of `cell` only where one is named."""
    out = {}
    for m in bench()["per_layer"]:
        f = run.load("metrics", m["name"])
        if f["kind"] in spans.KINDS and (cell is None
                                         or cell in m["workloads"]):
            out[m["name"]] = f
    return out


@pytest.mark.parametrize("name", sorted(span_metrics()))
def test_each_new_kind_is_none_without_a_trace(name):
    m = span_metrics()[name]
    r = workload.Run(steps=10, window_s=1.0, latencies_ms=[1.0] * 20)
    assert spans.KINDS[m["kind"]](r, m) is None


def _cpu_card(monkeypatch):
    """`run.main` past its look for a card, the profiler on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setattr(tracing, "activities",
                        lambda: [torch.profiler.ProfilerActivity.CPU])


def _main(argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = argv[0](argv[1:])
    line = out.getvalue().strip().splitlines()
    return rc, (json.loads(line[-1]) if line else None), err.getvalue()


def _driver_with_spans(cell):
    """A driver whose window runs two steps of program spans on the CPU
    through `workload.timed`, with a host sync before the window that
    the window does not count."""
    r = workload.Run(setup_s=1.0, latencies_ms=[1.0])
    r.checks = {k: 0.0 for k in cell.limits}
    with profiling.sync("setup"):
        pass

    def body(deadline):
        for step in range(2):
            with profiling.span("edit.step", rid=step):
                with profiling.span("train.optim"):
                    torch.ones(8).add_(1)
                with profiling.sync("x"):
                    pass
        return 2

    workload.timed(dataclasses.replace(cell, device=torch.device("cpu")), r,
                   body)
    return r


def test_main_reads_the_window_spans(monkeypatch):
    _cpu_card(monkeypatch)
    monkeypatch.setitem(workload.DRIVERS, "edit", _driver_with_spans)
    rc, line, err = _main([spans.main, "--workload", "edit1m", "--seed",
                           "1"])
    assert rc == 0
    assert line["correct"] is True and "breakdown" in line
    info = {k: v for k, _, v in (
        ln[len("info "):].partition(": ") for ln in
        err.splitlines() if ln.startswith("info "))}
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["host_syncs_per_step.edit"] == 1.0
    assert got["adam_ms.edit"] == 0.0          # no device on the CPU
    assert ast.literal_eval(info["host_syncs"]) == {"x": 2}
    # the recorder is off again
    assert profiling.take_spans() == [] and not profiling._on


@pytest.mark.parametrize("trace", [0, 1])
def test_the_recorder_is_on_in_traced_windows_only(monkeypatch, trace):
    _cpu_card(monkeypatch)
    monkeypatch.setitem(workload.DRIVERS, "edit", _driver_with_spans)
    calls = []
    plain = profiling.tracing
    monkeypatch.setattr(profiling, "tracing",
                        lambda on=True: calls.append(on) or plain(on))
    rc, line, _ = _main([run.main, "--workload", "edit1m", "--seed", "1",
                         "--trace", str(trace)])
    assert rc == 0 and line["correct"] is True
    assert calls == ([True, False] if trace else [])


class _FakeTrace:
    """The hand-made window of `conftest.step_spans` as a trace."""
    busy_s, window_s, kernels = 0.5, 1.0, 40

    def __init__(self):
        self.events = tracing.Events(step_events())
        self.program = (step_spans(), {"host_syncs": {"num_rendered": 3}})

    def seconds(self, pattern):
        return 0.01

    def top_ops(self):
        return [["k", 0.5]]

    def idle_gaps(self):
        return [["aten::item", 0.1]]


def test_the_result_line_carries_the_cells_span_metrics(monkeypatch):
    _cpu_card(monkeypatch)

    def fake(cell):
        r = workload.Run(setup_s=1.0, window_s=2.0, steps=3, attempted=3,
                         trace=_FakeTrace())
        r.checks = {k: 0.0 for k in cell.limits}
        return r

    monkeypatch.setitem(workload.DRIVERS, "edit", fake)
    rc, line, _ = _main([run.main, "--workload", "edit1m", "--seed", "1",
                         "--trace", "1"])
    assert rc == 0
    want = span_metrics("edit1m")
    assert want and set(want) <= set(line["metrics"])
    s = spans.Spans(step_spans(), {}, tracing.Events(step_events()))
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["adam_ms.edit"] == pytest.approx(s.device_ms("train.optim")
                                                / 3)
    assert got["sorted_bin_ms.edit"] == pytest.approx(
        s.device_ms("render.bin") / 3)
    assert got["host_syncs_per_step.edit"] == 1.0
    assert got["idle_in_sync_pct.edit"] == s.idle_in_sync_pct("edit.step")
    assert not set(line["metrics"]) & set(span_metrics("garden-late"))
