"""The harness: files found by name, the result line's keys, no result
without a card, and the metric kinds."""

import io
import json
import shutil
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import run, tracing, workload

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    b = bench()
    for w in b["workloads"]:
        entry, cfg, traffic, cell = run.cell_files(b, w["name"])
        assert traffic["driver"] in workload.DRIVERS
        assert cell["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert run.load("metrics", m["name"])["kind"] in run.KINDS
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()


def test_a_new_cell_is_files_only(tmp_path):
    for kind in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(BENCH / kind, tmp_path / kind)
    (tmp_path / "traffic" / "recon-early.json").write_text(
        json.dumps({"driver": "recon", "start_step": 501}))
    (tmp_path / "cells" / "garden-early.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-3}}))
    (tmp_path / "metrics" / "step_p50_ms.recon.json").write_text(
        json.dumps({"kind": "percentile", "q": 50}))
    b = bench()
    b["workloads"].append({"name": "garden-early", "config": "recon-garden",
                           "traffic": "recon-early", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "step_p50_ms.recon", "unit": "ms",
                           "workloads": ["garden-early"]})
    entry, cfg, traffic, cell = run.cell_files(b, "garden-early", tmp_path)
    assert traffic["start_step"] == 501 and cfg["name"] == "recon-garden"
    names = [m["name"] for m in run.metrics_of(b, "garden-early", True)]
    assert names == ["step_p50_ms.recon"]
    m = run.load("metrics", "step_p50_ms.recon", tmp_path)
    r = workload.Run(latencies_ms=[3.0, 1.0, 2.0])
    assert run.KINDS[m["kind"]](r, m) == 2.0


def test_cells_report_their_metrics():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in run.metrics_of(b, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(b, w["name"], True)


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "edit1m", "--seed", "1"])
    assert rc != 0 and out.getvalue() == ""


class _FakeTrace:
    busy_s, window_s, kernels = 0.5, 1.0, 40

    def seconds(self, pattern):
        return 0.01

    def top_ops(self):
        return [["k", 0.5]]

    def idle_gaps(self):
        return [["aten::item", 0.1]]


def _fake_driver(cell):
    r = workload.Run(setup_s=1.5, window_s=2.0, steps=10, attempted=10,
                     latencies_ms=[5.0] * 20, memory_peak=123,
                     views_per_step=2,
                     work=[dict(n=100, tiles=4, visible=30, last_slot=40,
                                alive=50, pairs=1000, contrib=200,
                                sum_nc=700, pixels=4096, height=64,
                                width=64)])
    r.checks = {k: 0.0 for k in cell.limits}
    if cell.trace:
        r.trace = _FakeTrace()
    return r


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setitem(workload.DRIVERS, "edit", _fake_driver)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "edit1m", "--seed", "1",
                       "--trace", str(trace)])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["checks"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert ("busy_s" in line["device"]) == bool(trace)
    names = {m["name"] for m in run.metrics_of(bench(), "edit1m", trace)}
    assert set(line["metrics"]) == names
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")


def test_a_number_over_its_limit_is_not_correct():
    r = workload.Run(checks={"a": 2.0, "b": 0.0})
    assert run.judge(r, {"a": 1.0, "b": 1.0})[0] is False
    assert run.judge(r, {"a": 3.0, "b": 1.0})[0] is True
    assert run.judge(workload.Run(), {"a": 1.0})[0] is False
    assert run.judge(workload.Run(), {"a": 1.0}, ["a"])[0] is True
    assert run.judge(r, {"a": 1.0}, ["a"])[0] is False


def test_trace_reader_on_the_cpu():
    with tracing.profiler() as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    t = tracing.Trace(prof)
    assert t.busy_s == 0 and t.window_s > 0
    assert t.idle_gaps()[0][1] == pytest.approx(t.window_s)


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert run.percentile(v, 90) == 90 and run.percentile(v, 50) == 50
