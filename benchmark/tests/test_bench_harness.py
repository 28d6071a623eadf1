"""The harness: files found by name, the extension modules of
`benchmark/ext/`, the result line's keys, no result without a card, and
the metric kinds."""

import io
import json
import shutil
import sys
import textwrap
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import counts, ext, run, tracing, workload
from conftest import step_events, step_spans

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    b = bench()
    for w in b["workloads"]:
        entry, cfg, traffic, cell = run.cell_files(b, w["name"])
        assert callable(workload.driver(traffic["driver"]))
        assert cell["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        f = run.load("metrics", m["name"])
        assert callable(run.kind(f["kind"]))
        if "count" in f:
            assert callable(counts.kernel(f["count"]))
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()


EXT = """
    from benchmark import workload

    def unet(w):
        return 2.0 * w["pixels"] / 989e12     # fp16 tensor-core FLOP/s

    def drive(cell):
        r = workload.Run(setup_s=1.0, window_s=2.0, steps=4, attempted=4,
                         extra_least_s=1e-3, work=[dict(
                             n=100, tiles=4, visible=30, last_slot=40,
                             alive=50, pairs=1000, contrib=200, sum_nc=700,
                             pixels=4096, height=64, width=64)])
        r.checks = {k: 0.0 for k in cell.limits}
        r.info["refreshes"] = 2
        return r

    DRIVERS = {"ip2p-refresh": drive}
    KINDS = {"refreshes_per_step": lambda run, m: (
        run.info["refreshes"] / run.steps)}
    KERNELS = {"unet": unet}
"""


@pytest.fixture
def ext_dir(tmp_path, monkeypatch):
    """`benchmark/ext/` as a fresh directory under `tmp_path`, loaded
    anew; the modules written there leave no trace after the test."""
    d = tmp_path / "ext"
    d.mkdir()
    monkeypatch.setattr(ext, "__path__", [str(d)])
    ext.load.cache_clear()
    before = set(sys.modules)
    yield d
    ext.load.cache_clear()
    for k in set(sys.modules) - before:
        if k.startswith("benchmark.ext."):
            del sys.modules[k]


def test_a_new_cell_is_files_only(tmp_path, ext_dir):
    """A cell whose configuration, traffic, limits, metrics, driver,
    metric kind and kernel count are all new files: a recon cell of an
    existing driver, and an edit cell whose driver, kind and count live
    only in a module of `benchmark/ext/`."""
    for kind in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(BENCH / kind, tmp_path / kind)
    (tmp_path / "traffic" / "recon-early.json").write_text(
        json.dumps({"driver": "recon", "start_step": 501}))
    (tmp_path / "cells" / "garden-early.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-3}}))
    (tmp_path / "metrics" / "step_p50_ms.recon.json").write_text(
        json.dumps({"kind": "percentile", "q": 50}))
    (ext_dir / "ip2p.py").write_text(textwrap.dedent(EXT))
    (tmp_path / "configs" / "edit-ip2p-1m.json").write_text(
        json.dumps({"name": "edit-ip2p-1m"}))
    (tmp_path / "traffic" / "edit-refresh.json").write_text(
        json.dumps({"driver": "ip2p-refresh"}))
    (tmp_path / "cells" / "ip2p1m.json").write_text(
        json.dumps({"limits": {"unet_gap": 1e-3}}))
    for name, f in {"refreshes_per_step": {"kind": "refreshes_per_step"},
                    "unet_roofline.ip2p": {"kind": "roofline",
                                           "pattern": "unet",
                                           "count": "unet"},
                    "ip2p_step_mfu": {"kind": "mfu"}}.items():
        (tmp_path / "metrics" / f"{name}.json").write_text(json.dumps(f))
    b = bench()
    b["workloads"] += [
        {"name": "garden-early", "config": "recon-garden",
         "traffic": "recon-early", "chips": 1, "why": "x"},
        {"name": "ip2p1m", "config": "edit-ip2p-1m",
         "traffic": "edit-refresh", "chips": 1, "why": "x"}]
    b["per_layer"] += [
        {"name": "step_p50_ms.recon", "unit": "ms",
         "workloads": ["garden-early"]},
        {"name": "refreshes_per_step", "unit": "1/step",
         "workloads": ["ip2p1m"]},
        {"name": "unet_roofline.ip2p", "unit": "%", "workloads": ["ip2p1m"]},
        {"name": "ip2p_step_mfu", "unit": "%", "workloads": ["ip2p1m"]}]
    entry, cfg, traffic, cell = run.cell_files(b, "garden-early", tmp_path)
    assert traffic["start_step"] == 501 and cfg["name"] == "recon-garden"
    names = [m["name"] for m in run.metrics_of(b, "garden-early", True)]
    assert names == ["step_p50_ms.recon"]
    m = run.load("metrics", "step_p50_ms.recon", tmp_path)
    r = workload.Run(latencies_ms=[3.0, 1.0, 2.0])
    assert run.kind(m["kind"])(r, m) == 2.0

    entry, cfg, traffic, cellf = run.cell_files(b, "ip2p1m", tmp_path)
    metrics = run.resolve(b, "ip2p1m", True, tmp_path)
    r = workload.driver(traffic["driver"])(workload.Cell(
        name="ip2p1m", cfg=cfg, traffic=traffic, limits=cellf["limits"],
        seed=1, seconds=2.0, trace=True, device=torch.device("cpu"),
        t_start=0.0))
    r.trace = _FakeTrace()
    assert run.judge(r, cellf["limits"]) == (
        True, {"unet_gap": {"value": 0.0, "limit": 1e-3}})
    got = {k: v["value"] for k, v in run.values(metrics, r).items()}
    unet = 2.0 * 4096 / 989e12
    step = counts.step_least_s(r.work, 1, "lpips", False) + 1e-3
    assert got == {
        "refreshes_per_step": 0.5,
        "unet_roofline.ip2p": pytest.approx(100.0 * unet / (0.01 / 4)),
        "ip2p_step_mfu": pytest.approx(100.0 * step / (2.0 / 4))}


@pytest.mark.parametrize("where", ["two modules", "a module and the harness"])
def test_a_name_defined_twice_fails_at_load(ext_dir, where):
    (ext_dir / "a.py").write_text('KINDS = {"twice": lambda run, m: 1.0}\n')
    if where == "two modules":
        (ext_dir / "b.py").write_text(
            'KINDS = {"twice": lambda run, m: 2.0}\n')
    else:
        (ext_dir / "b.py").write_text('DRIVERS = {"edit": print}\n')
    with pytest.raises(ValueError, match="twice" if where == "two modules"
                       else "edit"):
        run.kind("twice")
        workload.driver("edit")


def test_an_unknown_driver_exits_with_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delitem(workload.DRIVERS, "edit")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "edit1m", "--seed", "1"])
    assert rc != 0 and out.getvalue() == ""
    assert "'edit'" in err.getvalue() and "'recon'" in err.getvalue()


def _mfu_run(**over):
    return workload.Run(window_s=2.0, steps=10, views_per_step=2,
                        work=_fake_driver_work(), **over)


def test_extra_least_s_at_its_default_leaves_the_mfu_as_it_was():
    r = _mfu_run()
    least = counts.step_least_s(r.work, 2, "lpips", False)
    assert r.extra_least_s == 0.0
    assert run.KINDS["mfu"](r, {}) == 100.0 * least / 0.2


def test_extra_least_s_adds_its_share_to_the_mfu():
    plain = run.KINDS["mfu"](_mfu_run(), {})
    r = _mfu_run(extra_least_s=0.05)
    assert run.KINDS["mfu"](r, {}) == pytest.approx(
        plain + 100.0 * 0.05 / 0.2)


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

    def __init__(self):
        # the program's spans, for the per-layer metrics read from them
        self.events = tracing.Events(step_events())
        self.program = (step_spans(), {"host_syncs": {"num_rendered": 3}})

    def seconds(self, pattern):
        return 0.01

    def top_ops(self):
        return [["k", 0.5]]

    def idle_gaps(self):
        return [["aten::item", 0.1]]


def _fake_driver_work():
    return [dict(n=100, tiles=4, visible=30, last_slot=40, alive=50,
                 pairs=1000, contrib=200, sum_nc=700, pixels=4096,
                 height=64, width=64)]


def _fake_driver(cell):
    r = workload.Run(setup_s=1.5, window_s=2.0, steps=10, attempted=10,
                     latencies_ms=[5.0] * 20, memory_peak=123,
                     views_per_step=2, work=_fake_driver_work())
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
    assert workload.percentile(v, 90) == 90
    assert workload.percentile(v, 50) == 50
