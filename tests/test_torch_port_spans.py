"""The port's spans and host-sync counters (`utils/profiling.py`): off
records nothing, nesting across threads, the bound, the counters, the
Chrome-trace file, the clock against the profiler's, the span tree of
three edit steps (bitwise the same with tracing on and off), a web UI
frame, and on a card the B1 launches inside their `bin.key` spans.

This file imports neither JAX nor the JAX test helpers, so on a GPU
machine without JAX it runs with
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_spans.py
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussianeditor_tpu_torch.apps import launch
from gaussianeditor_tpu_torch.apps.webui import WebUIState, serve
from gaussianeditor_tpu_torch.core.cameras import lookat_camera, orbit_cameras
from gaussianeditor_tpu_torch.edit.edit_system import EditConfig, EditSystem
from gaussianeditor_tpu_torch.guidance.fake import FakeGuidance
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops.render import render
from gaussianeditor_tpu_torch.utils import profiling
from gaussianeditor_tpu_torch.utils.profiling import span, sync


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread, as `tests/torch_port_helpers.py` sets
    it (not imported: the card's machine may hold another `tests`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on for the test, with nothing left over before or after."""
    profiling.take_spans()
    profiling.tracing(True)
    yield
    profiling.tracing(False)
    profiling.take_spans()


def _scene(n, device, seed=0, capacity=None, sh=1):
    rng = np.random.RandomState(seed)
    cap = capacity or n
    k = (sh + 1) ** 2

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    params = dict(
        xyz=pad(rng.uniform(-1, 1, (n, 3))),
        features_dc=pad(rng.randn(n, 1, 3) * 0.5),
        features_rest=pad(rng.randn(n, k - 1, 3) * 0.1),
        opacity_raw=pad(rng.uniform(-1, 3, (n, 1))),
        log_scales=pad(np.log(rng.uniform(0.03, 0.12, (n, 3)))),
        quats=pad(rng.randn(n, 4)),
    )
    return GaussianScene.create(params, max_sh_degree=sh,
                                active_sh_degree=sh,
                                alive=np.arange(cap) < n)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_off_records_nothing():
    profiling.tracing(False)
    profiling.take_spans()
    a, b = span("a"), span("b", rid=3)
    assert a is b
    with a, b:
        pass
    assert profiling.take_spans() == []


def test_nesting_across_threads(traced):
    def work(tag, rid):
        with span(tag + ".outer", rid=rid):
            with span(tag + ".inner"):
                pass

    th = threading.Thread(target=work, args=("t", 9))
    with span("m.outer", rid=5):
        th.start()
        th.join(timeout=30)
        with span("m.inner"):
            pass
    assert not th.is_alive()
    by = {s.name: s for s in profiling.take_spans()}
    assert set(by) == {"m.outer", "m.inner", "t.outer", "t.inner"}
    for tag, rid in (("m", 5), ("t", 9)):
        outer, inner = by[tag + ".outer"], by[tag + ".inner"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.rid == outer.rid == rid
        assert inner.tid == outer.tid and inner.ident == outer.ident
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    assert by["m.outer"].tid == threading.get_native_id()
    assert by["t.outer"].tid != by["m.outer"].tid
    assert by["t.outer"].ident == th.ident & 0xFFFFFFFF


def test_spans_past_the_bound_are_dropped(traced, monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    before = profiling.counters()["spans_dropped"]
    for i in range(5):
        with span(f"s{i}"):
            pass
    assert [s.name for s in profiling.take_spans()] == ["s0", "s1", "s2"]
    assert profiling.counters()["spans_dropped"] - before == 2


@pytest.mark.parametrize("on", [False, True])
def test_sync_counts_whether_tracing_is_on(on):
    profiling.take_spans()
    profiling.tracing(on)
    try:
        before = profiling.counters()
        with sync("probe", 8):
            pass
        with sync("probe"):
            pass
        after = profiling.counters()
        spans = profiling.take_spans()
    finally:
        profiling.tracing(False)
    assert (after["host_syncs"]["probe"]
            - before["host_syncs"].get("probe", 0)) == 2
    assert after["d2h_bytes"] - before["d2h_bytes"] == 8
    assert [s.name for s in spans] == (["sync.probe"] * 2 if on else [])


def test_write_trace_writes_json_that_loads(traced, tmp_path):
    with span("step", rid=4):
        with sync("probe"):
            pass
    path = tmp_path / "trace.json"
    profiling.write_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"step", "sync.probe"}
    assert xs["sync.probe"]["args"]["rid"] == 4
    assert xs["sync.probe"]["args"]["parent"] == xs["step"]["args"]["id"]
    assert xs["step"]["dur"] >= xs["sync.probe"]["dur"] >= 0
    cs = {e["name"]: e["args"] for e in events if e["ph"] == "C"}
    assert cs["host_syncs"]["probe"] >= 1
    assert set(cs) == {"host_syncs", "bytes", "spans_dropped"}
    assert profiling.take_spans() == []


def test_cli_phases_open_spans(traced):
    timer = profiling.StepTimer()
    with launch._timed(timer, "export", torch.device("cpu")):
        pass
    assert [s.name for s in profiling.take_spans()] == ["export"]
    assert timer.summary()["export"]["count"] == 1


def test_a_span_encloses_the_profilers_event(traced):
    a = torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("op"):
            a @ a
    (s,) = profiling.take_spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= s.end_ns


def _edit_system():
    cfg = EditConfig(prompt="p", batch_size=2, max_steps=3,
                     densification_interval=2, densify_until_step=5,
                     densify_grad_threshold=1e-6, cameras_extent=2.0,
                     max_instances=8192, seed=3)
    cams = orbit_cameras(4, 4.0, 0.8, 0.8, 32, 32, device="cpu")
    return EditSystem(_scene(60, "cpu", capacity=96), cams, cfg,
                      guidance=FakeGuidance(), perceptual=None)


def test_edit_steps_span_tree_and_bitwise_repeat():
    runs = {}
    for on in (False, True):
        system = _edit_system()
        system.on_fit_start()
        profiling.take_spans()
        profiling.tracing(on)
        try:
            system.fit(n_steps=3, callback=lambda s, m: None)
        finally:
            profiling.tracing(False)
        runs[on] = (system.state.scene, profiling.take_spans())
    (off, none), (on, spans) = runs[False], runs[True]
    assert none == []
    for k, v in off.named_parameters():
        assert torch.equal(v, dict(on.named_parameters())[k]), k

    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    by_id = {s.id: s for s in spans}
    steps = sorted(by_name["edit.step"], key=lambda s: s.rid)
    assert [s.rid for s in steps] == [0, 1, 2]
    for st in steps:
        kids = _children(spans, st)
        assert kids.count("train.step") == 1
        assert kids.count("edit.targets") == 1
        assert kids.count("edit.callback") == 1
        assert kids.count("train.densify") == (st.rid == 2)
    assert len(by_name["train.optim"]) == 3
    for s in by_name["train.optim"] + by_name["train.backward"]:
        assert by_id[s.parent].name == "train.step"
    # a step's renders: two views, each with its three parts, the
    # binning's parts inside its bin span, and the host read in bin.key
    in_step = [r for r in by_name["render"]
               if by_id[r.parent].name == "train.step"]
    assert len(in_step) == 6
    for r in by_name["render"]:
        assert sorted(_children(spans, r)) == [
            "render.bin", "render.composite", "render.preprocess"]
    for b in by_name["render.bin"]:
        assert _children(spans, b) == ["bin.key", "bin.sort", "bin.gather"]
    for k in by_name["bin.key"]:
        assert _children(spans, k) == ["sync.num_rendered"]
    assert len(by_name["train.loss"]) == 6
    assert len(by_name["composite.backward"]) == 6
    assert len(by_name["sync.densify"]) == 1
    assert all(s.rid == by_id[s.parent].rid for s in spans
               if s.parent is not None)


def test_web_ui_frame_spans(traced):
    state = WebUIState(_scene(60, "cpu", capacity=80),
                       orbit_cameras(4, 4.0, 0.8, 0.8, 48, 48, device="cpu"),
                       cameras_extent=2.0)
    srv = serve(state, port=0, block=False)
    try:
        url = f"http://localhost:{srv.server_address[1]}"
        for _ in range(2):
            with urllib.request.urlopen(
                    url + "/render?theta=0.5&phi=0.2&radius=4&size=48",
                    timeout=60) as r:
                assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.shutdown()
        srv.server_close()
    spans = profiling.take_spans()
    frames = sorted((s for s in spans if s.name == "webui.frame"),
                    key=lambda s: s.start_ns)
    assert len(frames) == 2 and frames[1].rid == frames[0].rid + 1
    for f in frames:
        kids = _children(spans, f)
        assert kids == ["sync.camera", "webui.lock_wait", "webui.render",
                        "webui.png"]
        parts = [s for s in spans if s.parent == f.id]
        assert all(f.start_ns <= p.start_ns <= p.end_ns <= f.end_ns
                   for p in parts)
        assert all(p.rid == f.rid and p.tid == f.tid for p in parts)
    renders = [s for s in spans if s.name == "webui.render"]
    for r in renders:
        assert sorted(_children(spans, r)) == ["render", "sync.frame"]


@pytest.mark.cuda
def test_b1_launches_lie_inside_bin_key_spans(traced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene = _scene(20000, dev, capacity=40000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 256, 256,
                        device=dev)
    with torch.no_grad():
        render(scene, cam)
    torch.cuda.synchronize()
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            for _ in range(3):
                render(scene, cam)
        torch.cuda.synchronize()
    keys = [s for s in profiling.take_spans() if s.name == "bin.key"]
    events = list(prof.profiler.kineto_results.events())
    b1 = {e.correlation_id() for e in events
          if str(e.device_type()).endswith("CUDA")
          and "binning_key" in e.name()}
    launches = [e for e in events if e.correlation_id() in b1
                and not str(e.device_type()).endswith("CUDA")
                and e.name().startswith("cu")]
    assert len(b1) == 3 and len(launches) == 3
    for e in launches:
        t, who = e.start_ns(), e.device_resource_id()
        assert any(k.start_ns <= t <= k.end_ns and who in (k.tid, k.ident)
                   for k in keys)


@pytest.mark.cuda
def test_preprocess_backward_kernel_opens_its_span(traced):
    """On the card the preprocess backward kernel's launch lies in a
    `render.preprocess.backward` span, one per render's backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene = _scene(20000, dev, capacity=40000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 128, 128,
                        device=dev)
    profiling.take_spans()
    for _ in range(2):
        render(scene, cam).color.sum().backward()
    torch.cuda.synchronize()
    spans = [s for s in profiling.take_spans()
             if s.name == "render.preprocess.backward"]
    assert len(spans) == 2

