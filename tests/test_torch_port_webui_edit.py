"""Port vs JAX: the web UI's editing endpoints over real HTTP.

The port's viewer and the JAX `WebUIState` hold the same tiny scene, the
same orbit cameras, the same edit config, a segmentor that selects the
left or the right half of each view (so both packages trace from the
same 2D masks) and a point segmentor that selects every pixel. Traced
masks and counts must agree but on Gaussians whose normalised weight
lies within rounding of the threshold (the tracing tests' rule); a new
threshold re-applies the cached weights without the splat; groups
switch the mask; `/poses` segments agree to 1e-4 px and `/config` is
equal as JSON; status codes agree on every endpoint. `/edit`, `/stop`,
`/save`, delete and `/add` run as `tests/test_webui.py` runs them on the
JAX viewer. Frames taken while a fit runs must each be a render of the
scene after some whole step, and the served scene never shares storage
with the training state's.

Every HTTP call has a timeout, and every training thread is joined (with
a timeout) before its test returns.
"""

import copy
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gaussianeditor_tpu.apps.webui import WebUIState as JWebUIState
from gaussianeditor_tpu.apps.webui import serve as jserve
from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit.edit_system import EditConfig as JEditConfig
from gaussianeditor_tpu.guidance import fake as jfake
from gaussianeditor_tpu_torch import testing
from gaussianeditor_tpu_torch.apps.webui import WebUIState, serve
from gaussianeditor_tpu_torch.core.cameras import lookat_c2w, orbit_cameras
from gaussianeditor_tpu_torch.edit.edit_system import EditConfig
from gaussianeditor_tpu_torch.guidance import fake
from gaussianeditor_tpu_torch.models.ply import load_ply
from tests.helpers import random_scene
from tests.torch_port_helpers import one_torch_thread, port_scene  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HW = 48
N, CAP = 60, 90
TIMEOUT = 300
CFG = dict(batch_size=2, cameras_extent=2.0, densify_until_step=0,
           max_instances=8192, tile_cap=256, chunk=32)


def half_segmentor(img, prompt):
    """The left (prompt 'left') or the right half of the view."""
    m = np.zeros(img.shape[:2], np.float32)
    w = img.shape[1] // 2
    if prompt == "left":
        m[:, :w] = 1.0
    else:
        m[:, w:] = 1.0
    return m


def _states(seed=0):
    js = random_scene(N, seed=seed, capacity=CAP)
    state = WebUIState(
        port_scene(js), orbit_cameras(4, 4.0, 0.8, 0.8, HW, HW, device="cpu"),
        cameras_extent=2.0, guidance=fake.FakeGuidance(),
        segmentor=half_segmentor, inpainter=fake.FakeInpainter(),
        object_generator=fake.FakeObjectGenerator(n_points=30, device="cpu"),
        edit_config=EditConfig(**CFG),
        point_segmentor=fake.FakePointSegmentor(radius=2.0))
    jstate = JWebUIState(
        js, jorbit_cameras(4, 4.0, 0.8, 0.8, HW, HW), cameras_extent=2.0,
        guidance=jfake.FakeGuidance(), segmentor=half_segmentor,
        inpainter=jfake.FakeInpainter(),
        object_generator=jfake.FakeObjectGenerator(n_points=30),
        edit_config=JEditConfig(**CFG),
        point_segmentor=jfake.FakePointSegmentor(radius=2.0))
    return state, jstate


@pytest.fixture(scope="module")
def servers():
    state, jstate = _states()
    srv, jsrv = serve(state, port=0, block=False), jserve(jstate, port=0,
                                                          block=False)
    yield (f"http://localhost:{srv.server_address[1]}", state,
           f"http://localhost:{jsrv.server_address[1]}", jstate)
    state.stop_flag = True
    assert state.join(TIMEOUT)
    for s in (srv, jsrv):
        s.shutdown()
        s.server_close()


def _call(url, payload=None, raw=None):
    """(status code, body) of a GET (no payload) or a POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, payload):
    code, body = _call(url, payload)
    assert code == 200, (code, body)
    return json.loads(body)


def _get_json(url):
    code, body = _call(url)
    assert code == 200, (code, body)
    return json.loads(body)


def _near(jw, thres):
    """Gaussians whose JAX weight is within rounding of the threshold."""
    return np.abs(np.asarray(jw) - thres) <= 1e-6


def _assert_masks_agree(mask, jmask, jweights, thres):
    mask, jmask = mask.cpu().numpy(), np.asarray(jmask)
    near = _near(jweights, thres)
    np.testing.assert_array_equal(mask[~near], jmask[~near])
    assert abs(int(mask.sum()) - int(jmask.sum())) <= int(near.sum())


def test_endpoint_codes_match_jax(servers):
    url, _, jurl, _ = servers
    requests = [("/", None, None), ("/render?size=48", None, None),
                ("/render?size=48&pose=1,2,3", None, None),
                ("/status", None, None), ("/config", None, None),
                ("/groups", None, None),
                ("/poses?theta=0.6&phi=0.3&radius=4&size=64", None, None),
                ("/editframe?view=0", None, None), ("/nope", None, None),
                ("/nope", {}, None), ("/trace", None, b"not json"),
                ("/threshold", {"threshold": 0.5}, None),
                ("/group", {"name": "nope"}, None)]
    for path, payload, raw in requests:
        code, body = _call(url + path, payload, raw)
        jcode, jbody = _call(jurl + path, payload, raw)
        assert code == jcode, (path, code, jcode)
        if jbody[:1] == b"{":
            assert json.loads(body).keys() == json.loads(jbody).keys(), path
    assert _get_json(url + "/status") == {"training": False}
    assert _call(url + "/editframe?view=0")[0] == 404   # no training yet


def test_trace_groups_and_threshold_match_jax(servers, monkeypatch):
    url, state, _, jstate = servers
    for prompt in ("left", "right"):
        out = _post(url + "/trace", {"prompt": prompt, "threshold": 0.5})
        jout = jstate.trace(prompt, 0.5)
        assert {k: out[k] for k in ("group", "groups", "total")} == \
            {k: jout[k] for k in ("group", "groups", "total")}
        _assert_masks_agree(state.semantic_masks[prompt],
                            jstate.semantic_masks[prompt],
                            jstate.semantic_weights[prompt], 0.5)
        assert torch.equal(state.scene.mask, state.semantic_masks[prompt])
        assert abs(out["selected"] - jout["selected"]) <= int(
            _near(jstate.semantic_weights[prompt], 0.5).sum())
    assert _get_json(url + "/groups") == jstate.groups() == {
        "groups": ["left", "right"], "active": "right"}
    masks = {k: v.clone() for k, v in state.semantic_masks.items()}
    assert not torch.equal(masks["left"], masks["right"])
    for name in ("left", "right", "left"):
        out = _post(url + "/group", {"name": name})
        assert out == {**jstate.set_group(name),
                       "selected": int(masks[name].sum())}
        assert torch.equal(state.scene.mask, masks[name])

    # a new threshold: no render, no splat, no segmentor
    def refuse(*a, **k):
        raise AssertionError("re-thresholding must not render or splat")

    from gaussianeditor_tpu_torch.edit import tracing
    from gaussianeditor_tpu_torch.ops import apply_weights, render

    monkeypatch.setattr(render, "render", refuse)
    monkeypatch.setattr(apply_weights, "apply_weights", refuse)
    monkeypatch.setattr(tracing, "apply_weights", refuse)
    monkeypatch.setattr(state, "segmentor", None)
    w, jw = state.semantic_weights["left"], jstate.semantic_weights["left"]
    for t in (0.3, 0.7, -1.0, 1e9):
        out = _post(url + "/threshold", {"threshold": t})
        jout = jstate.rethreshold(t)
        assert out.keys() == jout.keys() and out["group"] == "left"
        want = (w > t) & state.scene.alive
        assert torch.equal(state.scene.mask, want)
        assert torch.equal(state.semantic_masks["left"], want)
        assert out["selected"] == int(want.sum())
        _assert_masks_agree(state.scene.mask, jstate.scene.mask, jw, t)
    assert out["selected"] == 0 and jout["selected"] == 0
    bad = _post(url + "/threshold", {"threshold": 0.5, "group": "nope"})
    assert bad == jstate.rethreshold(0.5, group="nope")


def test_click_matches_jax(servers):
    url, state, _, jstate = servers
    out = _post(url + "/click", {"view": 0, "x": 24, "y": 24,
                                 "threshold": 0.5, "group": "my object"})
    jout = jstate.click_trace(0, 24, 24, 0.5, group="my object")
    assert out["group"] == jout["group"] == "my object"
    assert out["groups"] == jout["groups"] and out["total"] == jout["total"]
    _assert_masks_agree(state.scene.mask, jstate.scene.mask,
                        jstate.semantic_weights["my object"], 0.5)
    assert 0 < out["selected"] < out["total"]
    assert "my object" in _get_json(url + "/groups")["groups"]
    out = _post(url + "/click", {"view": 1, "x": 30, "y": 20})
    assert out["group"] == "click@1"


@pytest.mark.parametrize("view", ["0.6,0.3,4,64", "2.2,-0.2,3.5,96"])
def test_poses_match_jax(servers, view):
    url, _, _, jstate = servers
    th, ph, r, size = view.split(",")
    got = _get_json(url + f"/poses?theta={th}&phi={ph}&radius={r}"
                    f"&size={size}")
    want = jstate.poses(float(th), float(ph), float(r), int(size))
    assert got["size"] == want["size"] == int(size)
    assert len(got["frustums"]) == len(want["frustums"]) == 4
    assert any(f["visible"] for f in got["frustums"])
    for f, jf in zip(got["frustums"], want["frustums"]):
        assert (f["view"], f["visible"]) == (jf["view"], jf["visible"])
        np.testing.assert_allclose(f["segments"], jf["segments"], atol=1e-4)
        if f["visible"]:
            assert len(f["segments"]) == 8
            np.testing.assert_allclose(f["apex"], jf["apex"], atol=1e-4)


def test_config_matches_jax(servers):
    url, state, _, jstate = servers
    upd = {"densification_interval": 55, "loss.lambda_p": 3.5}
    out = _post(url + "/config", upd)
    assert out == json.loads(json.dumps(jstate.update_config(upd)))
    assert out["densification_interval"] == 55
    assert out["loss"]["lambda_p"] == 3.5
    assert state.edit_config.densification_interval == 55
    bad = {"no_such_knob": 1, "loss.nope": 2}
    assert _post(url + "/config", bad) == jstate.update_config(bad)
    assert _get_json(url + "/config") == json.loads(
        json.dumps(jstate.update_config({})))


def _wait_idle(state):
    assert state.join(TIMEOUT), "training did not finish"


def test_edit_stop_save_and_editframe(servers, tmp_path):
    from PIL import Image

    url, state, _, _ = servers
    out = _post(url + "/edit", {"prompt": "bluer", "steps": 6,
                                "mode": "edit"})
    assert out == {"started": True, "mode": "edit", "steps": 6}
    _wait_idle(state)
    st = _get_json(url + "/status")
    assert st["training"] is False and st["step"] == 5
    assert np.isfinite(st["loss"])
    code, png = _call(url + "/editframe?view=0")
    assert code == 200 and png[:4] == b"\x89PNG"
    import io

    assert np.asarray(Image.open(io.BytesIO(png))).shape == (HW, HW, 3)
    out = _post(url + "/save", {"path": str(tmp_path / "webui.ply")})
    assert out["saved"].endswith("webui.ply")
    loaded = load_ply(out["saved"], device="cpu")
    assert int(loaded.n_alive) == N
    alive = state.scene.alive
    assert torch.equal(loaded.xyz, state.scene.xyz[alive].detach())

    # a long run, stopped: it ends within a step of the request
    prev = state.last_metrics   # the first run's, until a step ends
    _post(url + "/edit", {"prompt": "x", "steps": 500, "mode": "edit"})
    busy = _post(url + "/edit", {"prompt": "x", "steps": 5, "mode": "edit"})
    assert busy["error"] == "already training"
    import time

    deadline = time.monotonic() + TIMEOUT
    while state.last_metrics is prev or state.last_metrics["step"] < 1:
        assert time.monotonic() < deadline and state.training
        time.sleep(0.01)
    k = _get_json(url + "/status")["step"]
    assert _post(url + "/stop", {}) == {"stopping": True}
    _wait_idle(state)
    st = _get_json(url + "/status")
    assert st["training"] is False and k <= st["step"] <= k + 2 < 499


def test_delete_and_add(servers):
    url, state, _, _ = servers
    n0 = int(state.scene.n_alive)
    out = _post(url + "/edit", {"prompt": "left", "steps": 4, "mode": "del",
                                "inpaint_prompt": "background"})
    assert out == {"started": True, "mode": "del", "steps": 4}
    _wait_idle(state)
    st = _get_json(url + "/status")
    assert "error" not in st and st["step"] == 3
    n1 = int(state.scene.n_alive)
    assert 0 < n1 < n0   # the traced half was pruned
    out = _post(url + "/add", {"prompt": "a cube", "bbox": [8, 8, 40, 40],
                               "view": 0})
    assert out == {"started": True, "mode": "add"}
    _wait_idle(state)
    st = _get_json(url + "/status")
    assert st == {"training": False, "added": True, "n_alive": n1 + 30}
    assert int(state.scene.n_alive) == n1 + 30


def test_served_frames_are_whole_steps():
    """Frames taken while a fit runs are each bitwise a render of the scene
    after some whole step, in step order; the served scene never shares
    storage with the training state's scene; after the fit it is the
    scene of the same fit run in process."""
    state, _ = _states(seed=1)
    pose = [float(v) for v in lookat_c2w((0.0, 0.5, -4.0), (0.0, 0.0, 0.0),
                                         (0.0, 1.0, 0.0)).reshape(-1)]
    scene0 = copy.deepcopy(state.scene)
    frames, shared = testing.watch_served_fit(state, pose, HW, steps=8)
    assert shared == 0, "the served scene shared the train state's storage"
    cfg = dataclasses.replace(state.edit_config, prompt="p", max_steps=8)
    want, system = testing.whole_step_frames(
        scene0, state.cameras, cfg, pose, HW, fake.FakeGuidance(),
        half_segmentor)
    assert len(frames) >= 2 and not np.array_equal(want[0], want[-1])
    idx = [testing.whole_step_index(f, want) for f in frames]
    assert min(idx) >= 0, f"frames not of a whole step: {idx}"
    assert idx == sorted(idx), idx
    served = list(state.scene.parameters()) + list(state.scene.buffers())
    fitted = list(system.scene.parameters()) + list(system.scene.buffers())
    for a, b in zip(served, fitted):
        assert torch.equal(a, b)


@pytest.mark.parametrize("args,want", [
    (["--device", "cpu", "--dispatch_burst", "3"], "fake"),
    (["--device", "cpu", "--guidance", "ip2p"], ImportError),
    (["--device", "cuda"], RuntimeError),
], ids=["fake_cpu", "ip2p_without_diffusers", "cuda_without_a_card"])
def test_main_flags(tmp_path, monkeypatch, args, want):
    """`main` builds the JAX viewer's guidance and segmentor by name and
    sets `dispatch_burst`; the diffusers names raise the JAX ImportError
    without diffusers, and a CUDA device that is missing raises (no
    fallback to the CPU)."""
    from gaussianeditor_tpu_torch.apps import webui
    from gaussianeditor_tpu_torch.models.ply import save_ply
    from tests.test_data_config import _make_workspace

    if want is RuntimeError and torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device exists")
    ply = str(tmp_path / "scene.ply")
    save_ply(port_scene(random_scene(20, seed=2)), ply)
    ws = _make_workspace(str(tmp_path / "ws"))
    served = []
    monkeypatch.setattr(webui, "serve", lambda state, port: served.append(
        (state, port)))
    argv = ["--gs_source", ply, "--colmap_dir", ws, "--port", "0"] + args
    if want != "fake":
        with pytest.raises(want):
            webui.main(argv)
        assert not served
        return
    webui.main(argv)
    (state, port), = served
    assert port == 0 and state.scene.capacity == 80
    assert isinstance(state.guidance, fake.FakeGuidance)
    assert isinstance(state.segmentor, fake.FakeSegmentor)
    assert state.edit_config.dispatch_burst == 3
    assert state.edit_config.cameras_extent == state.cameras_extent
    assert (state.cameras[0].height, state.cameras[0].width) == (512, 512)
