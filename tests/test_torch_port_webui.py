"""The port's viewer over real HTTP on the CPU, and its frames against the
JAX viewer's for the same scene and view."""

import io
import json
import urllib.error
import urllib.request

import imageio.v2 as imageio
import numpy as np
import pytest

from gaussianeditor_tpu.apps.webui import WebUIState as JWebUIState
from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.edit.edit_system import EditConfig
from gaussianeditor_tpu_torch.apps.webui import WebUIState, encode_png, serve
from gaussianeditor_tpu_torch.core.cameras import orbit_cameras
from tests.helpers import random_scene
from tests.torch_port_helpers import one_torch_thread, port_scene  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def viewer():
    js = random_scene(80, seed=0, capacity=120)
    js = js.set_mask(js.alive & (np.arange(120) % 2 == 0))
    state = WebUIState(port_scene(js),
                       orbit_cameras(4, 4.0, 0.8, 0.8, 48, 48, device="cpu"),
                       cameras_extent=2.0)
    srv = serve(state, port=0, block=False)  # a free port
    yield f"http://localhost:{srv.server_address[1]}", state, js
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def decode_png(data):
    return imageio.imread(io.BytesIO(data))


def _code(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    return e.value.code


@pytest.mark.parametrize("kind", ["noise", "flat"])
def test_encode_png_is_lossless(kind):
    rng = np.random.RandomState(3)
    img = (rng.randint(0, 256, (37, 53, 3)) if kind == "noise"
           else np.full((37, 53, 3), 200)).astype(np.uint8)
    png = encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(png), img)


def test_index_and_render_sizes(viewer):
    url, _, _ = viewer
    body, ctype = _get(url + "/")
    assert "text/html" in ctype and b"<html>" in body
    for size in (48, 64):
        png, ctype = _get(url + f"/render?theta=0.5&phi=0.2&radius=4"
                          f"&size={size}")
        assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        img = decode_png(png)
        assert img.dtype == np.uint8
        assert img.shape == (size, size, 3) and img.max() > 0


def test_pose_overlay_and_errors(viewer):
    url, _, _ = viewer
    c2w = np.array([[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, -4],
                    [0, 0, 0, 1]], np.float64)
    pose = ",".join(str(v) for v in c2w.reshape(-1))
    png, _ = _get(url + f"/render?size=48&pose={pose}&fovx=0.8&fovy=0.8")
    assert decode_png(png).shape == (48, 48, 3)
    plain = decode_png(_get(url + "/render?theta=0&phi=0&size=48")[0])
    over = decode_png(_get(url + "/render?theta=0&phi=0&size=48&overlay=1")[0])
    assert (over != plain).any()  # the masked half is tinted red
    assert _code(url + "/render?size=48&pose=1,2,3") == 400
    for path in ("/status", "/poses", "/editframe", "/config", "/nope"):
        assert _code(url + path) == 404
    for path in ("/trace", "/edit", "/save", "/stop"):
        assert _code(url + path, data=json.dumps({}).encode()) == 404


@pytest.mark.parametrize("overlay", [False, True])
def test_frames_match_jax_viewer(viewer, overlay):
    _, state, js = viewer
    jstate = JWebUIState(js, jorbit_cameras(4, 4.0, 0.8, 0.8, 48, 48),
                         cameras_extent=2.0,
                         edit_config=EditConfig(batch_size=2,
                                                cameras_extent=2.0))
    np.testing.assert_allclose(state.center, jstate.center, rtol=1e-6)
    got = decode_png(state.render_frame(0.7, 0.25, 4.0, 64, overlay))
    want = decode_png(jstate.render_frame(0.7, 0.25, 4.0, 64, overlay))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert np.mean(diff <= 2) >= 0.995, diff.max()
