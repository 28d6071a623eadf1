"""Web viewer: an HTTP server that renders frames of a scene on demand.

Counterpart of the viewer part of `gaussianeditor_tpu/apps/webui.py`:
`WebUIState` (scene center, `_renderer`, `render_frame` with an orbit
view or a client c2w `pose`, `fovx`/`fovy`, and the red semantic overlay
from a 1-channel mask render), `GET /`, `GET /render` (400 for a pose
that is not 16 floats), `serve` and `main`, which loads the scene at 4x
capacity. The editing endpoints of the JAX viewer (trace, click, group,
threshold, edit, add, config, editframe, stop, save, status, poses)
answer 404 until their slices are ported.

    python -m gaussianeditor_tpu_torch.apps.webui --gs_source scene.ply \
        --colmap_dir workspace [--port 8084] [--device cuda]
"""

from __future__ import annotations

import io
import json
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>gaussianeditor_tpu_torch viewer</title><style>
body{font-family:sans-serif;margin:0;display:flex;background:#181818;color:#eee}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#panel{width:240px;padding:14px;background:#222}
img{max-width:100%;image-rendering:pixelated;cursor:grab}
label{font-size:12px;color:#aaa}
</style></head><body>
<div id=view><img id=frame></div>
<div id=panel><h3>gaussianeditor_tpu_torch</h3>
<label><input id=overlay type=checkbox onchange="refresh()"> semantic overlay</label>
<p><label>drag to orbit, wheel to zoom</label></p></div>
<script>
let th=0.6, ph=0.3, r=4.0, drag=null;
const img=document.getElementById('frame');
function refresh(){img.src=`/render?theta=${th}&phi=${ph}&radius=${r}&size=512`+
  `&overlay=${document.getElementById('overlay').checked?1:0}&t=${Date.now()}`;}
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault()};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;th+=(e.clientX-drag[0])*0.01;
  ph=Math.max(-1.4,Math.min(1.4,ph+(e.clientY-drag[1])*0.01));drag=[e.clientX,e.clientY];refresh();};
img.onwheel=e=>{r=Math.max(0.5,r*(1+e.deltaY*0.001));refresh();e.preventDefault();};
refresh();
</script></body></html>"""


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes, through Pillow (the PNG writer that
    the JAX viewer reaches through imageio), with zlib's run-length
    strategy: still lossless, and much cheaper than Pillow's default
    strategy on rendered frames (PERF.md)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", compress_type=zlib.Z_RLE)
    return buf.getvalue()


class WebUIState:
    """The served scene and its training cameras. Frames are rendered at
    the budget `default_max_instances` of the scene's capacity, as in the
    JAX viewer."""

    def __init__(self, scene, cameras, cameras_extent: float):
        self.scene = scene
        self.cameras = list(cameras)
        self.cameras_extent = cameras_extent
        self.lock = threading.Lock()
        # look-at center from the scene itself
        alive = scene.alive.cpu().numpy()
        xyz = scene.xyz.detach().cpu().numpy()[alive]
        self.center = xyz.mean(axis=0) if len(xyz) else np.zeros(3)

    def _render(self, cam, overlay: bool) -> np.ndarray:
        """[H, W, 3] float image in [0, 1], on the host."""
        from gaussianeditor_tpu_torch.ops.render import render

        scene = self.scene
        dev = scene.device
        with torch.no_grad():
            color = render(scene, cam, torch.zeros(3, device=dev)).color
            if overlay:
                # red-tinted semantic overlay of the edit mask
                m = render(scene, cam, torch.zeros(1, device=dev),
                           override_color=scene.mask[:, None].to(torch.float32)
                           ).color[..., 0]
                sel = (m > 0.8)[..., None]
                red = torch.tensor([1.0, 0.0, 0.0], device=dev)
                color = torch.where(sel, 0.5 * color + 0.5 * red, color)
            return torch.clamp(color, 0.0, 1.0).cpu().numpy()

    def render_frame(self, theta: float, phi: float, radius: float,
                     size: int, overlay: bool, pose=None, fovx: float = 0.8,
                     fovy: float = 0.8) -> bytes:
        """PNG of the orbit view (theta, phi, radius) around the scene
        center, or of the camera-to-world `pose` (16 floats)."""
        from gaussianeditor_tpu_torch.core.cameras import Camera, lookat_camera

        dev = self.scene.device
        if pose is not None:
            c2w = np.asarray(pose, np.float64).reshape(4, 4)
            cam = Camera.from_c2w(c2w, fovx, fovy, size, size, device=dev)
        else:
            eye = self.center + radius * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(phi),
                 np.sin(theta) * np.cos(phi)]
            )
            cam = lookat_camera(eye, self.center, np.array([0.0, 1.0, 0.0]),
                                fovx, fovy, size, size, device=dev)
        with self.lock:
            img = self._render(cam, overlay)
        return encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8))


def make_handler(state: WebUIState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif url.path == "/render":
                q = parse_qs(url.query)
                pose = None
                if "pose" in q:
                    vals = [float(v) for v in q["pose"][0].split(",")]
                    if len(vals) != 16:
                        return self._json(
                            {"error": "pose must be 16 floats (c2w)"}, 400)
                    pose = vals
                png = state.render_frame(
                    float(q.get("theta", [0.6])[0]),
                    float(q.get("phi", [0.3])[0]),
                    float(q.get("radius", [4.0])[0]),
                    int(q.get("size", [512])[0]),
                    q.get("overlay", ["0"])[0] == "1",
                    pose=pose,
                    fovx=float(q.get("fovx", [0.8])[0]),
                    fovy=float(q.get("fovy", [0.8])[0]),
                )
                self._send(png, "image/png")
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            self._json({"error": "not found"}, 404)

    return Handler


def serve(state: WebUIState, port: int = 8084,
          block: bool = True) -> ThreadingHTTPServer:
    """Serve `state` on `port` (0 picks a free one: read
    `server.server_address`). With block=False the server runs on a
    daemon thread; stop it with `shutdown()` and `server_close()`."""
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    if block:
        print(f"webui on http://localhost:{server.server_address[1]}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_state(gs_source: str, colmap_dir: str, device="cuda") -> WebUIState:
    """The viewer's state as `main` builds it: the PLY loaded at 4x its
    vertex count, the COLMAP cameras at 512x512."""
    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count

    n_pts = ply_vertex_count(gs_source)
    scene = load_ply(gs_source, capacity=int(n_pts * 4), device=device)
    cams = CamScene(colmap_dir, h=512, w=512, device=device)
    return WebUIState(scene, cams.cameras, cams.cameras_extent)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--gs_source", required=True)
    p.add_argument("--colmap_dir", required=True)
    p.add_argument("--port", type=int, default=8084)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    serve(build_state(args.gs_source, args.colmap_dir, args.device), args.port)


if __name__ == "__main__":
    main()
