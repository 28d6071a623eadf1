"""Interactive web UI: view and edit a Gaussian scene over HTTP.

Counterpart of `gaussianeditor_tpu/apps/webui.py` (`WebUIState`,
`make_handler`, `serve`, `main`), a dependency-free stdlib HTTP server
and single-page client in place of the reference's viser WebUI
(`webui.py:90-1570`):

  * live orbit viewer: the client drags to orbit and the server renders
    frames on demand (`render_loop`/`update_viewer`, webui.py:1022-1036);
  * semantic tracing: text prompt -> per-view 2D masks -> apply_weights
    lifting -> per-Gaussian mask, click tracing, named groups, an
    instant threshold and a red-tinted overlay (webui.py:747-797,
    684-745, 890-958);
  * edit and delete trainings with a live loss readout and a stop flag
    (webui.py:1129-1193 / 1038-1126), object insertion (:1195-1475);
  * save to PLY (webui.py:473-477).

Endpoints (JSON unless noted), with the JAX viewer's status codes and
keys:
  GET  /                      HTML client
  GET  /render?theta&phi&radius&size&overlay[&pose&fovx&fovy]  PNG frame
                              (400 for a pose that is not 16 floats)
  GET  /poses?theta&phi&radius&size   training-camera frustum segments
  GET  /status  /config  /groups      training progress, the edit
                                      config, the semantic groups
  GET  /editframe?view                PNG of a view's edited target
                                      (404 before any training)
  POST /trace {prompt, threshold}     /click {view, x, y, threshold, group}
  POST /group {name}                  /threshold {threshold, group?}
  POST /edit {prompt, steps, mode: edit | del, inpaint_prompt}
  POST /add {prompt, bbox, view}      /config {field: value, loss.x: v}
  POST /stop                          /save {path}
  (404 for any other path, 400 for a POST body that is not JSON)

Tracing walks every tile whole (`tile_cap` is ignored, as in the port's
tracing). Training runs on one background thread; the served scene is
never the training state's (see `WebUIState`).

    python -m gaussianeditor_tpu_torch.apps.webui --gs_source scene.ply \
        --colmap_dir workspace [--port 8084] [--device cuda] \
        [--guidance fake | ip2p | controlnet[-<type>]] [--dispatch_burst 1]
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import threading
import traceback
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>gaussianeditor_tpu_torch</title><style>
body{font-family:sans-serif;margin:0;display:flex;background:#181818;color:#eee}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#panel{width:300px;padding:14px;background:#222}
img{max-width:100%;image-rendering:pixelated;cursor:grab}
input,button,select{width:100%;margin:3px 0;padding:5px;box-sizing:border-box}
label{font-size:12px;color:#aaa}#log{font-size:11px;white-space:pre-wrap}
</style></head><body>
<div id=view><div style="position:relative">
<img id=frame><canvas id=fov width=512 height=512
 style="position:absolute;left:0;top:0;pointer-events:none"></canvas>
</div></div>
<div id=panel>
<h3>gaussianeditor_tpu_torch</h3>
<label>semantic prompt</label><input id=segp placeholder="e.g. the bear">
<label>mask threshold (live after a trace)</label>
<input id=thres type=number value=0.5 step=0.1 onchange="rethres()">
<button onclick="trace()">trace mask</button>
<label>semantic group</label><select id=groups onchange="setGroup()"></select>
<label><input id=overlay type=checkbox style="width:auto"> semantic overlay</label>
<label><input id=cams type=checkbox style="width:auto" onchange="refresh()">
 show training cameras</label>
<label>edited-frame view</label><input id=efv type=number value=0>
<button onclick="showFrame()">show edited frame</button>
<hr><label>edit prompt</label><input id=editp placeholder="make it golden">
<label>inpaint prompt (delete)</label><input id=inpp placeholder="background">
<label>steps</label><input id=steps type=number value=400>
<select id=mode><option value=edit>edit</option><option value=del>delete</option></select>
<button onclick="startEdit()">start training</button>
<button onclick="post('/stop',{})">stop</button>
<hr><label>add: prompt + bbox x0,y0,x1,y1 + view</label>
<input id=addp placeholder="a stone statue">
<input id=addb placeholder="128,128,384,384" value="128,128,384,384">
<input id=addv type=number value=0>
<button onclick="startAdd()">add object</button>
<hr><details><summary>training settings</summary>
<label>densify interval</label><input id=c_di type=number value=100>
<label>densify grad threshold</label><input id=c_dg type=number value=0.01 step=0.001>
<label>max densify %</label><input id=c_dp type=number value=0.01 step=0.001>
<label>min opacity</label><input id=c_mo type=number value=0.005 step=0.001>
<label>per-editing step</label><input id=c_pe type=number value=10>
<label>lambda L1</label><input id=c_l1 type=number value=10>
<label>lambda perceptual</label><input id=c_lp type=number value=10>
<label>lambda anchor geo</label><input id=c_ag type=number value=50>
<label>lambda anchor color</label><input id=c_ac type=number value=5>
<button onclick="applyCfg()">apply settings</button></details>
<button onclick="post('/save',{path:'webui_output.ply'})">save ply</button>
<div id=log></div></div>
<script>
let th=0.6, ph=0.3, r=4.0, drag=null;
const img=document.getElementById('frame');
function refresh(){img.src=`/render?theta=${th}&phi=${ph}&radius=${r}&size=512`+
  `&overlay=${document.getElementById('overlay').checked?1:0}&t=${Date.now()}`;
  drawCams();}
async function drawCams(){
  const cv=document.getElementById('fov'),ctx=cv.getContext('2d');
  ctx.clearRect(0,0,cv.width,cv.height);
  if(!document.getElementById('cams').checked)return;
  const d=await (await fetch(`/poses?theta=${th}&phi=${ph}&radius=${r}&size=512`)).json();
  ctx.strokeStyle='#4cf';ctx.fillStyle='#4cf';ctx.font='11px sans-serif';
  for(const f of d.frustums){if(!f.visible)continue;
    ctx.beginPath();
    for(const s of f.segments){ctx.moveTo(s[0],s[1]);ctx.lineTo(s[2],s[3]);}
    ctx.stroke();
    ctx.fillText(String(f.view),f.apex[0]+3,f.apex[1]-3);}}
function rethres(){post('/threshold',
  {threshold:+document.getElementById('thres').value});}
img.onmousedown=e=>{
  if(e.altKey){const rc=img.getBoundingClientRect();
    const sx=(e.clientX-rc.left)/rc.width*512, sy=(e.clientY-rc.top)/rc.height*512;
    post('/click',{view:0,x:sx,y:sy,threshold:+document.getElementById('thres').value});
    e.preventDefault();return;}
  drag=[e.clientX,e.clientY];e.preventDefault()};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;th+=(e.clientX-drag[0])*0.01;
  ph=Math.max(-1.4,Math.min(1.4,ph+(e.clientY-drag[1])*0.01));drag=[e.clientX,e.clientY];refresh();};
img.onwheel=e=>{r=Math.max(0.5,r*(1+e.deltaY*0.001));refresh();e.preventDefault();};
async function post(u,b){const r=await fetch(u,{method:'POST',body:JSON.stringify(b)});
  log(await r.text());refresh();}
function trace(){post('/trace',{prompt:document.getElementById('segp').value,
  threshold:+document.getElementById('thres').value});loadGroups();}
async function loadGroups(){const g=await (await fetch('/groups')).json();
  const sel=document.getElementById('groups');sel.innerHTML='';
  for(const n of g.groups){const o=document.createElement('option');
    o.value=o.textContent=n;if(n===g.active)o.selected=true;sel.appendChild(o);}}
function setGroup(){post('/group',{name:document.getElementById('groups').value});}
function showFrame(){img.src=`/editframe?view=${+document.getElementById('efv').value}`+
  `&t=${Date.now()}`;}
function startEdit(){post('/edit',{prompt:document.getElementById('editp').value,
  steps:+document.getElementById('steps').value,mode:document.getElementById('mode').value,
  inpaint_prompt:document.getElementById('inpp').value});
  poll();}
function startAdd(){const b=document.getElementById('addb').value.split(',').map(Number);
  post('/add',{prompt:document.getElementById('addp').value,bbox:b,
  view:+document.getElementById('addv').value});poll();}
function applyCfg(){const v=id=>+document.getElementById(id).value;
  post('/config',{densification_interval:v('c_di'),densify_grad_threshold:v('c_dg'),
  max_densify_percent:v('c_dp'),min_opacity:v('c_mo'),per_editing_step:v('c_pe'),
  'loss.lambda_l1':v('c_l1'),'loss.lambda_p':v('c_lp'),
  'loss.lambda_anchor_geo':v('c_ag'),'loss.lambda_anchor_color':v('c_ac')});}
async function poll(){const s=await (await fetch('/status')).json();log(JSON.stringify(s));
  refresh(); if(s.training) setTimeout(poll, 1500);}
function log(m){document.getElementById('log').textContent=m;}
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


def scene_image(scene, cam, overlay: bool = False,
                max_instances: Optional[int] = None) -> np.ndarray:
    """A served frame before its PNG encode: the [H, W, 3] float image in
    [0, 1] of `scene` through `cam`, on the host; with `overlay`, the
    pixels where the semantic mask renders above 0.8 are tinted red
    (GassuianEditor.py:183-204)."""
    from gaussianeditor_tpu_torch.ops.render import render

    dev = scene.device
    with torch.no_grad():
        color = render(scene, cam, torch.zeros(3, device=dev),
                       max_instances=max_instances).color
        if overlay:
            m = render(scene, cam, torch.zeros(1, device=dev),
                       override_color=scene.mask[:, None].to(torch.float32),
                       max_instances=max_instances).color[..., 0]
            sel = (m > 0.8)[..., None]
            red = torch.tensor([1.0, 0.0, 0.0], device=dev)
            color = torch.where(sel, 0.5 * color + 0.5 * red, color)
        return torch.clamp(color, 0.0, 1.0).cpu().numpy()


def _scene_tensors(scene):
    return list(scene.parameters()) + list(scene.buffers())


class WebUIState:
    """The served scene, its training cameras, the guidance, segmentation
    and inpainting the editing endpoints call, the named semantic groups
    and the background training run.

    The state owns the scene it is given: tracing, groups and training
    change it in place. `self.scene` is read and written only under
    `self.lock`. A training run never trains it: the system gets a copy
    taken under the lock, and after every whole step the callback copies
    the training state's scene into `self.scene` under the lock
    (`_publish`). So frames, traces, saves and poses always see the scene
    after some whole step, never the train state's tensors while a step
    updates them in place. When the fit returns, `self.scene` becomes
    the system's `scene`, as in the JAX viewer."""

    def __init__(self, scene, cameras, cameras_extent: float,
                 guidance=None, segmentor=None, inpainter=None,
                 edit_config=None, object_generator=None,
                 depth_estimator=None, point_segmentor=None):
        from gaussianeditor_tpu_torch.edit.edit_system import EditConfig

        self.scene = scene
        self.cameras = list(cameras)
        self.cameras_extent = cameras_extent
        self.guidance = guidance
        self.segmentor = segmentor
        self.inpainter = inpainter
        self.object_generator = object_generator
        self.depth_estimator = depth_estimator
        self.point_segmentor = point_segmentor
        self.edit_config = edit_config or EditConfig(
            batch_size=2, cameras_extent=cameras_extent)
        self.lock = threading.Lock()
        self.training = False
        self.stop_flag = False
        self.last_metrics = {}
        self._thread: Optional[threading.Thread] = None
        # named semantic groups (reference webui.py:540-558): each trace
        # stores its mask under its name, and switching groups installs it
        # again (the mask gates the optimizer) without tracing
        self.semantic_masks = {}
        # each group's per-Gaussian normalised weights, on the scene's
        # device: a new threshold re-applies `weights > t` without the
        # apply_weights splat (the reference's thres slider,
        # webui.py:782-793)
        self.semantic_weights = {}
        self.active_group = ""
        # the live training system, for the edited-frame browser
        # (reference edit_frame_show, webui.py:560-566)
        self._active_system = None
        # look-at center from the scene itself
        alive = scene.alive.cpu().numpy()
        xyz = scene.xyz.detach().cpu().numpy()[alive]
        self.center = xyz.mean(axis=0) if len(xyz) else np.zeros(3)

    # --- frames ---

    def _render(self, cam, overlay: bool) -> np.ndarray:
        """`scene_image` of `self.scene`; the caller holds the lock."""
        return scene_image(self.scene, cam, overlay,
                           self.edit_config.max_instances)

    def _orbit_eye(self, theta: float, phi: float, radius: float):
        return self.center + radius * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(phi),
             np.sin(theta) * np.cos(phi)])

    def render_image(self, theta: float, phi: float, radius: float,
                     size: int, overlay: bool, pose=None, fovx: float = 0.8,
                     fovy: float = 0.8) -> np.ndarray:
        """The float image [size, size, 3] of the orbit view (theta, phi,
        radius) around the scene center, or of the camera-to-world `pose`
        (16 floats, a client camera: reference webui.py:799-829)."""
        from gaussianeditor_tpu_torch.core.cameras import Camera, lookat_camera

        dev = self.scene.device
        if pose is not None:
            c2w = np.asarray(pose, np.float64).reshape(4, 4)
            cam = Camera.from_c2w(c2w, fovx, fovy, size, size, device=dev)
        else:
            cam = lookat_camera(self._orbit_eye(theta, phi, radius),
                                self.center, np.array([0.0, 1.0, 0.0]),
                                fovx, fovy, size, size, device=dev)
        with self.lock:
            return self._render(cam, overlay)

    def render_frame(self, theta: float, phi: float, radius: float,
                     size: int, overlay: bool, pose=None, fovx: float = 0.8,
                     fovy: float = 0.8) -> bytes:
        """`render_image` as PNG bytes."""
        img = self.render_image(theta, phi, radius, size, overlay, pose=pose,
                                fovx=fovx, fovy=fovy)
        return encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8))

    # --- semantic tracing and groups ---

    def _store_group(self, name: str, norm: torch.Tensor) -> dict:
        """Record the traced mask and weights as group `name` (the lock
        held) and answer with the selection."""
        self.scene.update_anchor()
        self.semantic_masks[name] = self.scene.mask.clone()
        self.semantic_weights[name] = norm.detach().clone()
        self.active_group = name
        return {"selected": int(self.scene.mask.sum()),
                "total": int(self.scene.n_alive),
                "group": name, "groups": list(self.semantic_masks)}

    def trace(self, prompt: str, threshold: float) -> dict:
        """Text tracing (reference webui.py:747-797): each training view
        rendered, segmented by the segmentor, and lifted with
        `update_mask_from_views` into the scene's mask."""
        if self.segmentor is None:
            return {"error": "no segmentor configured"}
        from gaussianeditor_tpu_torch.edit.tracing import (
            update_mask_from_views,
        )
        from gaussianeditor_tpu_torch.ops.render import render

        cfg = self.edit_config
        masks = []
        for cam in self.cameras:
            with self.lock, torch.no_grad():
                dev = self.scene.device
                frame = render(self.scene, cam, torch.zeros(3, device=dev),
                               max_instances=cfg.max_instances
                               ).color.cpu().numpy()
            masks.append(self.segmentor(frame, prompt))
        with self.lock:
            _, norm = update_mask_from_views(
                self.scene, self.cameras, masks, threshold,
                tile_cap=cfg.tile_cap, chunk=cfg.chunk)
            return self._store_group(prompt, norm)

    def click_trace(self, view: int, x: float, y: float,
                    threshold: float, group: str = "") -> dict:
        """Click-prompt tracing (reference webui.py:890-958) with the point
        segmentor (`FakePointSegmentor` when none is configured)."""
        from gaussianeditor_tpu_torch.edit.tracing import trace_from_click
        from gaussianeditor_tpu_torch.guidance.fake import FakePointSegmentor

        seg = self.point_segmentor or FakePointSegmentor()
        cfg = self.edit_config
        with self.lock:
            _, norm = trace_from_click(
                self.scene, self.cameras, int(view), (float(x), float(y)),
                seg, threshold, tile_cap=cfg.tile_cap, chunk=cfg.chunk)
            return self._store_group(group or f"click@{int(view)}", norm)

    def set_group(self, name: str) -> dict:
        """Install a stored group's mask (and so the optimizer's gradient
        gating) without tracing (reference webui.py:554-558)."""
        if name not in self.semantic_masks:
            return {"error": f"unknown group '{name}'",
                    "groups": list(self.semantic_masks)}
        with self.lock:
            self.scene.set_mask(self.semantic_masks[name])
            self.scene.update_anchor()
            self.active_group = name
            n_sel = int(self.scene.mask.sum())
        return {"group": name, "selected": n_sel,
                "groups": list(self.semantic_masks)}

    def groups(self) -> dict:
        return {"groups": list(self.semantic_masks),
                "active": self.active_group}

    def rethreshold(self, threshold: float, group: str = "") -> dict:
        """Re-threshold a traced group's cached weights, `weights >
        threshold` on alive slots, without the splat or the segmentor."""
        name = group or self.active_group
        if name not in self.semantic_weights:
            return {"error": f"no cached trace weights for '{name}'",
                    "groups": list(self.semantic_weights)}
        with self.lock:
            w = self.semantic_weights[name]
            self.scene.set_mask((w > float(threshold)) & self.scene.alive)
            self.scene.update_anchor()
            self.semantic_masks[name] = self.scene.mask.clone()
            self.active_group = name
            n_sel = int(self.scene.mask.sum())
            total = int(self.scene.n_alive)
        return {"group": name, "threshold": float(threshold),
                "selected": n_sel, "total": total}

    def poses(self, theta: float, phi: float, radius: float,
              size: int, depth: float = 0.0) -> dict:
        """The training cameras' frustums projected into the orbit view
        (theta, phi, radius): 2D line segments per view for the client's
        overlay (the reference's viser frustum gizmos, webui.py:560-566,
        ui_utils.py:9-60), with the server's own camera math."""
        from gaussianeditor_tpu_torch.core.cameras import lookat_camera

        cur = lookat_camera(self._orbit_eye(theta, phi, radius), self.center,
                            np.array([0.0, 1.0, 0.0]), 0.8, 0.8, size, size,
                            device="cpu")
        full_proj = cur.full_proj.numpy()
        if depth <= 0.0:
            depth = 0.12 * float(self.cameras_extent or radius)

        def project(pts):  # [N,3] world -> ([N,2] pixels, [N] front)
            ph = pts @ full_proj[:3, :3].T + full_proj[:3, 3]
            w = pts @ full_proj[3, :3].T + full_proj[3, 3]
            front = w > 1e-3
            w = np.where(front, w, 1.0)
            ndc = ph[:, :2] / w[:, None]
            pix = ((ndc + 1.0) * size - 1.0) * 0.5  # ndc2Pix convention
            return pix, front

        frustums = []
        for i, cam in enumerate(self.cameras):
            c2w = np.linalg.inv(cam.world_view.cpu().numpy())
            tx, ty = float(cam.tan_fovx), float(cam.tan_fovy)
            # apex + 4 image-plane corners at `depth` (+z forward)
            local = np.array([
                [0.0, 0.0, 0.0],
                [-tx * depth, -ty * depth, depth],
                [tx * depth, -ty * depth, depth],
                [tx * depth, ty * depth, depth],
                [-tx * depth, ty * depth, depth],
            ])
            world = local @ c2w[:3, :3].T + c2w[:3, 3]
            pix, front = project(world)
            if not bool(front.all()):
                frustums.append({"view": i, "visible": False,
                                 "segments": []})
                continue
            edges = [(0, 1), (0, 2), (0, 3), (0, 4),
                     (1, 2), (2, 3), (3, 4), (4, 1)]
            segs = [[float(pix[a, 0]), float(pix[a, 1]),
                     float(pix[b, 0]), float(pix[b, 1])] for a, b in edges]
            frustums.append({
                "view": i, "visible": True, "segments": segs,
                "apex": [float(pix[0, 0]), float(pix[0, 1])],
            })
        return {"size": size, "frustums": frustums}

    def edit_frame_png(self, view: int):
        """The training system's edited target for a view (its origin
        render before the view has one); None before any training (the
        reference's edit-frame preview, webui.py:560-566)."""
        sys_ = self._active_system
        if sys_ is None:
            return None
        frame = sys_.edit_frames.get(int(view))
        if frame is None:
            frame = sys_.origin_frames.get(int(view))
        if frame is None:
            return None
        return encode_png((np.clip(frame, 0, 1) * 255).astype(np.uint8))

    def update_config(self, updates: dict) -> dict:
        """Densify, learning-rate, loss, anchor and schedule knobs (the
        reference GUI's sliders, webui.py:224-391): top-level EditConfig
        fields and `loss.*` weights, applied to later trainings."""
        from gaussianeditor_tpu_torch.train.trainer import LossWeights

        cfg = self.edit_config
        loss_updates = {}
        top_updates = {}
        for k, v in updates.items():
            if k.startswith("loss."):
                loss_updates[k[5:]] = v
            else:
                top_updates[k] = v
        bad = [k for k in top_updates
               if k not in {f.name for f in dataclasses.fields(cfg)}]
        bad += [f"loss.{k}" for k in loss_updates
                if k not in {f.name for f in dataclasses.fields(LossWeights)}]
        if bad:
            return {"error": f"unknown config keys: {bad}"}
        loss = (dataclasses.replace(cfg.loss, **loss_updates)
                if loss_updates else cfg.loss)
        with self.lock:
            self.edit_config = dataclasses.replace(
                cfg, loss=loss, **top_updates)
        out = dataclasses.asdict(self.edit_config)
        out["loss"] = {f.name: getattr(self.edit_config.loss, f.name)
                       for f in dataclasses.fields(LossWeights)}
        return out

    # --- background training ---

    def _scene_copy(self):
        with self.lock:
            return copy.deepcopy(self.scene)

    def _publish(self, src) -> None:
        """Copy `src`, the training state's scene after a whole step, into
        the served scene under the lock (a copy of the served scene when
        the run began: densify keeps the capacity, so the shapes agree)."""
        with self.lock, torch.no_grad():
            for dst, new in zip(_scene_tensors(self.scene),
                                _scene_tensors(src)):
                dst.copy_(new)

    def _run_in_thread(self, build_and_fit) -> dict:
        with self.lock:
            if self.training:
                return {"error": "already training"}
            self.training = True
            self.stop_flag = False

        def run():
            try:
                build_and_fit()
            except Exception as e:  # surface errors to /status
                traceback.print_exc()
                with self.lock:
                    self.last_metrics = {"error": f"{type(e).__name__}: {e}"}
            finally:
                self.training = False

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return {"started": True}

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the background run (if any); True once none runs."""
        if self._thread is not None:
            self._thread.join(timeout)
        return not self.training

    def _fit_callbacks(self):
        def cb(step, metrics):
            with self.lock:
                self.last_metrics = {
                    "step": int(step),
                    "loss": float(metrics["loss"]),
                    "loss_l1": float(metrics.get("loss_l1", 0.0)),
                    "loss_p": float(metrics.get("loss_p", 0.0)),
                }

        return cb, (lambda: self.stop_flag)

    def _fit_and_serve(self, system) -> None:
        """`system.fit` with `self.scene` published after every step and
        set to the system's scene at the end."""
        self._active_system = system
        cb, stop = self._fit_callbacks()

        def cb_sync(step, metrics):
            cb(step, metrics)
            self._publish(system.state.scene)

        system.fit(callback=cb_sync, should_stop=stop)
        with self.lock:
            self.scene = system.scene

    def _base_fields(self) -> dict:
        return {f.name: getattr(self.edit_config, f.name)
                for f in dataclasses.fields(self.edit_config)}

    def start_training(self, prompt: str, steps: int, mode: str,
                       inpaint_prompt: str = "") -> dict:
        """Edit or delete training in the background (reference edit(),
        webui.py:1129-1193, delete(), :1038-1126) through the systems'
        `fit`, so the scheduled loss weights, the perceptual term and
        densification apply as in the CLI."""
        if mode == "del":
            if self.inpainter is None or self.segmentor is None:
                return {"error": "delete needs an inpainter and a segmentor"}
            from gaussianeditor_tpu_torch.edit.del_system import (
                DelConfig,
                DelSystem,
            )

            cfg = dataclasses.replace(
                DelConfig(**self._base_fields()),
                seg_prompt=prompt or self.edit_config.seg_prompt,
                inpaint_prompt=inpaint_prompt, max_steps=int(steps))

            def run_del():
                self._fit_and_serve(DelSystem(
                    self._scene_copy(), self.cameras, cfg,
                    inpainter=self.inpainter, segmentor=self.segmentor))

            return {**self._run_in_thread(run_del), "mode": mode,
                    "steps": steps}

        from gaussianeditor_tpu_torch.edit.edit_system import EditSystem

        cfg = dataclasses.replace(self.edit_config, prompt=prompt,
                                  max_steps=int(steps))

        def run_edit():
            self._fit_and_serve(EditSystem(
                self._scene_copy(), self.cameras, cfg,
                guidance=self.guidance, segmentor=self.segmentor))

        return {**self._run_in_thread(run_edit), "mode": mode,
                "steps": steps}

    def start_add(self, prompt: str, bbox, view: int = 0) -> dict:
        """Object insertion in the background (reference add(),
        webui.py:1195-1475): inpaint the bbox, generate the object, place
        it at the aligned depth, concatenate."""
        if self.inpainter is None or self.object_generator is None:
            return {"error": "add needs an inpainter and an object_generator"}
        from gaussianeditor_tpu_torch.edit.add_system import (
            AddConfig,
            AddSystem,
        )

        cfg = dataclasses.replace(
            AddConfig(**self._base_fields()), inpaint_prompt=prompt,
            bbox=tuple(int(v) for v in bbox), anchor_view_id=int(view))

        def run_add():
            merged = AddSystem(
                self._scene_copy(), self.cameras, cfg,
                inpainter=self.inpainter,
                object_generator=self.object_generator,
                depth_estimator=self.depth_estimator,
            ).run()
            with self.lock:
                self.scene = merged
                self.last_metrics = {"added": True,
                                     "n_alive": int(merged.n_alive)}

        return {**self._run_in_thread(run_add), "mode": "add"}

    def save(self, path: str) -> dict:
        from gaussianeditor_tpu_torch.models.ply import save_ply

        with self.lock:
            save_ply(self.scene, path)
        return {"saved": path}


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
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif url.path == "/render":
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
            elif url.path == "/status":
                self._json({"training": state.training, **state.last_metrics})
            elif url.path == "/config":
                self._json(state.update_config({}))
            elif url.path == "/groups":
                self._json(state.groups())
            elif url.path == "/poses":
                self._json(state.poses(
                    float(q.get("theta", [0.6])[0]),
                    float(q.get("phi", [0.3])[0]),
                    float(q.get("radius", [4.0])[0]),
                    int(q.get("size", [512])[0]),
                ))
            elif url.path == "/editframe":
                png = state.edit_frame_png(int(q.get("view", [0])[0]))
                if png is None:
                    return self._json({"error": "no frames yet"}, 404)
                self._send(png, "image/png")
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            url = urlparse(self.path)
            if url.path == "/trace":
                self._json(state.trace(payload.get("prompt", ""),
                                       float(payload.get("threshold", 0.5))))
            elif url.path == "/click":
                self._json(state.click_trace(
                    payload.get("view", 0), payload.get("x", 0),
                    payload.get("y", 0),
                    float(payload.get("threshold", 0.5)),
                    group=payload.get("group", ""),
                ))
            elif url.path == "/group":
                self._json(state.set_group(payload.get("name", "")))
            elif url.path == "/threshold":
                self._json(state.rethreshold(
                    float(payload.get("threshold", 0.5)),
                    group=payload.get("group", ""),
                ))
            elif url.path == "/edit":
                self._json(state.start_training(
                    payload.get("prompt", ""),
                    int(payload.get("steps", 100)),
                    payload.get("mode", "edit"),
                    inpaint_prompt=payload.get("inpaint_prompt", ""),
                ))
            elif url.path == "/add":
                self._json(state.start_add(
                    payload.get("prompt", ""),
                    payload.get("bbox", [0, 0, 0, 0]),
                    int(payload.get("view", 0)),
                ))
            elif url.path == "/config":
                self._json(state.update_config(payload))
            elif url.path == "/stop":
                state.stop_flag = True
                self._json({"stopping": True})
            elif url.path == "/save":
                self._json(state.save(payload.get("path", "webui_output.ply")))
            else:
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


def build_state(gs_source: str, colmap_dir: str, device="cuda",
                size: int = 512, **state_kwargs) -> WebUIState:
    """The viewer's state as `main` builds it: the PLY loaded at 4x its
    vertex count, the COLMAP cameras at size x size (512); `state_kwargs`
    go to `WebUIState` (guidance, segmentor, inpainter, ...)."""
    from gaussianeditor_tpu_torch.data.camera_scene import CamScene
    from gaussianeditor_tpu_torch.models.ply import load_ply, ply_vertex_count

    n_pts = ply_vertex_count(gs_source)
    scene = load_ply(gs_source, capacity=int(n_pts * 4), device=device)
    cams = CamScene(colmap_dir, h=size, w=size, device=device)
    return WebUIState(scene, cams.cameras, cams.cameras_extent,
                      **state_kwargs)


def main(argv=None):
    import argparse

    from gaussianeditor_tpu_torch.apps.launch import (
        build_guidance,
        build_segmentor,
    )
    from gaussianeditor_tpu_torch.guidance.fake import FakeSegmentor

    p = argparse.ArgumentParser()
    p.add_argument("--gs_source", required=True)
    p.add_argument("--colmap_dir", required=True)
    p.add_argument("--port", type=int, default=8084)
    p.add_argument("--device", default="cuda")
    p.add_argument("--guidance", default="fake")
    p.add_argument("--dispatch_burst", type=int, default=1,
                   help="EditConfig.dispatch_burst; the port trains one "
                        "step a call whatever it says (values > 1 warn)")
    args = p.parse_args(argv)

    state = build_state(
        args.gs_source, args.colmap_dir, args.device,
        guidance=build_guidance(args.guidance, {"device": args.device}),
        segmentor=FakeSegmentor() if args.guidance == "fake"
        else build_segmentor("langsam", args.device),
    )
    state.update_config({"dispatch_burst": args.dispatch_burst})
    serve(state, args.port)


if __name__ == "__main__":
    main()
