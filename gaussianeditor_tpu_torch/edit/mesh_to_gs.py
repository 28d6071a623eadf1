"""Mesh -> Gaussians, and the appearance fit (train_from_mesh).

Counterpart of `gaussianeditor_tpu/edit/mesh_to_gs.py` (the reference's
`train_from_mesh.py:43-232`, the third stage of the Add pipeline,
GassuianEditorAdd.py:144-157): OBJ loading and area-weighted surface
sampling (numpy, copied), Gaussians initialised on the sampled surface
(with the vertex colours when there are any), refinement with a guidance
on orbit views through the Edit system, and, for colorless meshes, a
photometric fit of the Gaussians' appearance to renders of the mesh by a
small numpy z-buffer rasterizer (`render_mesh_lambertian`, copied).

The fit runs on the scene's device through the train step; it trains the
scene it is given in place. It runs one train step per call:
`dispatch_burst > 1` (the JAX package's multi-step device programs,
`make_multi_train_step`, which is not ported) warns and runs the same
per-step loop.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from gaussianeditor_tpu_torch.models.gaussians import GaussianScene


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Minimal OBJ loader: vertices [V,3], faces [F,3] (triangulated),
    per-vertex colors [V,3] when present (xyzrgb vertex lines)."""
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                vals = [float(x) for x in line.split()[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    colors.append(vals[3:6])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    c = np.asarray(colors, np.float32) if len(colors) == len(verts) else None
    return v, f, c


def sample_mesh_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    n_samples: int,
    vert_colors: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface sampling with barycentric color
    interpolation (the `sample_surface_even` role, utils/mesh.py:31-48)."""
    rng = np.random.RandomState(seed)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=n_samples, p=probs)
    u = rng.rand(n_samples, 1)
    v = rng.rand(n_samples, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    pts = w * a[fidx] + u * b[fidx] + v * c[fidx]
    if vert_colors is not None:
        cols = (w * vert_colors[faces[fidx, 0]]
                + u * vert_colors[faces[fidx, 1]]
                + v * vert_colors[faces[fidx, 2]])
    else:
        cols = np.full((n_samples, 3), 0.5, np.float32)
    return pts.astype(np.float32), np.clip(cols, 0, 1).astype(np.float32)


def mesh_to_gaussians(
    mesh_path: str,
    n_samples: int = 200_000,
    max_sh_degree: int = 0,
    capacity: Optional[int] = None,
    seed: int = 0,
    device="cuda",
) -> GaussianScene:
    """OBJ mesh -> GaussianScene on `device` (train_from_mesh.py:68-81's
    initialisation: 200k surface samples, scales from 3-NN distances)."""
    verts, faces, colors = load_obj(mesh_path)
    if len(faces) == 0:
        raise ValueError(f"{mesh_path}: no faces")
    pts, cols = sample_mesh_surface(verts, faces, n_samples, colors, seed)
    return GaussianScene.from_points(
        pts, cols, max_sh_degree=max_sh_degree, capacity=capacity,
        device=device)


def _orbit_around(points: np.ndarray, n_views: int, radius_scale: float,
                  hw: int, device):
    """A horizontal orbit of n_views cameras around the points' centre,
    at radius_scale times their extent; returns (cameras, extent)."""
    from gaussianeditor_tpu_torch.core.cameras import orbit_cameras

    center = points.mean(axis=0)
    extent = float(np.abs(points - center).max())
    cams = orbit_cameras(n_views, radius_scale * max(extent, 1e-3), 0.8, 0.8,
                         hw, hw, center=center, device=device)
    return cams, extent


def refine_with_guidance(
    scene: GaussianScene,
    guidance,
    prompt: str,
    *,
    n_views: int = 12,
    steps: int = 200,
    hw: int = 256,
    radius_scale: float = 2.5,
    **edit_kwargs,
) -> GaussianScene:
    """ip2p texture refinement on a horizontal orbit
    (train_from_mesh.py:140-173) through the Edit system, on the scene's
    device; returns the refined scene (a copy: `scene` is unchanged)."""
    from gaussianeditor_tpu_torch.edit.edit_system import (
        EditConfig,
        EditSystem,
    )

    xyz = scene.xyz.detach()[scene.alive].cpu().numpy()
    cams, extent = _orbit_around(xyz, n_views, radius_scale, hw,
                                 scene.device)
    cfg = EditConfig(
        prompt=prompt, batch_size=2, max_steps=steps,
        cameras_extent=max(extent, 1e-3), **edit_kwargs,
    )
    system = EditSystem(scene, cams, cfg, guidance=guidance)
    system.fit()
    return system.scene


# --- photometric fit for colorless meshes (train_from_mesh.py:115-139) ---

def render_mesh_lambertian(
    verts: np.ndarray,
    faces: np.ndarray,
    camera,
    light_dir=(0.35, 0.45, 0.82),
    face_colors: Optional[np.ndarray] = None,
    albedo=(0.75, 0.75, 0.75),
    ambient: float = 0.25,
    bg: float = 1.0,
) -> np.ndarray:
    """Tiny z-buffer rasterizer with flat (per-face) two-sided Lambert
    shading: the supervision the reference takes from pyrender multiview
    renders (train_from_mesh.py:115-139). Pure numpy on the host: one
    python loop over faces with vectorized bbox fills.

    Returns [H, W, 3] float32 in [0, 1] on a background of `bg`.
    """
    P = camera.full_proj.cpu().numpy().astype(np.float64)
    WV = camera.world_view.cpu().numpy().astype(np.float64)
    H, W = int(camera.height), int(camera.width)

    hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    clip = hom @ P.T
    w = np.maximum(clip[:, 3:4], 1e-7)
    ndc = clip[:, :2] / w
    px = ((ndc[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5
    camz = (hom @ WV.T)[:, 2]

    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    ld = np.asarray(light_dir, np.float64)
    ld /= np.linalg.norm(ld)
    shade = ambient + (1.0 - ambient) * np.abs(n @ ld)  # two-sided
    if face_colors is None:
        face_colors = np.broadcast_to(np.asarray(albedo, np.float64),
                                      (len(faces), 3))
    fcol = np.clip(face_colors * shade[:, None], 0.0, 1.0)

    img = np.full((H, W, 3), float(bg), np.float32)
    zbuf = np.full((H, W), np.inf, np.float64)
    tx, ty = px[faces], py[faces]          # [F, 3]
    tz = camz[faces]
    # cull triangles behind the near plane or fully off screen
    ok = (tz > 0.2).all(axis=1)
    x0 = np.clip(np.floor(tx.min(1)), 0, W - 1).astype(int)
    x1 = np.clip(np.ceil(tx.max(1)), 0, W - 1).astype(int)
    y0 = np.clip(np.floor(ty.min(1)), 0, H - 1).astype(int)
    y1 = np.clip(np.ceil(ty.max(1)), 0, H - 1).astype(int)
    ok &= (tx.max(1) >= 0) & (tx.min(1) <= W - 1)
    ok &= (ty.max(1) >= 0) & (ty.min(1) <= H - 1)

    for f in np.nonzero(ok)[0]:
        xs = np.arange(x0[f], x1[f] + 1)
        ys = np.arange(y0[f], y1[f] + 1)
        if len(xs) == 0 or len(ys) == 0:
            continue
        gx, gy = np.meshgrid(xs, ys)
        xA, yA = tx[f, 0], ty[f, 0]
        e1x, e1y = tx[f, 1] - xA, ty[f, 1] - yA
        e2x, e2y = tx[f, 2] - xA, ty[f, 2] - yA
        det = e1x * e2y - e1y * e2x
        if abs(det) < 1e-12:
            continue
        rx, ry = gx - xA, gy - yA
        u = (rx * e2y - ry * e2x) / det
        v = (e1x * ry - e1y * rx) / det
        inside = (u >= 0) & (v >= 0) & (u + v <= 1)
        if not inside.any():
            continue
        z = tz[f, 0] + u * (tz[f, 1] - tz[f, 0]) + v * (tz[f, 2] - tz[f, 0])
        sub_z = zbuf[gy, gx]
        upd = inside & (z < sub_z)
        iy, ix = gy[upd], gx[upd]
        zbuf[iy, ix] = z[upd]
        img[iy, ix] = fcol[f]
    return img


def photometric_fit(
    scene: GaussianScene,
    cameras,
    targets: np.ndarray,
    *,
    steps: int = 300,
    lambda_dssim: float = 0.2,
    feature_lr: float = 0.00625,
    batch_size: int = 2,
    max_instances: Optional[int] = None,
    seed: int = 0,
    dispatch_burst: int = 1,
    callback=None,
) -> GaussianScene:
    """Fit the Gaussians' appearance to target multiview images [V, H, W,
    3] with the geometry frozen: the reference's coarse phase
    (train_from_mesh.py:68-81, 115-139), with the position, scaling,
    rotation and opacity learning rates zeroed, feature_lr 0.00625 and
    the loss (1 - lambda) * L1 + lambda * (1 - SSIM). Each step draws
    `batch_size` views with `np.random.RandomState(seed)`, as the JAX
    function does. Trains `scene` in place on its device and returns it.
    callback(step, metrics) is called after every step."""
    from gaussianeditor_tpu_torch.train.losses import ssim
    from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
    from gaussianeditor_tpu_torch.train.trainer import (
        LossWeights,
        init_train_state,
        make_train_step,
    )

    if dispatch_burst > 1:
        warnings.warn(
            f"dispatch_burst={dispatch_burst}: the port runs one train step "
            "per call; bursts are the JAX package's device programs")
    optim = GaussianAdam(config=OptimConfig(
        position_lr_init=0.0, position_lr_final=0.0, scaling_lr=0.0,
        rotation_lr=0.0, opacity_lr=0.0, feature_lr=feature_lr,
        position_lr_max_steps=steps,
    ))
    weights = LossWeights(
        lambda_l1=1.0 - lambda_dssim, lambda_p=lambda_dssim,
        lambda_anchor_color=0.0, lambda_anchor_geo=0.0,
        lambda_anchor_scale=0.0, lambda_anchor_opacity=0.0,
    )
    step = make_train_step(
        optim, weights, perceptual=lambda p, t: 1.0 - ssim(p, t),
        max_instances=max_instances,
    )
    state = init_train_state(scene, optim)
    dev = scene.device
    tgts = torch.as_tensor(np.asarray(targets, np.float32), device=dev)
    rng = np.random.RandomState(seed)
    for s in range(steps):
        ids = rng.randint(0, len(cameras), size=batch_size)
        state, metrics = step(state, [cameras[i] for i in ids],
                              tgts[torch.as_tensor(ids, device=dev)])
        if callback is not None:
            callback(s, metrics)
    return scene


def fit_colorless_mesh(
    mesh_path_or_arrays,
    *,
    n_samples: int = 200_000,
    n_views: int = 16,
    hw: int = 256,
    steps: int = 300,
    capacity: Optional[int] = None,
    max_instances: Optional[int] = None,
    seed: int = 0,
    device="cuda",
    callback=None,
) -> GaussianScene:
    """Colorless mesh (an OBJ path or (verts, faces)) -> object scene on
    `device` with a baked Lambertian appearance: sample the surface,
    render an orbit with the numpy rasterizer, and fit the Gaussians'
    features to those views (`photometric_fit`; callback(step, metrics)
    after every step). The targets are rendered on a black background,
    the train step's: a white one (the reference's, train_from_mesh.py:75)
    would teach the silhouette Gaussians to bleach."""
    if isinstance(mesh_path_or_arrays, str):
        verts, faces, colors = load_obj(mesh_path_or_arrays)
    else:
        verts, faces = mesh_path_or_arrays
        colors = None
    pts, cols = sample_mesh_surface(verts, faces, n_samples, colors, seed)
    scene = GaussianScene.from_points(pts, cols, max_sh_degree=0,
                                      capacity=capacity, device=device)
    cams, _ = _orbit_around(verts, n_views, 2.5, hw, scene.device)
    targets = np.stack([
        render_mesh_lambertian(verts, faces, cam, bg=0.0) for cam in cams
    ])
    return photometric_fit(scene, cams, targets, steps=steps,
                           max_instances=max_instances, seed=seed,
                           callback=callback)
