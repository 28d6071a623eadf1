"""The plain reference: 3D Gaussian splatting's render, losses, gradient
and Adam step in plain PyTorch, computed in blocks of tiles so that a
full-size view fits.

It imports nothing of the program (`benchmark/tests/test_bench_imports.py`
holds it to that) and takes nothing the program made: it gets the benchmark's
inputs (`scene.py`: parameters, camera poses, targets, LPIPS weights)
and works out the rest again, cameras' matrices included.

What it follows, and where each rule comes from:
  * Projection, EWA splat and colour: Kerbl et al. 2023 (3DGS) and its
    CUDA rasterizer (`forward.cu`): near cull at z <= 0.2, the Jacobian's
    1.3 tan(fov) clamp, +0.3 px^2 on the 2D covariance, radius
    ceil(3 sqrt(lambda_max)) with 0.1 under the root, `ndc2Pix`, SH to
    RGB as 0.5 + the SH sum, clamped at 0. Written in matrix form
    (`torch.matmul`), so a TF32 control changes it.
  * Tiles and order: 16 x 16 tiles; each Gaussian binned to the tiles of
    its per-axis, opacity-aware rect (empty where its opacity cannot
    reach 1/256), as `gaussianeditor_tpu_torch/ops/preprocess.py`
    documents for both packages; within a tile, front to back by the
    [tile | depth] key that keeps min(32 - tile bits, 24) top bits of the
    float32 depth, ties in slot order (`ops/binning_sorted.py`'s
    documented key).
  * Compositing: the CUDA rasterizer's per-pixel loop as
    `ops/refimpl.py::composite_dense` transliterates it (frozen here in
    vector form): a pair is skipped when its power is above 0 or its
    alpha = min(0.99, o exp(power)) is below 1/255; a pixel stops before
    the Gaussian that would take its transmittance below 1e-4.
  * LPIPS (Zhang et al. 2018) over VGG16's relu1_2 .. relu5_3, the
    channel vectors scaled to unit length as x / sqrt(|x|^2 + 1e-10),
    nonnegative heads; SSIM (Wang et al. 2004) with the 11 x 11 Gaussian
    window of sigma 1.5, zero padding; L1 as a mean.
  * GaussianEditor's anchor loss and Adam with eps after the root, per
    group rates, the exponential xyz rate, gradients masked outside the
    edit mask in every group but the rotation.

`precision(tf32=True)` turns on TF32 for matmuls and convolutions: the
control, the step below the float32 with TF32 off that the
configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
PARAMS = ("xyz", "features_dc", "features_rest", "opacity_raw",
          "log_scales", "quats")
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
BLOCK = 1 << 25   # (tile, row, pixel) triples a block of tiles may hold


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions, in TF32 when `tf32`."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# --- cameras ---

def camera(pose: dict, device) -> dict:
    """World-to-view and full projection matrices of a look-at pose
    (OpenCV axes: x right, y down, z forward), znear 0.01, zfar 100."""
    eye = np.asarray(pose["eye"], np.float64)
    fwd = np.asarray(pose["target"], np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(pose["up"], np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    w2c = np.linalg.inv(c2w)
    tx, ty = math.tan(pose["fovx"] / 2), math.tan(pose["fovy"] / 2)
    n, f = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[3, 2] = 1.0
    proj[2, 2] = f / (f - n)
    proj[2, 3] = -(f * n) / (f - n)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    H, W = int(pose["height"]), int(pose["width"])
    return dict(world_view=t(w2c), full_proj=t(proj @ w2c), cam_pos=t(eye),
                tan_x=tx, tan_y=ty, fx=W / (2 * tx), fy=H / (2 * ty),
                height=H, width=W)


# --- projection ---

def _sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    cols = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        cols += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                 SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                 SH_C2[4] * (xx - yy)]
    if degree >= 3:
        cols += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                 SH_C3[2] * y * (4 * zz - xx - yy),
                 SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 SH_C3[4] * x * (4 * zz - xx - yy),
                 SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(cols, dim=-1)


def _rotation(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
    r, i, j, k = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (j * j + k * k), 2 * (i * j - r * k),
                     2 * (i * k + r * j)], -1),
        torch.stack([2 * (i * j + r * k), 1 - 2 * (i * i + k * k),
                     2 * (j * k - r * i)], -1),
        torch.stack([2 * (i * k - r * j), 2 * (j * k + r * i),
                     1 - 2 * (i * i + j * j)], -1)], -2)


def _clip_tiles(v: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.nan_to_num(v, nan=0.0).clamp(0, hi).to(torch.int64)


def project(p: Dict[str, torch.Tensor], cam: dict, sh_degree: int) -> dict:
    """Screen-space Gaussians of the rows of `p` (the alive ones): the
    differentiable mean2d [n, 2], conic [n, 3], opacity [n], color
    [n, 3] and depth [n], and the detached tile rects and visibility."""
    H, W = cam["height"], cam["width"]
    xyz = p["xyz"]
    xh = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    clip = xh @ cam["full_proj"].T
    vc = xh @ cam["world_view"].T
    tx, ty, tz = vc[:, 0], vc[:, 1], vc[:, 2]
    pw = 1.0 / (clip[:, 3] + 1e-7)
    mx = ((clip[:, 0] * pw + 1.0) * W - 1.0) * 0.5
    my = ((clip[:, 1] * pw + 1.0) * H - 1.0) * 0.5

    m = _rotation(p["quats"]) * torch.exp(p["log_scales"])[:, None, :]
    sigma = m @ m.transpose(1, 2)
    limx, limy = 1.3 * cam["tan_x"], 1.3 * cam["tan_y"]
    txc = torch.clamp(tx / tz, -limx, limx) * tz
    tyc = torch.clamp(ty / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([cam["fx"] / tz, zero, -cam["fx"] * txc / (tz * tz)], -1),
        torch.stack([zero, cam["fy"] / tz, -cam["fy"] * tyc / (tz * tz)], -1),
    ], -2)
    tm = jac @ cam["world_view"][:3, :3]
    cov = tm @ sigma @ tm.transpose(1, 2)
    cxx, cxy, cyy = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    opacity = torch.sigmoid(p["opacity_raw"][:, 0])

    d = xyz - cam["cam_pos"]
    d = d / torch.sqrt(torch.clamp_min((d * d).sum(-1, keepdim=True), 1e-24))
    sh = torch.cat([p["features_dc"], p["features_rest"]], 1)
    k = (sh_degree + 1) ** 2
    rgb = (_sh_basis(d, sh_degree)[:, None, :] @ sh[:, :k])[:, 0]
    color = torch.clamp_min(rgb + 0.5, 0.0)

    with torch.no_grad():
        gx, gy = -(-W // TILE), -(-H // TILE)
        a, c, dt = cxx.detach(), cyy.detach(), det.detach()
        mid = 0.5 * (a + c)
        disc = torch.sqrt(torch.clamp_min(mid * mid - dt, 0.1))
        rad = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                        mid - disc)))
        ln_op = torch.log(256.0 * torch.clamp_min(opacity.detach(), 1e-12))
        two_ln = 2.0 * torch.clamp_min(ln_op, 0.0)
        rx = torch.minimum(rad, torch.ceil(torch.sqrt(two_ln * a)))
        ry = torch.minimum(rad, torch.ceil(torch.sqrt(two_ln * c)))
        mxs, mys = mx.detach(), my.detach()
        x0 = _clip_tiles((mxs - rx) / TILE, gx)
        y0 = _clip_tiles((mys - ry) / TILE, gy)
        x1 = _clip_tiles(torch.minimum((mxs + rad + TILE - 1) / TILE,
                                       (mxs + rx + TILE) / TILE), gx)
        y1 = _clip_tiles(torch.minimum((mys + rad + TILE - 1) / TILE,
                                       (mys + ry + TILE) / TILE), gy)
        tiles = torch.where(ln_op <= 0, 0, (x1 - x0) * (y1 - y0))
        visible = (tz.detach() > 0.2) & ok & (tiles > 0)
    return dict(mean2d=torch.stack([mx, my], -1), conic=conic,
                opacity=opacity, color=color, depth=tz,
                rect=torch.stack([x0, y0, x1, y1], -1), tiles=tiles,
                visible=visible, grid=(gx, gy), size=(H, W))


# --- binning and compositing ---

def bin_tiles(proc: dict) -> dict:
    """The visible Gaussians' (tile, depth) instances in compositing
    order: `gauss` [n] (index among the visible ones), per-tile `start`
    and `count`."""
    gx, gy = proc["grid"]
    T = gx * gy
    vis = torch.nonzero(proc["visible"])[:, 0]
    dev = vis.device
    tt = proc["tiles"][vis]
    n = int(tt.sum())
    g = torch.repeat_interleave(torch.arange(vis.numel(), device=dev), tt)
    first = torch.cumsum(tt, 0) - tt
    j = torch.arange(n, device=dev) - first[g]
    r = proc["rect"][vis][g]
    w = torch.clamp_min(r[:, 2] - r[:, 0], 1)
    jy = torch.div(j, w, rounding_mode="floor")
    tile = (r[:, 1] + jy) * gx + r[:, 0] + (j - jy * w)
    kdb = min(32 - (T + 1).bit_length(), 24)
    bits = proc["depth"].detach()[vis][g].contiguous().view(torch.int32)
    key = (tile << kdb) | ((bits.to(torch.int64) & 0xFFFFFFFF) >> (32 - kdb))
    order = torch.sort(key, stable=True).indices
    count = torch.bincount(tile, minlength=T)
    return dict(vis=vis, gauss=g[order], start=torch.cumsum(count, 0) - count,
                count=count, n=n, grid=(gx, gy))


def _blocks(count: torch.Tensor):
    """Tiles in blocks of similar row counts, each block's (tiles, rows)
    at most BLOCK (tile, row, pixel) triples."""
    cnt = count.cpu()
    order = torch.argsort(cnt, descending=True)
    i, T = 0, cnt.numel()
    while i < T and int(cnt[order[i]]) > 0:
        L = int(cnt[order[i]])
        nt = max(1, BLOCK // (L * TILE * TILE))
        yield order[i:i + nt].to(count.device), L
        i += nt


def _block_image(vals, b: dict, tiles: torch.Tensor, L: int,
                 work: Optional[dict] = None) -> torch.Tensor:
    """Front-to-back compositing of the given tiles: [nt, 256, 3]."""
    mean2d, conic, opacity, color = vals
    gx = b["grid"][0]
    dev = tiles.device
    rows = torch.arange(L, device=dev)
    cnt = b["count"][tiles]
    valid = rows[None, :] < cnt[:, None]
    pos = torch.clamp(b["start"][tiles][:, None] + rows[None, :],
                      max=max(b["n"] - 1, 0))
    g = b["gauss"][pos]                                   # [nt, L]
    pix = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % gx) * TILE)[:, None] + (pix % TILE)[None, :]
    py = ((tiles // gx) * TILE)[:, None] + (pix // TILE)[None, :]
    dx = mean2d[g][..., 0:1] - px[:, None, :].to(mean2d.dtype)
    dy = mean2d[g][..., 1:2] - py[:, None, :].to(mean2d.dtype)
    con = conic[g]
    power = (-0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy)
             - con[..., 1:2] * dx * dy)                   # [nt, L, 256]
    alpha = torch.clamp_max(
        opacity[g][..., None] * torch.exp(torch.clamp_max(power, 0.0)),
        ALPHA_MAX)
    skip = (power > 0) | (alpha < ALPHA_MIN) | ~valid[..., None]
    a = torch.where(skip, torch.zeros_like(alpha), alpha)
    t_in = torch.cumprod(1.0 - a, dim=1)
    t_ex = torch.cat([torch.ones_like(t_in[:, :1]), t_in[:, :-1]], 1)
    contrib = ~skip & (t_in >= T_MIN)
    wgt = torch.where(contrib, a * t_ex, torch.zeros_like(a))
    if work is not None:
        with torch.no_grad():
            alive = (t_in >= T_MIN).sum(1)
            work["pairs"] += int(torch.minimum(alive + 1, cnt[:, None]).sum())
            work["contrib"] += int(contrib.sum())
            last = torch.where(contrib, rows[None, :, None] + 1, 0)
            work["sum_nc"] += int(last.amax(1).sum())
    return torch.einsum("tlp,tlc->tpc", wgt, color[g])


def _to_image(tiles_rgb: torch.Tensor, b: dict, size) -> torch.Tensor:
    gx, gy = b["grid"]
    img = tiles_rgb.view(gy, gx, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * TILE, gx * TILE, 3)[:size[0], :size[1]]


def _to_tiles(img: torch.Tensor, b: dict) -> torch.Tensor:
    gx, gy = b["grid"]
    H, W = img.shape[:2]
    pad = F.pad(img, (0, 0, 0, gx * TILE - W, 0, gy * TILE - H))
    return pad.view(gy, TILE, gx, TILE, 3).permute(0, 2, 1, 3, 4).reshape(
        gx * gy, TILE * TILE, 3)


def render(proc: dict, b: dict, work: Optional[dict] = None) -> torch.Tensor:
    """The image [H, W, 3] on a black background, without gradient."""
    vals = tuple(proc[k].detach()[b["vis"]]
                 for k in ("mean2d", "conic", "opacity", "color"))
    gx, gy = b["grid"]
    out = torch.zeros((gx * gy, TILE * TILE, 3), dtype=torch.float32,
                      device=b["vis"].device)
    with torch.no_grad():
        for tiles, L in _blocks(b["count"]):
            out[tiles] = _block_image(vals, b, tiles, L, work)
    return _to_image(out, b, proc["size"])


def render_backward(proc: dict, b: dict, g_img: torch.Tensor) -> None:
    """Back-propagate the image gradient `g_img` [H, W, 3] through the
    compositing (recomputed block by block) and the projection into the
    parameters' `.grad`."""
    keys = ("mean2d", "conic", "opacity", "color")
    leaves = [proc[k].detach()[b["vis"]].requires_grad_() for k in keys]
    g_tiles = _to_tiles(g_img, b)
    for tiles, L in _blocks(b["count"]):
        rgb = _block_image(leaves, b, tiles, L)
        torch.autograd.backward(rgb, g_tiles[tiles])
    outs, grads = [], []
    for k, leaf in zip(keys, leaves):
        if leaf.grad is None:
            continue
        full = torch.zeros_like(proc[k])
        full[b["vis"]] = leaf.grad
        outs.append(proc[k])
        grads.append(full)
    if outs:
        torch.autograd.backward(outs, grads)


# --- losses ---

def lpips(w: Dict[str, torch.Tensor], pred: torch.Tensor,
          target: torch.Tensor) -> torch.Tensor:
    """LPIPS of two [H, W, 3] images in [0, 1] with VGG16 weights `w`
    (OIHW convolutions, `scene.lpips_weights`)."""
    from benchmark.scene import STAGE_CH, VGG_PLAN, VGG_TAPS

    shift = torch.tensor([-0.030, -0.088, -0.188], device=pred.device)
    scale = torch.tensor([0.458, 0.448, 0.450], device=pred.device)
    x = ((2 * torch.stack([pred, target]) - 1 - shift) / scale)
    x = x.permute(0, 3, 1, 2)
    total = torch.zeros((), device=pred.device)
    stage = 0
    for i, (_, pool) in enumerate(VGG_PLAN):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                                padding=1))
        if i in VGG_TAPS:
            n = x / torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
            head = torch.clamp_min(w[f"lin{stage}_w"], 0.0)
            assert head.numel() == STAGE_CH[stage]
            total = total + (((n[0] - n[1]) ** 2)
                             * head[:, None, None]).sum(0).mean()
            stage += 1
    return total


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images: the 11 x 11 Gaussian window of
    sigma 1.5 as one 2-D convolution per channel, zero padding."""
    g = torch.exp(-(torch.arange(11, dtype=torch.float64) - 5) ** 2 / 4.5)
    g = (g / g.sum()).to(torch.float32)
    win = (g[:, None] * g[None, :]).to(pred.device).expand(3, 1, 11, 11)

    def blur(x):
        return F.conv2d(x.permute(2, 0, 1)[None], win, padding=5, groups=3)

    mu1, mu2 = blur(pred), blur(target)
    s11 = blur(pred * pred) - mu1 * mu1
    s22 = blur(target * target) - mu2 * mu2
    s12 = blur(pred * target) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def anchor_loss(p: Dict[str, torch.Tensor], anchor: Dict[str, torch.Tensor],
                weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """GaussianEditor's elastic loss over the rows of `p`: each row's
    squared distance from its anchor times its generation weight, over
    the selected rows and the row's elements."""
    n_sel = max(int((weight > 0).sum()), 1)

    def term(k):
        d = (p[k] - anchor[k]).reshape(p[k].shape[0], -1)
        feat = d.shape[1]
        if feat == 0:
            return torch.zeros((), device=d.device)
        return ((d * d).sum(1) * weight).sum() / (n_sel * feat)

    return dict(color=term("features_dc") + term("features_rest"),
                geo=term("xyz") + term("quats"),
                opacity=term("opacity_raw"), scale=term("log_scales"))


# --- the train step ---

def expon_lr(step: int, init: float, final: float, max_steps: int) -> float:
    """3DGS's `get_expon_lr_func` with no delay steps."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


class Trainer:
    """The train step on plain tensors: the parameters' alive rows as
    leaves, Adam's moments beside them.

    `train` holds the configuration's rates and weights: `lr` (xyz
    init/final/max_steps, spatial scale, feature, opacity, scaling,
    rotation), `lambda_l1`, `lambda_p`, `perceptual` ("lpips" or
    "ssim"), `anchor` (the four weights and the generation-0 weight, or
    None)."""

    def __init__(self, params: Dict[str, torch.Tensor], n_alive: int,
                 sh_degree: int, train: dict,
                 lpips_w: Optional[Dict[str, torch.Tensor]] = None):
        self.p = {k: params[k][:n_alive].detach().clone() for k in PARAMS}
        self.anchor = {k: v.clone() for k, v in self.p.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.sh_degree = sh_degree
        self.cfg = train
        self.lpips_w = lpips_w
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.work: List[dict] = []

    def lrs(self, step: int) -> Dict[str, float]:
        lr = self.cfg["lr"]
        s = lr["spatial_lr_scale"]
        return dict(
            xyz=expon_lr(step, lr["position_lr_init"] * s,
                         lr["position_lr_final"] * s,
                         lr["position_lr_max_steps"]),
            features_dc=lr["feature_lr"], features_rest=lr["feature_lr"] / 20,
            opacity_raw=lr["opacity_lr"], log_scales=lr["scaling_lr"],
            quats=lr["rotation_lr"])

    def step(self, step: int, cams: Sequence[dict], targets: torch.Tensor,
             tf32: bool = False) -> float:
        """One step over the views `cams` and targets [B, H, W, 3]; the
        parameters and moments are updated; returns the loss."""
        cfg = self.cfg
        for v in self.p.values():
            v.requires_grad_(True)
            v.grad = None
        B = len(cams)
        total = 0.0
        with precision(tf32):
            for cam, tgt in zip(cams, targets):
                proc = project(self.p, cam, self.sh_degree)
                b = bin_tiles(proc)
                vis = b["vis"]
                work = dict(pairs=0, contrib=0, sum_nc=0, n=b["n"],
                            tiles=b["grid"][0] * b["grid"][1],
                            visible=int(vis.numel()),
                            last_slot=int(vis[-1]) + 1 if vis.numel() else 0,
                            alive=int(self.p["xyz"].shape[0]),
                            height=cam["height"], width=cam["width"],
                            pixels=cam["height"] * cam["width"])
                img = render(proc, b, work).requires_grad_()
                self.work.append(work)
                l1 = (img - tgt).abs().mean()
                if cfg["perceptual"] == "lpips":
                    perc = lpips(self.lpips_w, img, tgt)
                else:
                    perc = 1.0 - ssim(img, tgt)
                loss = (cfg["lambda_l1"] * l1 + cfg["lambda_p"] * perc) / B
                (g_img,) = torch.autograd.grad(loss, img)
                total += float(loss.detach())
                render_backward(proc, b, g_img)
                del proc, b, img
            an = cfg.get("anchor")
            if an:
                w = torch.full((self.p["xyz"].shape[0],), an["weight_g0"],
                               device=self.p["xyz"].device)
                terms = anchor_loss(self.p, self.anchor, w)
                aloss = sum(an[k] * terms[k] for k in terms)
                total += float(aloss.detach())
                aloss.backward()
        with torch.no_grad():
            grads = {k: (v.grad if v.grad is not None
                         else torch.zeros_like(v)) for k, v in self.p.items()}
            if self.first_grad is None:
                self.first_grad = {k: g.clone() for k, g in grads.items()}
            self.count += 1
            b1, b2, eps = 0.9, 0.999, 1e-15
            bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
            lrs = self.lrs(step)
            for k, v in self.p.items():
                g = grads[k]
                self.mu[k].mul_(b1).add_((1 - b1) * g)
                self.nu[k].mul_(b2).add_((1 - b2) * g * g)
                v.sub_(lrs[k] * (self.mu[k] / bc1)
                       / (torch.sqrt(self.nu[k] / bc2) + eps))
                v.requires_grad_(False)
                v.grad = None
        return total


def densify(p: Dict[str, torch.Tensor], alive: torch.Tensor,
            mask: torch.Tensor, accum: torch.Tensor, denom: torch.Tensor,
            noise: tuple, cfg: dict) -> tuple:
    """GaussianEditor's densify and prune within a fixed capacity, from a
    train state's parameters [C, ...], alive and mask [C] and densify
    accumulators [C]; returns (parameters, alive) after it.

    Gradients are the accumulated viewspace norms over their visits,
    kept on masked alive slots; with `max_densify_percent` below 1 only
    the top share of the nonzero ones stays (the quantile of the alive
    slots' values, linearly interpolated). Those at or above `max_grad`
    are cloned when their largest scale is at most `percent_dense` x
    extent, else split: child A in place, child B to a free slot, each at
    R (eps * scale) + xyz with the scales over 1.6. Free slots go to the
    requests in slot order, lowest free slot first; requests past the
    free slots are dropped. Then slots whose opacity is under
    `min_opacity` or whose largest scale is over 0.1 x extent are pruned
    among the masked ones (the screen-space test sees the reset radii
    and never fires)."""
    C = alive.shape[0]
    grads = torch.nan_to_num(accum / torch.clamp_min(denom, 1e-12), nan=0.0)
    grads = torch.where(mask & alive, grads, torch.zeros_like(grads))
    if cfg["max_densify_percent"] < 1.0:
        n_alive = alive.sum().to(torch.float32)
        nnz = (grads != 0).sum().to(torch.float32)
        share = nnz * cfg["max_densify_percent"] / torch.clamp_min(n_alive, 1)
        vals = torch.sort(grads[alive]).values
        pos = torch.clamp(1.0 - share, 0, 1) * max(vals.numel() - 1, 0)
        lo = int(torch.floor(pos))
        hi = min(int(torch.ceil(pos)), vals.numel() - 1)
        frac = pos - lo
        thres = vals[lo] * (1.0 - frac) + vals[hi] * frac
        grads = torch.where(grads < thres, torch.zeros_like(grads), grads)
    scales = torch.exp(p["log_scales"])
    big = scales.max(-1).values > cfg["percent_dense"] * cfg["extent"]
    hot = (grads >= cfg["max_grad"]) & alive
    req = torch.nonzero(hot)[:, 0]
    free = torch.nonzero(~alive)[:, 0]
    k = min(req.numel(), free.numel())
    src, dst = req[:k], free[:k]
    split = torch.zeros_like(alive)
    split[src] = big[src]
    out = {k2: v.clone() for k2, v in p.items()}
    for name, v in p.items():
        out[name][dst] = v[src]
    child = torch.log(scales / 1.6)
    rot = _rotation(p["quats"])

    def sample(eps):
        return (rot @ (eps * scales)[..., None])[..., 0] + p["xyz"]

    sp = torch.nonzero(split)[:, 0]
    sp_dst = dst[split[src]]
    out["xyz"][sp_dst] = sample(noise[1])[sp]
    out["xyz"][sp] = sample(noise[0])[sp]
    out["log_scales"][sp_dst] = child[sp]
    out["log_scales"][sp] = child[sp]
    new_alive = alive.clone()
    new_alive[dst] = True
    new_mask = mask.clone()
    new_mask[dst] = mask[src]
    prune = ((torch.sigmoid(out["opacity_raw"][:, 0]) < cfg["min_opacity"])
             | (torch.exp(out["log_scales"]).max(-1).values
                > 0.1 * cfg["extent"])) & new_mask & new_alive
    return out, new_alive & ~prune


def frame(params: Dict[str, torch.Tensor], alive: torch.Tensor,
          sh_degree: int, pose: dict, device, tf32: bool = False
          ) -> torch.Tensor:
    """The [H, W, 3] image of a scene's alive slots through a pose."""
    with precision(tf32), torch.no_grad():
        p = {k: params[k][alive] for k in PARAMS}
        proc = project(p, camera(pose, device), sh_degree)
        return render(proc, bin_tiles(proc))
