"""Per-Gaussian preprocessing: cull, project, EWA splat, SH -> color.

Counterpart of `gaussianeditor_tpu/ops/preprocess.py::preprocess` and
`ProcessedGaussians`. `preprocess_plain` is written as plain elementwise
torch over [C] vectors (structure of arrays) in the same operation order,
so that the two packages round alike. Every constant is kept: near cull
at z <= 0.2, the 1.3*tanfov clamp in the EWA Jacobian, the +0.3 px^2
low-pass, radius = ceil(3*sqrt(lambda_max)) with the 0.1 floor inside
the sqrt, ndc2pix, and the 1e-7 w epsilon. So are the JAX package's
deliberate deviations from the CUDA reference: the per-axis,
opacity-aware binning rect, the empty rect for a Gaussian whose opacity
can never reach 1/255 ("dead opacity"), and `active_sh_degree` gating.

Float-to-int casts follow XLA's rules (NaN -> 0, saturating), which the
JAX package's rect arithmetic relies on for culled Gaussians.

On float32 CUDA tensors `preprocess` is one autograd Function whose
forward and backward are each one hand-written kernel
(`csrc/preprocess.cu`): eager PyTorch would run each line of the plain
version as its own pass over all C slots, about 420 passes forward and
675 for autograd's backward, where XLA fuses the JAX code into a few.
On CPU tensors, and on a float64 scene on the card (the dense oracle's),
it is `preprocess_plain`, which autograd differentiates as it stands;
any other dtype on the card raises. Only the opacity passes through
unchanged, so its gradient is not the Function's.

What the JAX package wraps in `stop_gradient` carries no gradient here:
the isotropic radius, the per-axis rect radii, the dead-opacity flag and
the mean2d the rect is cut from. Without that,
`ceil(sqrt(2 ln(256 op) c_xx))` at `ln(256 op) <= 0` (every dead slot,
every Gaussian with op <= 1/256) multiplies an infinite local derivative
by `ceil`'s zero and gives NaN gradients on the conic and the opacity.
The kernels' backward follows autograd's rules on the plain version:
`maximum` and `minimum` split a tie in half, `clamp_min` passes the
gradient at equality. `mean2d_offset_ndc` is the densification probe:
an all-zero [C, 2] added in NDC before `ndc2pix`, whose gradient is the
viewspace gradient the densify statistics read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.core.sh import C0, C1, C2, C3, C4, num_sh_bases
from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.utils.profiling import span

TILE = 16  # pixels per tile side


class ProcessedGaussians(NamedTuple):
    mean2d: torch.Tensor      # [C, 2] pixel-space center
    depth: torch.Tensor       # [C] camera-space z
    conic: torch.Tensor       # [C, 3] inverse 2D covariance (xx, xy, yy)
    color: torch.Tensor       # [C, ch] per-Gaussian feature to composite
    opacity: torch.Tensor     # [C] activated opacity
    radius: torch.Tensor      # [C] int32 screen-space radius (0 = culled)
    visible: torch.Tensor     # [C] bool
    rect_min: torch.Tensor    # [C, 2] int32 (tx, ty) inclusive
    rect_max: torch.Tensor    # [C, 2] int32 (tx, ty) exclusive
    tiles_touched: torch.Tensor  # [C] int32


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _clip_int(v: torch.Tensor, hi: int) -> torch.Tensor:
    """`clip(int32(v), 0, hi)` with XLA's cast (NaN -> 0, saturating)."""
    return torch.nan_to_num(v, nan=0.0).clamp(0, hi).to(torch.int32)


def _eval_sh_soa(max_degree, shT, x, y, z, active_degree):
    """SH basis combination in SoA layout: shT [K, ch, C], x/y/z [C] unit
    direction components; returns [ch, C]."""

    def gate(deg, val):
        if active_degree is None:
            return val
        on = torch.as_tensor(active_degree >= deg, device=val.device)
        return torch.where(on, val, torch.zeros_like(val))

    res = C0 * shT[0]
    if max_degree == 0:
        return res
    band1 = (-C1 * y) * shT[1] + (C1 * z) * shT[2] + (-C1 * x) * shT[3]
    res = res + gate(1, band1)
    if max_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        band2 = (
            (C2[0] * xy) * shT[4]
            + (C2[1] * yz) * shT[5]
            + (C2[2] * (2.0 * zz - xx - yy)) * shT[6]
            + (C2[3] * xz) * shT[7]
            + (C2[4] * (xx - yy)) * shT[8]
        )
        res = res + gate(2, band2)
    if max_degree >= 3:
        band3 = (
            (C3[0] * y * (3 * xx - yy)) * shT[9]
            + (C3[1] * xy * z) * shT[10]
            + (C3[2] * y * (4 * zz - xx - yy)) * shT[11]
            + (C3[3] * z * (2 * zz - 3 * xx - 3 * yy)) * shT[12]
            + (C3[4] * x * (4 * zz - xx - yy)) * shT[13]
            + (C3[5] * z * (xx - yy)) * shT[14]
            + (C3[6] * x * (xx - 3 * yy)) * shT[15]
        )
        res = res + gate(3, band3)
    if max_degree >= 4:
        band4 = (
            (C4[0] * xy * (xx - yy)) * shT[16]
            + (C4[1] * yz * (3 * xx - yy)) * shT[17]
            + (C4[2] * xy * (7 * zz - 1)) * shT[18]
            + (C4[3] * yz * (7 * zz - 3)) * shT[19]
            + (C4[4] * (zz * (35 * zz - 30) + 3)) * shT[20]
            + (C4[5] * xz * (7 * zz - 3)) * shT[21]
            + (C4[6] * (xx - yy) * (7 * zz - 1)) * shT[22]
            + (C4[7] * xz * (xx - 3 * yy)) * shT[23]
            + (C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))) * shT[24]
        )
        res = res + gate(4, band4)
    return res


def preprocess_plain(
    xyz: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    sh,
    camera: Camera,
    *,
    alive: Optional[torch.Tensor] = None,
    active_sh_degree=None,
    max_sh_degree: int = 3,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset_ndc: Optional[torch.Tensor] = None,
    tile_row_range: Optional[Tuple[int, int]] = None,
) -> ProcessedGaussians:
    """`preprocess` as plain torch, differentiable by autograd: what the
    kernels are held to, and `preprocess` itself on CPU tensors and
    float64 ones. `sh` as in `preprocess`."""
    W, H = camera.width, camera.height
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    # projection and near-plane cull
    P = camera.full_proj
    hx = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    hy = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    hw = P[3, 0] * x + P[3, 1] * y + P[3, 2] * z + P[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    WV = camera.world_view
    tz = WV[2, 0] * x + WV[2, 1] * y + WV[2, 2] * z + WV[2, 3]
    in_frustum = tz > 0.2

    ndc_x = hx * p_w
    ndc_y = hy * p_w
    if mean2d_offset_ndc is not None:
        ndc_x = ndc_x + mean2d_offset_ndc[:, 0]
        ndc_y = ndc_y + mean2d_offset_ndc[:, 1]
    mx = ndc2pix(ndc_x, W)
    my = ndc2pix(ndc_y, H)

    # covariance Sigma = L L^T, L = R diag(s)
    sc = torch.exp(log_scales) * scale_modifier
    sx, sy, sz = sc[:, 0], sc[:, 1], sc[:, 2]
    q = quats
    qn2 = q[:, 0] ** 2 + q[:, 1] ** 2 + q[:, 2] ** 2 + q[:, 3] ** 2
    qinv = torch.rsqrt(torch.clamp_min(qn2, 1e-24))
    qr, qi, qj, qk = (q[:, 0] * qinv, q[:, 1] * qinv,
                      q[:, 2] * qinv, q[:, 3] * qinv)
    R00 = 1 - 2 * (qj * qj + qk * qk)
    R01 = 2 * (qi * qj - qr * qk)
    R02 = 2 * (qi * qk + qr * qj)
    R10 = 2 * (qi * qj + qr * qk)
    R11 = 1 - 2 * (qi * qi + qk * qk)
    R12 = 2 * (qj * qk - qr * qi)
    R20 = 2 * (qi * qk - qr * qj)
    R21 = 2 * (qj * qk + qr * qi)
    R22 = 1 - 2 * (qi * qi + qj * qj)
    L00, L01, L02 = R00 * sx, R01 * sy, R02 * sz
    L10, L11, L12 = R10 * sx, R11 * sy, R12 * sz
    L20, L21, L22 = R20 * sx, R21 * sy, R22 * sz
    S00 = L00 * L00 + L01 * L01 + L02 * L02
    S01 = L00 * L10 + L01 * L11 + L02 * L12
    S02 = L00 * L20 + L01 * L21 + L02 * L22
    S11 = L10 * L10 + L11 * L11 + L12 * L12
    S12 = L10 * L20 + L11 * L21 + L12 * L22
    S22 = L20 * L20 + L21 * L21 + L22 * L22

    # EWA projection: cov2d = J W Sigma W^T J^T with the frustum-clamped
    # Jacobian, +0.3 on the diagonal
    tx = WV[0, 0] * x + WV[0, 1] * y + WV[0, 2] * z + WV[0, 3]
    ty = WV[1, 0] * x + WV[1, 1] * y + WV[1, 2] * z + WV[1, 3]
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    txc = torch.minimum(torch.maximum(tx / tz, -limx), limx) * tz
    tyc = torch.minimum(torch.maximum(ty / tz, -limy), limy) * tz
    itz = 1.0 / tz
    itz2 = itz * itz
    J00 = camera.focal_x * itz
    J02 = -camera.focal_x * txc * itz2
    J11 = camera.focal_y * itz
    J12 = -camera.focal_y * tyc * itz2
    T00 = J00 * WV[0, 0] + J02 * WV[2, 0]
    T01 = J00 * WV[0, 1] + J02 * WV[2, 1]
    T02 = J00 * WV[0, 2] + J02 * WV[2, 2]
    T10 = J11 * WV[1, 0] + J12 * WV[2, 0]
    T11 = J11 * WV[1, 1] + J12 * WV[2, 1]
    T12 = J11 * WV[1, 2] + J12 * WV[2, 2]
    A0 = T00 * S00 + T01 * S01 + T02 * S02
    A1 = T00 * S01 + T01 * S11 + T02 * S12
    A2 = T00 * S02 + T01 * S12 + T02 * S22
    B0 = T10 * S00 + T11 * S01 + T12 * S02
    B1 = T10 * S01 + T11 * S11 + T12 * S12
    B2 = T10 * S02 + T11 * S12 + T12 * S22
    c_xx = A0 * T00 + A1 * T01 + A2 * T02 + 0.3
    c_xy = A0 * T10 + A1 * T11 + A2 * T12
    c_yy = B0 * T10 + B1 * T11 + B2 * T12 + 0.3

    det = c_xx * c_yy - c_xy * c_xy
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic_a = c_yy * det_inv
    conic_b = -c_xy * det_inv
    conic_c = c_xx * det_inv

    # the radius, the rect and the dead-opacity flag carry no gradient
    # (stop_gradient in the JAX package): they are computed from
    # detached values
    cxx_s, cyy_s, det_s = c_xx.detach(), c_yy.detach(), det.detach()
    mid = 0.5 * (cxx_s + cyy_s)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det_s, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    # per-axis opacity-aware rect radii: every pixel beyond
    # sqrt(2 ln(256 op) Sigma_axis) has alpha <= 1/256 and is dropped by
    # the compositor anyway; capped at the isotropic radius. A Gaussian
    # with op <= 1/256 gets an empty rect ("dead opacity").
    ln_op = torch.log(256.0 * torch.clamp_min(opacity.detach(), 1e-12))
    two_ln = 2.0 * torch.clamp_min(ln_op, 0.0)
    rx_f = torch.minimum(radius_f, torch.ceil(torch.sqrt(two_ln * cxx_s)))
    ry_f = torch.minimum(radius_f, torch.ceil(torch.sqrt(two_ln * cyy_s)))
    dead_op = ln_op <= 0.0

    # tile rect, grid in tiles
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    mxs, mys = mx.detach(), my.detach()
    rminx = _clip_int((mxs - rx_f) / TILE, grid_x)
    rminy = _clip_int((mys - ry_f) / TILE, grid_y)
    # upper bound: the tightened radius needs +TILE to keep every pixel
    # within rx, capped at the CUDA bound floor((p + r + TILE-1)/TILE)
    rmaxx = _clip_int(torch.minimum((mxs + radius_f + TILE - 1) / TILE,
                                    (mxs + rx_f + TILE) / TILE), grid_x)
    rmaxy = _clip_int(torch.minimum((mys + radius_f + TILE - 1) / TILE,
                                    (mys + ry_f + TILE) / TILE), grid_y)
    if tile_row_range is not None:
        ty0, ty1 = (int(v) for v in tile_row_range)
        rminy = torch.clamp(rminy, ty0, ty1) - ty0
        rmaxy = torch.clamp(rmaxy, ty0, ty1) - ty0
    tiles = torch.where(dead_op, 0, (rmaxx - rminx) * (rmaxy - rminy))

    visible = in_frustum & det_valid & (tiles > 0)
    if alive is not None:
        visible = visible & alive
    tiles_touched = torch.where(visible, tiles, 0).to(torch.int32)
    radius = _clip_int(torch.where(visible, radius_f, 0.0), 2 ** 30)

    # color: SH -> RGB (+0.5, clamp at 0) or the override
    if override_color is not None:
        color = override_color
    else:
        assert sh is not None
        if isinstance(sh, (tuple, list)):
            sh = torch.cat(list(sh), dim=1)
        assert sh.shape[-2] == num_sh_bases(max_sh_degree)
        dx = x - camera.cam_pos[0]
        dy = y - camera.cam_pos[1]
        dz = z - camera.cam_pos[2]
        dn = torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-24))
        dx, dy, dz = dx * dn, dy * dn, dz * dn
        shT = sh.permute(1, 2, 0)  # [K, ch, C]
        res = _eval_sh_soa(max_sh_degree, shT, dx, dy, dz, active_sh_degree)
        # maximum, not clamp_min: a tie splits its gradient as jnp.maximum
        color = torch.maximum(res + 0.5, res.new_zeros(())).T.contiguous()

    return ProcessedGaussians(
        mean2d=torch.stack([mx, my], dim=-1),
        depth=tz,
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        color=color,
        opacity=opacity,
        radius=radius,
        visible=visible,
        rect_min=torch.stack([rminx, rminy], dim=-1),
        rect_max=torch.stack([rmaxx, rmaxy], dim=-1),
        tiles_touched=tiles_touched,
    )


class _Options(NamedTuple):
    max_sh_degree: int
    active_sh_degree: object      # None, an int or an int tensor
    scale_modifier: float
    tile_row_range: Optional[Tuple[int, int]]


def _use_kernels(xyz: torch.Tensor) -> bool:
    """The kernels run on float32 CUDA tensors; CPU tensors and a float64
    scene on the card take the plain version; anything else raises."""
    if xyz.device.type == "cpu":
        return False
    if xyz.device.type != "cuda":
        raise ValueError(f"preprocess: unsupported device {xyz.device}")
    if xyz.dtype == torch.float32:
        return True
    if xyz.dtype == torch.float64:
        return False
    raise ValueError(f"preprocess: the kernels take float32 (float64 takes "
                     f"the plain version), got {xyz.dtype}")


def _active(opts: _Options, dev):
    """(pointer tensor or None, int) of the active SH degree as the
    kernels take it: a device-held degree is read by the kernel."""
    a = opts.active_sh_degree
    if a is None:
        return None, opts.max_sh_degree
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int32).reshape(()), 0
    return None, int(a)


def _camera_args(camera: Camera, dev):
    chk = _kernels.check_cuda_tensor
    f32 = torch.float32
    return (chk(camera.world_view, "world_view", f32, dev, (4, 4)),
            chk(camera.full_proj, "full_proj", f32, dev, (4, 4)),
            chk(camera.cam_pos, "cam_pos", f32, dev, (3,)),
            chk(camera.tan_fovx, "tan_fovx", f32, dev, ()),
            chk(camera.tan_fovy, "tan_fovy", f32, dev, ()),
            camera.width, camera.height)


def _forward_kernel(xyz, log_scales, quats, dc, rest, offset, opacity, alive,
                    camera: Camera, opts: _Options):
    dev, C = xyz.device, xyz.shape[0]
    chk = _kernels.check_cuda_tensor
    f32 = torch.float32
    xyz = chk(xyz, "xyz", f32, dev, (C, 3))
    log_scales = chk(log_scales, "log_scales", f32, dev, (C, 3))
    quats = chk(quats, "quats", f32, dev, (C, 4))
    opacity = chk(opacity, "opacity", f32, dev, (C,))
    if alive is not None:
        alive = chk(alive, "alive", torch.bool, dev, (C,))
    if offset is not None:
        offset = chk(offset, "mean2d_offset_ndc", f32, dev, (C, 2))
    D = opts.max_sh_degree
    if dc is not None:
        dc = chk(dc, "features_dc", f32, dev, (C, 1, 3))
        rest = chk(rest, "features_rest", f32, dev,
                   (C, num_sh_bases(D) - 1, 3))
    active_ptr, active = _active(opts, dev)
    W, H = camera.width, camera.height
    ty0, ty1 = (-1, -1) if opts.tile_row_range is None else (
        int(opts.tile_row_range[0]), int(opts.tile_row_range[1]))
    mean2d = torch.empty((C, 2), dtype=f32, device=dev)
    depth = torch.empty((C,), dtype=f32, device=dev)
    conic = torch.empty((C, 3), dtype=f32, device=dev)
    color = (torch.empty((C, 3), dtype=f32, device=dev) if dc is not None
             else None)
    radius = torch.empty((C,), dtype=torch.int32, device=dev)
    visible = torch.empty((C,), dtype=torch.bool, device=dev)
    rect_min = torch.empty((C, 2), dtype=torch.int32, device=dev)
    rect_max = torch.empty((C, 2), dtype=torch.int32, device=dev)
    tiles = torch.empty((C,), dtype=torch.int32, device=dev)
    if C > 0:
        _kernels.launch(
            "preprocess_forward", dev, xyz, log_scales, quats, opacity, alive,
            offset, dc, rest, active_ptr, active,
            *_camera_args(camera, dev), float(opts.scale_modifier), ty0, ty1,
            C, D, mean2d, depth, conic, color, radius, visible, rect_min,
            rect_max, tiles)
    return (mean2d, depth, conic, color, radius, visible, rect_min, rect_max,
            tiles)


def _backward_kernel(xyz, log_scales, quats, dc, rest, camera: Camera,
                     opts: _Options, g_mean2d, g_depth, g_conic, g_color,
                     want_offset: bool):
    dev, C = xyz.device, xyz.shape[0]
    f32 = torch.float32
    chk = _kernels.check_cuda_tensor
    D = opts.max_sh_degree
    # the kernel indexes its inputs as contiguous rows: a [C, K, 3] `sh`
    # arrives as two strided slices of it
    xyz = chk(xyz, "xyz", f32, dev, (C, 3))
    log_scales = chk(log_scales, "log_scales", f32, dev, (C, 3))
    quats = chk(quats, "quats", f32, dev, (C, 4))
    if dc is not None:
        dc = chk(dc, "features_dc", f32, dev, (C, 1, 3))
        rest = chk(rest, "features_rest", f32, dev,
                   (C, num_sh_bases(D) - 1, 3))

    def rows(g, name, shape):
        """(g, its row stride): the compositor's backward hands over
        column slices of one array, read in place."""
        if g is None:
            return None, 0
        if g.device != dev or g.dtype != f32 or tuple(g.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {g.dtype} {tuple(g.shape)} on {g.device}")
        if g.dim() > 1 and g.stride(1) != 1:
            g = g.contiguous()
        return g, g.stride(0)

    g_mean2d, s_mean2d = rows(g_mean2d, "g_mean2d", (C, 2))
    g_depth, s_depth = rows(g_depth, "g_depth", (C,))
    g_conic, s_conic = rows(g_conic, "g_conic", (C, 3))
    g_color, s_color = rows(None if dc is None else g_color, "g_color",
                            (C, 3))
    active_ptr, active = _active(opts, dev)
    d_xyz = torch.empty((C, 3), dtype=f32, device=dev)
    d_ls = torch.empty((C, 3), dtype=f32, device=dev)
    d_q = torch.empty((C, 4), dtype=f32, device=dev)
    d_dc = torch.empty_like(dc) if dc is not None else None
    d_rest = torch.empty_like(rest) if dc is not None else None
    d_off = torch.empty((C, 2), dtype=f32, device=dev) if want_offset else None
    if C > 0:
        _kernels.launch(
            "preprocess_backward", dev, xyz, log_scales, quats, dc, rest,
            active_ptr, active, *_camera_args(camera, dev),
            float(opts.scale_modifier), C, D, g_mean2d,
            g_depth, g_conic, g_color, s_mean2d, s_depth, s_conic, s_color,
            d_xyz, d_ls, d_q, d_dc, d_rest, d_off)
    return d_xyz, d_ls, d_q, d_dc, d_rest, d_off


class _Preprocess(torch.autograd.Function):
    """The kernel pair. mean2d, depth, conic and color (SH mode) are
    differentiable; the radius, visibility, rects and tile counts are
    not. Inputs: xyz, log_scales, quats, features_dc and features_rest
    (both None when the colour is overridden), mean2d_offset_ndc (or
    None), opacity (read for the rect only), alive, the camera and
    `_Options`."""

    @staticmethod
    def forward(ctx, xyz, log_scales, quats, dc, rest, offset, opacity, alive,
                camera, opts):
        out = list(_forward_kernel(xyz, log_scales, quats, dc, rest, offset,
                                   opacity, alive, camera, opts))
        if out[3] is None:      # no colour: a placeholder output
            out[3] = xyz.new_empty((0,))
            ctx.mark_non_differentiable(out[3])
        ctx.mark_non_differentiable(*out[4:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xyz, log_scales, quats, dc, rest)
        ctx.camera, ctx.opts = camera, opts
        ctx.has_offset = offset is not None
        return tuple(out)

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, g_color, *_):
        xyz, log_scales, quats, dc, rest = ctx.saved_tensors
        with span("render.preprocess.backward"):
            d_xyz, d_ls, d_q, d_dc, d_rest, d_off = _backward_kernel(
                xyz, log_scales, quats, dc, rest, ctx.camera, ctx.opts,
                g_mean2d, g_depth, g_conic, g_color, ctx.has_offset)
        return (d_xyz, d_ls, d_q, d_dc, d_rest,
                d_off if ctx.has_offset else None, None, None, None, None)


def preprocess(
    xyz: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    sh,
    camera: Camera,
    *,
    alive: Optional[torch.Tensor] = None,
    active_sh_degree=None,
    max_sh_degree: int = 3,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset_ndc: Optional[torch.Tensor] = None,
    tile_row_range: Optional[Tuple[int, int]] = None,
) -> ProcessedGaussians:
    """Project all C Gaussians into `camera` (on the Gaussians' device).

    `sh` is [C, K, ch] SH coefficients, or the pair (features_dc [C, 1,
    3], features_rest [C, K-1, 3]) as the scene stores them (the kernels
    read the pair in place); it is not read when `override_color` [C, ch]
    is given, which is returned as the colour. Culled and dead Gaussians
    stay in place with `visible=False`, `radius=0` and `tiles_touched=0`.
    `mean2d_offset_ndc` [C, 2] is added to the NDC projection (the
    densification probe). `tile_row_range` (ty0, ty1) keeps only the
    tile rows [ty0, ty1) of the image, for a strip render
    (`parallel/tile_sharded.py`): the rects' rows are clipped to it and
    made strip-local (ty0 subtracted), so `tiles_touched` and `visible`
    count the strip's tiles alone; `mean2d` stays in image pixels."""
    if not _use_kernels(xyz):
        return preprocess_plain(
            xyz, log_scales, quats, opacity, sh, camera, alive=alive,
            active_sh_degree=active_sh_degree, max_sh_degree=max_sh_degree,
            scale_modifier=scale_modifier, override_color=override_color,
            mean2d_offset_ndc=mean2d_offset_ndc,
            tile_row_range=tile_row_range)
    dc = rest = None
    if override_color is None:
        assert sh is not None
        if isinstance(sh, (tuple, list)):
            dc, rest = sh
        else:
            dc, rest = sh[:, :1], sh[:, 1:]
        assert dc.shape[1] + rest.shape[1] == num_sh_bases(max_sh_degree)
    opts = _Options(int(max_sh_degree), active_sh_degree,
                    float(scale_modifier), tile_row_range)
    (mean2d, depth, conic, color, radius, visible, rect_min, rect_max,
     tiles) = _Preprocess.apply(xyz, log_scales, quats, dc, rest,
                                mean2d_offset_ndc, opacity, alive, camera,
                                opts)
    return ProcessedGaussians(
        mean2d=mean2d, depth=depth, conic=conic,
        color=override_color if override_color is not None else color,
        opacity=opacity, radius=radius, visible=visible, rect_min=rect_min,
        rect_max=rect_max, tiles_touched=tiles)
