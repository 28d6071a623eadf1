"""Per-Gaussian preprocessing: cull, project, EWA splat, SH -> color.

Counterpart of `gaussianeditor_tpu/ops/preprocess.py::preprocess` and
`ProcessedGaussians`, written as plain elementwise torch over [C]
vectors (structure of arrays) in the same operation order, so that the
two packages round alike. Every constant is kept: near cull at
z <= 0.2, the 1.3*tanfov clamp in the EWA Jacobian, the +0.3 px^2
low-pass, radius = ceil(3*sqrt(lambda_max)) with the 0.1 floor inside
the sqrt, ndc2pix, and the 1e-7 w epsilon. So are the JAX package's
deliberate deviations from the CUDA reference: the per-axis,
opacity-aware binning rect, the empty rect for a Gaussian whose opacity
can never reach 1/255 ("dead opacity"), and `active_sh_degree` gating.

Float-to-int casts follow XLA's rules (NaN -> 0, saturating), which the
JAX package's rect arithmetic relies on for culled Gaussians.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianeditor_tpu_torch.core.cameras import Camera
from gaussianeditor_tpu_torch.core.sh import C0, C1, C2, C3, C4, num_sh_bases

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


def preprocess(
    xyz: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    sh: Optional[torch.Tensor],
    camera: Camera,
    *,
    alive: Optional[torch.Tensor] = None,
    active_sh_degree=None,
    max_sh_degree: int = 3,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
) -> ProcessedGaussians:
    """Project all C Gaussians into `camera` (on the Gaussians' device).

    Culled and dead Gaussians stay in place with `visible=False`,
    `radius=0` and `tiles_touched=0`."""
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

    mx = ndc2pix(hx * p_w, W)
    my = ndc2pix(hy * p_w, H)

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

    mid = 0.5 * (c_xx + c_yy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    # per-axis opacity-aware rect radii: every pixel beyond
    # sqrt(2 ln(256 op) Sigma_axis) has alpha <= 1/256 and is dropped by
    # the compositor anyway; capped at the isotropic radius. A Gaussian
    # with op <= 1/256 gets an empty rect ("dead opacity").
    ln_op = torch.log(256.0 * torch.clamp_min(opacity, 1e-12))
    two_ln = 2.0 * torch.clamp_min(ln_op, 0.0)
    rx_f = torch.minimum(radius_f, torch.ceil(torch.sqrt(two_ln * c_xx)))
    ry_f = torch.minimum(radius_f, torch.ceil(torch.sqrt(two_ln * c_yy)))
    dead_op = ln_op <= 0.0

    # tile rect, grid in tiles
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    rminx = _clip_int((mx - rx_f) / TILE, grid_x)
    rminy = _clip_int((my - ry_f) / TILE, grid_y)
    # upper bound: the tightened radius needs +TILE to keep every pixel
    # within rx, capped at the CUDA bound floor((p + r + TILE-1)/TILE)
    rmaxx = _clip_int(torch.minimum((mx + radius_f + TILE - 1) / TILE,
                                    (mx + rx_f + TILE) / TILE), grid_x)
    rmaxy = _clip_int(torch.minimum((my + radius_f + TILE - 1) / TILE,
                                    (my + ry_f + TILE) / TILE), grid_y)
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
        assert sh.shape[-2] == num_sh_bases(max_sh_degree)
        dx = x - camera.cam_pos[0]
        dy = y - camera.cam_pos[1]
        dz = z - camera.cam_pos[2]
        dn = torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-24))
        dx, dy, dz = dx * dn, dy * dn, dz * dn
        shT = sh.permute(1, 2, 0)  # [K, ch, C]
        res = _eval_sh_soa(max_sh_degree, shT, dx, dy, dz, active_sh_degree)
        color = torch.clamp_min(res + 0.5, 0.0).T.contiguous()  # [C, ch]

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
