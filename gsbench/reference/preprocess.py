"""Per-Gaussian preprocessing in plain PyTorch: activations, SH colour,
projection, covariance, screen radius and tile rectangle.

The 3DGS rasterizer's preprocess (cuda_rasterizer/forward.cu:63-246 and
auxiliary.h:30-153 of the INRIA code) as the program specifies it, frozen
from rain_tpu_torch/ops/projection.py:90-285, ops/sh.py:20-95 and
model/gaussians.py:63-71 in the same operation order, so that autograd
gives the backward of backward.cu:133-386. Two rules of the program's
specification beyond the INRIA code are kept, since they set its
instance list: the tile rectangle is shrunk to the ellipse where the
Gaussian can reach alpha >= 1/255 (rain_tpu/ops/projection.py:246-284),
and a Gaussian whose opacity is below 1/255 touches no tile.

Every function works in the dtype of its inputs, so the control can run
it in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
NEAR_Z = 0.2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Screen(NamedTuple):
    xy: torch.Tensor          # [N, 2] pixel-space mean
    depth: torch.Tensor       # [N] view-space z
    conic: torch.Tensor       # [N, 3] inverse 2D covariance (a, b, c)
    rgb: torch.Tensor         # [N, 3] clamped SH colour
    opacity: torch.Tensor     # [N] sigmoid opacity
    radii: torch.Tensor       # [N] int32, 0 where culled
    rect_min: torch.Tensor    # [N, 2] int64 first tile (x, y)
    rect_wh: torch.Tensor     # [N, 2] int64 tiles across, down
    tiles: torch.Tensor       # [N] int64 tiles touched


def activate(params: dict):
    """(scales, unit quaternions, opacity, SH [N, K, 3]) of raw params."""
    rot = params["rotation"]
    quats = rot / torch.sqrt(torch.sum(rot * rot, dim=-1, keepdim=True))
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return (torch.exp(params["scaling"]), quats,
            torch.sigmoid(params["opacity"][:, 0]), shs)


def sh_colour(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """Clamped RGB of SH up to degree 3 seen from ``campos``."""
    d = means - campos[None, :]
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    d = torch.where(sq > 0, d * inv, torch.zeros_like(d))
    out = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        out = (out - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :] -
               SH_C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * sh[..., 4, :] +
                   SH_C2[1] * yz * sh[..., 5, :] +
                   SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :] +
                   SH_C2[3] * xz * sh[..., 7, :] +
                   SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                out = (out +
                       SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :] +
                       SH_C3[1] * xy * z * sh[..., 10, :] +
                       SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :] +
                       SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) *
                       sh[..., 12, :] +
                       SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :] +
                       SH_C3[5] * z * (xx - yy) * sh[..., 14, :] +
                       SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return torch.clamp(out + 0.5, min=0.0)


def covariance3d(scale: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Σ = (S R)ᵀ(S R) as (Σ00, Σ01, Σ02, Σ11, Σ12, Σ22)."""
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = 1.0 * scale
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    return torch.stack([
        s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02,
        s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12,
        s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22,
        s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12,
        s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22,
        s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22], dim=-1)


def covariance2d(pv, c, W, fx, fy, tanx, tany, low_pass) -> torch.Tensor:
    """EWA projection of Σ with the 1.3·tan(fov) clamp and the low-pass
    added to the diagonal: (cov_xx, cov_xy, cov_yy)."""
    tz = torch.where(pv[:, 2] > NEAR_Z, pv[:, 2], torch.ones_like(pv[:, 2]))
    limx, limy = 1.3 * tanx, 1.3 * tany
    tx = torch.clamp(pv[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -limy, limy) * tz
    inv = 1.0 / tz
    inv2 = inv * inv
    j00, j02 = fx * inv, -(fx * tx) * inv2
    j11, j12 = fy * inv, -(fy * ty) * inv2
    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]
    v00 = c[:, 0] * m00 + c[:, 1] * m01 + c[:, 2] * m02
    v01 = c[:, 1] * m00 + c[:, 3] * m01 + c[:, 4] * m02
    v02 = c[:, 2] * m00 + c[:, 4] * m01 + c[:, 5] * m02
    v10 = c[:, 0] * m10 + c[:, 1] * m11 + c[:, 2] * m12
    v11 = c[:, 1] * m10 + c[:, 3] * m11 + c[:, 4] * m12
    v12 = c[:, 2] * m10 + c[:, 4] * m11 + c[:, 5] * m12
    cxx = m00 * v00 + m01 * v01 + m02 * v02
    cxy = m10 * v00 + m11 * v01 + m12 * v02
    cyy = m10 * v10 + m11 * v11 + m12 * v12
    return torch.stack([cxx + low_pass, cxy, cyy + low_pass], dim=-1)


def screen(params: dict, camera: dict, *, width: int, height: int,
           sh_degree: int, low_pass: float) -> Screen:
    """The screen-space quantities of every Gaussian (all rows alive)."""
    scales, quats, opac, shs = activate(params)
    means = params["xyz"]
    dt = means.dtype
    grid_x, grid_y = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    W, P = camera["world_view"].to(dt), camera["full_proj"].to(dt)
    tanx, tany = camera["tanfovx"].to(dt), camera["tanfovy"].to(dt)
    fx = torch.tensor(float(width), dtype=dt, device=means.device) / \
        (2.0 * tanx)
    fy = torch.tensor(float(height), dtype=dt, device=means.device) / \
        (2.0 * tany)
    ph = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    pv = ph @ W[:3, :].T
    phom = ph @ P.T
    pw = 1.0 / (phom[:, 3] + 1e-7)
    pproj = phom[:, :3] * pw[:, None]
    in_front = pv[:, 2] > NEAR_Z
    cov = covariance2d(pv, covariance3d(scales, quats), W, fx, fy, tanx,
                       tany, low_pass)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    det_ok = det != 0.0
    det_inv = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([cov[:, 2] * det_inv, -cov[:, 1] * det_inv,
                         cov[:, 0] * det_inv], dim=-1)
    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    xy = torch.stack([((pproj[:, 0] + 1.0) * width - 1.0) * 0.5,
                      ((pproj[:, 1] + 1.0) * height - 1.0) * 0.5], dim=-1)

    def rect(rx, ry):
        x0 = torch.clamp(torch.floor((xy[:, 0] - rx) / TILE), 0, grid_x)
        y0 = torch.clamp(torch.floor((xy[:, 1] - ry) / TILE), 0, grid_y)
        x1 = torch.clamp(torch.floor((xy[:, 0] + rx + TILE - 1) / TILE),
                         0, grid_x)
        y1 = torch.clamp(torch.floor((xy[:, 1] + ry + TILE - 1) / TILE),
                         0, grid_y)
        return x0, y0, (x1 - x0).to(torch.int64), (y1 - y0).to(torch.int64)

    _, _, w3, h3 = rect(radius, radius)
    visible = in_front & det_ok & ((w3 * h3) > 0)
    lim = torch.clamp(
        2.0 * torch.log(torch.clamp(255.0 * opac, min=1e-6)) + 0.02, min=0.0)
    rx = torch.minimum(radius, torch.ceil(torch.sqrt(lim * cov[:, 0])) + 1.0)
    ry = torch.minimum(radius, torch.ceil(torch.sqrt(lim * cov[:, 2])) + 1.0)
    x0, y0, rw, rh = rect(rx, ry)
    tiles = torch.where(visible & (opac >= 1.0 / 255.0), rw * rh,
                        torch.zeros_like(rw))
    return Screen(
        xy=xy, depth=pv[:, 2], conic=conic,
        rgb=sh_colour(sh_degree, shs, means, camera["camera_center"].to(dt)),
        opacity=opac,
        radii=torch.where(visible, radius,
                          torch.zeros_like(radius)).to(torch.int32),
        rect_min=torch.stack([x0, y0], dim=-1).to(torch.int64),
        rect_wh=torch.stack([rw, rh], dim=-1), tiles=tiles)
