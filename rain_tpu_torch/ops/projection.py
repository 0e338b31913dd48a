"""Per-Gaussian preprocessing: projection, covariance, culling.

Port of rain_tpu/ops/projection.py in plain torch ops (so autograd gives
the reference's backward.cu:133-386 when the training slice needs it),
itself the vectorised form of the reference preprocess kernel
(cuda_rasterizer/forward.cu:63-246, auxiliary.h:30-153).

Conventions (identical to the reference; see data/cameras.py):
- world_view: 4x4 math-convention world→view (p_view = W @ p_h).
- full_proj:  4x4 math-convention world→clip (p_hom = P @ W @ p_h).
- NDC→pixel: ((v + 1) * S - 1) / 2               (auxiliary.h:30-33)
- view-frustum cull: p_view.z <= 0.2             (auxiliary.h:143)
- EWA: cov2D = J R_wv Σ R_wvᵀ Jᵀ with the 1.3·tanfov clamp on view-space
  x/y, and `low_pass` added to the diagonal      (forward.cu:63-102)
- conic = inverse(cov2D); radius = ceil(3·sqrt(λmax)), eigenvalues through
  sqrt(max(0.1, mid²−det))                       (forward.cu:209-222)
- 16x16 pixel tiles; rect clamped to the tile grid (auxiliary.h:35-45)

All matmuls run in full f32 (TF32 is switched off in the package's
__init__), as the reference pins them (rain_tpu/ops/projection.py:31-34).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch.ops import sh as sh_ops

TILE = 16          # BLOCK_X == BLOCK_Y == 16 (config.h:4-5)
NEAR_Z = 0.2       # frustum cull threshold (auxiliary.h:143)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""

    xy: torch.Tensor            # [N, 2] pixel-space mean
    depth: torch.Tensor         # [N]   view-space z
    conic: torch.Tensor         # [N, 3] (a, b, c) of inverse 2D covariance
    rgb: torch.Tensor           # [N, 3] SH-evaluated color
    opacity: torch.Tensor       # [N]   post-sigmoid opacity
    radii: torch.Tensor         # [N]   int32 screen radius, 0 = culled
    rect_min: torch.Tensor      # [N, 2] int32 (tx0, ty0) tile rect
    rect_wh: torch.Tensor       # [N, 2] int32 (w, h) tile rect size
    tiles_touched: torch.Tensor  # [N] int32 = w*h (0 if culled)


def quat_scale_to_cov3d(scale: torch.Tensor, quat: torch.Tensor,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance Σ = (S·R)ᵀ(S·R) packed as 6 uniques (forward.cu:107-141).

    Args:
      scale: [N, 3] post-activation (exp) scales.
      quat: [N, 4] (r, x, y, z), normalized by the caller.
    Returns:
      [N, 6]: (Σ00, Σ01, Σ02, Σ11, Σ12, Σ22).
    """
    r, x, y, z = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scale_modifier * scale                     # [N, 3]
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    return torch.stack([
        s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02,
        s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12,
        s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22,
        s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12,
        s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22,
        s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22,
    ], dim=-1)


def project_cov2d(mean_view: torch.Tensor, cov3d: torch.Tensor,
                  world_view: torch.Tensor, focal_x, focal_y,
                  tan_fovx, tan_fovy, low_pass) -> torch.Tensor:
    """EWA projection of Σ to a 2D screen covariance (forward.cu:63-102).

    Args:
      mean_view: [N, 3] view-space means (pre-clamp).
      cov3d: [N, 6] packed symmetric Σ.
      world_view: [4, 4].
    Returns:
      [N, 3]: (cov_xx, cov_xy, cov_yy) with low_pass added to the diagonal.
    """
    # rows behind the camera plane are culled, but 1/tz there would leak
    # NaN into a later autograd (0 * inf)
    tz = torch.where(mean_view[:, 2] > NEAR_Z, mean_view[:, 2],
                     torch.ones_like(mean_view[:, 2]))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(mean_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(mean_view[:, 1] / tz, -limy, limy) * tz

    # J rows = d(pix_unscaled)/d(view xyz); cov = (J Rwv) Σ (J Rwv)ᵀ
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * tx) * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -(focal_y * ty) * inv_tz2

    W = world_view
    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]

    c = cov3d
    v00 = c[:, 0] * m00 + c[:, 1] * m01 + c[:, 2] * m02
    v01 = c[:, 1] * m00 + c[:, 3] * m01 + c[:, 4] * m02
    v02 = c[:, 2] * m00 + c[:, 4] * m01 + c[:, 5] * m02
    v10 = c[:, 0] * m10 + c[:, 1] * m11 + c[:, 2] * m12
    v11 = c[:, 1] * m10 + c[:, 3] * m11 + c[:, 4] * m12
    v12 = c[:, 2] * m10 + c[:, 4] * m11 + c[:, 5] * m12

    cov00 = m00 * v00 + m01 * v01 + m02 * v02
    cov01 = m10 * v00 + m11 * v01 + m12 * v02
    cov11 = m10 * v10 + m11 * v11 + m12 * v12
    return torch.stack([cov00 + low_pass, cov01, cov11 + low_pass], dim=-1)


def ndc_to_pix(v: torch.Tensor, size) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5          # auxiliary.h:30-33


def preprocess(means3d: torch.Tensor,
               scales: torch.Tensor,
               quats: torch.Tensor,
               opacities: torch.Tensor,
               shs: torch.Tensor,
               alive: torch.Tensor,
               *,
               sh_degree: int,
               world_view: torch.Tensor,
               full_proj: torch.Tensor,
               camera_center: torch.Tensor,
               tan_fovx, tan_fovy,
               width: int, height: int,
               low_pass=0.3,
               scale_modifier: float = 1.0,
               grid: tuple[int, int] | None = None,
               tight_opacity_culling: bool = True,
               ) -> Preprocessed:
    """Vectorized equivalent of preprocessCUDA.

    Args:
      means3d: [N, 3]; scales: [N, 3] (post-exp); quats: [N, 4] (normalized);
      opacities: [N] (post-sigmoid); shs: [N, K, 3]; alive: [N] bool mask
        for live capacity slots (dead slots are culled).
      sh_degree: active SH degree.
      width/height: image size in pixels (focal lengths, NDC → pixels).
      grid: (grid_x, grid_y), the tile grid the rects are clamped to; by
        default the image's own. A bucketed render passes the bucket's grid
        (ops.render ``render_wh``).
      tight_opacity_culling: shrink each rect to the ellipse where the
        Gaussian can reach alpha >= 1/255 (see below).

    Returns: Preprocessed tensors; culled/dead entries have radii == 0 and
      tiles_touched == 0 (matching forward.cu:178-179).
    """
    if grid is None:
        grid = ((width + TILE - 1) // TILE, (height + TILE - 1) // TILE)
    grid_x, grid_y = grid
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    p_h = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)
    p_view = p_h @ world_view[:3, :].T                        # [N, 3]
    p_hom = p_h @ full_proj.T                                 # [N, 4]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)                          # forward.cu:189
    p_proj = p_hom[:, :3] * p_w[:, None]

    in_front = p_view[:, 2] > NEAR_Z                          # auxiliary.h:143

    cov3d = quat_scale_to_cov3d(scales, quats, scale_modifier)
    cov = project_cov2d(p_view, cov3d, world_view, focal_x, focal_y,
                        tan_fovx, tan_fovy, low_pass)

    det = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    det_ok = det != 0.0                                       # forward.cu:210
    det_inv = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([cov[:, 2] * det_inv, -cov[:, 1] * det_inv,
                         cov[:, 0] * det_inv], dim=-1)

    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))          # forward.cu:222

    xy = torch.stack([ndc_to_pix(p_proj[:, 0], width),
                      ndc_to_pix(p_proj[:, 1], height)], dim=-1)

    # Tile rect (auxiliary.h:35-45); the clamp absorbs C's trunc-vs-floor
    # division difference (both land at the clamp for negatives).
    def make_rect(radius_x, radius_y):
        rx0 = torch.clamp(torch.floor((xy[:, 0] - radius_x) / TILE), 0, grid_x)
        ry0 = torch.clamp(torch.floor((xy[:, 1] - radius_y) / TILE), 0, grid_y)
        rx1 = torch.clamp(torch.floor((xy[:, 0] + radius_x + TILE - 1) / TILE),
                          0, grid_x)
        ry1 = torch.clamp(torch.floor((xy[:, 1] + radius_y + TILE - 1) / TILE),
                          0, grid_y)
        return (rx0, ry0, (rx1 - rx0).to(torch.int32),
                (ry1 - ry0).to(torch.int32))

    _, _, ref_w, ref_h = make_rect(radius_f, radius_f)
    has_area = (ref_w * ref_h) > 0                            # forward.cu:226
    visible = alive & in_front & det_ok & has_area
    radii = torch.where(visible, radius_f,
                        torch.zeros_like(radius_f)).to(torch.int32)

    if tight_opacity_culling:
        # Output-exact tile culling, as in rain_tpu/ops/projection.py:
        # 246-284: a pixel passes the alpha >= 1/255 test only inside the
        # ellipse q <= lim = 2 ln(255 op), whose axis-aligned extents are
        # sqrt(lim·cov00 / cov11); the per-axis min with the reference
        # radius keeps the rect inside the reference bbox, and only
        # n_contrib bookkeeping can differ from the unculled rect.
        lim = torch.clamp(
            2.0 * torch.log(torch.clamp(255.0 * opacities, min=1e-6)) + 0.02,
            min=0.0)
        r_x = torch.minimum(radius_f,
                            torch.ceil(torch.sqrt(lim * cov[:, 0])) + 1.0)
        r_y = torch.minimum(radius_f,
                            torch.ceil(torch.sqrt(lim * cov[:, 2])) + 1.0)
        reachable = opacities >= (1.0 / 255.0)
    else:
        r_x = r_y = radius_f
        reachable = torch.ones_like(visible)

    rx0, ry0, rect_w, rect_h = make_rect(r_x, r_y)
    tiles_touched = torch.where(visible & reachable, rect_w * rect_h,
                                torch.zeros_like(rect_w)).to(torch.int32)

    rgb = sh_ops.sh_to_rgb(sh_degree, shs, means3d, camera_center)

    return Preprocessed(
        xy=xy,
        depth=p_view[:, 2],
        conic=conic,
        rgb=rgb,
        opacity=opacities,
        radii=radii,
        rect_min=torch.stack([rx0, ry0], dim=-1).to(torch.int32),
        rect_wh=torch.stack([rect_w, rect_h], dim=-1),
        tiles_touched=tiles_touched,
    )
