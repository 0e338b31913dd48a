"""Spherical-harmonics evaluation (degrees 0..4), plain PyTorch.

Port of rain_tpu/ops/sh.py: the reference closed forms
(utils/sh_utils.py:1-83, cuda_rasterizer/forward.cu:9-60) written in the
same operation order. On the card the training step and the evaluation
render evaluate SH inside ops.preprocess's kernels
(csrc/preprocess.cuh:sh_basis, whose backward is the reference's
backward.cu:9-128 by hand), in this order; these ops are its plain
version, and autograd through them the sharded step's SH backward.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
SH_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
         -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
         0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions.

    Args:
      deg: active degree, 0..4.
      sh: [..., K, C] coefficients with K >= (deg+1)^2.
      dirs: [..., 3] unit directions.

    Returns:
      [..., C] color (without the +0.5 offset or clamping).
    """
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} is outside 0..4")
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1, :] +
                  SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + SH_C2[0] * xy * sh[..., 4, :] +
                      SH_C2[1] * yz * sh[..., 5, :] +
                      SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :] +
                      SH_C2[3] * xz * sh[..., 7, :] +
                      SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (result +
                          SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :] +
                          SH_C3[1] * xy * z * sh[..., 10, :] +
                          SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :] +
                          SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) *
                          sh[..., 12, :] +
                          SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :] +
                          SH_C3[5] * z * (xx - yy) * sh[..., 14, :] +
                          SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
                if deg > 3:
                    result = (
                        result +
                        SH_C4[0] * xy * (xx - yy) * sh[..., 16, :] +
                        SH_C4[1] * yz * (3 * xx - yy) * sh[..., 17, :] +
                        SH_C4[2] * xy * (7 * zz - 1) * sh[..., 18, :] +
                        SH_C4[3] * yz * (7 * zz - 3) * sh[..., 19, :] +
                        SH_C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20, :] +
                        SH_C4[5] * xz * (7 * zz - 3) * sh[..., 21, :] +
                        SH_C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22, :] +
                        SH_C4[7] * xz * (xx - 3 * yy) * sh[..., 23, :] +
                        SH_C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)) *
                        sh[..., 24, :])
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """SH → clamped RGB exactly as the rasterizer does (forward.cu:9-60).

    Args:
      deg: active SH degree.
      sh: [N, K, 3]; means: [N, 3]; campos: [3].
    Returns:
      rgb [N, 3] >= 0.
    """
    d = means - campos[None, :]
    # zero-length guard: dead capacity slots can sit exactly at the camera
    # center (inside the rsqrt too, so a later autograd stays NaN-free)
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    d = torch.where(sq > 0, d * inv, torch.zeros_like(d))
    rgb = eval_sh(deg, sh, d) + 0.5
    return torch.clamp(rgb, min=0.0)


def rgb_to_sh_dc(rgb):
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(sh):
    return sh * SH_C0 + 0.5
