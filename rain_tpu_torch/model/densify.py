"""Adaptive density control: the densification statistics.

Port of ``add_densification_stats`` of rain_tpu/model/densify.py
(:55-70), which the training step calls after every backward
(gaussian_model.py:419-421, train.py:133-134). Clone, split, prune and the
opacity reset come with the Trainer loop.
"""

from __future__ import annotations

import torch

from rain_tpu_torch.model.gaussians import GaussianState


def add_densification_stats(state: GaussianState, tap_grad: torch.Tensor,
                            radii: torch.Tensor, width,
                            height) -> GaussianState:
    """Accumulate screen-space gradient norms; returns a new state and
    leaves ``state`` untouched.

    ``tap_grad`` [C, 2] is the pixel-unit xy gradient; the reference
    accumulates the NDC-scaled one (backward.cu:450-451), so it is scaled by
    (W/2, H/2) of the TRUE image size. ``radii`` [C] int32 marks the
    visible Gaussians (radii > 0).
    """
    vis = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=tap_grad.device)
    s = tap_grad * scale[None, :]
    g = torch.sqrt(torch.sum(s * s, dim=-1))
    return state._replace(
        xyz_gradient_accum=state.xyz_gradient_accum +
        torch.where(vis, g, torch.zeros_like(g)),
        denom=state.denom + vis.to(torch.float32),
        max_radii2d=torch.where(
            vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d),
    )
