"""Evaluation render of a Gaussian state.

Port of ``eval_render`` of rain_tpu/train/step.py (:102-116); the training
step comes with the training slice.
"""

from __future__ import annotations

import torch

from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import render as render_ops


@torch.no_grad()
def eval_render(state: gmod.GaussianState, camera: dict, bg: torch.Tensor,
                low_pass, scale_modifier=1.0, *, width: int, height: int,
                sh_degree: int, max_instances: int,
                on_stage: binning_ops.StageHook = binning_ops.no_stage_hook
                ) -> render_ops.RenderOutput:
    """Non-training render; scale_modifier is the viewer's Gaussian-size
    slider (reference gaussian_renderer/__init__.py:29, applied to the
    activated scales before covariance construction). Runs on the device
    of ``state``. on_stage(name, value) is called after each of
    ops.render.STAGES with its result."""
    scales, quats, opac, shs = gmod.activate(state.params)
    return render_ops.render(
        state.params.xyz, scales, quats, opac, shs, gmod.alive_mask(state),
        camera=camera, width=width, height=height, sh_degree=sh_degree,
        bg=bg, low_pass=low_pass, max_instances=max_instances,
        scale_modifier=scale_modifier, on_stage=on_stage)
