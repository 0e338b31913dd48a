"""The training step and the evaluation render of a Gaussian state.

Port of rain_tpu/train/step.py: ``train_step`` (render → loss → grads →
densification statistics → Adam, the body of the reference's loop,
train.py:71-147) and ``eval_render`` (:102-116). Gradients with respect
to the screen-space tap are taken with the parameter gradients, in one
``torch.autograd.grad``, to feed the densification statistics (the
reference's screenspace_points.grad).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import render as render_ops


# The stages of ``train_step`` after the render's (ops.render.STAGES, then
# BACKWARD_STAGES inside the backward), in order, each reported to
# ``on_stage`` with its result: (loss, l1), the gradients (GaussianParams,
# tap gradient), the state with its new statistics, and (params, AdamState).
TRAIN_STAGES = ("loss", "grads", "densify_stats", "adam")


class StepAux(NamedTuple):
    loss: torch.Tensor            # 0-d f32
    l1: torch.Tensor              # 0-d f32
    num_instances: torch.Tensor   # 0-d int64 (may exceed max_instances)
    instance_overflow: torch.Tensor  # 0-d bool
    n_alive: int


def train_step(state: gmod.GaussianState, opt: adam_mod.AdamState,
               camera: dict, gt_image: torch.Tensor, bg: torch.Tensor,
               low_pass, xyz_lr, *,
               width: int, height: int, sh_degree: int, max_instances: int,
               opt_cfg_leaves: dict, lambda_dssim: float = 0.2,
               update_densify_stats: bool = True,
               real_wh: tuple[int, int] | None = None,
               on_stage: binning_ops.StageHook = binning_ops.no_stage_hook):
    """One optimisation step on one camera; runs on the device of ``state``.

    opt_cfg_leaves: feature_lr, opacity_lr, scaling_lr and rotation_lr as
      floats; ``xyz_lr`` is the scheduled position lr (float or 0-d f32).
    real_wh: optional (w, h) true image size. width/height are then the
      tile-aligned bucket, gt_image is zero-padded to it, and the loss is
      masked to the true size.
    on_stage(name, value) is called after each of ops.render.STAGES, of
      ops.render.BACKWARD_STAGES and of TRAIN_STAGES with its result.

    Returns (state, opt, StepAux) as new tensors; the inputs are left
    untouched.
    """
    dev = state.params.xyz.device
    alive = gmod.alive_mask(state)
    params = gmod.GaussianParams(
        *[p.detach().requires_grad_(True) for p in state.params])
    tap = torch.zeros((state.capacity, 2), dtype=torch.float32, device=dev,
                      requires_grad=True)
    with torch.enable_grad():
        scales, quats, opac, shs = gmod.activate(params)
        out = render_ops.render(
            params.xyz, scales, quats, opac, shs, alive,
            camera=camera, width=width, height=height,
            sh_degree=sh_degree, bg=bg, low_pass=low_pass,
            max_instances=max_instances, xy_tap=tap,
            need_depth=False,   # the training loss never reads depth
            render_wh=real_wh, on_stage=on_stage)
        if real_wh is None:
            loss, l1 = loss_ops.training_loss(out.render, gt_image,
                                              lambda_dssim)
        else:
            loss, l1 = loss_ops.masked_training_loss(
                out.render, gt_image, real_wh[0], real_wh[1], lambda_dssim)
        on_stage("loss", (loss, l1))
        *grads, tap_grad = torch.autograd.grad(loss, [*params, tap])
    grads = gmod.GaussianParams(*grads)
    on_stage("grads", (grads, tap_grad))

    if update_densify_stats:
        # the NDC rescale uses the TRUE image size, not the bucket's
        rw, rh = (width, height) if real_wh is None else real_wh
        state = densify_mod.add_densification_stats(
            state, tap_grad, out.radii, rw, rh)
        on_stage("densify_stats", state)

    # f32 learning rates, as the JAX step's traced leaves: features_rest's
    # is feature_lr / 20 in f32. Each is a device fill, which rounds the
    # float to f32 as torch.tensor(v, dtype=float32) does but, unlike a
    # copy from pageable host memory, does not wait for the device
    lr = {k: torch.full((), v, dtype=torch.float32, device=dev)
          for k, v in opt_cfg_leaves.items()}
    lrs = gmod.GaussianParams(
        xyz=xyz_lr,
        features_dc=lr["feature_lr"],
        features_rest=lr["feature_lr"] / 20.0,
        scaling=lr["scaling_lr"],
        rotation=lr["rotation_lr"],
        opacity=lr["opacity_lr"],
    )
    new_params, new_opt = adam_mod.update(state.params, grads, opt, lrs)
    on_stage("adam", (new_params, new_opt))
    state = state._replace(params=new_params)

    aux = StepAux(loss=loss.detach(), l1=l1.detach(),
                  num_instances=out.num_instances,
                  instance_overflow=out.overflow, n_alive=state.n_alive)
    return state, new_opt, aux


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
