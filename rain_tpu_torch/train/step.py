"""The training step and the evaluation render of a Gaussian state.

Port of rain_tpu/train/step.py: ``train_step`` (render → loss → grads →
densification statistics → Adam, the body of the reference's loop,
train.py:71-147) and ``eval_render`` (:102-116). Gradients with respect
to the screen-space tap are taken with the parameter gradients, in one
``torch.autograd.grad``, to feed the densification statistics (the
reference's screenspace_points.grad).

Depth regularization (graphdeco-inria/gaussian-splatting's 2024 update,
from Kerbl et al., SIGGRAPH 2024), off by default: given a
``DepthTarget``, the render's depth channel is the inverse depth
D = Σ T α / z (ops.render's ``depth_row`` "inverse") and the loss gains
w·mean(|(D - D̂)·m|) (ops.losses.depth_l1); its gradient reaches the
opacities, the screen quantities and, through 1/z, the means.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
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
    n_alive: int                  # the input state's (int or 0-d tensor)
    inv_depth: torch.Tensor | None = None  # [H, W] rendered inverse depth
    #                                        (a step with a DepthTarget)


class DepthTarget(NamedTuple):
    """The depth term's inputs: the target inverse depth D̂ and its mask m,
    [H, W] f32 each on the step's device (ones, or zeros for a map that is
    not reliable; zero beyond the true size in a bucket), and the weight
    w(t), a number or a 0-d f32 device tensor (``schedules.
    depth_l1_weight``)."""
    inv_depth: torch.Tensor
    mask: torch.Tensor
    weight: object


# 1/20 in f32: rain_tpu's jitted ``feature_lr / 20.0``
# (rain_tpu/train/step.py:89) is compiled by XLA into a product with the
# constant's f32 reciprocal, and CUDA divides a tensor by a number the same
# way, where the CPU divides: a product gives rain_tpu's bits on both
FEATURE_REST_LR = float(np.float32(1.0) / np.float32(20.0))


def learning_rates(opt_cfg_leaves: dict, xyz_lr,
                   device: torch.device) -> gmod.GaussianParams:
    """The step's per-leaf learning rates as 0-d f32 tensors on ``device``
    (``xyz_lr`` as given), as the JAX step's traced leaves: a float is
    filled on the device, which rounds it to f32 as torch.tensor(v,
    dtype=float32) does; features_rest's is feature_lr / 20 as rain_tpu
    compiles it (``FEATURE_REST_LR``)."""
    lr = {k: device_mod.scalar(v, torch.float32, device)
          for k, v in opt_cfg_leaves.items()}
    return gmod.GaussianParams(
        xyz=xyz_lr,
        features_dc=lr["feature_lr"],
        features_rest=lr["feature_lr"] * FEATURE_REST_LR,
        scaling=lr["scaling_lr"],
        rotation=lr["rotation_lr"],
        opacity=lr["opacity_lr"],
    )


def adam_update(params: gmod.GaussianParams, grads: gmod.GaussianParams,
                opt: adam_mod.AdamState, opt_cfg_leaves: dict, xyz_lr):
    """The step's Adam update (``adam.update``) at the step's learning
    rates (``learning_rates``); returns (params, AdamState).

    Adam takes contiguous leaves. The plain preprocess's backward (the
    CPU step's and the sharded step's) gives features_dc's and
    features_rest's gradients as views of one [N, 16, 3] tensor (the
    backward of ``gaussians.activate``'s cat), so they are made
    contiguous here; the preprocess kernel's gradients already are, and
    the one-card step on the card copies nothing."""
    return adam_mod.update(
        params, gmod.GaussianParams(*[g.contiguous() for g in grads]), opt,
        learning_rates(opt_cfg_leaves, xyz_lr, params.xyz.device))


def train_step(state: gmod.GaussianState, opt: adam_mod.AdamState,
               camera: dict, gt_image: torch.Tensor, bg: torch.Tensor,
               low_pass, xyz_lr, *,
               width: int, height: int, sh_degree: int, max_instances: int,
               opt_cfg_leaves: dict, lambda_dssim: float = 0.2,
               update_densify_stats: bool = True,
               real_wh: tuple | None = None,
               on_stage: binning_ops.StageHook = binning_ops.no_stage_hook,
               depth: DepthTarget | None = None):
    """One optimisation step on one camera; runs on the device of ``state``.

    Every value that changes from call to call may be a 0-d device tensor,
    as rain_tpu traces it: ``low_pass`` and ``xyz_lr`` (f32), the four
    ``opt_cfg_leaves`` (feature_lr, opacity_lr, scaling_lr, rotation_lr;
    f32), ``real_wh`` (int32) and ``state.n_alive`` (int32); each may also
    be a Python number. The keywords width, height, sh_degree,
    max_instances, lambda_dssim and update_densify_stats are static: they
    set the shapes and the work (train.compiled keys its graphs by them).
    real_wh: optional (w, h) true image size. width/height are then the
      tile-aligned bucket, gt_image is zero-padded to it, and the loss is
      masked to the true size.
    on_stage(name, value) is called after each of ops.render.STAGES, of
      ops.render.BACKWARD_STAGES and of TRAIN_STAGES with its result.
    depth: optional DepthTarget, the depth term (see the module
      docstring). Whether it is given is static (a key of its own in
      train.compiled); its weight may be a 0-d device tensor. The
      returned aux then holds the rendered inverse depth.

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
        out = render_ops.render_params(
            params, alive,
            camera=camera, width=width, height=height,
            sh_degree=sh_degree, bg=bg, low_pass=low_pass,
            max_instances=max_instances, xy_tap=tap,
            # the colour loss reads no depth; the depth term 1/z
            depth_row=None if depth is None else "inverse",
            render_wh=real_wh, on_stage=on_stage)
        if real_wh is None:
            loss, l1 = loss_ops.training_loss(out.render, gt_image,
                                              lambda_dssim)
        else:
            loss, l1 = loss_ops.masked_training_loss(
                out.render, gt_image, real_wh[0], real_wh[1], lambda_dssim)
        if depth is not None:
            loss = loss + depth.weight * loss_ops.depth_l1(
                out.depth[0], depth.inv_depth, depth.mask, real_wh)
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

    new_params, new_opt = adam_update(state.params, grads, opt,
                                      opt_cfg_leaves, xyz_lr)
    on_stage("adam", (new_params, new_opt))
    state = state._replace(params=new_params)

    aux = StepAux(loss=loss.detach(), l1=l1.detach(),
                  num_instances=out.num_instances,
                  instance_overflow=out.overflow, n_alive=state.n_alive,
                  inv_depth=None if depth is None else out.depth[0].detach())
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
    of ``state``. ``low_pass``, ``scale_modifier`` and ``state.n_alive``
    may be 0-d device tensors, as in ``train_step``. on_stage(name, value)
    is called after each of ops.render.STAGES with its result."""
    return render_ops.render_params(
        state.params, gmod.alive_mask(state), camera=camera, width=width,
        height=height, sh_degree=sh_degree, bg=bg, low_pass=low_pass,
        max_instances=max_instances, scale_modifier=scale_modifier,
        on_stage=on_stage)
