"""The system under test for the Trainer's cells: rain_tpu_torch's
``train.trainer.Trainer``, the loop that ``scripts/train.py`` runs, set up
by the port's own configuration module (``config.build_parser``'s
defaults, the configuration's values, ``config.apply_method_presets``)
on a scene the benchmark makes: the configuration's points and colours
as the scene's point cloud, the pan's poses as its training cameras,
each with its seeded target, and the scene's extent by the Trainer's own
rule (``data.dataset.nerfpp_norm``) over the scene's ring of cameras.
An episode is ``Trainer.train`` from a start in memory
(``start=(state, opt, iteration, low_pass)``).
The state's parameters, statistics and fresh moments are read with
``gsbench.program``'s helpers. The plain reference imports none of this.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import rain_tpu_torch  # noqa: F401  (pins f32 products to full precision)
from rain_tpu_torch import config as cfg_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.data.dataset import SceneData, nerfpp_norm
from rain_tpu_torch.train import schedules
from rain_tpu_torch.train import trainer as trainer_mod

# the methods of the Trainer's CompiledStep that an episode calls
METHODS = ("train_step", "densify_and_prune", "reset_opacity")


def configs(cfg: dict) -> dict:
    """The Trainer's configuration groups: the train CLI's defaults with
    the configuration's ``model``, ``opt``, ``rain`` and ``system``
    values, then the method presets of its ``rain`` flags."""
    cfgs = cfg_mod.extract_all(cfg_mod.build_parser("gsbench").parse_args(
        []))
    for group in ("model", "opt", "rain", "system"):
        cfgs[group] = dataclasses.replace(cfgs[group], **cfg[group])
    return cfg_mod.apply_method_presets(cfgs, cfg["model"]["source_path"])


def pan_camera(k: int, yaw: float, x_offset: float, image: np.ndarray,
               fovx: float, fovy: float) -> Camera:
    """Training camera ``k``: turned by ``yaw`` about the vertical axis and
    shifted by ``x_offset`` along x in its own frame, with ``image``
    [3, H, W] as its ground truth."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return Camera(uid=k, image_name=f"pan{k}", R=R,
                  T=np.array([x_offset, 0.0, 0.0]), fovx=fovx, fovy=fovy,
                  image=image, width=image.shape[2], height=image.shape[1])


def ring_camera(k: int, yaw: float, centre: np.ndarray, fovx: float,
                fovy: float) -> Camera:
    """A pose-only camera of the scene's ring at ``centre``, turned by
    ``yaw`` about the vertical axis."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return Camera(uid=k, image_name=f"ring{k}", R=R, T=-R.T @ centre,
                  fovx=fovx, fovy=fovy, image=None, width=0, height=0)


def scene(points: np.ndarray, colors: np.ndarray, cameras: list[Camera],
          ring: list[Camera]) -> SceneData:
    """The Trainer's scene: ``cameras`` train; its extent and translation
    are ``nerfpp_norm``'s over ``ring``."""
    norm = nerfpp_norm(ring)
    return SceneData(train_cameras=cameras, test_cameras=[], points=points,
                     colors=colors, nerf_radius=norm["radius"],
                     nerf_translate=norm["translate"])


def trainer(scene_data: SceneData, cfgs: dict, model_path: str,
            device: torch.device, log_fn=None) -> trainer_mod.Trainer:
    """A Trainer as the train CLI makes one, with TensorBoard off."""
    return trainer_mod.Trainer(scene_data, cfgs, model_path, device=device,
                               log_fn=log_fn or (lambda *a: None),
                               tensorboard=False)


def low_pass_at(tr: trainer_mod.Trainer, iteration: int, n: int,
                width: int, height: int) -> float:
    """The c2f filter a run holds after ``iteration`` with ``n``
    Gaussians at its last recomputation."""
    rain = tr.rain
    last = iteration - iteration % int(rain.c2f_every_step) or 1
    return schedules.c2f_low_pass(
        last, c2f=rain.c2f, c2f_every_step=rain.c2f_every_step,
        c2f_max_lowpass=rain.c2f_max_lowpass,
        densify_until_iter=tr.densify_until, height=height, width=width,
        num_gaussians=n)


def moments_of(opt) -> dict:
    """{mu.<leaf>, nu.<leaf>: tensor} of Adam's moments."""
    return {**{f"mu.{k}": v for k, v in opt.mu._asdict().items()},
            **{f"nu.{k}": v for k, v in opt.nu._asdict().items()}}
