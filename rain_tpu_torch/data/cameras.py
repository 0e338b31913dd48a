"""Camera model and view/projection matrix construction.

A copy of rain_tpu/data/cameras.py whose ``render_inputs`` returns torch
tensors on the requested device. Matches the reference conventions
exactly (see reference utils/graphics_utils.py:27-66 and
scene/cameras.py:13-59):

- ``R`` is the camera-to-world rotation (COLMAP qvec transposed on load),
  ``T`` is the world-to-camera translation.
- The world-to-view matrix is built as in getWorld2View2 (optional
  translate/scale re-centering applied in camera space of the inverse).
- The projection matrix follows getProjectionMatrix (OpenGL-like, z_sign=+1,
  maps view-space z in [znear, zfar] to [~0, 1] after perspective divide).
- The reference stores both matrices *transposed* and multiplies row-vectors
  on the left (p_hom = p @ M). We store the plain math-convention matrices
  (columns act on the right: p_hom = M @ p) which produces identical floats;
  ``world_view`` here equals reference ``world_view_transform.T`` and
  ``full_proj`` equals reference ``full_proj_transform.T``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rain_tpu_torch import device as device_mod


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→view matrix; reference utils/graphics_utils.py:27-38."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is None and scale == 1.0:
        return np.float32(Rt)
    translate = np.zeros(3) if translate is None else translate
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """4x4 perspective matrix; reference utils/graphics_utils.py:40-60."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


@dataclasses.dataclass
class Camera:
    """One training/eval viewpoint plus its ground-truth image.

    ``image`` is float32 [3, H, W] in [0, 1] (already alpha-composited /
    background-blended as the loaders require; reference scene/cameras.py).
    """

    uid: int
    image_name: str
    R: np.ndarray            # (3,3) cam-to-world rotation
    T: np.ndarray            # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: np.ndarray | None  # (3,H,W) float32 or None (pose-only cameras)
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64))
    scale: float = 1.0
    # depth regularization's target (upstream scene/cameras.py, port
    # only): the inverse depth map [H, W] float32, its mask [H, W]
    # (ones, zeros for a map that is not reliable) and the flag
    invdepthmap: np.ndarray | None = None
    depth_mask: np.ndarray | None = None
    depth_reliable: bool = False

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = projection_matrix(self.znear, self.zfar, self.fovx,
                                      self.fovy)
        # math convention: full = P @ V so p_clip = full @ p_world
        self.full_proj = np.float32(self.proj @ self.world_view)
        self.camera_center = np.float32(
            np.linalg.inv(self.world_view)[:3, 3])

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def render_inputs(self, device=None) -> dict:
        """The tensor bundle consumed by ops.render (all float32), on
        ``device`` (default: the CUDA card)."""
        dev = device_mod.resolve(device)
        arrays = {
            "world_view": np.float32(self.world_view),
            "full_proj": np.float32(self.full_proj),
            "camera_center": np.float32(self.camera_center),
            "tanfovx": np.float32(self.tanfovx),
            "tanfovy": np.float32(self.tanfovy),
        }
        return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
