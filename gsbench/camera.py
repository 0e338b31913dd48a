"""Camera inputs of the benchmark's traffic: the pan's poses and a path.

The matrices follow the 3DGS conventions that the program takes
(getWorld2View2 and getProjectionMatrix, utils/graphics_utils.py:27-60 of
the INRIA code), frozen from rain_tpu_torch/data/cameras.py:38-66 and
:101-110 so that the benchmark makes its inputs itself and hands the same
tensors to the program and to the reference. The pan is chip_smoke.py's
``pose(k)`` (chip_smoke.py:460-468): yaw 0.04·(k - 2) about the vertical
axis and an x offset of 0.15·(k - 2), fov 1.0 x 0.7, around bench.py's
camera at the origin looking down +z into the scene's box.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FOVX, FOVY = 1.0, 0.7
ZNEAR, ZFAR = 0.01, 100.0
N_POSES = 5
KEYS = ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy")


def _world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    rt = np.zeros((4, 4))
    rt[:3, :3] = R.transpose()
    rt[:3, 3] = t
    rt[3, 3] = 1.0
    return np.float32(rt)


def _projection() -> np.ndarray:
    tan_y, tan_x = math.tan(FOVY / 2), math.tan(FOVX / 2)
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return np.float32(p)


def camera_arrays(yaw: float, x_offset: float) -> dict:
    """The program's camera inputs (float32 numpy) of a camera turned by
    ``yaw`` and shifted by ``x_offset`` along x in its own frame."""
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    wv = _world_to_view(R, np.array([x_offset, 0.0, 0.0]))
    full = np.float32(_projection() @ wv)
    return {"world_view": wv, "full_proj": full,
            "camera_center": np.float32(np.linalg.inv(wv)[:3, 3]),
            "tanfovx": np.float32(math.tan(FOVX * 0.5)),
            "tanfovy": np.float32(math.tan(FOVY * 0.5))}


def pan_pose(k: int) -> dict:
    """Pose k of the pan (chip_smoke.py:460-468)."""
    return camera_arrays(0.04 * (k - N_POSES // 2),
                         0.15 * (k - N_POSES // 2))


def path_pose(i: int, period: int, phases: tuple[float, float]) -> dict:
    """Frame i of a closed, smooth camera path inside the pan's range:
    yaw within ±0.08 and the x offset within ±0.3, one turn of the yaw and
    two of the offset every ``period`` frames, started at ``phases``."""
    u = 2.0 * math.pi * i / period
    return camera_arrays(0.08 * math.sin(u + phases[0]),
                         0.3 * math.sin(2.0 * u + phases[1]))


def stack(cams: list[dict], device) -> dict:
    """The cameras as stacked device tensors: key -> [len(cams), ...]."""
    return {k: torch.from_numpy(np.stack([c[k] for c in cams])).to(device)
            for k in KEYS}


def pick(cams: dict, i: int) -> dict:
    """Camera i of stacked cameras (views of the device tensors)."""
    return {k: v[i] for k, v in cams.items()}
