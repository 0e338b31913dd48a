"""Scene data: the container the Trainer consumes and the nerf++ radius.

Port of ``SceneData`` and ``nerfpp_norm`` of rain_tpu/data/dataset.py
(:28-36, :71-81), numpy only. The COLMAP and Blender loaders come with the
data slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rain_tpu_torch.data.cameras import Camera, world_to_view


@dataclasses.dataclass
class SceneData:
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    points: np.ndarray          # [N, 3]
    colors: np.ndarray          # [N, 3] in [0, 1]
    nerf_radius: float          # cameras_extent (scene/__init__.py:61)
    nerf_translate: np.ndarray
    ply_path: str | None = None


def nerfpp_norm(cameras: list[Camera]):
    """(getNerfppNorm, dataset_readers.py:34-55)."""
    centers = []
    for cam in cameras:
        w2c = world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = float(np.linalg.norm(centers - avg, axis=0).max())
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}
