"""The single-device entry point: a forward render of a synthetic scene.

Port of __graft_entry__.py:entry (:16-60): 1,500 Gaussians from a seeded
point cloud, initialised as a training run would (``create_from_pcd``,
capacity 2,048, KNN window 32), rendered at 256x192 with SH degree 3 and
an instance tier of 32,768. ``dryrun_multichip`` and ``scaling_sweep``
wait for the multi-GPU slice.

    from rain_tpu_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    image = fn(*args)           # [3, 192, 256]
"""

from __future__ import annotations

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops

WIDTH, HEIGHT = 256, 192
N_GAUSS, CAPACITY, MAX_INSTANCES = 1500, 2048, 32768


def _synthetic_scene(n: int, seed: int = 0):
    """n points in front of the camera and their colours, from a seed."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                          rng.uniform(2.5, 6.0, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def _camera(width: int, height: int, device) -> dict:
    cam = Camera(uid=0, image_name="entry", R=np.eye(3), T=np.zeros(3),
                 fovx=0.9, fovy=0.7, image=None, width=width, height=height)
    return cam.render_inputs(device)


def entry(device=None):
    """(fn, args): ``fn(params, n_alive)`` renders the scene's [3, 192,
    256] image from its params; ``args`` are the initial state's. Runs on
    the CUDA card unless ``device`` says otherwise (RuntimeError without
    one)."""
    dev = device_mod.resolve(device)
    pts, cols = _synthetic_scene(N_GAUSS)
    state = gmod.create_from_pcd(pts, cols, sh_degree=3, capacity=CAPACITY,
                                 knn_window=32, device=dev)
    camera = _camera(WIDTH, HEIGHT, dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)

    def fn(params: gmod.GaussianParams, n_alive: int) -> torch.Tensor:
        scales, quats, opac, shs = gmod.activate(params)
        alive = torch.arange(CAPACITY, device=dev) < n_alive
        return render_ops.render(
            params.xyz, scales, quats, opac, shs, alive, camera=camera,
            width=WIDTH, height=HEIGHT, sh_degree=3, bg=bg,
            max_instances=MAX_INSTANCES).render

    return fn, (state.params, state.n_alive)
