"""Throughput of the sharded train step at several world sizes.

Port of rain_tpu/parallel/scaling.py (:77-144): the same seeded scene
(8,000 points, capacity 8,000, the Morton KNN with window 32), camera,
ground truth and learning rates, the per-band tier max(2^20 / D, 32768),
and the same dicts. Each world size D runs in D fresh processes
(parallel.launch.spawn); every rank takes one step to warm up, then times
``iters`` steps on the host clock, its device synchronised; the sweep
takes the slowest rank's time.

Ranks that share one card (``share_device``) or the CPU measure the step's
logic and overheads, not scaling: efficiency there is bounded by the one
device they share.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.parallel import distributed, launch, sharding

OPT_LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05,
              "scaling_lr": 0.005, "rotation_lr": 0.001}
TIMEOUT_S = 900.0    # per world size: spawn, the KNN init and the steps


def _sweep_rank(rank, device, width, height, n_gaussians, iters):
    """One rank of a sweep point: the seconds per step over ``iters``
    steps after one warm-up step."""
    rng = np.random.default_rng(0)
    n = n_gaussians
    pts = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                          rng.uniform(2.5, 8.0, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    world = distributed.world_size()
    state = gmod.create_from_pcd(pts, cols, sh_degree=3, capacity=n,
                                 knn_window=32, device=device)
    opt = adam_mod.init(state.params)
    s = sharding.shard_state(state, rank, world)
    o = sharding.shard_opt(opt, rank, world)
    del state, opt
    camera = Camera(uid=0, image_name="sweep", R=np.eye(3), T=np.zeros(3),
                    fovx=0.9, fovy=0.9, image=None, width=width,
                    height=height).render_inputs(device)
    gt = torch.from_numpy(rng.uniform(0, 1, (3, height, width)).astype(
        np.float32)).to(device)
    bg = torch.zeros(3, device=device)
    xyz_lr = torch.full((), 1.6e-4, device=device)
    step = sharding.make_sharded_train_step(
        width=width, height=height, sh_degree=3,
        max_instances_per_shard=max(1_048_576 // world, 32768))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    s, o, aux = step(s, o, camera, gt, bg, 0.3, xyz_lr, OPT_LEAVES)
    if bool(aux.instance_overflow):
        raise RuntimeError(f"the sweep's step overflowed its tier: "
                           f"{int(aux.num_instances)} instances")
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        s, o, aux = step(s, o, camera, gt, bg, 0.3, xyz_lr, OPT_LEAVES)
    sync()
    return (time.perf_counter() - t0) / iters


def scaling_sweep(device_counts, *, device=None, share_device: bool = False,
                  backend: str | None = None, width: int = 256,
                  height: int = 256, n_gaussians: int = 8_000,
                  iters: int = 4, log_fn=print):
    """Times the sharded train step at each world size of
    ``device_counts``.

    Returns a list of dicts {n_dev, steps_per_s, mpix_per_s, efficiency}
    (efficiency = throughput / (throughput of the first count · n_dev /
    first count)). ``device``, ``share_device`` and ``backend`` place the
    ranks as parallel.launch.spawn does: on the CUDA cards by default, one
    per rank (RuntimeError with too few), all on one card with
    ``share_device``, or on the CPU with ``device="cpu"``.
    """
    results = []
    base = None
    for n_dev in device_counts:
        dts = launch.spawn(_sweep_rank, n_dev, device=device,
                           share_device=share_device, backend=backend,
                           timeout_s=TIMEOUT_S,
                           args=(width, height, n_gaussians, iters))
        steps_per_s = 1.0 / max(dts)
        mpix = width * height * steps_per_s / 1e6
        if base is None:
            base = steps_per_s
        eff = steps_per_s / (base * n_dev / device_counts[0])
        results.append({"n_dev": n_dev, "steps_per_s": round(steps_per_s, 3),
                        "mpix_per_s": round(mpix, 3),
                        "efficiency": round(eff, 3)})
        log_fn(f"[sweep] {n_dev} dev: {steps_per_s:.2f} steps/s "
               f"({mpix:.1f} Mpix/s), efficiency {eff:.2f}")
    return results
