"""The entry points of __graft_entry__.py: a forward render of a synthetic
scene, a dry run of the sharded step, and the scaling sweep.

``entry`` ports __graft_entry__.py:entry (:16-60): 1,500 Gaussians from a
seeded point cloud, initialised as a training run would
(``create_from_pcd``, capacity 2,048, KNN window 32), rendered at 256x192
with SH degree 3 and an instance tier of 32,768.

``dryrun_multichip`` (:63-127) runs one full sharded training step over
``n`` ranks (parallel.sharding, one process per rank): 200 Gaussians,
capacity 256, a 64 x 16·max(n, 2) image (at least one tile row a rank),
a per-band tier of 4,096. ``scaling_sweep`` (:131-150) sweeps 1, 2, 4, ...
ranks up to ``max_devices`` (parallel.scaling). rain_tpu drops to a
virtual CPU mesh when too few devices are visible; the port does not: too
few cards raise, unless the caller passes ``device="cpu"`` or
``share_device=True`` (every rank on one card, over gloo).

    from rain_tpu_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    image = fn(*args)           # [3, 192, 256]
    dryrun_multichip(4, share_device=True)
"""

from __future__ import annotations

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.data.cameras import Camera
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.parallel import distributed, launch, scaling, sharding

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


DRYRUN_N, DRYRUN_CAPACITY, DRYRUN_TIER = 200, 256, 4096
DRYRUN_OPT_LEAVES = {"feature_lr": 0.0025, "opacity_lr": 0.05,
                     "scaling_lr": 0.005, "rotation_lr": 0.001}


def _dryrun_rank(rank, device, width, height):
    """One rank of ``dryrun_multichip``: (loss, overflow, instances, the
    sum of its shard's denom)."""
    pts, cols = _synthetic_scene(DRYRUN_N, seed=1)
    state = gmod.create_from_pcd(pts, cols, sh_degree=3,
                                 capacity=DRYRUN_CAPACITY, knn_window=16,
                                 device=device)
    world = distributed.world_size()
    opt = adam_mod.init(state.params)
    gt = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (3, height, width)).astype(np.float32)).to(device)
    step = sharding.make_sharded_train_step(
        width=width, height=height, sh_degree=3,
        max_instances_per_shard=DRYRUN_TIER)
    s, _, aux = step(sharding.shard_state(state, rank, world),
                     sharding.shard_opt(opt, rank, world),
                     _camera(width, height, device), gt,
                     torch.zeros(3, device=device), 0.3,
                     torch.full((), 1e-4, device=device), DRYRUN_OPT_LEAVES)
    return (float(aux.loss), bool(aux.instance_overflow),
            int(aux.num_instances), float(s.denom.sum()))


def dryrun_multichip(n_devices: int, *, device=None, backend=None,
                     share_device: bool = False) -> dict:
    """One full sharded training step over ``n_devices`` ranks (see the
    module docstring). Raises AssertionError unless the loss is finite, no
    band overflows and the densify statistics moved (denom summed over
    every shard > 0). Returns {"loss", "num_instances", "denom_sum"}."""
    width, height = 64, 16 * max(n_devices, 2)
    outs = launch.spawn(_dryrun_rank, n_devices, device=device,
                        share_device=share_device, backend=backend,
                        args=(width, height))
    loss, _, n_inst, _ = outs[0]
    denom = sum(o[3] for o in outs)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: loss {loss}")
    if any(o[1] for o in outs):
        raise AssertionError(f"dryrun_multichip: a band overflowed the "
                             f"tier {DRYRUN_TIER} ({n_inst} instances)")
    if not denom > 0:
        raise AssertionError("dryrun_multichip: no densify statistics")
    print(f"dryrun_multichip({n_devices}): loss={loss:.5f} OK")
    return {"loss": loss, "num_instances": n_inst, "denom_sum": denom}


def scaling_sweep(max_devices: int = 8, *, device=None, backend=None,
                  share_device: bool = False, **kw):
    """``parallel.scaling.scaling_sweep`` over 1, 2, 4, ... ranks up to
    ``max_devices``; the keyword arguments go to it."""
    counts = [1]
    while counts[-1] * 2 <= max_devices:
        counts.append(counts[-1] * 2)
    return scaling.scaling_sweep(counts, device=device, backend=backend,
                                 share_device=share_device, **kw)
