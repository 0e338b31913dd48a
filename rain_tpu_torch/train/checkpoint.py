"""Checkpoint save/restore: full training state + PLY interchange.

Port of rain_tpu/train/checkpoint.py, with its two mechanisms:
1. full checkpoint (npz): params + Adam moments + densification stats +
   iteration + spatial_lr_scale, the counterpart of
   ``torch.save((gaussians.capture(), iteration))`` (train.py:149-151,
   gaussian_model.py:51-83). Only the alive prefix is stored, so files are
   capacity-independent; restore pads to any capacity. The keys are
   rain_tpu's, so a file written by either package loads in the other.
2. PLY snapshots with the reference attribute schema (data/ply.py;
   scene/__init__.py:77-79), also readable by both packages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod


def save_checkpoint(path, state: gmod.GaussianState,
                    opt: adam_mod.AdamState, iteration: int,
                    spatial_lr_scale: float):
    """Write the live rows of ``state`` and ``opt`` to an npz file."""
    n = state.n_alive
    payload = {"iteration": iteration, "n_alive": n,
               "spatial_lr_scale": spatial_lr_scale,
               "adam_step": int(opt.step)}

    def host(x):
        return x[:n].detach().cpu().numpy()

    for i, name in enumerate(gmod.GaussianParams._fields):
        payload[f"params.{name}"] = host(state.params[i])
        payload[f"mu.{name}"] = host(opt.mu[i])
        payload[f"nu.{name}"] = host(opt.nu[i])
    for name in gmod.STAT_FIELDS:
        payload[name] = host(getattr(state, name))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **payload)


def load_checkpoint(path, capacity: int | None = None, device=None):
    """Read an npz checkpoint onto ``device`` (default: the CUDA card),
    padded to ``capacity`` rows (default: the stored count). Returns
    (state, opt, iteration, spatial_lr_scale)."""
    with np.load(path) as z:
        n = int(z["n_alive"])
        capacity = capacity or n
        if capacity < n:
            raise ValueError(f"{n} stored Gaussians do not fit a capacity "
                             f"of {capacity}")
        state = gmod.from_numpy(
            {k: z[f"params.{k}"] for k in gmod.GaussianParams._fields}, n,
            capacity=capacity, device=device,
            stats={k: z[k] for k in gmod.STAT_FIELDS})
        dev = state.params.xyz.device

        def moments(prefix):
            leaves = []
            for name, like in zip(gmod.GaussianParams._fields, state.params):
                full = torch.zeros_like(like)
                full[:n] = torch.from_numpy(
                    np.array(z[f"{prefix}.{name}"], np.float32)).to(dev)
                leaves.append(full)
            return gmod.GaussianParams(*leaves)

        opt = adam_mod.AdamState(
            mu=moments("mu"), nu=moments("nu"),
            step=torch.tensor(int(z["adam_step"]), dtype=torch.int32,
                              device=dev))
        return state, opt, int(z["iteration"]), float(z["spatial_lr_scale"])


def save_ply_snapshot(path, state: gmod.GaussianState):
    """Write the live rows of ``state`` as a 3DGS PLY file."""
    n = state.n_alive
    p = [t[:n].detach().cpu().numpy() for t in state.params]
    xyz, f_dc, f_rest, scaling, rotation, opacity = p
    ply_io.write_gaussians(path, xyz, f_dc, f_rest, opacity, scaling,
                           rotation)


def load_ply_snapshot(path, max_sh_degree: int = 3,
                      capacity: int | None = None,
                      device=None) -> gmod.GaussianState:
    """Read a 3DGS PLY file into a state on ``device`` (default: the CUDA
    card)."""
    d = ply_io.read_gaussians(path, max_sh_degree)
    return gmod.from_arrays(
        xyz=d["xyz"], f_dc=d["f_dc"], f_rest=d["f_rest"],
        scaling=d["scaling"], rotation=d["rotation"], opacity=d["opacity"],
        capacity=capacity or d["xyz"].shape[0], device=device)
