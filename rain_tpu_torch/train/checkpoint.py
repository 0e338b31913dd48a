"""PLY snapshots of the Gaussian state.

Port of the PLY half of rain_tpu/train/checkpoint.py (:84-100), the
counterpart of the reference's scene.save (scene/__init__.py:77-79). The
files use the reference attribute schema (data/ply.py), so snapshots
written by either package load in the other. The npz training checkpoints
come with the Trainer loop.
"""

from __future__ import annotations

from rain_tpu_torch.data import ply as ply_io
from rain_tpu_torch.model import gaussians as gmod


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
