"""Gaussian scene state: fixed-capacity parameter tensors with an alive count.

Port of rain_tpu/model/gaussians.py (itself the counterpart of the
reference GaussianModel, scene/gaussian_model.py:13-137). Parameters live
in capacity-C tensors; the first ``n_alive`` rows are live and dead rows
hold valid placeholders (identity quaternion etc.), so no NaN can come out
of a masked row.

Parameterization (identical to the reference):
  xyz            [C, 3]   raw positions
  features_dc    [C, 1, 3]  SH DC coefficients
  features_rest  [C, K-1, 3] higher SH coefficients (K = (deg+1)^2)
  scaling        [C, 3]   log-scales     (activation: exp)
  rotation       [C, 4]   quaternions    (activation: L2 normalize)
  opacity        [C, 1]   logits         (activation: sigmoid)

The state also carries the densification statistics of the JAX state
(max_radii2d, xyz_gradient_accum, denom; gaussian_model.py:137-141),
zeros at construction. ``create_from_pcd`` initialises a state from a
point cloud (the KNN init) and ``grow_capacity`` pads one with dead rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.ops import knn as knn_ops
from rain_tpu_torch.ops import sh as sh_ops


class GaussianParams(NamedTuple):
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


class GaussianState(NamedTuple):
    params: GaussianParams
    n_alive: int
    max_radii2d: torch.Tensor         # [C] f32
    xyz_gradient_accum: torch.Tensor  # [C] f32
    denom: torch.Tensor               # [C] f32

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]


# The densification statistics of GaussianState, each [C] f32.
STAT_FIELDS = ("max_radii2d", "xyz_gradient_accum", "denom")


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def activate(params: GaussianParams):
    """Raw → rendering quantities (gaussian_model.py:15-31,85-105)."""
    scales = torch.exp(params.scaling)
    norm = torch.sqrt(torch.sum(params.rotation * params.rotation, dim=-1,
                                keepdim=True))
    quats = params.rotation / norm
    opacity = torch.sigmoid(params.opacity[:, 0])
    shs = torch.cat([params.features_dc, params.features_rest], dim=1)
    return scales, quats, opacity, shs


def alive_mask(state: GaussianState) -> torch.Tensor:
    return torch.arange(state.capacity,
                        device=state.params.xyz.device) < state.n_alive


def _dead_fill(capacity: int, sh_rest: int,
               device: torch.device) -> GaussianParams:
    """Placeholder values for dead slots (NaN-safe under all activations)."""
    rot = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    rot[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), device=device),
        features_dc=torch.zeros((capacity, 1, 3), device=device),
        features_rest=torch.zeros((capacity, sh_rest, 3), device=device),
        scaling=torch.full((capacity, 3), -10.0, device=device),
        rotation=rot,
        opacity=torch.full((capacity, 1), -10.0, device=device),
    )


def from_arrays(xyz, f_dc, f_rest, scaling, rotation, opacity,
                capacity: int | None = None, device=None) -> GaussianState:
    """Build a state from raw attribute arrays (e.g. a loaded PLY) on
    ``device`` (default: the CUDA card)."""
    dev = device_mod.resolve(device)
    n = xyz.shape[0]
    capacity = capacity or n
    if n > capacity:
        raise ValueError(f"{n} Gaussians do not fit a capacity of {capacity}")
    params = _dead_fill(capacity, f_rest.shape[1], dev)
    for dst, src in zip(params, (xyz, f_dc, f_rest, scaling, rotation,
                                 opacity)):
        dst[:n] = torch.from_numpy(np.array(src, np.float32)).to(dev)
    return GaussianState(params=params, n_alive=n,
                         **{k: torch.zeros(capacity, device=dev)
                            for k in STAT_FIELDS})


def from_numpy(params: dict[str, np.ndarray], n_alive: int,
               capacity: int | None = None, device=None,
               stats: dict[str, np.ndarray] | None = None) -> GaussianState:
    """Carry a state over from numpy arrays keyed by the GaussianParams
    field names (``np.asarray`` of each field of the JAX package's
    GaussianParams). The first ``n_alive`` rows are taken; the capacity
    defaults to the arrays' own. ``stats``, keyed by STAT_FIELDS (the JAX
    GaussianState's fields of those names), carries the densification
    statistics over too; without it they are zeros."""
    n_alive = int(n_alive)
    rows = {k: np.asarray(params[k])[:n_alive] for k in GaussianParams._fields}
    state = from_arrays(
        rows["xyz"], rows["features_dc"], rows["features_rest"],
        rows["scaling"], rows["rotation"], rows["opacity"],
        capacity=capacity or len(params["xyz"]), device=device)
    for k, v in (stats or {}).items():
        getattr(state, k)[:n_alive] = torch.from_numpy(
            np.array(v, np.float32)[:n_alive]).to(state.denom.device)
    return state


def create_from_pcd(points: np.ndarray, colors: np.ndarray, *,
                    sh_degree: int, capacity: int, knn_window: int = 0,
                    device=None) -> GaussianState:
    """Initialise a state from a point cloud on ``device`` (default: the
    CUDA card); gaussian_model.py:114-137.

    Scales: log(sqrt(mean squared 3-NN distance)) per point, floored at
    1e-7 (the distCUDA2 clamp, gaussian_model.py:124), with the exact
    search (``mean_dist3_auto``) or, for ``knn_window`` > 0, the Morton
    window; rotation: identity quaternion; opacity: logit(0.1).
    """
    dev = device_mod.resolve(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points do not fit a capacity of {capacity}")
    k = sh_ops.num_sh_coeffs(sh_degree)
    params = _dead_fill(capacity, k - 1, dev)

    pts = torch.from_numpy(np.array(points, np.float32)).to(dev)
    if knn_window > 0:
        d2 = knn_ops.mean_dist3(pts, window=knn_window)
    else:
        d2 = knn_ops.mean_dist3_auto(pts)
    dist2 = torch.maximum(d2, torch.tensor(1e-7, device=dev))
    # log(sqrt(.)), not 0.5·log(.): the two round differently
    scales = torch.log(torch.sqrt(dist2))[:, None].expand(n, 3)
    f_dc = sh_ops.rgb_to_sh_dc(
        torch.from_numpy(np.array(colors, np.float32)).to(dev))[:, None, :]
    # rain_tpu's inverse_sigmoid(0.1): the quotient in double, rounded to
    # f32, then an f32 log
    opac = torch.log(torch.tensor(0.1 / (1 - 0.1), device=dev))

    params.xyz[:n] = pts
    params.features_dc[:n] = f_dc
    params.scaling[:n] = scales
    params.opacity[:n] = opac
    return GaussianState(params=params, n_alive=n,
                         **{k: torch.zeros(capacity, device=dev)
                            for k in STAT_FIELDS})


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """The state padded to ``new_capacity`` rows: dead-row placeholders
    after the old rows, zero statistics. Returns new tensors."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"cannot shrink capacity {cap} to {new_capacity}")
    if new_capacity == cap:
        return state
    dev = state.params.xyz.device
    fill = _dead_fill(new_capacity - cap,
                      state.params.features_rest.shape[1], dev)
    params = GaussianParams(*[torch.cat([o, f]) for o, f in
                              zip(state.params, fill)])
    return GaussianState(
        params=params, n_alive=state.n_alive,
        **{k: torch.cat([getattr(state, k),
                         torch.zeros(new_capacity - cap, device=dev)])
           for k in STAT_FIELDS})
