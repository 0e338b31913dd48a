"""Per-group Adam for the Gaussian parameters.

Port of rain_tpu/model/adam.py, itself the reference's torch.optim.Adam
set-up (scene/gaussian_model.py:144-153): one learning rate per parameter
group, eps = 1e-15 *outside* the sqrt, one shared step count with bias
correction, and moments kept as capacity-shaped tensors that
densification can permute and zero row by row.

``torch.optim.Adam`` is not used: it folds the bias corrections into the
step size and the denominator in another order, so it rounds differently.
``update`` is the JAX formula as written (adam.py:61-71): m/b1c, v/b2c and
p - lr·m̂/(√v̂ + eps), with b1c and b2c in f32 from the shared step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.model.gaussians import GaussianParams

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


class AdamState(NamedTuple):
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor    # 0-d int32


def init(params: GaussianParams) -> AdamState:
    """Zero moments on the parameters' device, step 0."""
    def zeros():
        return GaussianParams(*[torch.zeros_like(p) for p in params])

    return AdamState(mu=zeros(), nu=zeros(),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=params.xyz.device))


def from_numpy(mu: dict[str, np.ndarray], nu: dict[str, np.ndarray], step,
               device=None) -> AdamState:
    """Carry an Adam state over from numpy arrays: ``mu`` and ``nu`` keyed
    by the GaussianParams field names (``np.asarray`` of each field of the
    JAX package's AdamState.mu / .nu), ``step`` its step count."""
    dev = device_mod.resolve(device)

    def leaves(d):
        return GaussianParams(*[
            torch.from_numpy(np.array(d[k], np.float32)).to(dev)
            for k in GaussianParams._fields])

    return AdamState(mu=leaves(mu), nu=leaves(nu),
                     step=torch.tensor(int(step), dtype=torch.int32,
                                       device=dev))


def learning_rates(opt_cfg, xyz_lr) -> GaussianParams:
    """Per-leaf learning rates (gaussian_model.py:144-151): ``xyz_lr`` is
    the scheduled position lr, the rest are constants of ``opt_cfg`` (an
    object with feature_lr, scaling_lr, rotation_lr and opacity_lr)."""
    return GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
    )


def update(params: GaussianParams, grads: GaussianParams,
           state: AdamState, lrs: GaussianParams
           ) -> tuple[GaussianParams, AdamState]:
    """One Adam step (torch semantics); returns new tensors and leaves its
    inputs untouched. Dead rows have zero grads and zero moments, so they
    stay exactly unchanged. A learning rate may be a float or a 0-d f32
    tensor."""
    step = state.step + 1
    b1c = 1.0 - BETA1 ** step.to(torch.float32)
    b2c = 1.0 - BETA2 ** step.to(torch.float32)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs):
        m = BETA1 * m + (1.0 - BETA1) * g
        v = BETA2 * v + (1.0 - BETA2) * (g * g)
        m_hat = m / b1c
        v_hat = v / b2c
        new_p.append(p - lr * m_hat / (torch.sqrt(v_hat) + EPS))
        new_m.append(m)
        new_v.append(v)
    return GaussianParams(*new_p), AdamState(
        mu=GaussianParams(*new_m), nu=GaussianParams(*new_v), step=step)


def zero_moments_for(state: AdamState, leaf_name: str) -> AdamState:
    """Reset one group's moments (replace_tensor_to_optimizer,
    gaussian_model.py:248-261, used by reset_opacity)."""
    idx = GaussianParams._fields.index(leaf_name)
    mu = state.mu._replace(**{leaf_name: torch.zeros_like(state.mu[idx])})
    nu = state.nu._replace(**{leaf_name: torch.zeros_like(state.nu[idx])})
    return AdamState(mu=mu, nu=nu, step=state.step)
