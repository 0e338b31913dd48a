"""Per-group Adam for the Gaussian parameters.

Port of rain_tpu/model/adam.py, itself the reference's torch.optim.Adam
set-up (scene/gaussian_model.py:144-153): one learning rate per parameter
group, eps = 1e-15 *outside* the sqrt, one shared step count with bias
correction, and moments kept as capacity-shaped tensors that
densification can permute and zero row by row.

``torch.optim.Adam`` is not used: it folds the bias corrections into the
step size and the denominator in another order, so it rounds differently.
``update_plain`` is the JAX formula as written (adam.py:61-71): m/b1c,
v/b2c and p - lr·m̂/(√v̂ + eps), with b1c and b2c in f32 from the shared
step.

``update`` follows the leaves' device, as every kernel wrapper does:

- CPU leaves run ``update_plain``, about 14 element-wise ops a leaf.
- CUDA leaves run the kernel AD of ``csrc/adam.cu``: one launch over all
  six leaves, which reads p, g, m and v once and writes p', m' and v'
  once (28 bytes a parameter). b1c and b2c stay the two torch ops of
  ``update_plain`` and the kernel reads them, and each leaf's learning
  rate, from device memory, so a replayed CUDA graph uses each step's
  values; a learning rate given as a number or a 0-d tensor in host
  memory is filled on the device first. The kernel keeps ``update_plain``'s order and rounds each
  operation on its own as ATen does (the constants are the f32 values
  ATen casts the Python doubles to, division and square root IEEE), so
  its p', m' and v' equal ``update_plain``'s on the card bit for bit.

Either way ``update`` returns new tensors and leaves its inputs
untouched, and dead rows (zero gradients and moments) stay exactly
unchanged. It takes contiguous f32 leaves of matching shapes on one
device, learning rates that are numbers or 0-d f32 tensors there or in
host memory, and a step count there, and raises ValueError on anything
else: no copy, no fallback. It counts its launches in ``update.launches``: one a call on
the card, none on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch import _build
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


def update_plain(params: GaussianParams, grads: GaussianParams,
                 state: AdamState, lrs: GaussianParams
                 ) -> tuple[GaussianParams, AdamState]:
    """One Adam step (torch semantics) in element-wise torch ops; returns
    new tensors and leaves its inputs untouched. Dead rows have zero grads
    and zero moments, so they stay exactly unchanged. A learning rate may
    be a float or a 0-d f32 tensor."""
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


class _LeafArgs(ctypes.Structure):
    """One leaf of the kernel's table (``csrc/adam.cu``'s LeafArgs)."""
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("p", "g", "m", "v", "p_out", "m_out", "v_out", "lr")] + [
        ("n", ctypes.c_longlong)]


def _check(params: GaussianParams, grads: GaussianParams,
           state: AdamState, lrs: GaussianParams) -> torch.device:
    """The leaves' device; raises ValueError on what the kernel does not
    take."""
    dev = params.xyz.device
    for name, p, g, m, v, lr in zip(GaussianParams._fields, params, grads,
                                    state.mu, state.nu, lrs):
        for what, t in (("parameter", p), ("gradient", g),
                        ("first moment", m), ("second moment", v)):
            if t.dtype != torch.float32 or not t.is_contiguous() or \
                    t.device != dev or t.shape != p.shape:
                raise ValueError(
                    f"adam.update takes contiguous float32 leaves of one "
                    f"shape on {dev}; {name}'s {what} is {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}, strides {t.stride()}")
        if isinstance(lr, torch.Tensor) and (
                lr.dim() != 0 or lr.dtype != torch.float32 or
                lr.device not in (dev, torch.device("cpu"))):
            raise ValueError(f"{name}'s learning rate must be a number or "
                             f"a 0-d float32 tensor on {dev} or the CPU, got "
                             f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
    if state.step.device != dev:
        raise ValueError(f"the step count must lie on {dev}, got "
                         f"{state.step.device}")
    return dev


def update(params: GaussianParams, grads: GaussianParams,
           state: AdamState, lrs: GaussianParams
           ) -> tuple[GaussianParams, AdamState]:
    """One Adam step (torch semantics): ``update_plain`` on CPU leaves,
    the kernel AD (``csrc/adam.cu``, through ``update_kernel``) on CUDA
    leaves, with the same bits (see the module docstring). Returns new
    tensors and leaves its inputs untouched. Raises ValueError on what the
    kernel does not take."""
    dev = _check(params, grads, state, lrs)
    if dev.type == "cpu":
        return update_plain(params, grads, state, lrs)
    if dev.type != "cuda":
        raise ValueError(f"no Adam update on {dev}")
    step = state.step + 1
    b1c = 1.0 - BETA1 ** step.to(torch.float32)
    b2c = 1.0 - BETA2 ** step.to(torch.float32)
    new_p, new_m, new_v = [
        GaussianParams(*[torch.empty_like(x) for x in leaves])
        for leaves in (params, state.mu, state.nu)]
    update_kernel(params, grads, state, [_lr_on(dev, lr) for lr in lrs],
                  b1c, b2c, new_p, new_m, new_v)
    return new_p, AdamState(mu=new_m, nu=new_v, step=step)


def _lr_on(dev: torch.device, lr) -> torch.Tensor:
    """A learning rate as a 0-d f32 tensor on ``dev``. A number, or a 0-d
    tensor in host memory, is a host value: it is filled on ``dev`` (a
    launch, no wait), rounded to f32 as ATen rounds a host scalar for an
    f32 tensor."""
    if isinstance(lr, torch.Tensor) and lr.device == dev:
        return lr
    return torch.full((), float(lr), dtype=torch.float32, device=dev)


def update_kernel(params: GaussianParams, grads: GaussianParams,
                  state: AdamState, lrs: list, b1c: torch.Tensor,
                  b2c: torch.Tensor, new_p: GaussianParams,
                  new_m: GaussianParams, new_v: GaussianParams) -> None:
    """One launch of AD on the current stream: writes the new parameters
    and moments into ``new_p``, ``new_m`` and ``new_v`` (``state.step`` is
    not read). ``lrs`` are 0-d f32 tensors, ``b1c`` and ``b2c`` the step's
    bias corrections, all on the leaves' CUDA device; the caller has
    checked the leaves (``update``)."""
    table = (_LeafArgs * len(params))(*[
        _LeafArgs(*[t.data_ptr() for t in leaf], leaf[0].numel())
        for leaf in zip(params, grads, state.mu, state.nu, new_p, new_m,
                        new_v, lrs)])
    f = _build.kernel("adam", "rain_adam_update", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float))
    # the constants go as Python doubles: ctypes rounds each to the
    # nearest f32, as ATen casts a Python number for an f32 tensor
    _build.launch(f, params.xyz.device, ctypes.addressof(table),
                  b1c.data_ptr(), b2c.data_ptr(), BETA1, 1.0 - BETA1, BETA2,
                  1.0 - BETA2, EPS)
    update.launches += 1


update.launches = 0


def zero_moments_for(state: AdamState, leaf_name: str) -> AdamState:
    """Reset one group's moments (replace_tensor_to_optimizer,
    gaussian_model.py:248-261, used by reset_opacity)."""
    idx = GaussianParams._fields.index(leaf_name)
    mu = state.mu._replace(**{leaf_name: torch.zeros_like(state.mu[idx])})
    nu = state.nu._replace(**{leaf_name: torch.zeros_like(state.nu[idx])})
    return AdamState(mu=mu, nu=nu, step=state.step)
