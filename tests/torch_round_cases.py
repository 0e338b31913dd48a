"""Seeded densify rounds for the compiled round's checks: a state spread
and given statistics and Adam moments by seeded draws, the round's six
scalars as 0-d tensors, split noise, and the bitwise comparison of two
rounds' (or resets') results.

tests/test_torch_compiled.py and tests/test_torch_cuda.py use it, and
chip_smoke.py loads it by path (phase 16); it imports numpy and torch
only. The draws are torch's, from a generator on the state's device: a
comparison holds two paths on one device.
"""

import numpy as np
import torch

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.train.compiled import ROUND_SCALARS


def _gen(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def seeded(state: gmod.GaussianState, n_alive: int, seed: int):
    """(state, opt) from ``state``: ``n_alive`` rows alive; on them the
    log-scales moved by U(-1, 1), random rotations, the opacity logits
    moved by N(0, 3) (some below the prune threshold), denom in 1..5,
    gradient norms U(0, 4e-4) (half above the default threshold 2e-4),
    screen radii U(0, 40), and Adam moments N(0, 1e-3) and |N(0, 1e-6)| at
    step 7; zeros past them."""
    dev = state.params.xyz.device
    g = _gen(dev, seed)
    cap = state.capacity
    live = (torch.arange(cap, device=dev) < n_alive)

    def draw(shape, fn):
        x = fn(torch.empty(shape, device=dev))
        return torch.where(live.reshape((-1,) + (1,) * (len(shape) - 1)),
                           x, torch.zeros((), device=dev))

    p = state.params
    params = p._replace(
        scaling=torch.where(live[:, None], p.scaling + draw(
            p.scaling.shape, lambda t: t.uniform_(-1, 1, generator=g)),
            p.scaling),
        rotation=torch.where(live[:, None], draw(
            p.rotation.shape, lambda t: t.normal_(generator=g)),
            p.rotation),
        opacity=p.opacity + draw(p.opacity.shape,
                                 lambda t: t.normal_(0, 3, generator=g)))
    denom = draw((cap,), lambda t: t.random_(1, 6, generator=g))
    accum = draw((cap,), lambda t: t.uniform_(0, 4e-4, generator=g)) * denom
    radii = draw((cap,), lambda t: t.uniform_(0, 40, generator=g))
    out = gmod.GaussianState(params, n_alive, max_radii2d=radii,
                             xyz_gradient_accum=accum, denom=denom)

    def moments(fn):
        return gmod.GaussianParams(*[draw(x.shape, fn) for x in p])

    opt = adam_mod.AdamState(
        mu=moments(lambda t: t.normal_(0, 1e-3, generator=g)),
        nu=moments(lambda t: t.normal_(0, 1e-6, generator=g).abs_()),
        step=torch.full((), 7, dtype=torch.int32, device=dev))
    return out, opt


def scalars(k: int, device, **override) -> dict:
    """The round's six scalars, varied with ``k``, as 0-d f32 tensors on
    ``device``: extent 1.1 (so percent_dense·extent parts the spread
    scales into clones and splits), the Trainer's thresholds otherwise.
    ``override`` sets any of them."""
    values = dict(max_grad=2e-4 * (1 + 0.1 * k),
                  min_opacity=0.005 * (1 + 0.2 * k),
                  extent=1.1 * (1 + 0.05 * k), percent_dense=0.01,
                  divide_ratio=0.8 - 0.05 * k,
                  size_threshold=20.0 + 2.0 * k)
    values.update(override)
    return {name: torch.full((), values[name], dtype=torch.float32,
                             device=device) for name in ROUND_SCALARS}


def noise(capacity: int, device, seed: int, n_split: int = 2):
    """Split noise [n_split, capacity, 3], standard normal."""
    return torch.randn((n_split, capacity, 3), generator=_gen(device, seed),
                       device=device)


def leaves(state, opt) -> list:
    """A round's or reset's tensors: params, statistics, moments, step."""
    return (list(state.params) +
            [getattr(state, k) for k in gmod.STAT_FIELDS] +
            list(opt.mu) + list(opt.nu) + [opt.step])


def bits(x: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits (signed zeros and NaNs told apart)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(a, b) -> bool:
    """Two (state, opt, info) results, or two (state, opt), equal bit for
    bit: every tensor, n_alive and the info."""
    if len(a) != len(b) or a[0].n_alive != b[0].n_alive or \
            tuple(a[2:]) != tuple(b[2:]):
        return False
    return all(x.shape == y.shape and torch.equal(bits(x), bits(y))
               for x, y in zip(leaves(*a[:2]), leaves(*b[:2])))


def host(result):
    """A result's tensors copied to host memory, as numpy arrays."""
    return [np.asarray(x.cpu()) for x in leaves(*result[:2])]
