"""Adaptive density control: statistics, clone / split / prune, opacity reset.

Port of rain_tpu/model/densify.py, the counterpart of the reference
densification engine (scene/gaussian_model.py:319-421) on fixed-capacity
tensors: selected Gaussians are written into free capacity rows with
unique-index scatters, and pruning is a stable compaction (one permutation
applied to the parameters, Adam's moments and the statistics). Rows end up
in the reference's order: survivors keep their relative order, and
appended rows land after them in clone → abe → split order
(gaussian_model.py:403-415).

Semantics replicated:
- clone: grad-norm >= threshold AND max scale <= percent_dense * extent →
  copy verbatim (gaussian_model.py:388-401).
- split: grad >= threshold AND max scale > percent_dense * extent →
  N=2 children at rotated Gaussian-noise offsets with scales divided by
  (divide_ratio * N); the originals are pruned (gaussian_model.py:366-386).
- abe_split warmup pre-pass: same selection, ONE extra copy placed at
  0.3 * scene_extent * original position with unchanged scale
  (gaussian_model.py:342-363).
- prune: opacity < min_opacity, optionally screen radius > threshold or
  world size > 0.1 * extent (gaussian_model.py:410-415).
- new rows keep the (zero) moments of their free rows
  (cat_tensors_to_optimizer, gaussian_model.py:305-306); pruned rows'
  moments are zeroed (_prune_optimizer, :268-269); the statistics reset to
  zero (densification_postfix, :335-337).

If appends would exceed the capacity the excess rows are dropped and
``overflow`` is set so the caller can grow the capacity.

The scalar thresholds are f32 in rain_tpu's jitted round, so their
products (percent_dense·extent, 0.3·extent, 0.1·extent,
divide_ratio·N) are taken in f32 here too. The split noise is an argument:
rain_tpu draws it inside from ``jax.random.normal(key, (N, C, 3))``, which
torch cannot reproduce, so the caller draws it (the Trainer from its own
``torch.Generator``; the tests feed JAX's draw in).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model.gaussians import (GaussianParams, GaussianState,
                                            STAT_FIELDS, alive_mask,
                                            inverse_sigmoid)


class DensifyInfo(NamedTuple):
    n_cloned: int
    n_split: int
    n_pruned: int
    n_alive: int
    overflow: bool


def add_densification_stats(state: GaussianState, tap_grad: torch.Tensor,
                            radii: torch.Tensor, width,
                            height) -> GaussianState:
    """Accumulate screen-space gradient norms; returns a new state and
    leaves ``state`` untouched.

    ``tap_grad`` [C, 2] is the pixel-unit xy gradient; the reference
    accumulates the NDC-scaled one (backward.cu:450-451), so it is scaled by
    (W/2, H/2) of the TRUE image size. ``radii`` [C] int32 marks the
    visible Gaussians (radii > 0).
    """
    vis = radii > 0
    # two fills, not a copy of host values (torch.tensor, or assigning a
    # Python number to an element), which would wait for the device
    scale = torch.full((2,), 0.5 * width, dtype=torch.float32,
                       device=tap_grad.device)
    scale[1:].fill_(0.5 * height)
    s = tap_grad * scale[None, :]
    g = torch.sqrt(torch.sum(s * s, dim=-1))
    return state._replace(
        xyz_gradient_accum=state.xyz_gradient_accum +
        torch.where(vis, g, torch.zeros_like(g)),
        denom=state.denom + vis.to(torch.float32),
        max_radii2d=torch.where(
            vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d),
    )


def reset_opacity(state: GaussianState, opt: adam_mod.AdamState):
    """Clamp opacity to <= 0.01 (every row, dead ones included, as
    rain_tpu maps them) and reset its moments (gaussian_model.py:200-203).
    Returns a new (state, opt)."""
    op = torch.sigmoid(state.params.opacity)
    new = inverse_sigmoid(torch.clamp(op, max=0.01))
    params = state.params._replace(opacity=new)
    return state._replace(params=params), adam_mod.zero_moments_for(
        opt, "opacity")


def _rotmat(q: torch.Tensor) -> torch.Tensor:
    """[M,4] quaternions → [M,3,3] rotations of the normalised quaternions
    (utils/general_utils.py:52-73)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def _append(params: GaussianParams, n_alive: int, mask: torch.Tensor,
            new_leaves: GaussianParams, copies: int):
    """Write ``copies`` transformed copies of the masked rows into the
    free rows: copy j of the r-th masked row goes to n_alive + r·copies +
    j, and rows at or past the capacity are dropped. ``new_leaves`` holds
    per-copy values shaped [copies, C, ...]. Returns (params, new_n,
    n_appended_requested) as new tensors and Python ints."""
    cap = params.xyz.shape[0]
    src = torch.nonzero(mask).flatten()          # masked rows, in order
    n_sel = int(src.shape[0])
    out = []
    for leaf, new in zip(params, new_leaves):
        leaf = leaf.clone()
        for j in range(copies):
            tgt = n_alive + torch.arange(n_sel, device=src.device) * copies + j
            fits = tgt < cap
            leaf[tgt[fits]] = new[j][src[fits]]
        out.append(leaf)
    appended = n_sel * copies
    return GaussianParams(*out), min(n_alive + appended, cap), appended


def _compact(params: GaussianParams, opt: adam_mod.AdamState,
             keep: torch.Tensor):
    """Stable compaction: survivors first (order kept), then the rest (the
    permutation of a stable argsort of ~keep); moments beyond the new
    alive count are zeroed. Returns (params, opt, new_n)."""
    perm = torch.cat([torch.nonzero(keep).flatten(),
                      torch.nonzero(~keep).flatten()])
    new_n = int(keep.sum())
    params = GaussianParams(*[x[perm] for x in params])

    def perm_zero(x):
        x = x[perm]
        x[new_n:] = 0.0
        return x

    mu = GaussianParams(*[perm_zero(x) for x in opt.mu])
    nu = GaussianParams(*[perm_zero(x) for x in opt.nu])
    return params, adam_mod.AdamState(mu=mu, nu=nu, step=opt.step), new_n


def _f32(x) -> np.float32:
    return np.float32(x)


def densify_and_prune(state: GaussianState, opt: adam_mod.AdamState,
                      noise: torch.Tensor, *,
                      max_grad, min_opacity, extent, percent_dense,
                      divide_ratio, size_threshold=20.0,
                      use_size_threshold: bool = False, n_split: int = 2,
                      abe_split: bool = False):
    """One densification round (gaussian_model.py:403-417); returns a new
    (state, opt, DensifyInfo) and leaves its inputs untouched.

    noise: [n_split, C, 3] standard normal draws, one per capacity row
      (rain_tpu's ``jax.random.normal(key, (n_split, C, 3))``); the split
      children of row i sit at rotation_i · (noise[s, i] · scale_i).
    """
    cap = state.capacity
    dev = state.params.xyz.device
    if tuple(noise.shape) != (n_split, cap, 3):
        raise ValueError(f"noise is {tuple(noise.shape)}, expected "
                         f"{(n_split, cap, 3)}")
    extent = _f32(extent)
    alive = alive_mask(state)
    grads = state.xyz_gradient_accum / state.denom
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    max_scale = torch.exp(state.params.scaling).amax(dim=1)
    small = max_scale <= float(_f32(percent_dense) * extent)
    high_grad = (grads >= float(_f32(max_grad))) & alive
    n0 = state.n_alive

    params = state.params

    # --- clone (gaussian_model.py:388-401): verbatim copies -------------
    clone_mask = high_grad & small
    params, n1, req1 = _append(
        params, n0, clone_mask, GaussianParams(*[x[None] for x in params]),
        copies=1)

    # --- abe_split warmup pre-pass (gaussian_model.py:342-363) ----------
    # selection over the ORIGINAL rows only: appended clones have zero
    # statistics, like the reference's zero-padded grads (:344-345,366-367)
    split_mask = high_grad & ~small
    n2, req2 = n1, 0
    if abe_split:
        abe_leaves = params._replace(
            xyz=params.xyz * float(_f32(0.3) * extent))
        params, n2, req2 = _append(
            params, n1, split_mask,
            GaussianParams(*[x[None] for x in abe_leaves]), copies=1)

    # --- split (gaussian_model.py:366-386) ------------------------------
    stds = torch.exp(params.scaling)                     # activated scales
    samples = noise.to(dev) * stds[None]
    rots = _rotmat(params.rotation)
    # rots[c] @ samples[s, c], the three products summed in order
    offsets = ((rots[None, :, :, 0] * samples[:, :, None, 0] +
                rots[None, :, :, 1] * samples[:, :, None, 1]) +
               rots[None, :, :, 2] * samples[:, :, None, 2])
    # scales / (divide_ratio * N), in log space (gaussian_model.py:377)
    new_scaling = params.scaling - torch.log(
        torch.tensor(_f32(divide_ratio) * _f32(n_split), device=dev))

    def per_copy(x):
        return x[None].expand((n_split,) + tuple(x.shape))

    split_leaves = GaussianParams(
        xyz=params.xyz[None] + offsets,
        features_dc=per_copy(params.features_dc),
        features_rest=per_copy(params.features_rest),
        scaling=per_copy(new_scaling),
        rotation=per_copy(params.rotation),
        opacity=per_copy(params.opacity))
    params, n3, req3 = _append(params, n2, split_mask, split_leaves,
                               copies=n_split)

    # --- prune (split originals + transparency/size, :385-386,410-415) --
    alive3 = torch.arange(cap, device=dev) < n3
    opacity = torch.sigmoid(params.opacity[:, 0])
    prune = split_mask | (opacity < float(_f32(min_opacity)))
    if use_size_threshold:
        big_vs = state.max_radii2d > float(_f32(size_threshold))
        big_ws = torch.exp(params.scaling).amax(dim=1) > \
            float(_f32(0.1) * extent)
        prune = prune | big_vs | big_ws
    keep = alive3 & ~prune

    params, opt, new_n = _compact(params, opt, keep)
    new_state = GaussianState(
        params=params, n_alive=new_n,
        **{k: torch.zeros(cap, device=dev) for k in STAT_FIELDS})
    requested = req1 + req2 + req3
    info = DensifyInfo(
        n_cloned=int(clone_mask.sum()), n_split=int(split_mask.sum()),
        n_pruned=n3 - new_n, n_alive=new_n,
        overflow=(n0 + requested) > cap)
    return new_state, opt, info
