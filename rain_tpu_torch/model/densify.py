"""Adaptive density control: statistics, clone / split / prune, opacity reset.

Port of rain_tpu/model/densify.py, the counterpart of the reference
densification engine (scene/gaussian_model.py:319-421) on fixed-capacity
tensors: selected Gaussians are written into free capacity rows, and
pruning is a stable compaction (one permutation applied to the parameters,
Adam's moments and the statistics). Rows end up in the reference's order:
survivors keep their relative order, and appended rows land after them in
clone → abe → split order (gaussian_model.py:403-415).

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

``densify_round`` is the round as rain_tpu jits it
(rain_tpu/model/densify.py:144-147): one program per capacity,
``n_split``, ``abe_split`` and ``use_size_threshold``, whose outputs have
shapes fixed by those alone and which never reads the device: n_alive and
the six scalars are device inputs, the counts stay 0-d tensors and the
info is one packed int32 tensor, so train.compiled captures it into a
CUDA graph. The appends are gathers, not rain_tpu's scatter: each row
finds its source row by a ``searchsorted`` over the mask's running count,
so every output row is written once, from one place, with no duplicate
index and no atomic, and the result is the same bits on every run (a
scatter into a dump row would write that row from many places). The
compaction's permutation comes from the running counts of the kept and
the dropped rows the same way (a stable argsort of ~keep).
``densify_and_prune`` is the round followed by one read of its info.

The scalar thresholds are f32 in rain_tpu's jitted round, so their
products (percent_dense·extent, 0.3·extent, 0.1·extent,
divide_ratio·N) are each one f32 multiply on the device here too. The
split noise is an argument: rain_tpu draws it inside from
``jax.random.normal(key, (N, C, 3))``, which torch cannot reproduce, so
the caller draws it (the Trainer from its own ``torch.Generator``; the
tests feed JAX's draw in).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch import device as device_mod
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model.gaussians import (GaussianParams, GaussianState,
                                            STAT_FIELDS, inverse_sigmoid)


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
    (W/2, H/2) of the TRUE image size, given as ints or 0-d device tensors.
    ``radii`` [C] int32 marks the visible Gaussians (radii > 0).
    """
    vis = radii > 0
    dev = tap_grad.device
    # exact in f32: the sizes are integers below 2^24
    scale = torch.stack([device_mod.scalar(width, torch.float32, dev),
                         device_mod.scalar(height, torch.float32, dev)]) * 0.5
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
    params = state.params._replace(
        opacity=reset_logits(state.params.opacity))
    return state._replace(params=params), adam_mod.zero_moments_for(
        opt, "opacity")


def reset_logits(opacity: torch.Tensor) -> torch.Tensor:
    """The opacity logits of ``reset_opacity``: sigmoid clamped to 0.01."""
    return inverse_sigmoid(torch.clamp(torch.sigmoid(opacity), max=0.01))


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


def _append(params: GaussianParams, n_alive: torch.Tensor,
            mask: torch.Tensor, new_leaves: GaussianParams, copies: int):
    """Write ``copies`` transformed copies of the masked rows into the
    free rows: copy j of the r-th masked row goes to n_alive + r·copies +
    j, and rows at or past the capacity are dropped (rain_tpu's scatter
    with ``mode="drop"``). ``new_leaves`` holds per-copy values shaped
    [copies, C, ...]; ``n_alive`` is a 0-d int64 tensor.

    The gather form: each row d finds its source, the r-th masked row for
    r = (d − n_alive) div copies, by a search of the running count of the
    mask, and takes copy (d − n_alive) mod copies of it if r lies below
    the masked rows' count; every other row keeps its value. Each output
    row is written once, from one place. Returns (params, new_n,
    n_appended_requested), the counts as 0-d int64 tensors."""
    cap = mask.shape[0]
    upto = torch.cumsum(mask, 0)               # masked rows in [0, d]
    appended = upto[-1] * copies
    rel = torch.arange(cap, device=mask.device) - n_alive
    fill = (rel >= 0) & (rel < appended)
    rel = rel.clamp(min=0)
    r = torch.div(rel, copies, rounding_mode="floor")
    j = rel - r * copies
    # the first row whose running count reaches r + 1: the r-th masked one
    src = torch.searchsorted(upto, r + 1).clamp(max=cap - 1)
    out = []
    for leaf, new in zip(params, new_leaves):
        rows = fill.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out.append(torch.where(rows, new[j, src], leaf))
    new_n = (n_alive + appended).clamp(max=cap)
    return GaussianParams(*out), new_n, appended


def _compact(params: GaussianParams, opt: adam_mod.AdamState,
             keep: torch.Tensor):
    """Stable compaction: survivors first (order kept), then the rest, the
    permutation of a stable argsort of ~keep built from the running counts
    of ``keep`` and ``~keep``; moments at and past the new alive count are
    zeroed. Returns (params, opt, new_n), new_n a 0-d int64 tensor."""
    cap = keep.shape[0]
    kept, dropped = torch.cumsum(keep, 0), torch.cumsum(~keep, 0)
    new_n = kept[-1]
    d = torch.arange(cap, device=keep.device)
    live = d < new_n
    perm = torch.where(live, torch.searchsorted(kept, d + 1),
                       torch.searchsorted(dropped, d - new_n + 1))
    params = GaussianParams(*[x[perm] for x in params])

    def perm_zero(x):
        rows = live.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(rows, x[perm], 0.0)

    mu = GaussianParams(*[perm_zero(x) for x in opt.mu])
    nu = GaussianParams(*[perm_zero(x) for x in opt.nu])
    return params, adam_mod.AdamState(mu=mu, nu=nu, step=opt.step), new_n


def densify_round(state: GaussianState, opt: adam_mod.AdamState,
                  noise: torch.Tensor, *,
                  max_grad, min_opacity, extent, percent_dense,
                  divide_ratio, size_threshold=20.0,
                  use_size_threshold: bool = False, n_split: int = 2,
                  abe_split: bool = False):
    """One densification round (gaussian_model.py:403-417) at fixed
    shapes, as rain_tpu's jitted ``densify_and_prune``; returns a new
    (state, opt, info) and leaves its inputs untouched.

    ``state.n_alive`` is an int or a 0-d int32 tensor, the six scalars
    numbers or 0-d f32 tensors. Every output's shape follows from the
    capacity, ``n_split``, ``abe_split`` and ``use_size_threshold``: the
    new state's n_alive is a 0-d int64 tensor and ``info`` an int32 [5]
    tensor of DensifyInfo's fields (``unpack_info``). Nothing waits for
    the device.

    noise: [n_split, C, 3] standard normal draws, one per capacity row
      (rain_tpu's ``jax.random.normal(key, (n_split, C, 3))``); the split
      children of row i sit at rotation_i · (noise[s, i] · scale_i).
    """
    cap = state.capacity
    dev = state.params.xyz.device
    if tuple(noise.shape) != (n_split, cap, 3):
        raise ValueError(f"noise is {tuple(noise.shape)}, expected "
                         f"{(n_split, cap, 3)}")

    def f32(v):
        return device_mod.scalar(v, torch.float32, dev)

    extent = f32(extent)
    n0 = device_mod.scalar(state.n_alive, torch.int64, dev)
    alive = torch.arange(cap, device=dev) < n0
    grads = state.xyz_gradient_accum / state.denom
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    max_scale = torch.exp(state.params.scaling).amax(dim=1)
    small = max_scale <= f32(percent_dense) * extent
    high_grad = (grads >= f32(max_grad)) & alive

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
        abe_leaves = params._replace(xyz=params.xyz * (f32(0.3) * extent))
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
    new_scaling = params.scaling - torch.log(f32(divide_ratio) * n_split)

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
    prune = split_mask | (opacity < f32(min_opacity))
    if use_size_threshold:
        big_vs = state.max_radii2d > f32(size_threshold)
        big_ws = torch.exp(params.scaling).amax(dim=1) > f32(0.1) * extent
        prune = prune | big_vs | big_ws
    keep = alive3 & ~prune

    params, opt, new_n = _compact(params, opt, keep)
    new_state = GaussianState(
        params=params, n_alive=new_n,
        **{k: torch.zeros(cap, device=dev) for k in STAT_FIELDS})
    requested = req1 + req2 + req3
    info = torch.stack([clone_mask.sum(), split_mask.sum(), n3 - new_n,
                        new_n, ((n0 + requested) > cap).long()])
    return new_state, opt, info.to(torch.int32)


def unpack_info(info: torch.Tensor) -> DensifyInfo:
    """``densify_round``'s packed info as Python numbers: one read of the
    device."""
    n_cloned, n_split, n_pruned, n_alive, overflow = info.tolist()
    return DensifyInfo(n_cloned, n_split, n_pruned, n_alive, bool(overflow))


def densify_and_prune(state: GaussianState, opt: adam_mod.AdamState,
                      noise: torch.Tensor, **kw):
    """One densification round, ``densify_round`` with its info read
    (``unpack_info``): a new (state, opt, DensifyInfo), the state's
    n_alive and the info Python numbers. Takes ``densify_round``'s
    arguments and leaves its inputs untouched."""
    new_state, opt, packed = densify_round(state, opt, noise, **kw)
    info = unpack_info(packed)
    return new_state._replace(n_alive=info.n_alive), opt, info
