"""The tile compositor in plain PyTorch, in blocks of tiles, with autograd.

The rules are the 3DGS rasterizer's (cuda_rasterizer/forward.cu:251-369 of
the INRIA code, as rain_tpu_torch/ops/reference_composite.py states them):
each 16x16 tile walks its Gaussians front to back in (depth, index)
order; power = -0.5 (a dx² + c dy²) - b dx dy with dx = x - px; a pair is
skipped when power > 0 or alpha = min(0.99, op·e^power) < 1/255; a pixel
stops, before compositing, at the first pair whose T·(1 - alpha) falls
below 1e-4. Colour = Σ alpha_k T_k c_k + T_final·bg.

Here a block of tiles is one [tiles, K, 256] tensor of pairs: the masks
come from a cumulative product without a gradient, and the weights from
a second one with it, so autograd differentiates the forward as written.
The 0.99 clamp passes its gradient, as the INRIA backward does
(backward.cu:528,544). The gradients of the per-Gaussian inputs are
gathered by autograd from every block. The blocks' pairs are counted on
the way: those evaluated (in range, pixel not yet stopped) and those
composited.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsbench.reference.preprocess import TILE, Screen

P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
BLOCK_PAIRS = 1 << 25     # (tile, instance, pixel) triples per block


class Instances(NamedTuple):
    gauss: torch.Tensor       # [M] int64 Gaussian of each sorted instance
    start: torch.Tensor       # [n_tiles] int64 first instance of each tile
    count: torch.Tensor       # [n_tiles] int64 instances of each tile
    total: int                # M


class Counts(NamedTuple):
    evaluated: int            # pairs walked before each pixel stopped
    composited: int           # pairs that composited
    contrib_walk: int         # pairs up to each pixel's last composited one


def instances(s: Screen, grid_x: int, grid_y: int) -> Instances:
    """Each visible Gaussian once per tile of its rect, sorted by tile and
    then by (depth, index)."""
    n = s.tiles.shape[0]
    dev = s.tiles.device
    key = torch.where(s.tiles > 0, s.depth.float(),
                      torch.full_like(s.depth, float("inf"), dtype=torch.float32))
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    gid = torch.repeat_interleave(torch.arange(n, device=dev), s.tiles)
    total = int(gid.shape[0])
    first = torch.cumsum(s.tiles, 0) - s.tiles
    j = torch.arange(total, device=dev) - first[gid]
    w = s.rect_wh[gid, 0]
    tile = (s.rect_min[gid, 1] + j // w) * grid_x + s.rect_min[gid, 0] + j % w
    perm = torch.sort(tile * n + rank[gid]).indices
    count = torch.bincount(tile, minlength=grid_x * grid_y)
    return Instances(gid[perm], torch.cumsum(count, 0) - count, count, total)


def blocks(inst: Instances, budget: int = BLOCK_PAIRS):
    """Blocks of tiles, longest lists first: (tile ids, their list length
    K) with tiles·K·256 within ``budget`` or one tile alone."""
    count = inst.count.cpu()
    order = torch.sort(count, descending=True, stable=True).indices
    counts = count[order].tolist()
    i = 0
    while i < len(counts) and counts[i] > 0:
        k = counts[i]
        n = max(1, budget // (k * P))
        yield order[i:i + n], k
        i += n


def composite_block(s: Screen, inst: Instances, tiles: torch.Tensor, k: int,
                    grid_x: int, bg: torch.Tensor):
    """(colour [T, 256, 3] with bg, final T [T, 256], Counts) of the tiles
    ``tiles``, each walking up to k instances; differentiable in s.xy,
    s.conic, s.opacity and s.rgb."""
    dev = s.xy.device
    dt = s.xy.dtype
    tiles = tiles.to(dev)
    kk = torch.arange(k, device=dev)
    valid = kk[None, :] < inst.count[tiles][:, None]                 # [T, K]
    idx = torch.clamp(inst.start[tiles][:, None] + kk[None, :],
                      max=max(inst.total - 1, 0))
    g = inst.gauss[idx]
    p = torch.arange(P, device=dev)
    px = ((tiles % grid_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((tiles // grid_x) * TILE)[:, None] + (p // TILE)[None, :]
    px, py = px.to(dt)[:, None, :], py.to(dt)[:, None, :]            # [T,1,P]
    a, b, c = (s.conic[g, i][..., None] for i in range(3))           # [T,K,1]
    dx = s.xy[g, 0][..., None] - px
    dy = s.xy[g, 1][..., None] - py
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = s.opacity[g][..., None] * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_CLAMP) - raw).detach()
    with torch.no_grad():
        ok = valid[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        walk = torch.cumprod(torch.where(ok, 1.0 - alpha,
                                         torch.ones_like(alpha)), dim=1)
        live = ok & (walk >= T_EPS)
        stopped = torch.cumsum((ok & ~live).to(torch.int32), dim=1)
        # walked: in range and not past the stopping pair
        walked = valid[..., None] & ((stopped - (ok & ~live).to(
            torch.int32)) == 0)
        last = torch.amax(torch.where(live, kk[None, :, None] + 1, 0), dim=1)
        counts = Counts(int(walked.sum()), int(live.sum()), int(last.sum()))
    f = torch.where(live, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(f, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    w = torch.where(live, alpha * t_excl, torch.zeros_like(alpha))
    colour = torch.einsum("tkp,tkc->tpc", w, s.rgb[g])
    t_final = t_incl[:, -1]
    return colour + t_final[..., None] * bg, t_final, counts


def pixel_index(tiles: torch.Tensor, grid_x: int, width: int, height: int):
    """(mask [T, 256] of the tile pixels inside the image, their flat
    index y·width + x)."""
    p = torch.arange(P, device=tiles.device)
    x = ((tiles % grid_x) * TILE)[:, None] + (p % TILE)[None, :]
    y = ((tiles // grid_x) * TILE)[:, None] + (p // TILE)[None, :]
    inside = (x < width) & (y < height)
    return inside, y * width + x
