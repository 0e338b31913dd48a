"""Tile binning: the depth- and tile-sorted instance pack, and tile ranges.

Port of the forward of rain_tpu/ops/binning.py (``sorted_pack``,
``tile_ranges``), the counterpart of the reference binning stage
(cuda_rasterizer/rasterizer_impl.cu:187-330). The port keeps the contract
and drops the TPU's workarounds:

1. Depth order: a stable ``torch.sort`` of the view depths with ``inf``
   for culled Gaussians — the order of the reference's argsort(stable)
   and of its (depth, index) payload sort at N >= 2^21.
2. Expansion (kernel B1, ops.expand): each depth-ordered Gaussian's
   attributes are copied to its instances, one per tile of its rect in
   row-major order, with one int64 key ``tile << 32 | depth_rank`` each.
3. Tile sort: ``torch.sort`` of the keys (unique, so no stability is
   needed) and one gather of the attribute columns. The instance order is
   the reference's packed (tile, depth-rank) key order
   (binning.py:432-449), itself the CUDA 64-bit radix order.
4. Tile ranges: per-tile instance counts from a 2-D difference array over
   the rect corners, then prefix sums (identifyTileRanges,
   rasterizer_impl.cu:105-127).

Shapes are static with capacity ``max_instances``. When the true instance
count exceeds it the farthest instances are dropped and ``overflow`` is
set, as in the reference.

``sorted_pack`` is differentiable in its attribute table (the VJP of
rain_tpu/ops/binning.py:_sorted_pack_bwd): the pack cotangent's 9
differentiable rows go back to rank order through the sort permutation,
are summed to their owners by kernel B2 (ops.expand.reduce_instances) and
go back to Gaussian order through the depth order. Both permutations are
explicit scatters with unique indices, so nothing accumulates; the depth
row takes no gradient, as in the reference (dgr/__init__.py:96).

What the pack's depth row carries is one static option, ``depth_row``:
the view depth z (``"z"``, the default), nothing (``None``: a zero row,
as training reads no depth), or the inverse depth (``"inverse"``). The
inverse-depth path is depth regularization's (graphdeco-inria/
gaussian-splatting, 2024): the depth order still keys on the table's z,
and then, once per Gaussian, row 9 of the depth-ordered table becomes
1/z (0 for a culled Gaussian, which has no instance), so the
compositor's depth channel is the inverse depth Σ T α / z. Its backward
reduces ten rows with B2, the tenth the gradient of 1/z, and turns it
into the gradient of z, -g / z², before the table's cotangent goes back
to Gaussian order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.tile_render import StageHook, no_stage_hook


class DepthOrdered(NamedTuple):
    """Per-Gaussian inputs of the expansion, in depth order."""

    table: torch.Tensor       # [10, N] f32 attribute rows
    tiles: torch.Tensor       # [N] int32 tiles touched (0 if culled)
    offs: torch.Tensor        # [N] int64 inclusive prefix sum of tiles
    rect_w: torch.Tensor      # [N] int32 rect width in tiles
    rect_base: torch.Tensor   # [N] int32 global id of the rect's first tile
    order: torch.Tensor       # [N] int64 depth rank → Gaussian index


class PackResiduals(NamedTuple):
    """What the forward keeps for the sorted_pack VJP."""

    order: torch.Tensor       # [N] int64 depth rank → Gaussian index
    exc: torch.Tensor         # [N] int64 exclusive prefix sum of tiles
    tiles: torch.Tensor       # [N] int32 tiles per depth-ordered Gaussian
    perm: torch.Tensor        # [M] int64 tile-sorted → generated position
    inv: torch.Tensor | None = None   # [N] 1/z in depth order ("inverse")


def depth_order(table10, tiles_touched, rect_min, rect_wh,
                grid_x: int) -> DepthOrdered:
    """Stable depth sort of the visible Gaussians (culled ones last)."""
    visible = tiles_touched > 0
    depth_key = torch.where(visible, table10[9],
                            torch.full_like(table10[9], float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    tiles = tiles_touched[order]
    rect = rect_min[order]
    return DepthOrdered(
        table=table10[:, order].contiguous(),
        tiles=tiles,
        offs=torch.cumsum(tiles, 0),
        rect_w=rect_wh[order, 0].contiguous(),
        rect_base=(rect[:, 1] * grid_x + rect[:, 0]).to(torch.int32),
        order=order,
    )


DEPTH_ROWS = ("z", None, "inverse")   # the values of ``depth_row``


def tile_sort(cols: torch.Tensor, keys: torch.Tensor,
              need_depth: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort the expanded instances by key; returns (pack [16, M], perm).

    One pass over the pack: the sorted columns are gathered straight into
    its first rows and the rest is zeroed (the depth row too, and not
    gathered, when ``need_depth`` is False)."""
    perm = torch.sort(keys).indices
    pack = torch.empty((tile_render.PACK_ROWS, cols.shape[1]),
                       dtype=cols.dtype, device=cols.device)
    # the depth row is the last of the ten
    rows = cols.shape[0] if need_depth else tile_render.ROW_DEPTH
    torch.index_select(cols[:rows], 1, perm, out=pack[:rows])
    pack[rows:].zero_()
    return pack, perm


def inverse_depth(table: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """1/z of the rows of a depth-ordered table whose Gaussian touches a
    tile (z > 0.2 there: the near cull), 0 for the rest, [N]."""
    vis = tiles > 0
    z = torch.where(vis, table[tile_render.ROW_DEPTH], 1.0)
    return torch.where(vis, torch.reciprocal(z), 0.0)


def sorted_pack_fwd(table10, tiles_touched, rect_min, rect_wh,
                    tile_offset: int, grid_x: int, n_tiles: int,
                    max_instances: int, depth_row: str | None = "z",
                    on_stage: StageHook = no_stage_hook):
    """``sorted_pack`` without autograd, plus its residuals: ((pack,
    num_instances, overflow), PackResiduals).

    ``on_stage(name, value)`` is called after each stage with its result:
    "depth_sort" (DepthOrdered), "expand_B1" ((cols, keys)) and
    "tile_sort_gather" (pack). With ``depth_row="inverse"`` the
    depth-ordered table's row 9, and so the pack's, is ``inverse_depth``
    (see the module docstring).
    """
    if depth_row not in DEPTH_ROWS:
        raise ValueError(f"depth_row {depth_row!r} is none of {DEPTH_ROWS}")
    d = depth_order(table10, tiles_touched, rect_min, rect_wh, grid_x)
    inv = None
    if depth_row == "inverse":
        inv = inverse_depth(d.table, d.tiles)
        d.table[tile_render.ROW_DEPTH] = inv   # depth_order's own copy
    on_stage("depth_sort", d)
    cols, keys = expand_ops.expand_instances(
        d.table, d.tiles, d.offs, d.rect_w, d.rect_base, grid_x=grid_x,
        tile_offset=tile_offset, n_tiles=n_tiles,
        max_instances=max_instances)
    on_stage("expand_B1", (cols, keys))
    pack, perm = tile_sort(cols, keys, depth_row is not None)
    on_stage("tile_sort_gather", pack)
    total = d.offs[-1]
    res = PackResiduals(order=d.order, exc=d.offs - d.tiles, tiles=d.tiles,
                        perm=perm, inv=inv)
    return (pack, total, total > max_instances), res


def sorted_pack_bwd(res: PackResiduals, d_pack: torch.Tensor,
                    on_stage: StageHook = no_stage_hook) -> torch.Tensor:
    """The VJP of ``sorted_pack`` in its table: [16, M] pack cotangent →
    [10, N] table cotangent, in the pack cotangent's dtype. The depth row
    is zero, but on the inverse-depth path (``res.inv`` set), where it is
    the gradient of z: -g / z² from the gradient g of the pack's 1/z row,
    as -g·(1/z)².

    ``on_stage("reduce_B2", (d_rank, exc, tiles, d_depth))`` reports kernel
    B2's inputs and output.
    """
    m = d_pack.shape[1]
    n = res.order.shape[0]
    rows = tile_render.GRAD_ROWS if res.inv is None else \
        tile_render.DEPTH_GRAD_ROWS
    # tile order → rank (generated) order: d_rank[:, perm[j]] = d_pack[:, j]
    # (B2 reads only the columns of kept instances, so the padding columns
    # past them need no masking)
    d_rank = torch.empty((rows, m), dtype=d_pack.dtype, device=d_pack.device)
    d_rank[:, res.perm] = d_pack[:rows]
    d_depth = expand_ops.reduce_instances(d_rank, res.exc, res.tiles)
    on_stage("reduce_B2", (d_rank, res.exc, res.tiles, d_depth))
    if res.inv is not None:
        # d(1/z)/dz = -(1/z)², as autograd's reciprocal takes it
        d_z = -d_depth[tile_render.ROW_DEPTH] * (res.inv * res.inv)
        d_depth = torch.cat([d_depth[:tile_render.ROW_DEPTH], d_z[None]])
    # depth order → Gaussian order: d_table[:, order[r]] = d_depth[:, r]
    d_table = torch.zeros((tile_render.KERNEL_ROWS, n), dtype=d_pack.dtype,
                          device=d_pack.device)
    d_table[:rows, res.order] = d_depth
    return d_table


class _SortedPack(torch.autograd.Function):
    """``sorted_pack`` with its VJP in ``table10``."""

    @staticmethod
    def forward(ctx, table10, tiles_touched, rect_min, rect_wh, tile_offset,
                grid_x, n_tiles, max_instances, depth_row, on_stage):
        (pack, total, overflow), res = sorted_pack_fwd(
            table10, tiles_touched, rect_min, rect_wh, tile_offset, grid_x,
            n_tiles, max_instances, depth_row, on_stage)
        ctx.res, ctx.on_stage = res, on_stage
        ctx.mark_non_differentiable(total, overflow)
        return pack, total, overflow

    @staticmethod
    def backward(ctx, d_pack, d_total, d_overflow):
        # let go of the hook: a caller that keeps the pack would otherwise
        # keep, through the pack's graph, the hook and all it holds
        on_stage, ctx.on_stage = ctx.on_stage, None
        d_table = sorted_pack_bwd(ctx.res, d_pack.contiguous(), on_stage)
        return (d_table,) + (None,) * 9


def sorted_pack(table10, tiles_touched, rect_min, rect_wh,
                tile_offset: int, grid_x: int, n_tiles: int,
                max_instances: int, depth_row: str | None = "z",
                on_stage: StageHook = no_stage_hook):
    """Tile-sorted [16, M] instance pack for ops.tile_render.

    Args:
      table10: [10, N] f32 per-Gaussian attribute rows in the
        tile_render.ROW_* layout (conic a/b/c, GLOBAL pixel xy, opacity,
        rgb, depth). The only differentiable input.
      tiles_touched [N] int32, rect_min [N, 2] int32, rect_wh [N, 2] int32:
        integer rect data (ops.projection).
      tile_offset: global tile id of local tile 0. Every rect must lie in
        the owned tiles [tile_offset, tile_offset + n_tiles).
      grid_x, n_tiles, max_instances: grid config and instance capacity M.
      depth_row: what the pack's depth row carries (``DEPTH_ROWS``): z,
        zeros (None), or 1/z, which takes a gradient ("inverse": the
        inverse-depth path of the module docstring).
      on_stage: called with each forward stage's result (see
        ``sorted_pack_fwd``) and, in the backward, with B2's
        (see ``sorted_pack_bwd``).

    Returns (pack [16, M] f32, num_instances (0-d int64, may exceed M),
    overflow (0-d bool)).
    """
    return _SortedPack.apply(table10, tiles_touched, rect_min, rect_wh,
                             tile_offset, grid_x, n_tiles, max_instances,
                             depth_row, on_stage)


def tile_ranges(rect_min, rect_wh, visible, grid_x: int, n_tiles: int,
                tile_offset: int, max_instances: int):
    """Per-tile [start, end) instance ranges, int32 [n_tiles] each.

    The count of a tile is the number of visible Gaussians whose rect
    covers it: +1/-1 at the four corners of each rect in a 2-D difference
    array, then prefix sums over both axes (exact and deterministic).
    The ranges equal those of the sorted pack when it did not overflow; on
    overflow they are clamped to [0, M], as in the reference, so the
    compositor stays in bounds.
    """
    n_rows = n_tiles // grid_x
    y0 = tile_offset // grid_x
    stride = grid_x + 1
    x0 = torch.clamp(rect_min[:, 0], 0, grid_x).to(torch.int64)
    x1 = torch.clamp(rect_min[:, 0] + rect_wh[:, 0], 0, grid_x).to(torch.int64)
    r0 = torch.clamp(rect_min[:, 1] - y0, 0, n_rows).to(torch.int64)
    r1 = torch.clamp(rect_min[:, 1] + rect_wh[:, 1] - y0,
                     0, n_rows).to(torch.int64)
    v = visible.to(torch.int64)
    diff = torch.zeros((n_rows + 1) * stride, dtype=torch.int64,
                       device=rect_min.device)
    diff.index_add_(0, torch.cat([r0 * stride + x0, r0 * stride + x1,
                                  r1 * stride + x0, r1 * stride + x1]),
                    torch.cat([v, -v, -v, v]))
    counts2d = diff.view(n_rows + 1, stride).cumsum(0).cumsum(1)
    counts = counts2d[:n_rows, :grid_x].reshape(-1)
    ends_all = torch.cumsum(counts, 0)
    tile_end = torch.clamp(ends_all, max=max_instances).to(torch.int32)
    tile_start = torch.clamp(ends_all - counts,
                             max=max_instances).to(torch.int32)
    return tile_start, tile_end
