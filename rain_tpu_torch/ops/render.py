"""The differentiable render pipeline (preprocess → bin → composite).

Port of rain_tpu/ops/render.py, the counterpart of the reference render
API and rasterizer orchestration (gaussian_renderer/__init__.py:9-79,
rasterizer_impl.cu:187-330).

Differentiability map:
- preprocess: plain torch ops under autograd (the reference's
  backward.cu:133-386).
- binning: the integer rect data leaves the graph; ``sorted_pack`` is an
  autograd Function whose backward un-permutes the pack cotangent and sums
  it to the Gaussians with kernel B2 (ops.binning, ops.expand).
- composite: an autograd Function, forward kernel B3, backward kernel B4
  (ops.tile_render).

Two A/B paths of rain_tpu are keyword arguments here, where rain_tpu reads
them from the environment at import: ``expand="legacy"``
(``RAIN_TPU_EXPAND=legacy``) builds the instance list with
``binning.bin_gaussians`` and gathers the pack from a [16, N+1] table with
a dump column (``pack_take``, whose backward is the per-Gaussian sum
``binning.owner_sum``), and ``reduce="scatter"`` (``RAIN_TPU_REDUCE``)
sums the fused path's instance gradients with ``owner_sum`` instead of
kernel B2. Both default to the main path and are plain torch: the legacy
path launches neither B1 nor B2, the scatter reduction no B2; both keep
B3 and B4. The legacy path always carries the depth row (as rain_tpu's
does).

``xy_tap`` plays the role of the reference's ``screenspace_points`` dummy
(gaussian_renderer/__init__.py:10-14): pass zeros [N, 2] that require a
gradient, and its gradient is the per-Gaussian screen-space gradient the
densification statistics read. It is in pixel units; the statistics scale
it by (W/2, H/2) (backward.cu:450-451,535-536).

The colour and covariance overrides of the JAX ``render`` are off the
training path and not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import projection as proj_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.projection import TILE


# The stages of ``render``, in order. A caller's ``on_stage(name, value)``
# is called once after each with its result: Preprocessed, DepthOrdered,
# (cols, keys) of kernel B1, the [16, M] pack, (tile_start, tile_end), the
# tiles of kernel B3, and the RenderOutput.
STAGES = ("preprocess", "depth_sort", "expand_B1", "tile_sort_gather",
          "tile_ranges", "composite_B3", "assemble")
# The stages of ``render(..., expand="legacy")``: Preprocessed, the
# binning.Binning, the [16, M] pack, the tiles of kernel B3 and the
# RenderOutput.
LEGACY_STAGES = ("preprocess", "bin_gaussians", "pack_take", "composite_B3",
                 "assemble")
# The stages of a backward through ``render``, in order: kernel B4's
# (args, d_pack) (ops.tile_render.composite) and kernel B2's
# (d_rank, exc, tiles, d_depth) (ops.binning.sorted_pack_bwd; not with
# reduce="scatter" or the legacy path).
BACKWARD_STAGES = ("composite_bwd_B4", "reduce_B2")
EXPANSIONS = ("fused", "legacy")


class _PackTake(torch.autograd.Function):
    """table [R, N+1] → pack [R, M], column j = table[:, idx[j]]."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1] - 1
        return table[:, idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        d = binning_ops.owner_sum(g, idx, ctx.n)
        return torch.cat([d, d.new_zeros((d.shape[0], 1))], dim=1), None


def pack_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The legacy pack gather (rain_tpu/ops/render.py:42-66): columns of
    ``table`` [16, N+1], whose last column is the dump column of the
    padding instances, by ``idx`` [M]. Its backward sums each instance's
    cotangent to its Gaussian's column in instance order
    (``binning.owner_sum``): deterministic on every device, with no float
    atomics. The dump column, a constant, takes a zero gradient (the
    padding instances lie in no tile's range, so their cotangents are
    zero)."""
    return _PackTake.apply(table, idx)


class RenderOutput(NamedTuple):
    render: torch.Tensor        # [3, H, W] color (background applied)
    depth: torch.Tensor         # [1, H, W] alpha-weighted depth
    alpha: torch.Tensor         # [H, W] accumulated alpha
    final_t: torch.Tensor       # [H, W] final transmittance
    radii: torch.Tensor         # [N] int32 (visibility_filter = radii > 0)
    n_contrib: torch.Tensor     # [H, W] int32
    num_instances: torch.Tensor  # 0-d int64 (may exceed max_instances)
    overflow: torch.Tensor      # 0-d bool


def render_tiles(prep: proj_ops.Preprocessed,
                 xy_tap: torch.Tensor | None = None, *, grid_x: int,
                 n_rows: int, max_instances: int, need_depth: bool = True,
                 on_stage: binning_ops.StageHook = binning_ops.no_stage_hook,
                 expand: str = "fused", reduce: str = "kernel"):
    """Composite every tile row of the image.

    Returns tiles [n_rows*grid_x, 256, 8] plus (num_instances, overflow).
    ``xy_tap`` [N, 2], when given, is added to the pixel-space means.
    ``on_stage`` is called after each stage, see STAGES (LEGACY_STAGES
    with ``expand="legacy"``), and after each stage of a backward through
    the tiles, see BACKWARD_STAGES. ``expand`` ("fused" or "legacy") and
    ``reduce`` ("kernel" or "scatter"; the legacy path has its own sum)
    pick the A/B paths of the module docstring; ValueError otherwise.
    """
    binning_ops._choose("expand", expand, EXPANSIONS)
    binning_ops._choose("reduce", reduce, binning_ops.REDUCTIONS)
    n_tiles = n_rows * grid_x
    xy = prep.xy if xy_tap is None else prep.xy + xy_tap
    table10 = tile_render.pack_rows(xy, prep.conic, prep.opacity,
                                    prep.rgb, prep.depth)
    if expand == "legacy":
        binn = binning_ops.bin_gaussians(prep, grid_x, n_rows,
                                         max_instances)
        on_stage("bin_gaussians", binn)
        # [16, N+1]: the ten kernel rows, zero rows and the dump column
        # that padding instances gather
        n = table10.shape[1]
        table = torch.cat([table10, table10.new_zeros(
            (tile_render.PACK_ROWS - tile_render.KERNEL_ROWS, n))])
        table = torch.cat([table, table.new_zeros((table.shape[0], 1))],
                          dim=1)
        pack = pack_take(table, binn.gauss_idx)
        on_stage("pack_take", pack)
        tiles = tile_render.composite(pack, binn.tile_start, binn.tile_end,
                                      0, grid_x, on_stage)
        on_stage("composite_B3", tiles)
        return tiles, binn.num_instances, binn.overflow
    pack, num_instances, overflow = binning_ops.sorted_pack(
        table10, prep.tiles_touched, prep.rect_min, prep.rect_wh,
        0, grid_x, n_tiles, max_instances, need_depth, on_stage,
        reduce=reduce)
    tile_start, tile_end = binning_ops.tile_ranges(
        prep.rect_min, prep.rect_wh, prep.tiles_touched > 0, grid_x,
        n_tiles, 0, max_instances)
    on_stage("tile_ranges", (tile_start, tile_end))
    tiles = tile_render.composite(pack, tile_start, tile_end, 0, grid_x,
                                  on_stage)
    on_stage("composite_B3", tiles)
    return tiles, num_instances, overflow


def assemble_image(tiles: torch.Tensor, grid_x: int, n_rows: int,
                   height: int, width: int) -> torch.Tensor:
    """[n_rows*grid_x, 256, 8] tiles → [height, width, 8] image band."""
    img = tiles.reshape(n_rows, grid_x, TILE, TILE, 8)
    img = img.permute(0, 2, 1, 3, 4).reshape(n_rows * TILE,
                                             grid_x * TILE, 8)
    return img[:height, :width]


def render(means3d, scales_act, quats_act, opacity_act, shs, alive,
           *,
           camera: dict,
           width: int, height: int,
           sh_degree: int,
           bg: torch.Tensor,
           low_pass=0.3,
           scale_modifier: float = 1.0,
           max_instances: int,
           xy_tap: torch.Tensor | None = None,
           need_depth: bool = True,
           render_wh: tuple[int, int] | None = None,
           on_stage: binning_ops.StageHook = binning_ops.no_stage_hook,
           expand: str = "fused", reduce: str = "kernel") -> RenderOutput:
    """Render one view from post-activation inputs (see model.gaussians).

    camera: dict from data.cameras.Camera.render_inputs().
    xy_tap: optional [N, 2] screen-space tap (see the module docstring).
    need_depth=False (training steps) returns a zero depth channel.
    render_wh: optional (w, h) true image size. width/height are then the
      tile-aligned bucket that sets the tile grid and the output's shape,
      and the true size sets the focal lengths and NDC → pixel scaling;
      pixels beyond it are dead ones the caller masks.
    on_stage(name, value) is called after each of STAGES (LEGACY_STAGES
      with expand="legacy") with its result, and after each of
      BACKWARD_STAGES in a backward through the render.
    expand, reduce: the A/B paths (see ``render_tiles``).
    """
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    rw, rh = (width, height) if render_wh is None else render_wh
    prep = proj_ops.preprocess(
        means3d, scales_act, quats_act, opacity_act, shs, alive,
        sh_degree=sh_degree,
        world_view=camera["world_view"],
        full_proj=camera["full_proj"],
        camera_center=camera["camera_center"],
        tan_fovx=camera["tanfovx"], tan_fovy=camera["tanfovy"],
        width=rw, height=rh, grid=(grid_x, grid_y),
        low_pass=low_pass, scale_modifier=scale_modifier)
    on_stage("preprocess", prep)

    tiles, num_instances, overflow = render_tiles(
        prep, xy_tap, grid_x=grid_x, n_rows=grid_y,
        max_instances=max_instances, need_depth=need_depth,
        on_stage=on_stage, expand=expand, reduce=reduce)

    img = assemble_image(tiles, grid_x, grid_y, height, width)
    color = img[..., 0:3] + img[..., tile_render.CH_T:tile_render.CH_T + 1] \
        * bg[None, None, :]
    out = RenderOutput(
        render=color.permute(2, 0, 1),
        depth=img[..., tile_render.CH_DEPTH][None],
        alpha=img[..., tile_render.CH_ALPHA],
        final_t=img[..., tile_render.CH_T],
        radii=prep.radii,
        n_contrib=img[..., tile_render.CH_NCONTRIB].to(torch.int32),
        num_instances=num_instances,
        overflow=overflow,
    )
    on_stage("assemble", out)
    return out


def mark_visible(means3d: torch.Tensor,
                 world_view: torch.Tensor) -> torch.Tensor:
    """Frustum visibility test (GaussianRasterizer.markVisible,
    rasterize_points.cu:193-212): view-space z > 0.2."""
    ones = torch.ones_like(means3d[:, :1])
    p_view = torch.cat([means3d, ones], dim=-1) @ world_view[:3, :].T
    return p_view[:, 2] > proj_ops.NEAR_Z
