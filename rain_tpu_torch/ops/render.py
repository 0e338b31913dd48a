"""The differentiable render pipeline (preprocess → bin → composite).

Port of rain_tpu/ops/render.py, the counterpart of the reference render
API and rasterizer orchestration (gaussian_renderer/__init__.py:9-79,
rasterizer_impl.cu:187-330).

Differentiability map:
- preprocess: ``render_params`` takes the raw parameters and runs
  ops.preprocess, on the card an autograd Function with one forward and
  one backward kernel (the reference's preprocessCUDA and
  backward.cu:133-386); ``render`` takes activated tensors (or the
  overrides below) and runs ops.projection.preprocess, plain torch ops
  under autograd.
- binning: the integer rect data leaves the graph; ``sorted_pack`` is an
  autograd Function whose backward un-permutes the pack cotangent and sums
  it to the Gaussians with kernel B2 (ops.binning, ops.expand).
- composite: an autograd Function, forward kernel B3, backward kernel B4
  (ops.tile_render).

``xy_tap`` plays the role of the reference's ``screenspace_points`` dummy
(gaussian_renderer/__init__.py:10-14): pass zeros [N, 2] that require a
gradient, and its gradient is the per-Gaussian screen-space gradient the
densification statistics read. It is in pixel units; the statistics scale
it by (W/2, H/2) (backward.cu:450-451,535-536).

``colors_override`` [N, 3] and ``cov3d_override`` [N, 6] replace the SH
colours and the covariances built from scales and quats, as in the JAX
``render``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import preprocess as prep_ops
from rain_tpu_torch.ops import projection as proj_ops
from rain_tpu_torch.ops import tile_render
from rain_tpu_torch.ops.projection import TILE


# The stages of ``render``, in order. A caller's ``on_stage(name, value)``
# is called once after each with its result: Preprocessed, DepthOrdered,
# (cols, keys) of kernel B1, the [16, M] pack, (tile_start, tile_end), the
# tiles of kernel B3, and the RenderOutput.
STAGES = ("preprocess", "depth_sort", "expand_B1", "tile_sort_gather",
          "tile_ranges", "composite_B3", "assemble")
# The stages of a backward through ``render``, in order: the tiles'
# cotangent as kernel B4 receives it (the backward of what follows the
# compositor: the loss and the image's assembly), kernel B4's
# (args, d_pack) (both ops.tile_render.composite) and kernel B2's
# (d_rank, exc, tiles, d_depth) (ops.binning.sorted_pack_bwd).
BACKWARD_STAGES = ("loss_bwd", "composite_bwd_B4", "reduce_B2")


class RenderOutput(NamedTuple):
    render: torch.Tensor        # [3, H, W] color (background applied)
    depth: torch.Tensor         # [1, H, W] alpha-weighted depth (inverse
    #                             depth with depth_row "inverse")
    alpha: torch.Tensor         # [H, W] accumulated alpha
    final_t: torch.Tensor       # [H, W] final transmittance
    radii: torch.Tensor         # [N] int32 (visibility_filter = radii > 0)
    n_contrib: torch.Tensor     # [H, W] int32
    num_instances: torch.Tensor  # 0-d int64 (may exceed max_instances)
    overflow: torch.Tensor      # 0-d bool


def render_tiles(table10: torch.Tensor, tiles_touched: torch.Tensor,
                 rect_min: torch.Tensor, rect_wh: torch.Tensor, *,
                 tile_offset: int, grid_x: int, n_tiles: int,
                 max_instances: int, depth_row: str | None = "z",
                 on_stage: binning_ops.StageHook = binning_ops.no_stage_hook):
    """Bin and composite the tiles [tile_offset, tile_offset + n_tiles) of
    the grid: the whole image (offset 0) or a band of tile rows
    (parallel.sharding). ``depth_row`` (static; ops.binning.DEPTH_ROWS)
    sets the depth channel: the α-weighted depth ("z"), zero (None), or
    the inverse depth Σ T α / z, which takes a gradient ("inverse":
    ops.binning's inverse-depth path and B4's depth variant).

    ``table10`` [10, N] holds the Gaussians' attribute rows
    (tile_render.pack_rows) and ``tiles_touched``, ``rect_min`` and
    ``rect_wh`` their rects, each within the owned tiles (ops.binning.
    sorted_pack). Returns tiles [n_tiles, 256, 8] plus (num_instances,
    overflow). ``on_stage`` is called after each stage from "depth_sort"
    to "composite_B3" (see STAGES), and after each stage of a backward
    through the tiles (see BACKWARD_STAGES).
    """
    pack, num_instances, overflow = binning_ops.sorted_pack(
        table10, tiles_touched, rect_min, rect_wh, tile_offset, grid_x,
        n_tiles, max_instances, depth_row, on_stage)
    tile_start, tile_end = binning_ops.tile_ranges(
        rect_min, rect_wh, tiles_touched > 0, grid_x, n_tiles, tile_offset,
        max_instances)
    on_stage("tile_ranges", (tile_start, tile_end))
    tiles = tile_render.composite(pack, tile_start, tile_end, tile_offset,
                                  grid_x, on_stage,
                                  depth=depth_row == "inverse")
    on_stage("composite_B3", tiles)
    return tiles, num_instances, overflow


def assemble_image(tiles: torch.Tensor, grid_x: int, n_rows: int,
                   height: int, width: int) -> torch.Tensor:
    """[n_rows*grid_x, 256, 8] tiles → [height, width, 8] image band."""
    img = tiles.reshape(n_rows, grid_x, TILE, TILE, 8)
    img = img.permute(0, 2, 1, 3, 4).reshape(n_rows * TILE,
                                             grid_x * TILE, 8)
    return img[:height, :width]


def over_background(img: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """[height, width, 8] image → [3, height, width] colour over ``bg``
    [3], weighted by the final transmittance."""
    color = img[..., 0:3] + img[..., tile_render.CH_T:tile_render.CH_T + 1] \
        * bg[None, None, :]
    return color.permute(2, 0, 1)


def _grids(width: int, height: int, render_wh) -> tuple:
    """(grid_x, grid_y, true width, true height) of a render."""
    rw, rh = (width, height) if render_wh is None else render_wh
    return ((width + TILE - 1) // TILE, (height + TILE - 1) // TILE, rw, rh)


def render(means3d, scales_act, quats_act, opacity_act, shs, alive,
           *,
           camera: dict,
           width: int, height: int,
           sh_degree: int,
           bg: torch.Tensor,
           low_pass=0.3,
           scale_modifier=1.0,
           max_instances: int,
           xy_tap: torch.Tensor | None = None,
           colors_override: torch.Tensor | None = None,
           cov3d_override: torch.Tensor | None = None,
           need_depth: bool = True,
           render_wh: tuple | None = None,
           on_stage: binning_ops.StageHook = binning_ops.no_stage_hook
           ) -> RenderOutput:
    """Render one view from post-activation inputs (see model.gaussians),
    through ops.projection.preprocess.

    camera: dict from data.cameras.Camera.render_inputs().
    xy_tap: optional [N, 2] screen-space tap (see the module docstring).
    colors_override, cov3d_override: optional [N, 3] colours and [N, 6]
      3D covariances in place of the computed ones (ops.projection).
    need_depth=False (training steps) returns a zero depth channel.
    render_wh: optional (w, h) true image size, ints or 0-d int32 device
      tensors. width/height are then the tile-aligned bucket that sets the
      tile grid and the output's shape, and the true size sets the focal
      lengths and NDC → pixel scaling; pixels beyond it are dead ones the
      caller masks.
    low_pass, scale_modifier: numbers or 0-d f32 device tensors.
    on_stage(name, value) is called after each of STAGES with its result,
      and after each of BACKWARD_STAGES in a backward through the render.
    """
    grid_x, grid_y, rw, rh = _grids(width, height, render_wh)
    prep = proj_ops.preprocess(
        means3d, scales_act, quats_act, opacity_act, shs, alive,
        sh_degree=sh_degree,
        world_view=camera["world_view"],
        full_proj=camera["full_proj"],
        camera_center=camera["camera_center"],
        tan_fovx=camera["tanfovx"], tan_fovy=camera["tanfovy"],
        width=rw, height=rh, grid=(grid_x, grid_y),
        low_pass=low_pass, scale_modifier=scale_modifier,
        colors_override=colors_override, cov3d_override=cov3d_override)
    return _render_prepared(
        prep, width=width, height=height, bg=bg,
        max_instances=max_instances, xy_tap=xy_tap,
        depth_row="z" if need_depth else None, on_stage=on_stage)


def render_params(params: gmod.GaussianParams, alive: torch.Tensor, *,
                  camera: dict, width: int, height: int, sh_degree: int,
                  bg: torch.Tensor, low_pass=0.3, scale_modifier=1.0,
                  max_instances: int, xy_tap: torch.Tensor | None = None,
                  depth_row: str | None = "z",
                  render_wh: tuple | None = None,
                  on_stage: binning_ops.StageHook = binning_ops.no_stage_hook
                  ) -> RenderOutput:
    """``render`` from the raw parameters (model.gaussians.GaussianParams,
    differentiable) through ops.preprocess: on the card one forward and
    one backward kernel from the raw leaves to the screen quantities; on
    the CPU gaussians.activate followed by ``render``'s preprocess, the
    same ops. ``depth_row`` is ``render_tiles``' (``render``'s need_depth
    False is None; with "inverse" the output's ``depth`` is the
    differentiable inverse depth). The other arguments are
    ``render``'s."""
    grid_x, grid_y, rw, rh = _grids(width, height, render_wh)
    prep = prep_ops.preprocess(
        params, alive, sh_degree=sh_degree, camera=camera, width=rw,
        height=rh, grid=(grid_x, grid_y), low_pass=low_pass,
        scale_modifier=scale_modifier)
    return _render_prepared(
        prep, width=width, height=height, bg=bg,
        max_instances=max_instances, xy_tap=xy_tap, depth_row=depth_row,
        on_stage=on_stage)


def _render_prepared(
        prep: proj_ops.Preprocessed, *, width: int, height: int,
        bg: torch.Tensor, max_instances: int,
        xy_tap: torch.Tensor | None = None, depth_row: str | None = "z",
        on_stage: binning_ops.StageHook = binning_ops.no_stage_hook
        ) -> RenderOutput:
    """The render after its preprocess: ``on_stage("preprocess", prep)``,
    the tiles of the whole grid (``render_tiles``; ``xy_tap`` [N, 2], when
    given, is added to the pixel-space means) and the image of width x
    height (the bucket's, when the true size is smaller) over ``bg``."""
    grid_x, grid_y, _, _ = _grids(width, height, None)
    on_stage("preprocess", prep)

    xy = prep.xy if xy_tap is None else prep.xy + xy_tap
    table10 = tile_render.pack_rows(xy, prep.conic, prep.opacity, prep.rgb,
                                    prep.depth)
    tiles, num_instances, overflow = render_tiles(
        table10, prep.tiles_touched, prep.rect_min, prep.rect_wh,
        tile_offset=0, grid_x=grid_x, n_tiles=grid_x * grid_y,
        max_instances=max_instances, depth_row=depth_row,
        on_stage=on_stage)

    img = assemble_image(tiles, grid_x, grid_y, height, width)
    out = RenderOutput(
        render=over_background(img, bg),
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
