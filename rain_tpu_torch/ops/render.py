"""The forward render pipeline (preprocess → bin → composite → assemble).

Port of the forward of rain_tpu/ops/render.py, the counterpart of the
reference render API and rasterizer orchestration
(gaussian_renderer/__init__.py:9-79, rasterizer_impl.cu:187-330). This
slice renders without gradients: the screen-space tap, colour/covariance
overrides and resolution bucketing of the JAX ``render`` come with the
training slice.
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


class RenderOutput(NamedTuple):
    render: torch.Tensor        # [3, H, W] color (background applied)
    depth: torch.Tensor         # [1, H, W] alpha-weighted depth
    alpha: torch.Tensor         # [H, W] accumulated alpha
    final_t: torch.Tensor       # [H, W] final transmittance
    radii: torch.Tensor         # [N] int32 (visibility_filter = radii > 0)
    n_contrib: torch.Tensor     # [H, W] int32
    num_instances: torch.Tensor  # 0-d int64 (may exceed max_instances)
    overflow: torch.Tensor      # 0-d bool


def render_tiles(prep: proj_ops.Preprocessed, *, grid_x: int, n_rows: int,
                 max_instances: int, need_depth: bool = True,
                 on_stage: binning_ops.StageHook = binning_ops.no_stage_hook):
    """Composite every tile row of the image (the reference's fused path).

    Returns tiles [n_rows*grid_x, 256, 8] plus (num_instances, overflow).
    ``on_stage`` is called after each stage, see STAGES.
    """
    n_tiles = n_rows * grid_x
    table10 = tile_render.pack_rows(prep.xy, prep.conic, prep.opacity,
                                    prep.rgb, prep.depth)
    pack, num_instances, overflow = binning_ops.sorted_pack_fwd(
        table10, prep.tiles_touched, prep.rect_min, prep.rect_wh,
        0, grid_x, n_tiles, max_instances, need_depth, on_stage)[0]
    tile_start, tile_end = binning_ops.tile_ranges(
        prep.rect_min, prep.rect_wh, prep.tiles_touched > 0, grid_x,
        n_tiles, 0, max_instances)
    on_stage("tile_ranges", (tile_start, tile_end))
    tiles = tile_render.composite_forward(pack, tile_start, tile_end, 0,
                                          grid_x)
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
           need_depth: bool = True,
           on_stage: binning_ops.StageHook = binning_ops.no_stage_hook
           ) -> RenderOutput:
    """Render one view from post-activation inputs (see model.gaussians).

    camera: dict from data.cameras.Camera.render_inputs().
    need_depth=False returns a zero depth channel.
    on_stage(name, value) is called after each of STAGES with its result.
    """
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    prep = proj_ops.preprocess(
        means3d, scales_act, quats_act, opacity_act, shs, alive,
        sh_degree=sh_degree,
        world_view=camera["world_view"],
        full_proj=camera["full_proj"],
        camera_center=camera["camera_center"],
        tan_fovx=camera["tanfovx"], tan_fovy=camera["tanfovy"],
        width=width, height=height,
        low_pass=low_pass, scale_modifier=scale_modifier)
    on_stage("preprocess", prep)

    tiles, num_instances, overflow = render_tiles(
        prep, grid_x=grid_x, n_rows=grid_y, max_instances=max_instances,
        need_depth=need_depth, on_stage=on_stage)

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
