"""The sharded training step: Gaussians and tile rows split over the ranks.

Port of rain_tpu/parallel/sharding.py in PyTorch's idiom, one process per
device (parallel.distributed, parallel.launch). Rank r of D owns two
things, as rain_tpu's device r of its one mesh axis does:

- shard r of the Gaussian capacity, rows [r·C/D, (r+1)·C/D): its
  parameters, Adam moments and densification statistics (ZeRO style);
- band r of the tile rows, ``rows_per_band = ceil(grid_y / D)`` rows from
  row r·rows_per_band, rendered with ``HALO`` more tile rows on each side.

One step on each rank:

  forward:  activate and preprocess its shard (colours zeroed, so that SH
            is evaluated apart from the geometry); gather every shard's
            render streams in two collectives, the 7 geometry rows, then
            the 3 SH colours (``distributed.gather_shards``), and the rect
            ints; clip each rect to the band's rows; bin, sort and
            composite the band (ops.render.render_tiles) with the tile
            offset (band·rows − HALO)·grid_x, which is negative on band
            0; the band's L1 and SSIM sums over its interior pixels,
            with pixels outside the image zeroed, so that the SSIM blur's
            zero padding is the one of the whole image.
  backward: the gathers' transpose sums every band's stream cotangents
            onto the owning shard (a reduce-scatter), so each shard's
            gradients are the whole image's; no gradient all-reduce exists.
  update:   the loss and L1 sums are all-reduced, the instance count takes
            the max over ranks and the overflow any rank's; then the
            densify statistics and Adam, elementwise on the shard.

A band's tile rows run from ``band_ty0 = band·rows_per_band − HALO`` for
``n_rows = rows_per_band + 2·HALO`` rows. The 16-pixel halo covers the
SSIM window's 5-pixel reach, so the SSIM map over the band's interior is
the whole image's there. Bands past the last tile row render empty and add
zero. Instances are binned only where a rect meets the band's rows that
lie in the image, so the halo rows above and below the image hold none.

Where the port differs from rain_tpu's step: a culled Gaussian (dead,
behind the camera, or too faint) takes no tile in any band, as in the
single-device step; rain_tpu's band keeps the rect of such a Gaussian and
counts its instances, which composite nothing (rain_tpu's
``tiles_b = where(h > 0, w·h, 0)`` ignores ``tiles_touched``). And no
check of ``max_instances_per_shard`` has a counterpart: kernel B1 takes
any M (rain_tpu requires a power-of-two chunk divisor, ``_expand_chunk``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import densify as densify_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning as binning_ops
from rain_tpu_torch.ops import losses as loss_ops
from rain_tpu_torch.ops import projection as proj_ops
from rain_tpu_torch.ops import render as render_ops
from rain_tpu_torch.ops import sh as sh_ops
from rain_tpu_torch.ops.projection import TILE
from rain_tpu_torch.parallel import distributed
from rain_tpu_torch.train import step as step_mod

HALO = 1   # tile rows of halo per side (16 px >= the SSIM window's 5)


class ShardedAux(NamedTuple):
    """train.step.StepAux of the sharded step: the loss and l1 of the whole
    image; num_instances the max over the bands and instance_overflow any
    band's, the values that matter against the per-band instance tier."""
    loss: torch.Tensor            # 0-d f32
    l1: torch.Tensor              # 0-d f32
    num_instances: torch.Tensor   # 0-d int64
    instance_overflow: torch.Tensor  # 0-d bool
    n_alive: int


class BandLayout(NamedTuple):
    grid_x: int
    grid_y: int
    rows_per_band: int
    n_rows: int          # rows_per_band + 2·HALO


def band_layout(width: int, height: int, world: int) -> BandLayout:
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    rows = (grid_y + world - 1) // world
    return BandLayout(grid_x, grid_y, rows, rows + 2 * HALO)


def band_offset(layout: BandLayout, band: int) -> int:
    """The global tile id of band ``band``'s first tile: negative on band 0,
    whose first row is the halo row above the image."""
    return (band * layout.rows_per_band - HALO) * layout.grid_x


# -- shards of the state ----------------------------------------------------
def _rows(capacity: int, rank: int, world: int) -> slice:
    if capacity % world:
        raise ValueError(f"capacity {capacity} is not divisible by "
                         f"{world} ranks")
    n = capacity // world
    return slice(rank * n, (rank + 1) * n)


def shard_state(state: gmod.GaussianState, rank: int,
                world: int) -> gmod.GaussianState:
    """Rows of shard ``rank`` of ``world`` of a whole state, as new tensors
    (``n_alive`` stays the whole state's). ValueError unless the capacity
    divides by ``world``."""
    rows = _rows(state.capacity, rank, world)
    return gmod.GaussianState(
        params=gmod.GaussianParams(*[p[rows].clone() for p in state.params]),
        n_alive=state.n_alive,
        **{k: getattr(state, k)[rows].clone() for k in gmod.STAT_FIELDS})


def shard_opt(opt: adam_mod.AdamState, rank: int,
              world: int) -> adam_mod.AdamState:
    """Rows of shard ``rank`` of Adam's moments; the step count is shared."""
    rows = _rows(opt.mu.xyz.shape[0], rank, world)
    return adam_mod.AdamState(
        mu=gmod.GaussianParams(*[m[rows].clone() for m in opt.mu]),
        nu=gmod.GaussianParams(*[v[rows].clone() for v in opt.nu]),
        step=opt.step.clone())


def gather_state(state: gmod.GaussianState, group=None) -> gmod.GaussianState:
    """The whole state from every rank's shard (a collective every rank
    of the group joins)."""
    return gmod.GaussianState(
        params=gmod.GaussianParams(*[distributed.all_gather(p, group)
                                     for p in state.params]),
        n_alive=state.n_alive,
        **{k: distributed.all_gather(getattr(state, k), group)
           for k in gmod.STAT_FIELDS})


def gather_opt(opt: adam_mod.AdamState, group=None) -> adam_mod.AdamState:
    """Adam's whole moments from every rank's shard (a collective)."""
    return adam_mod.AdamState(
        mu=gmod.GaussianParams(*[distributed.all_gather(m, group)
                                 for m in opt.mu]),
        nu=gmod.GaussianParams(*[distributed.all_gather(v, group)
                                 for v in opt.nu]),
        step=opt.step)


def shard_alive(state: gmod.GaussianState, rank: int) -> torch.Tensor:
    """The alive mask of shard ``rank``'s rows: row i of the shard is row
    rank·C_shard + i of the whole state, alive below ``n_alive`` (an int
    or a 0-d int32 device tensor)."""
    dev = state.params.xyz.device
    first = rank * state.capacity
    return torch.arange(first, first + state.capacity,
                        device=dev) < state.n_alive


# -- the band's loss ----------------------------------------------------------
def _band_loss_sums(color, gt_band, band_ty0: int, rows_per_band: int, *,
                    width: int, height: int):
    """(l1_sum, ssim_sum) over the band's interior pixels of [3, n_rows·16,
    grid_x·16] images whose first row is pixel row band_ty0·16; pixels
    outside the image are zeroed, so the SSIM blur's zero padding is the
    whole image's."""
    dev = color.device
    row_px = band_ty0 * TILE + torch.arange(color.shape[1], device=dev)
    col_px = torch.arange(color.shape[2], device=dev)
    in_image = ((row_px >= 0) & (row_px < height))[:, None] & \
        (col_px < width)[None, :]
    band_lo = (band_ty0 + HALO) * TILE
    band_hi = band_lo + rows_per_band * TILE
    in_band = in_image & ((row_px >= band_lo) & (row_px < band_hi))[:, None]
    color = color * in_image[None]
    gt = gt_band * in_image[None]
    l1_sum = torch.sum(torch.abs(color - gt) * in_band[None])
    ssim_sum = torch.sum(loss_ops.ssim_map(
        color.contiguous(), gt.contiguous())[0] * in_band[None])
    return l1_sum, ssim_sum


def gt_band(gt_image: torch.Tensor, layout: BandLayout,
            band: int) -> torch.Tensor:
    """The band's rows of the ground truth [3, H, W] as [3, n_rows·16,
    grid_x·16], zero outside the image (rain_tpu slices a zero-padded copy
    of the whole image, ``gt_pad``)."""
    y0 = (band * layout.rows_per_band - HALO) * TILE
    out = gt_image.new_zeros((3, layout.n_rows * TILE, layout.grid_x * TILE))
    lo, hi = max(y0, 0), min(y0 + out.shape[1], gt_image.shape[1])
    if hi > lo:
        out[:, lo - y0:hi - y0, :gt_image.shape[2]] = gt_image[:, lo:hi]
    return out


# -- the step ---------------------------------------------------------------
def refuse_depth(depth) -> None:
    """ValueError for depth inputs: the sharded step has no depth term
    (train.step's ``DepthTarget``), and dropping one would train another
    objective without a word."""
    if depth is not None:
        raise ValueError("the sharded step has no depth term: depth "
                         "regularization runs on one device "
                         "(train.step.train_step's depth)")


def make_sharded_train_step(group=None, *, width: int, height: int,
                            sh_degree: int, max_instances_per_shard: int,
                            lambda_dssim: float = 0.2,
                            update_densify_stats: bool = True):
    """The sharded train step of this rank in ``group`` (the default group
    when None), for images of width x height.

    Returns ``step(state, opt, camera, gt_image, bg, low_pass, xyz_lr,
    opt_leaves, on_stage=no_stage_hook, depth=None) -> (state, opt,
    ShardedAux)``, the
    counterpart of train.step.train_step, which every rank of the group
    calls together. ``state`` and ``opt`` are this rank's shards
    (``shard_state``, ``shard_opt``; ``n_alive`` the whole state's) and come
    back as new tensors; camera, gt_image [3, H, W], bg and the learning
    rates are every rank's same values. Every value that changes from call
    to call may be a 0-d device tensor, as rain_tpu traces it, or a
    number, with the same bits: ``state.n_alive`` (int32), ``low_pass``,
    ``xyz_lr`` and the four ``opt_leaves`` (f32); train.compiled captures
    the step on an NCCL group with them as graph inputs.
    ``on_stage(name, value)`` sees the band's stages of ops.render.STAGES
    from "depth_sort" on, and its BACKWARD_STAGES. ``depth`` other than
    None raises ValueError (``refuse_depth``).
    """
    world = distributed.world_size(group)
    rank = distributed.rank(group)
    layout = band_layout(width, height, world)
    grid_x, grid_y, rows_per_band, n_rows = layout
    n_tiles = n_rows * grid_x
    band_ty0 = rank * rows_per_band - HALO
    toff = band_offset(layout, rank)
    # the band's rows that lie in the image; empty past the last row
    lo, hi = max(band_ty0, 0), min(band_ty0 + n_rows, grid_y)
    m = max_instances_per_shard
    n_pix_f32 = float(np.float32(3.0) * np.float32(height) *
                      np.float32(width))

    def step(state: gmod.GaussianState, opt: adam_mod.AdamState, camera,
             gt_image, bg, low_pass, xyz_lr, opt_leaves,
             on_stage: binning_ops.StageHook = binning_ops.no_stage_hook,
             depth=None):
        refuse_depth(depth)
        dev = state.params.xyz.device
        cap_sh = state.capacity
        alive = shard_alive(state, rank)
        params = gmod.GaussianParams(
            *[p.detach().requires_grad_(True) for p in state.params])
        tap = torch.zeros((cap_sh, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
        gt = gt_band(gt_image, layout, rank)
        # a device fill, not a copy of a host value (see losses.py)
        n_pix = torch.full((), n_pix_f32, dtype=torch.float32, device=dev)
        with torch.enable_grad():
            scales, quats, opac, shs = gmod.activate(params)
            prep = proj_ops.preprocess(
                params.xyz, scales, quats, opac, shs, alive,
                sh_degree=sh_degree,
                world_view=camera["world_view"],
                full_proj=camera["full_proj"],
                camera_center=camera["camera_center"],
                tan_fovx=camera["tanfovx"], tan_fovy=camera["tanfovy"],
                width=width, height=height, low_pass=low_pass,
                colors_override=torch.zeros((cap_sh, 3), device=dev))
            xy = prep.xy + tap
            # two gathers, as rain_tpu's: the geometry does not wait for
            # the SH colours
            geom = distributed.gather_shards(torch.stack([
                prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
                xy[:, 0], xy[:, 1], prep.opacity, prep.depth], dim=1), group)
            rgb = distributed.gather_shards(sh_ops.sh_to_rgb(
                sh_degree, shs, params.xyz, camera["camera_center"]), group)
            table10 = torch.cat([geom[:, :6], rgb, geom[:, 6:]],
                                dim=1).T.contiguous()
            # a culled Gaussian's rect gets no width, so no band bins it
            visible = (prep.tiles_touched > 0)[:, None]
            rect = distributed.all_gather(torch.cat([
                prep.rect_min,
                torch.where(visible, prep.rect_wh,
                            torch.zeros_like(prep.rect_wh))], dim=1), group)
            y0 = torch.clamp(rect[:, 1], lo, hi)
            y1 = torch.clamp(rect[:, 1] + rect[:, 3], lo, hi)
            h = torch.clamp(y1 - y0, min=0)
            rect_min = torch.stack([rect[:, 0], y0], dim=1)
            rect_wh = torch.stack([rect[:, 2], h], dim=1)
            tiles = rect[:, 2] * h

            band, num_inst, ovf = render_ops.render_tiles(
                table10, tiles, rect_min, rect_wh, tile_offset=toff,
                grid_x=grid_x, n_tiles=n_tiles, max_instances=m,
                depth_row=None,   # the loss reads no depth
                on_stage=on_stage)
            img = render_ops.assemble_image(band, grid_x, n_rows,
                                            n_rows * TILE, grid_x * TILE)
            color = render_ops.over_background(img, bg)
            l1_sum, ssim_sum = _band_loss_sums(
                color, gt, band_ty0, rows_per_band, width=width,
                height=height)
            local = ((1.0 - lambda_dssim) * l1_sum -
                     lambda_dssim * ssim_sum) / n_pix
            # the gathers' backward sums every band's cotangents onto this
            # shard: these are the whole image's gradients
            *grads, tap_grad = torch.autograd.grad(local, [*params, tap])
        grads = gmod.GaussianParams(*grads)

        sums = distributed.all_reduce(
            torch.stack([local.detach(), l1_sum.detach()]), "sum", group)
        counts = distributed.all_reduce(
            torch.stack([num_inst, ovf.to(torch.int64)]), "max", group)
        if update_densify_stats:
            state = densify_mod.add_densification_stats(
                state, tap_grad, prep.radii, width, height)
        new_params, new_opt = step_mod.adam_update(state.params, grads, opt,
                                                   opt_leaves, xyz_lr)
        state = state._replace(params=new_params)
        aux = ShardedAux(loss=sums[0] + lambda_dssim, l1=sums[1] / n_pix,
                         num_instances=counts[0],
                         instance_overflow=counts[1] > 0,
                         n_alive=state.n_alive)
        return state, new_opt, aux

    return step
