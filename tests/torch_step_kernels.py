"""Kernels B1-B4 of one frame or training step against their plain
versions, on the inputs the step gave them (its ``on_stage`` hook).

Imports torch and the port only (no jax): chip_smoke.py loads it by
path, and the card tests of tests/test_torch_cuda.py import it.
"""

import torch

from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import tile_render


def kernel_inputs(seen, width, height, max_instances, band=None):
    """The inputs that kernels B1 and B3 were given in a frame or step
    (at the tier max_instances), or with band = (tile offset, tile rows)
    in a band of the sharded step: B1's (args, kwargs) and B3's args."""
    grid_x = (width + 15) // 16
    toff, n_rows = band or (0, (height + 15) // 16)
    d = seen["depth_sort"]
    start, end = seen["tile_ranges"]
    return (((d.table, d.tiles, d.offs, d.rect_w, d.rect_base),
             dict(grid_x=grid_x, tile_offset=toff, n_tiles=grid_x * n_rows,
                  max_instances=max_instances)),
            (seen["tile_sort_gather"], start, end, toff, grid_x))


def bitwise_equal(a, b):
    """Equal bit for bit, signed zeros included (torch.equal takes -0.0
    for +0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def compare_tiles(got, want, what):
    """Kernel vs plain compositor output, bit for bit in all 8 channels:
    the kernel does the plain loop's operations in its order (built with
    -fmad=false) and skips only pairs that the loop skips. Returns the max
    abs error (0)."""
    if not bitwise_equal(got, want):
        n_px = got[..., 0].numel()
        flips = int((got[..., tile_render.CH_NCONTRIB] !=
                     want[..., tile_render.CH_NCONTRIB]).sum())
        raise AssertionError(
            f"{what}: B3 differs from its plain version (max abs "
            f"{float((got - want).abs().max()):.3g}, n_contrib at {flips} "
            f"of {n_px} pixels)")
    print(f"{what}: B3 bitwise equal to its plain version")
    return float((got - want).abs().max())


@torch.no_grad()
def compare_forward(seen, width, height, what, max_instances, band=None):
    """B1 and B3 of one frame or step (or band, see kernel_inputs) against
    their plain versions on the inputs it gave them, bit for bit (B1 in
    columns and keys). Returns their max abs errors. Without autograd: a
    training step's pack carries its graph, and the plain loops would
    record theirs."""
    b1_args, b3_args = kernel_inputs(seen, width, height, max_instances,
                                     band)
    cols_k, keys_k = seen["expand_B1"]
    cols_p, keys_p = expand_ops.expand_instances_torch(*b1_args[0],
                                                       **b1_args[1])
    if not (bitwise_equal(cols_k, cols_p) and torch.equal(keys_k, keys_p)):
        raise AssertionError(f"B1 {what} differs from "
                             f"expand_instances_torch")
    print(f"B1 {what}, M={b1_args[1]['max_instances']}: bitwise equal to "
          f"its plain version")
    b1_err = float((cols_k - cols_p).abs().max())
    del cols_p, keys_p
    return b1_err, compare_tiles(
        seen["composite_B3"], tile_render.composite_forward_torch(*b3_args),
        f"B3 {what}")


@torch.no_grad()
def compare_backward(seen, what):
    """B2 and B4 of one training step against their plain versions on the
    inputs the step gave them. B2 sums each segment from 0.0 in the plain
    version's order, so the two are equal bit for bit; the gradients of a
    loss averaged over millions of pixels are small, so no absolute bar
    would do (each row's max |value| is printed). B4 follows the plain
    version's arithmetic and pixel-sum order, so the two are equal bit for
    bit in every row, zero rows and columns included. Returns (B2's,
    B4's) max abs error and B2's max |value| per row."""
    d_rank, exc, tiles, d_depth = seen["reduce_B2"]
    want = expand_ops.reduce_instances_torch(d_rank, exc, tiles)
    scale = want.abs().amax(dim=1).tolist()
    print(f"B2 {what}: max |value| per row {[f'{v:.3g}' for v in scale]}")
    if not torch.equal(d_depth, want):
        raise AssertionError(f"B2 {what} differs from its plain version")
    b2_err = float((d_depth - want).abs().max())
    args, d_pack = seen["composite_bwd_B4"]
    want = tile_render.composite_backward_torch(*args)
    err = (d_pack - want).abs()
    if not bitwise_equal(d_pack, want):
        raise AssertionError(
            f"B4 {what} differs from its plain version: max abs error per "
            f"row {[f'{float(e):.3g}' for e in err.amax(dim=1)]}")
    print(f"B2 {what}: bitwise equal; B4 {what}: bitwise equal in all "
          f"{d_pack.shape[0]} rows")
    return b2_err, float(err.max()), scale
