"""Instance expansion: kernel B1 and its plain PyTorch version.

Port of the forward of rain_tpu/ops/expand.py (``expand_instances``, whose
TPU kernel is ``_kernel``). Gaussians arrive in depth order; Gaussian g
owns the instances i with ``offs[g] - tiles[g] <= i < offs[g]`` (``offs``
= the inclusive prefix sum of the tile counts), one per tile of its rect
in row-major order (the reference's duplicateWithKeys,
cuda_rasterizer/rasterizer_impl.cu:269-290). For every
``i < min(total, M)`` the expansion writes the owner's 10 attribute rows
and one int64 key ``tile << 32 | g``; columns past that are zero with key
``n_tiles << 32``, so they sort last.

The TPU kernel selects columns with a windowed one-hot matmul and carries
the integer streams through it as f32 (12-bit halves of the offsets, the
original index, which is inexact from 2^24 Gaussians on). Here the key is
an exact integer and nothing else is carried.

The transpose, kernel B2 (``reduce_instances``, the port of
``_reduce_kernel``), sums rank-ordered per-instance gradient columns back
to their owners: column g is the sum of the columns
``[exc[g], exc[g] + tiles[g])``, clipped to M. Segments are contiguous and
each instance has one owner, so every sum is taken by one thread in
instance order, with no atomics: the result is the same on every run.

Each wrapper picks the path from its input's device: a CPU tensor runs the
plain version (``expand_instances_torch``, ``reduce_instances_torch``); a
CUDA tensor launches the kernel of ``csrc/expand.cu`` or ``csrc/reduce.cu``.
Kernel B1 expands each block of 1024 consecutive instances from the
window of depth-ordered Gaussians that owns them, whose offsets and rects
it stages in shared memory. Kernel B2 takes the same chunks the other way:
each block stages its 1024 instances' rows in shared memory and sums the
segments that start there, carrying on past the chunk for the one segment
that runs over it.
"""

from __future__ import annotations

import ctypes

import torch

from rain_tpu_torch import _build

ROWS = 10
REDUCE_MAX_ROWS = 16    # kernel B2's limit (csrc/reduce.cu:kMaxRows)


def _check(table, tiles, offs, rect_w, rect_base, max_instances):
    if table.dtype != torch.float32 or table.dim() != 2 or \
            table.shape[0] != ROWS or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [10, N] float32 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    n = table.shape[1]
    if n >= 2**31 or not 0 <= max_instances < 2**31:   # B1's int32 math
        raise ValueError(f"N = {n} and max_instances = {max_instances} must "
                         f"lie in [0, 2^31)")
    for name, t, dtype in (("tiles", tiles, torch.int32),
                           ("offs", offs, torch.int64),
                           ("rect_w", rect_w, torch.int32),
                           ("rect_base", rect_base, torch.int32)):
        if t.dtype != dtype or t.shape != (n,) or \
                t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} "
                             f"tensor on {table.device}")


def expand_instances(table: torch.Tensor, tiles: torch.Tensor,
                     offs: torch.Tensor, rect_w: torch.Tensor,
                     rect_base: torch.Tensor, *, grid_x: int,
                     tile_offset: int, n_tiles: int,
                     max_instances: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand depth-ordered per-Gaussian columns to per-instance columns.

    Args (N Gaussians in depth order):
      table: [10, N] float32 attribute rows (tile_render.ROW_* layout).
      tiles: [N] int32 tiles per Gaussian (0 for culled ones).
      offs: [N] int64 inclusive prefix sum of ``tiles``.
      rect_w: [N] int32 rect width in tiles.
      rect_base: [N] int32 global id of the rect's first tile.
      grid_x, tile_offset, n_tiles: tile grid width, global id of local
        tile 0, tiles owned.
      max_instances: the instance capacity M.

    Returns (cols [10, M] float32, keys [M] int64), see the module
    docstring. A CPU table runs the plain version; a CUDA table launches
    kernel B1. Raises ValueError unless N and M are below 2^31.
    """
    _check(table, tiles, offs, rect_w, rect_base, int(max_instances))
    if table.device.type == "cpu":
        return expand_instances_torch(
            table, tiles, offs, rect_w, rect_base, grid_x=grid_x,
            tile_offset=tile_offset, n_tiles=n_tiles,
            max_instances=max_instances)
    if table.device.type != "cuda":
        raise ValueError(f"no expansion for device {table.device}")
    m = int(max_instances)
    cols = torch.empty((ROWS, m), dtype=torch.float32, device=table.device)
    keys = torch.empty((m,), dtype=torch.int64, device=table.device)
    f = _build.kernel("expand", "rain_expand_instances", (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
    _build.launch(f, table.device, table.data_ptr(), table.shape[1],
                  tiles.data_ptr(), offs.data_ptr(), rect_w.data_ptr(),
                  rect_base.data_ptr(), m, int(grid_x), int(tile_offset),
                  int(n_tiles), cols.data_ptr(), keys.data_ptr())
    expand_instances.launches += 1
    return cols, keys


expand_instances.launches = 0


def expand_instances_torch(table: torch.Tensor, tiles: torch.Tensor,
                           offs: torch.Tensor, rect_w: torch.Tensor,
                           rect_base: torch.Tensor, *, grid_x: int,
                           tile_offset: int, n_tiles: int,
                           max_instances: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel B1 (same contract as
    ``expand_instances``), on any device and in the table's dtype: a
    searchsorted over the offsets, then a gather."""
    dev = table.device
    n = table.shape[1]
    i = torch.arange(max_instances, dtype=torch.int64, device=dev)
    pad_key = torch.full_like(i, int(n_tiles) << 32)
    if n == 0:
        return torch.zeros((ROWS, max_instances), dtype=table.dtype,
                           device=dev), pad_key
    valid = i < offs[-1]
    g = torch.clamp(torch.searchsorted(offs, i, right=True), max=n - 1)
    local = i - (offs[g] - tiles[g])
    w = torch.clamp(rect_w[g], min=1).to(torch.int64)
    dy = torch.div(local, w, rounding_mode="floor")
    dx = local - dy * w
    tile = rect_base[g].to(torch.int64) + dy * grid_x + dx - tile_offset
    keys = torch.where(valid, (tile << 32) | g, pad_key)
    cols = torch.where(valid[None, :], table[:, g],
                       torch.zeros((), device=dev))
    return cols, keys


def reduce_instances(d_rank: torch.Tensor, exc: torch.Tensor,
                     tiles: torch.Tensor) -> torch.Tensor:
    """Sum per-instance gradient columns to their owning Gaussians.

    Args (N Gaussians in depth order, M instance slots):
      d_rank: [rows, M] float32 gradient columns in rank (generated) order.
      exc: [N] int64 exclusive prefix sum of ``tiles``.
      tiles: [N] int32 instances per Gaussian.

    Returns [rows, N] float32: column g = the sum of d_rank's columns
    ``[exc[g], min(exc[g] + tiles[g], M))`` taken in order from 0.0. A CPU
    tensor runs the plain version; a CUDA tensor launches kernel B2, which
    takes at most 16 rows and writes every element of its output.
    """
    if d_rank.dtype != torch.float32 or d_rank.dim() != 2 or \
            not d_rank.is_contiguous():
        raise ValueError(f"d_rank must be a contiguous [rows, M] float32 "
                         f"tensor, got {d_rank.dtype} {tuple(d_rank.shape)}")
    n = exc.shape[0]
    for name, t, dtype in (("exc", exc, torch.int64),
                           ("tiles", tiles, torch.int32)):
        if t.dtype != dtype or t.shape != (n,) or \
                t.device != d_rank.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} "
                             f"tensor on {d_rank.device}")
    if d_rank.device.type == "cpu":
        return reduce_instances_torch(d_rank, exc, tiles)
    if d_rank.device.type != "cuda":
        raise ValueError(f"no reduction for device {d_rank.device}")
    rows, m = d_rank.shape
    if rows > REDUCE_MAX_ROWS:
        raise ValueError(f"kernel B2 takes at most {REDUCE_MAX_ROWS} rows, "
                         f"got {rows}")
    out = torch.empty((rows, n), dtype=torch.float32, device=d_rank.device)
    f = _build.kernel("reduce", "rain_reduce_instances", (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p))
    _build.launch(f, d_rank.device, d_rank.data_ptr(), rows, m,
                  exc.data_ptr(), tiles.data_ptr(), n, out.data_ptr())
    reduce_instances.launches += 1
    return out


reduce_instances.launches = 0


def reduce_instances_torch(d_rank: torch.Tensor, exc: torch.Tensor,
                           tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel B2 (same contract as
    ``reduce_instances``), on any device and in d_rank's dtype: a loop
    over the position k in each segment, adding in the kernel's order, so
    the two agree bit for bit."""
    rows, m = d_rank.shape
    out = torch.zeros((rows, exc.shape[0]), dtype=d_rank.dtype,
                      device=d_rank.device)
    if m == 0 or exc.shape[0] == 0:
        return out
    end = torch.clamp(exc + tiles, max=m)
    for k in range(int(tiles.max())):
        idx = exc + k
        ok = (idx < end)[None, :]
        col = d_rank[:, torch.clamp(idx, max=m - 1)]
        out = torch.where(ok, out + col, out)
    return out
