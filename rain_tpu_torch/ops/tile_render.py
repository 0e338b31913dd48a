"""Forward tile compositor: kernel B3 and its plain PyTorch version.

Port of the forward half of rain_tpu/ops/tile_render.py (``composite``,
whose TPU kernel is ``_fwd_kernel``). Each 16x16 pixel tile composites its
``[start, end)`` range of the tile-sorted instance pack front to back with
the reference's rules (cuda_rasterizer/forward.cu:251-369):

  power = -0.5 (a dx² + c dy²) - b dx dy, dx = xg - px in global pixels;
  skip when power > 0; alpha = min(0.99, op·e^power); skip alpha < 1/255;
  stop before compositing when T·(1 - alpha) < 1e-4, keeping T.

Output tiles are [n_tiles, 256, 8] with channels
[r, g, b, depth, alpha_sum, final_T, n_contrib, 0] and no background.

``composite_forward`` picks the path from the pack's device: a CPU tensor
runs ``composite_forward_torch``; a CUDA tensor launches the kernel of
``csrc/tile_render_fwd.cu``. The power is in the direct form above, not the
TPU kernel's tile-local quadratic-basis matmul, so the port rounds like the
reference's sequential loop (and ops/reference_composite.py). The backward
kernel (B4) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from rain_tpu_torch import _build

TILE = 16
P = TILE * TILE          # pixels per tile
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99

# Output tile channels.
CH_R, CH_G, CH_B, CH_DEPTH, CH_ALPHA, CH_T, CH_NCONTRIB, CH_PAD = range(8)

# Instance-pack rows (raw per-Gaussian data, [16, M] layout):
#   0: conic a   1: conic b   2: conic c
#   3: xg (global pixel x)    4: yg (global pixel y)
#   5: opacity   6..8: rgb    9: depth   10..15: zero padding
ROW_A, ROW_B, ROW_C, ROW_XG, ROW_YG, ROW_OP, ROW_R, ROW_G, ROW_B2, \
    ROW_DEPTH = range(10)
PACK_ROWS = 16
KERNEL_ROWS = 10         # rows the compositor reads (ROW_A .. ROW_DEPTH)


def pack_rows(xy, conic, opacity, color, depth):
    """Raw per-Gaussian rows 0..9 of the kernel layout (see ROW_* above),
    [10, N]; xy is in GLOBAL pixel coordinates. The zero rows 10..15 are
    added only to the tile-sorted pack (ops.binning.tile_sort)."""
    return torch.stack([
        conic[:, 0], conic[:, 1], conic[:, 2],
        xy[:, 0], xy[:, 1],
        opacity,
        color[:, 0], color[:, 1], color[:, 2],
        depth,
    ], dim=0)


def _check(pack, starts, ends):
    if pack.dtype != torch.float32 or pack.dim() != 2 or \
            pack.shape[0] != PACK_ROWS or not pack.is_contiguous():
        raise ValueError(f"pack must be a contiguous [16, M] float32 tensor, "
                         f"got {pack.dtype} {tuple(pack.shape)}")
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.dim() != 1 or \
                t.device != pack.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [n_tiles] int32 "
                             f"tensor on {pack.device}")
    if starts.shape != ends.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and ends "
                         f"{tuple(ends.shape)} differ in shape")


def composite_forward(pack: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor, toff: int,
                      grid_x: int) -> torch.Tensor:
    """Composite sorted instances into per-tile images.

    Args (M = instance capacity; pack in tile-sorted order, see
    ops.binning.sorted_pack):
      pack: [16, M] float32 raw per-instance rows (see ROW_*).
      starts, ends: [n_tiles] int32 instance ranges per (local) tile.
      toff: global tile id of local tile 0.
      grid_x: tile-grid width.

    Returns tiles [n_tiles, 256, 8] float32 (see the module docstring).
    A CPU pack runs the plain version; a CUDA pack launches kernel B3.
    """
    _check(pack, starts, ends)
    if pack.device.type == "cpu":
        return composite_forward_torch(pack, starts, ends, toff, grid_x)
    if pack.device.type != "cuda":
        raise ValueError(f"no compositor for device {pack.device}")
    n_tiles = starts.shape[0]
    out = torch.empty((n_tiles, P, 8), dtype=torch.float32,
                      device=pack.device)
    f = _build.kernel("tile_render_fwd", "rain_composite_forward", (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    _build.launch(f, pack.device, pack.data_ptr(), pack.shape[1],
                  starts.data_ptr(), ends.data_ptr(), n_tiles, int(toff),
                  int(grid_x), out.data_ptr())
    composite_forward.launches += 1
    return out


composite_forward.launches = 0


def _composite_loop(pack, starts, ends, toff, grid_x):
    """The plain compositor, vectorised over tiles and pixels and looping
    over the position k in each tile's range. Returns (tiles, n_eval,
    n_comp): per pixel, the instances evaluated (in range, pixel not yet
    done) and composited."""
    dev = pack.device
    n_tiles = starts.shape[0]
    gt = torch.arange(n_tiles, device=dev) + int(toff)
    p = torch.arange(P, device=dev)
    px = ((gt % grid_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((gt // grid_x) * TILE)[:, None] + (p // TILE)[None, :]
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    start = starts.to(torch.int64)
    length = (ends - starts).to(torch.int64)
    last_col = max(pack.shape[1] - 1, 0)

    shape = (n_tiles, P)
    T = torch.ones(shape, device=dev)
    acc = torch.zeros((5,) + shape, device=dev)   # r, g, b, depth, alpha
    last = torch.zeros(shape, dtype=torch.int64, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    n_eval = torch.zeros(shape, dtype=torch.int64, device=dev)
    n_comp = torch.zeros(shape, dtype=torch.int64, device=dev)
    max_len = int(length.max()) if n_tiles else 0
    for k in range(max_len):
        in_range = (k < length)[:, None]
        col = pack[:KERNEL_ROWS, torch.clamp(start + k, max=last_col)]
        a, b, c, xg, yg, op, r, g, b2, d = col[:, :, None]
        dx = xg - px
        dy = yg - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
        active = in_range & ~done
        ok = active & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = T * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        live = ok & ~stop
        w = alpha * T
        for ch, v in enumerate((r, g, b2, d)):
            acc[ch] = torch.where(live, acc[ch] + w * v, acc[ch])
        acc[4] = torch.where(live, acc[4] + w, acc[4])
        T = torch.where(live, test_t, T)
        done = done | stop
        last = torch.where(live, k + 1, last)
        n_eval += active
        n_comp += live
    tiles = torch.stack([acc[0], acc[1], acc[2], acc[3], acc[4], T,
                         last.to(torch.float32), torch.zeros_like(T)], dim=-1)
    return tiles, n_eval, n_comp


def composite_forward_torch(pack: torch.Tensor, starts: torch.Tensor,
                            ends: torch.Tensor, toff: int,
                            grid_x: int) -> torch.Tensor:
    """The plain PyTorch version of kernel B3 (same contract as
    ``composite_forward``), on any device."""
    return _composite_loop(pack, starts, ends, toff, grid_x)[0]


def composite_work(pack: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor, toff: int,
                   grid_x: int) -> tuple[int, int]:
    """(pixel-instance pairs evaluated, pairs composited) by a front-to-back
    compositor on these inputs: the data-dependent work that bounds B3."""
    _, n_eval, n_comp = _composite_loop(pack, starts, ends, toff, grid_x)
    return int(n_eval.sum()), int(n_comp.sum())
