"""Tile compositor: kernels B3 and B4 and their plain PyTorch versions.

Port of rain_tpu/ops/tile_render.py (``composite``, whose TPU kernels are
``_fwd_kernel`` and ``_bwd_kernel``). Each 16x16 pixel tile composites its
``[start, end)`` range of the tile-sorted instance pack front to back with
the reference's rules (cuda_rasterizer/forward.cu:251-369):

  power = -0.5 (a dx² + c dy²) - b dx dy, dx = xg - px in global pixels;
  skip when power > 0; alpha = min(0.99, op·e^power); skip alpha < 1/255;
  stop before compositing when T·(1 - alpha) < 1e-4, keeping T.

Output tiles are [n_tiles, 256, 8] with channels
[r, g, b, depth, alpha_sum, final_T, n_contrib, 0] and no background.

The backward (kernel B4, ``composite_backward``, the port of
``_bwd_kernel``) takes the cotangents of r, g, b and final_T and gives the
gradients of conic a/b/c, xg, yg, opacity and rgb per instance, in the
pack's row layout; depth gets none, and the 0.99 clamp passes the gradient
through (the reference's backward.cu:528,544). It walks each pixel's
instances front to back again, seeded with C·g (the pixel's colour dotted
with its cotangent), so the contribution behind instance k is C·g minus
the contributions up to k:

  dL/dalpha_k = T_k (c_k·g) - (S_k + T_final g_T) / (1 - alpha_k),
  S_k = C·g - sum_{j <= k} alpha_j T_j (c_j·g);

and it differentiates the direct-form power: dpower/dxg = -(a dx + b dy),
dpower/dyg = -(c dy + b dx), dpower/da = -dx²/2, dpower/db = -dx dy,
dpower/dc = -dy²/2. ``composite`` is the autograd Function whose forward
is B3 and whose backward is B4.

Each wrapper picks the path from the pack's device: a CPU tensor runs the
plain version (``composite_forward_torch``, ``composite_backward_torch``);
a CUDA tensor launches the kernel of ``csrc/tile_render_fwd.cu`` or
``csrc/tile_render_bwd.cu``. The power is in the direct form above, not
the TPU kernel's tile-local quadratic-basis matmul, so the port rounds
like the reference's sequential loop (and ops/reference_composite.py).

Kernel B3 skips, before the exponential, every pair whose power lies
below a per-instance floor (``power_floor``), and both kernels skip, for
a warp, every instance whose alpha >= 1/255 ellipse cannot reach the
warp's 8x4 pixel block (``block_mask``; ``thread_pixels`` maps threads
to pixels); these are the plain copies of ``csrc/composite_cull.cuh``.
Both only skip pairs that the rules above skip, so the plain versions
walk every pair and still equal the kernels bit for bit.

B4 sums, per instance over the tile's 256 pixels, the moments of dpow =
gd·op (Σ dpow·dx, Σ dpow·dy, Σ dpow·dx², Σ dpow·dy², Σ dpow·dx·dy), Σ gd
and Σ w·g_rgb, in a fixed order (``_pixel_sum``): 8 partial sums,
partial s adding the pixels of threads s, s + 8, ..., s + 248 in turn
from +0.0, then a tree over the 8 (s + 4, s + 2, s + 1); the conic and
position rows follow from the moments (d a = -Σ dpow·dx²/2, d xg = -(a Σ
dpow·dx + b Σ dpow·dy), ...). Pixels that did not composite the instance
add +0, which the kernel skips; a sum that starts at +0 is never -0, so
that is exact. B4 writes every element of its [16, M] output, zeros
included, so the wrapper allocates it with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

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
GRAD_ROWS = 9            # rows that take a gradient (ROW_A .. ROW_B2)
SPLIT = 8                # partial sums per instance in B4's reduction
# The cull of csrc/composite_cull.cuh (see there for the derivation).
FLOOR_MARGIN = 1e-3      # the power floor's margin below ln(alpha_min/op)
CULL_GAMMA = 1e-5        # bound on the f32 power's relative rounding
CULL_GROW, CULL_PAD = 1.01, 0.05   # the radii's margin, relative and in px
CULL_COND = 1e-3         # det'' / (a'' c'') below which nothing is culled
CULL_HUGE = 1e30
WARP, WARPS = 32, 8      # threads per warp, warps per tile (8x4 pixels each)


StageHook = Callable[[str, object], None]


def no_stage_hook(stage: str, value: object) -> None:
    """The default ``on_stage`` hook: records nothing."""


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


def power_floor(op: torch.Tensor) -> torch.Tensor:
    """Per-instance power floor (csrc/composite_cull.cuh:power_floor): a
    pair whose power lies below it has op·e^power < 1/255, so the kernels
    skip it without the exponential."""
    return torch.log(torch.full_like(op, ALPHA_MIN) / op) - FLOOR_MARGIN


def thread_pixels() -> torch.Tensor:
    """[P] int64: the tile pixel (row-major) of each thread of kernels B3
    and B4 (csrc/composite_cull.cuh:pixel_of). Warp w takes the 8x4 block
    x = 8 (w mod 2) + lane mod 8, y = 4 (w // 2) + lane // 8."""
    tid = torch.arange(P)
    w, lane = tid // WARP, tid % WARP
    return TILE * (4 * (w // 2) + lane // 8) + 8 * (w % 2) + lane % 8


def block_mask(a, b, c, xg, yg, floor, tx0, ty0) -> torch.Tensor:
    """Per-instance block mask (csrc/composite_cull.cuh:block_mask), int64:
    bit w is set unless no pixel of warp w's 8x4 block (x in [tx0 + 8 (w
    mod 2), + 7], y in [ty0 + 4 (w // 2), + 3]) can reach power >= floor.
    Arguments broadcast (instance rows as float32 tensors, tile origins as
    numbers or tensors)."""
    L = -floor
    ap = a * (1.0 - 2.0 * CULL_GAMMA)
    cp = c * (1.0 - 2.0 * CULL_GAMMA)
    bp = b.abs() * (1.0 + 2.0 * CULL_GAMMA)
    apcp = ap * cp
    det = apcp - bp * bp
    ry = torch.sqrt(2.0 * L * ap / det) * CULL_GROW + CULL_PAD
    rx = torch.sqrt(2.0 * L * cp / det) * CULL_GROW + CULL_PAD
    ok = (ap > 0.0) & (cp > 0.0) & (det > CULL_COND * apcp) & \
        (ry < CULL_HUGE) & (rx < CULL_HUGE)
    w = torch.arange(WARPS)
    x0 = torch.as_tensor(tx0, dtype=torch.float32)[..., None] + 8.0 * (w % 2)
    y0 = torch.as_tensor(ty0, dtype=torch.float32)[..., None] + 4.0 * (w // 2)
    bits = ((xg + rx)[..., None] >= x0) & ((xg - rx)[..., None] <= x0 + 7.0) \
        & ((yg + ry)[..., None] >= y0) & ((yg - ry)[..., None] <= y0 + 3.0)
    mask = (bits.to(torch.int64) << w).sum(-1)
    mask = torch.where(ok, mask, (1 << WARPS) - 1)
    return torch.where(L < 0.0, 0, mask)


def _pixel_coords(n_tiles, toff, grid_x, dev):
    """Global pixel coordinates (px, py) of every tile's pixels, [T, P]
    float32 each, pixel p = row-major position in the tile."""
    gt = torch.arange(n_tiles, device=dev) + int(toff)
    p = torch.arange(P, device=dev)
    px = ((gt % grid_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((gt // grid_x) * TILE)[:, None] + (p // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _composite_loop(pack, starts, ends, toff, grid_x):
    """The plain compositor, vectorised over tiles and pixels and looping
    over the position k in each tile's range. Returns (tiles, n_eval,
    n_comp): per pixel, the instances evaluated (in range, pixel not yet
    done) and composited."""
    dev = pack.device
    n_tiles = starts.shape[0]
    px, py = _pixel_coords(n_tiles, toff, grid_x, dev)
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


def _check_tiles(name, t, pack, n_tiles):
    if t.dtype != torch.float32 or t.shape != (n_tiles, P, 8) or \
            t.device != pack.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [{n_tiles}, {P}, 8] "
                         f"float32 tensor on {pack.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def composite_backward(pack: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor, toff: int, grid_x: int,
                       tiles: torch.Tensor,
                       g_tiles: torch.Tensor) -> torch.Tensor:
    """Per-instance gradients of the compositor.

    Args: ``composite_forward``'s (pack, starts, ends, toff, grid_x), its
      output ``tiles`` and the cotangent ``g_tiles`` [n_tiles, 256, 8]
      (only channels r, g, b and final_T are read).

    Returns d_pack [16, M] float32 in the pack's row layout: rows ROW_A ..
    ROW_B2 hold the gradients of conic a/b/c, xg, yg, opacity and rgb, the
    depth and padding rows are zero, and so are the columns of instances
    no pixel composited. The ranges must be ascending and disjoint, as
    ``ops.binning.tile_ranges`` makes them: kernel B4 zeroes the columns
    between and after them by that order. A CPU pack runs the plain
    version; a CUDA pack launches kernel B4.
    """
    _check(pack, starts, ends)
    n_tiles = starts.shape[0]
    _check_tiles("tiles", tiles, pack, n_tiles)
    _check_tiles("g_tiles", g_tiles, pack, n_tiles)
    if pack.device.type == "cpu":
        return composite_backward_torch(pack, starts, ends, toff, grid_x,
                                        tiles, g_tiles)
    if pack.device.type != "cuda":
        raise ValueError(f"no compositor for device {pack.device}")
    d_pack = torch.empty_like(pack)     # B4 writes every element
    f = _build.kernel("tile_render_bwd", "rain_composite_backward", (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p))
    _build.launch(f, pack.device, pack.data_ptr(), pack.shape[1],
                  starts.data_ptr(), ends.data_ptr(), n_tiles, int(toff),
                  int(grid_x), tiles.data_ptr(), g_tiles.data_ptr(),
                  d_pack.data_ptr())
    composite_backward.launches += 1
    return d_pack


composite_backward.launches = 0


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum [T, P, R] over the pixels in kernel B4's order: partial sum s
    (of SPLIT) adds the pixels of threads s, s + SPLIT, s + 2 SPLIT, ...
    (``thread_pixels``) in turn, from +0.0; then a tree over the partial
    sums, s + SPLIT/2 into s, then s + SPLIT/4, ..., as B4's
    shuffle-down."""
    x = x[:, thread_pixels().to(x.device)]
    x = x.reshape(x.shape[0], P // SPLIT, SPLIT, x.shape[-1])
    acc = torch.zeros_like(x[:, 0])
    for i in range(P // SPLIT):
        acc = acc + x[:, i]
    half = SPLIT // 2
    while half:
        acc = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    return acc[:, 0]


def composite_backward_torch(pack: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor, toff: int, grid_x: int,
                             tiles: torch.Tensor,
                             g_tiles: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel B4 (same contract as
    ``composite_backward``), on any device: vectorised over tiles and
    pixels, looping over the position k in each tile's range, with the
    kernel's arithmetic and reduction order (``_pixel_sum``), so the two
    agree bit for bit. The gradients are written by hand, not taken by
    autograd through the forward: the 0.99 clamp passes the gradient here,
    as in the reference."""
    dev = pack.device
    n_tiles = starts.shape[0]
    m = pack.shape[1]
    d_pack = torch.zeros_like(pack)
    if n_tiles == 0:
        return d_pack
    px, py = _pixel_coords(n_tiles, toff, grid_x, dev)
    start = starts.to(torch.int64)
    g_r, g_g, g_b = g_tiles[..., CH_R], g_tiles[..., CH_G], g_tiles[..., CH_B]
    bg = tiles[..., CH_T] * g_tiles[..., CH_T]
    last = tiles[..., CH_NCONTRIB].to(torch.int64)
    rest = tiles[..., CH_R] * g_r + tiles[..., CH_G] * g_g + \
        tiles[..., CH_B] * g_b
    T = torch.ones_like(bg)
    n_walk = last.max(dim=1).values
    zero = torch.zeros((), device=dev)
    last_col = max(m - 1, 0)
    for k in range(int(n_walk.max())):
        cols = torch.clamp(start + k, max=last_col)
        a, b, c, xg, yg, op, cr, cg, cb = pack[:GRAD_ROWS, cols][:, :, None]
        dx = xg - px
        dy = yg - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(op * G, max=ALPHA_CLAMP)
        active = (k < last) & (power <= 0.0) & (alpha >= ALPHA_MIN)
        cgd = g_r * cr + g_g * cg + g_b * cb
        om = 1.0 - alpha
        w = alpha * T
        rest = torch.where(active, rest - w * cgd, rest)
        dalpha = T * cgd - (rest + bg) / om
        T = torch.where(active, T * om, T)
        gd = dalpha * G
        dpow = gd * op
        ex, ey = dpow * dx, dpow * dy
        contrib = torch.stack([ex, ey, ex * dx, ey * dy, ex * dy, gd,
                               w * g_r, w * g_g, w * g_b], dim=-1)
        contrib = torch.where(active[..., None], contrib, zero)
        # the moments Σ dpow·(dx, dy, dx², dy², dx·dy), then d op and d rgb
        sums = _pixel_sum(contrib)
        mx, my, mxx, myy, mxy = sums[:, :5].unbind(-1)
        a, b, c = a[:, 0], b[:, 0], c[:, 0]
        grads = torch.cat([torch.stack([
            -0.5 * mxx, -mxy, -0.5 * myy,
            -(a * mx + b * my), -(c * my + b * mx)], dim=-1), sums[:, 5:]],
            dim=-1)
        walked = k < n_walk
        d_pack[:GRAD_ROWS, cols[walked]] = grads[walked].T
    return d_pack


class _Composite(torch.autograd.Function):
    """The compositor with kernel B3 forward and kernel B4 backward."""

    @staticmethod
    def forward(ctx, pack, starts, ends, toff, grid_x, on_stage):
        tiles = composite_forward(pack, starts, ends, toff, grid_x)
        ctx.save_for_backward(pack, starts, ends, tiles)
        ctx.toff, ctx.grid_x, ctx.on_stage = toff, grid_x, on_stage
        return tiles

    @staticmethod
    def backward(ctx, g_tiles):
        pack, starts, ends, tiles = ctx.saved_tensors
        g_tiles = g_tiles.contiguous()
        d_pack = composite_backward(pack, starts, ends, ctx.toff,
                                    ctx.grid_x, tiles, g_tiles)
        ctx.on_stage("composite_bwd_B4",
                     ((pack.detach(), starts, ends, ctx.toff, ctx.grid_x,
                       tiles.detach(), g_tiles), d_pack))
        return d_pack, None, None, None, None, None


def composite(pack: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              toff: int, grid_x: int, on_stage: StageHook = no_stage_hook
              ) -> torch.Tensor:
    """``composite_forward`` (kernel B3) as an autograd Function whose
    backward is ``composite_backward`` (kernel B4): only the pack takes a
    gradient, and only through the r, g, b and final_T channels.
    ``on_stage("composite_bwd_B4", (B4's args, d_pack))`` is called in the
    backward."""
    return _Composite.apply(pack, starts, ends, toff, grid_x, on_stage)
