"""Synthetic inputs of the instance expansion (kernel B1) at its edge cases.

Made with numpy from a seed, with no scene: N Gaussians in depth order,
each with a rect of the 82x53 tile grid of a 1297x840 frame or with no
tile, and a [10, N] table with signed zeros and NaNs among its values, so
that a bitwise comparison sees every copied bit. The rects are 1-2 tiles
wide and high, about as many instances per Gaussian as the 262k garden
proxy makes. tests/test_torch_expand.py holds the plain version to the
contract on them, tests/test_torch_cuda.py and chip_smoke.py hold kernel
B1 to the plain version.
"""

import numpy as np
import torch

GRID_X, GRID_Y = 82, 53
N_TILES = GRID_X * GRID_Y
CASES = (
    "zero_tile_interleaved",   # tile-less Gaussians among visible ones
    "one_rect_spans_chunks",   # one rect of the whole grid: 4346 instances
    "overflow",                # M below the instance count (and odd)
    "ragged_m",                # M one below the capacity: not a multiple of 4
    "no_instances",            # every Gaussian without a tile: total == 0
    "no_gaussians",            # N == 0
    "n_above_2_21",            # N = 2^21 + 3, depth ranks past 2^21
)


def expand_case(name: str, n: int, m: int, seed: int = 0):
    """The inputs of case `name` with N = n Gaussians (but 0 or 2^21 + 3
    where the case says) and capacity M = m (but below the instance count
    for "overflow" and m - 1 for "ragged_m"): ((table, tiles, offs, rect_w,
    rect_base) as CPU tensors, the keyword arguments of expand_instances)."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}")
    rng = np.random.default_rng(seed)
    n = {"no_gaussians": 0, "n_above_2_21": 2**21 + 3}.get(name, n)
    visible = rng.random(n) < 0.7
    if name == "zero_tile_interleaved":
        run = max(1500, n // 8)   # longer than B1's 1024-Gaussian window
        visible[n // 2:n // 2 + run] = False
    elif name == "no_instances":
        visible[:] = False
    elif name == "n_above_2_21":
        visible = rng.random(n) < 1e-3
        visible[-500:] = True
    w = rng.integers(1, 3, n)
    h = rng.integers(1, 3, n)
    x = rng.integers(0, GRID_X - w + 1)
    y = rng.integers(0, GRID_Y - h + 1)
    if name == "one_rect_spans_chunks":
        g = n // 2
        visible[g], w[g], h[g], x[g], y[g] = True, GRID_X, GRID_Y, 0, 0
    tiles = np.where(visible, w * h, 0)
    offs = np.cumsum(tiles, dtype=np.int64)
    total = int(offs[-1]) if n else 0
    if name == "overflow":
        m = (total // 2) | 1
    elif name == "ragged_m":
        m = m - 1
    table = rng.standard_normal((10, n)).astype(np.float32)
    u = rng.random((10, n))
    table[u < 0.02] = -0.0
    table[u > 0.99] = np.nan
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        table, tiles.astype(np.int32), offs, w.astype(np.int32),
        (y * GRID_X + x).astype(np.int32)))
    return args, dict(grid_x=GRID_X, tile_offset=0, n_tiles=N_TILES,
                      max_instances=m)
