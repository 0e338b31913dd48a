"""Synthetic inputs of the instance reduction (kernel B2) at its edge cases.

Made with numpy from a seed, with no scene: N Gaussians in depth order,
each owning a segment of tiles[g] consecutive instances from exc[g] (the
exclusive prefix sum), and [9, M] gradient columns with signed zeros among
their values. Segments are 1 to ~2x the mean long, sized so that the
instances fill about 3/4 of M, with a few empty ones among them (20-60
long in "crossing_chunks", with an empty tail where the budget ends).
tests/test_torch_reduce.py holds the plain version and a Python copy of
B2's block schedule to a loop over segments on them; tests/test_torch_cuda.py
and chip_smoke.py hold kernel B2 to the plain version.
"""

import numpy as np
import torch

ROWS = 9
WHOLE_GRID = 82 * 53    # the tiles of a 1297x840 frame
CASES = (
    "long_segment",        # one segment of over three 1024-instance chunks
    "whole_grid",          # one Gaussian on every tile of the grid, first
    "crossing_chunks",     # segments of 20-60 across every chunk boundary
    "culled_tail",         # the last 2/3 of the Gaussians own no instance
    "empty_run",           # a run of empty segments in the middle
    "clipped_at_m",        # M below the instance count (and odd)
    "ragged_m",            # M one below the capacity: not a multiple of 4
    "no_instances",        # every segment empty: total == 0
    "no_gaussians",        # N == 0
)


def reduce_case(name: str, n: int, m: int, seed: int = 0):
    """The inputs of case `name` with N = n Gaussians (0 for
    "no_gaussians") and capacity M = m (below the instance count for
    "clipped_at_m", m - 1 for "ragged_m"): (d [9, M] float32, exc [N]
    int64, tiles [N] int32) as CPU tensors."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}")
    rng = np.random.default_rng(seed)
    n = 0 if name == "no_gaussians" else n
    live = np.ones(n, bool)
    if name == "culled_tail":
        live[n // 3:] = False
    elif name == "empty_run":
        run = max(1500, n // 8)   # more than a chunk or a tail block
        live[n // 2:n // 2 + run] = False
    elif name == "no_instances":
        live[:] = False
    live &= rng.random(n) >= 0.1
    special = {"long_segment": 3 * 1024 + 5,
               "whole_grid": WHOLE_GRID}.get(name, 0)
    budget = max(3 * m // 4 - special, int(live.sum()))
    mean = budget / max(int(live.sum()), 1)
    if name == "crossing_chunks":   # 20-60 each while the budget lasts
        tiles = np.where(live, rng.integers(20, 61, n), 0)
        tiles[np.cumsum(tiles) > budget] = 0
    else:
        tiles = np.where(live, rng.integers(1, max(2, int(2 * mean)) + 1, n),
                         0)
    if tiles.sum() > budget:
        tiles = np.where(live, np.maximum(
            1, tiles * budget // max(int(tiles.sum()), 1)), 0)
    if special and n:
        tiles[0 if name == "whole_grid" else n // 2] = special
    exc = np.cumsum(tiles) - tiles
    total = int(tiles.sum())
    if name == "clipped_at_m":
        m = (total // 2) | 1
    elif name == "ragged_m":
        m = m - 1
    d = rng.standard_normal((ROWS, m)).astype(np.float32)
    u = rng.random((ROWS, m))
    d[u < 0.02] = -0.0
    d[u > 0.98] = 0.0
    return (torch.from_numpy(d), torch.from_numpy(exc.astype(np.int64)),
            torch.from_numpy(tiles.astype(np.int32)))


def contract(d: np.ndarray, exc: np.ndarray, tiles: np.ndarray) -> np.ndarray:
    """The reduction as its contract states it, a loop over segments:
    column g sums d's columns [exc[g], min(exc[g] + tiles[g], M)) left to
    right from +0.0, in float32."""
    rows, m = d.shape
    out = np.zeros((rows, exc.shape[0]), np.float32)
    for g in range(exc.shape[0]):
        b, e = int(exc[g]), min(int(exc[g]) + int(tiles[g]), m)
        if e > b:
            # np.cumsum adds in order in float32; the leading zero makes
            # the first add 0.0 + d, as the contract's (-0.0 becomes +0.0)
            seq = np.concatenate([np.zeros((rows, 1), np.float32),
                                  d[:, b:e]], axis=1)
            out[:, g] = np.cumsum(seq, axis=1, dtype=np.float32)[:, -1]
    return out
