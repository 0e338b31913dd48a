"""Mean squared distance to the 3 nearest neighbours (scale initialisation).

Port of rain_tpu/ops/knn.py, the counterpart of the simple-knn CUDA
extension (submodules/simple-knn/simple_knn.cu:174-210) that the reference
calls once at model init (scene/gaussian_model.py:124) to size each
Gaussian by its local point density. rain_tpu computes it in plain XLA
(matmuls, top-k and sorts, no Pallas), so this port is plain PyTorch too:

- ``mean_dist3_matmul``: the EXACT all-pairs search. Candidates are picked
  per row from the matmul form |a|² + |b|² − 2a·b (one f32 ``matmul``,
  TF32 off as the package sets it), then the four candidates are
  re-evaluated with the direct difference formula, whose top-3 mean is the
  result, so the values are the direct formula's. The default up to
  ``exact_limit`` points.
- ``mean_dist3``: the approximate O(N·W) windowed search along three
  Morton curves (the 30-bit interleave of simple_knn.cu:34-59), the
  elementwise min of the per-curve top-3 means: an upper bound.

``mean_dist3_auto`` dispatches between them; ``mean_dist3_exact`` is the
naive O(N²) oracle used by the tests. Sums of three squares and means
are computed as XLA's CPU backend computes rain_tpu's (fused multiply-adds,
a product with the reciprocal of 3), so the values are rain_tpu's bit for
bit where both pick the same neighbours.
"""

from __future__ import annotations

import torch

# the largest [rows, N] f32 tile of the exact search (1 GiB): its row block
# is 2^28 // N rows, at most MAX_ROW_BLOCK
TILE_ELEMENTS = 1 << 28
MAX_ROW_BLOCK = 1024


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (simple_knn.cu:34-41). int64 with
    the uint32 masks: no intermediate exceeds 26 bits."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes over the bounding box (simple_knn.cu:43-59), as
    int64. The f32 quantisation (p − mn) / scale · 1023 truncates toward
    zero, as rain_tpu's cast to uint32 does (the values are ≥ 0)."""
    mn = torch.amin(points, dim=0)
    mx = torch.amax(points, dim=0)
    scale = mx - mn
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = ((points - mn) / scale * float((1 << 10) - 1)).to(torch.int64)
    return (_expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) |
            (_expand_bits(q[:, 2]) << 2))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32, as a fused multiply-add rounds it: the
    f32 product is exact in f64 and the sum is rounded to f64 and then to
    f32 (which differs from one rounding only when the f64 sum falls on an
    f32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ (a − b)² over the last axis of 3 as XLA's CPU backend computes
    rain_tpu's ``jnp.sum((a - b) ** 2, axis=-1)``: fma(dz, dz, fma(dy, dy,
    dx·dx))."""
    d = a - b
    return _fma(d[..., 2], d[..., 2],
                _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))


def _mean3(top3: torch.Tensor) -> torch.Tensor:
    """Mean of an ascending [rows, 3] top 3 as XLA computes jnp.mean: the
    sum in order, times the f32 reciprocal of 3."""
    return ((top3[:, 0] + top3[:, 1]) + top3[:, 2]) * float(
        torch.tensor(1.0 / 3.0, dtype=torch.float32))


def _smallest(d2: torch.Tensor, k: int):
    """The k smallest of each row, ascending, padded with +inf (and index
    -1) where a row has fewer than k entries."""
    kk = min(k, d2.shape[1])
    vals, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((d2.shape[0], pad),
                                              float("inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((d2.shape[0], pad), -1)], dim=1)
    return vals, idx


def _window_mean3(points, order, window):
    n = points.shape[0]
    dev = points.device
    pts = points[order]                                    # [N, 3]
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(n, device=dev)[:, None] + offsets[None, :]
    valid = (idx >= 0) & (idx < n)
    idx = torch.clamp(idx, 0, n - 1)
    d2 = _sq_dist(pts[idx], pts[:, None, :])               # [N, 2W]
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    top3, _ = _smallest(d2, 3)
    top3 = torch.where(torch.isfinite(top3), top3, torch.zeros_like(top3))
    out = torch.zeros((n,), dtype=points.dtype, device=dev)
    out[order] = _mean3(top3)
    return out


def mean_dist3(points: torch.Tensor, window: int = 64) -> torch.Tensor:
    """Mean squared distance to each point's 3 nearest neighbours, from
    windows along THREE Morton curves (the three cyclic axis
    interleavings); each curve's top-3 mean upper-bounds the true value,
    so the elementwise min is a tight upper bound (rain_tpu measured a mean
    relative error of 17-21 % on clustered clouds). Points in one Morton
    cell share a code, so the order of ties is the stable sort's, as in
    rain_tpu.

    Args:
      points: [N, 3] float32.
      window: candidates per side along each Morton curve.

    Returns:
      [N] float32 — the same quantity as the reference's distCUDA2.
    """
    best = None
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        codes = morton_codes(points[:, list(perm)])
        order = torch.argsort(codes, stable=True)
        est = _window_mean3(points, order, window)
        best = est if best is None else torch.minimum(best, est)
    return best


def mean_dist3_matmul(points: torch.Tensor,
                      row_block: int | None = None) -> torch.Tensor:
    """Exact mean 3-NN squared distance, a [row_block, N] tile at a time.

    Phase 1 picks each row's 4 candidates by d²(i,j) = (|p_i|² + |p_j|²) −
    2·p_i·p_j with the cross term as one f32 matmul (cancellation makes
    these values approximate); phase 2 re-evaluates the candidates with the
    direct difference formula (full f32, no cancellation) and keeps the
    top-3 mean. rain_tpu pads the columns to blocks of 65,536 and merges a
    running top 4; here each tile holds the whole row, so the row block is
    chosen for bounded memory: 2^28 // N rows (at most 1024), a 1 GiB f32
    tile, and a peak of about three tiles. O(N²) operations: a one-time
    init cost.
    """
    n = points.shape[0]
    dev = points.device
    if row_block is None:
        row_block = max(1, min(MAX_ROW_BLOCK, TILE_ELEMENTS // max(n, 1)))
    n2 = _sq_dist(points, torch.zeros_like(points))
    out = torch.empty((n,), dtype=points.dtype, device=dev)
    for r0 in range(0, n, row_block):
        p = points[r0:r0 + row_block]
        rb = p.shape[0]
        rows = torch.arange(r0, r0 + rb, device=dev)
        d2 = n2[r0:r0 + rb, None] + n2[None, :]
        # (|a|² + |b|²) − 2g: the doubling is exact, so one add rounds as
        # rain_tpu's subtraction does
        d2.add_(torch.matmul(p, points.T), alpha=-2.0)
        d2[torch.arange(rb, device=dev), rows] = float("inf")
        _, cand = _smallest(d2, 4)
        del d2
        d2x = _sq_dist(points[cand.clamp(min=0)], p[:, None, :])
        bad = (cand == rows[:, None]) | (cand < 0)
        d2x = torch.where(bad, torch.full_like(d2x, float("inf")), d2x)
        top3, _ = _smallest(d2x, 3)
        top3 = torch.where(torch.isfinite(top3), top3,
                           torch.zeros_like(top3))
        out[r0:r0 + rb] = _mean3(top3)
    return out


def mean_dist3_auto(points: torch.Tensor,
                    exact_limit: int = 1_048_576) -> torch.Tensor:
    """Exact search up to ``exact_limit`` points, the Morton-window
    approximation beyond. The 2^20 switch is rain_tpu's, which works around
    a TPU fault of its exact search past ~1.5M points (rain_tpu/ops/
    knn.py:84-86); a CUDA card does not have that fault, so a larger limit
    is open here. It is kept so that both packages initialise the same
    scene identically."""
    if points.shape[0] <= exact_limit:
        return mean_dist3_matmul(points)
    return mean_dist3(points)


def mean_dist3_exact(points: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """O(N²) exact reference (for tests / tiny N): the direct formula for
    every pair."""
    n = points.shape[0]
    dev = points.device
    out = torch.empty((n,), dtype=points.dtype, device=dev)
    for i0 in range(0, n, block):
        p = points[i0:i0 + block]
        d2 = _sq_dist(p[:, None, :], points[None, :, :])
        rows = torch.arange(i0, i0 + p.shape[0], device=dev)
        d2[torch.arange(p.shape[0], device=dev), rows] = float("inf")
        top3, _ = _smallest(d2, 3)
        out[i0:i0 + p.shape[0]] = _mean3(top3)
    return out
