"""Bitonic sorting networks in plain PyTorch.

Port of rain_tpu/ops/sort.py. Each compare-exchange stage at distance j
is a [M/(2j), 2, j] view, a min/max pair and a direction select, with the
ascending/descending pattern of stage (k, j) taken from the block index;
~log²(M)/2 stages in all. rain_tpu keeps the network for A/B runs of its
instance sort (``RAIN_TPU_SORT=bitonic``); the port keeps it for the same
purpose, as ``bin_gaussians(..., sort="bitonic")`` (ops.binning), beside
``torch.sort``. Integer keys only, on any device.
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def _ascending(m: int, k: int, j: int, device) -> torch.Tensor:
    """[M/(2j), 1] bool: block b of stage (k, j) sorts ascending iff bit k
    of its element indices is 0, which within a block of 2j <= k elements
    is bit k // (2j) of b."""
    b = torch.arange(m // (2 * j), device=device)[:, None]
    return (b & (k // (2 * j))) == 0


def _stage(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One compare-exchange stage: partner i ^ j, ascending iff
    (i & k) == 0."""
    m = x.shape[0]
    v = x.view(m // (2 * j), 2, j)
    lo, hi = v[:, 0], v[:, 1]
    mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
    asc = _ascending(m, k, j, x.device)
    return torch.stack([torch.where(asc, mn, mx), torch.where(asc, mx, mn)],
                       dim=1).reshape(m)


def _stage_pairs(key: torch.Tensor, val: torch.Tensor, k: int, j: int):
    """Compare-exchange of (key, value) pairs ordered lexicographically,
    the order of one wide (key << bits | value) key."""
    m = key.shape[0]
    kv, vv = key.view(m // (2 * j), 2, j), val.view(m // (2 * j), 2, j)
    klo, khi, vlo, vhi = kv[:, 0], kv[:, 1], vv[:, 0], vv[:, 1]
    asc = _ascending(m, k, j, key.device)
    hi_less = (khi < klo) | ((khi == klo) & (vhi < vlo))
    lo_less = (klo < khi) | ((klo == khi) & (vlo < vhi))
    swap = torch.where(asc, hi_less, lo_less)
    return (torch.stack([torch.where(swap, khi, klo),
                         torch.where(swap, klo, khi)], dim=1).reshape(m),
            torch.stack([torch.where(swap, vhi, vlo),
                         torch.where(swap, vlo, vhi)], dim=1).reshape(m))


def _network(m: int):
    """The (k, j) stages of a bitonic network over m = 2^p elements."""
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def bitonic_sort(keys: torch.Tensor, pad_value: int = I32_MAX
                 ) -> torch.Tensor:
    """Ascending sort of a 1-D integer tensor. A length that is not a
    power of two is padded with ``pad_value``, which must compare >= every
    real key for the first len(keys) entries to be the sorted input."""
    n = keys.shape[0]
    m = _next_pow2(n)
    x = keys if m == n else torch.cat(
        [keys, keys.new_full((m - n,), pad_value)])
    for k, j in _network(m):
        x = _stage(x, k, j)
    return x[:n]


def bitonic_sort_pairs(keys: torch.Tensor, values: torch.Tensor,
                       pad_value: int = I32_MAX):
    """Ascending sort of (key, value) pairs, lexicographic in (key, value);
    each value follows its key. Padded as ``bitonic_sort``, with value 0."""
    n = keys.shape[0]
    m = _next_pow2(n)
    if m != n:
        keys = torch.cat([keys, keys.new_full((m - n,), pad_value)])
        values = torch.cat([values, values.new_zeros(m - n)])
    for k, j in _network(m):
        keys, values = _stage_pairs(keys, values, k, j)
    return keys[:n], values[:n]
