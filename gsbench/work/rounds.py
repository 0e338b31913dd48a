"""Bytes of one densification round at a key's capacity.

A round (model/densify.py:densify_round, one captured graph per key)
reads every capacity row of the parameters (59 floats a Gaussian at SH
degree 3), both Adam moments, the three statistics and the split noise
(n_split·3 floats), and writes the compacted parameters and moments and
the zeroed statistics: each read once and each written once, as the
mathematics of the round needs. The compaction's order takes one running
count of the kept rows: an int32 written and read per row. Its
operations (the selection's compares, the children's 15 f32 operations a
row) are far below the bytes' time and are not counted.
"""

from __future__ import annotations

from gsbench.work import bound_s
from gsbench.work.counts import F

PARAMS = 59                 # floats of a Gaussian's parameters at SH 3
STATS = 3                   # max radius, gradient sum, count


def round_bytes(capacity: int, n_split: int = 2,
                params: int = PARAMS) -> float:
    read = params + 2 * params + STATS + 3 * n_split
    written = params + 2 * params + STATS
    scan = 2
    return float(F * (read + written + scan) * capacity)


def round_bound_s(capacity: int, n_split: int = 2) -> float:
    """The least seconds of a round's bytes at the H100's HBM rate."""
    return bound_s(round_bytes(capacity, n_split), 0.0)
