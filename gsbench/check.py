"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs.

A gap of norms is taken leaf by leaf, as the gap between the program's
norm of a leaf and the reference's (not the norm of their difference),
over the reference's norm of that leaf or of the median leaf, whichever
is larger, and the worst leaf counts.
"""

from __future__ import annotations

import statistics

import torch

CHUNK_ROWS = 1 << 20


def norm(x: torch.Tensor) -> float:
    """The 2-norm of x, summed in float64 over blocks of rows."""
    total = 0.0
    for i in range(0, x.shape[0], CHUNK_ROWS):
        total += float(torch.sum(x[i:i + CHUNK_ROWS].double() ** 2))
    return total ** 0.5


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a - b‖ in float64 over blocks of rows, without a full temporary."""
    total = 0.0
    for i in range(0, a.shape[0], CHUNK_ROWS):
        d = a[i:i + CHUNK_ROWS].double() - b[i:i + CHUNK_ROWS].double()
        total += float(torch.sum(d * d))
    return total ** 0.5


def norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, median ‖ref‖)."""
    if not ref:
        return 0.0
    median = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in ref)


def rel_gap(prog: list, ref: list) -> float:
    """The worst |prog - ref| / |ref| over paired values."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def moved_leaves(first_grad: dict, floor: float = 1e-3) -> list:
    """The leaves whose reference first gradient is at least ``floor``
    of the median leaf's: the others move under Adam by round-off alone
    and are left out of the change."""
    median = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= floor * median]


def train_numbers(prog_rec: dict, ref_rec: dict) -> dict:
    """The numbers of a training cell: ``prog_rec`` (the program's record
    of its first steps, or a reference's in its place) against the
    reference's ``ref_rec``. A record holds per step the loss and the
    instance count, per leaf the first gradient's norm and the change's,
    and the statistics' norms."""
    moved = moved_leaves(ref_rec["first_grad"])
    return {"loss": rel_gap(prog_rec["loss"], ref_rec["loss"]),
            "grad": norm_gap(prog_rec["first_grad"], ref_rec["first_grad"]),
            "change": norm_gap(prog_rec["change"],
                               {k: ref_rec["change"][k] for k in moved}),
            "stats": norm_gap(prog_rec["stats"], ref_rec["stats"]),
            "instances": rel_gap(prog_rec["instances"],
                                 ref_rec["instances"])}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, shown
