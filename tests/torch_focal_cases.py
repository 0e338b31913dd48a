"""The inputs of the focal-length checks: seeded tan(fov/2) values and a
camera whose focal lengths round apart in the two forms of the division.

Shared by tests/test_torch_focal.py (the port against rain_tpu's jitted
expression on the CPU) and chip_smoke.py (the card against the CPU).
Imports numpy and torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WIDTHS = (1297, 96, 840)     # bench.py's width, a test size, its height
N_TAN = 20_000


def tans(seed: int = 0) -> np.ndarray:
    """N_TAN f32 tan(fov/2) for fov drawn uniformly from [0.3, 1.6]."""
    fov = np.random.default_rng(seed).uniform(0.3, 1.6, N_TAN)
    return np.tan(fov.astype(np.float32) * np.float32(0.5)).astype(
        np.float32)


def reciprocal_form(tan: torch.Tensor, size: int) -> torch.Tensor:
    """The size times the reciprocal of 2·tan: two roundings, what the
    port computed before it divided (and what torch makes of
    ``size / (2.0 * tan)`` with a Python number as the size)."""
    return torch.reciprocal(2.0 * tan) * size


def parting_fovs(width: int, height: int) -> tuple[float, float]:
    """The first (fovx, fovy) on a grid of 0.001 from 0.5 at which both
    focal lengths of a width x height camera round apart in the two forms
    (one division against ``reciprocal_form``)."""
    def parts(fov, size):
        t = torch.tensor(np.float32(math.tan(fov * 0.5)))
        true = torch.tensor(float(size), dtype=torch.float32) / (2.0 * t)
        return not torch.equal(true, reciprocal_form(t, size))

    grid = [0.5 + 0.001 * i for i in range(1000)]
    fovx = next(f for f in grid if parts(f, width))
    fovy = next(f for f in grid if parts(f, height))
    return fovx, fovy
