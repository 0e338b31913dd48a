"""The work of a step or a frame: the H100's peaks, the operations and
bytes of each counted kernel and of the whole step, and the least time
the chip could take for them.

The peaks and the compositor's operation counts are frozen from
chip_smoke.py:407-429 and the roofline rule from its ``bound``
(chip_smoke.py:538-543): the least time is the larger of the bytes over
the HBM rate and the f32 operations over the rate outside the tensor
cores. Each input byte is counted read once and each output byte written
once, for what the mathematics needs (the compositors' pairs: the ones
this step's data composites, from the reference's counts).
"""

from __future__ import annotations

# H100 SXM published peaks: HBM bytes/s, and f32 operations/s outside the
# tensor cores (a fused multiply-add counted as two operations).
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# f32 operations per (pixel, instance) pair of the compositor: the power
# (2 sub, 7 mul, 2 add) plus exp, the opacity product and the clamp for
# every evaluated pair; 1 - alpha, T·(1 - alpha), alpha·T, the four
# weighted channel sums (2 each) and the alpha sum for a composited one
OPS_EVAL, OPS_COMP = 14, 12
# the backward compositor: the same 14 to re-evaluate a pair; for a
# composited one c·g (5), 1 - alpha, alpha·T, the running sum (2),
# dL/dalpha (4), T (1), dL/dG and dL/dpower (2), the three moments (3),
# the gradient terms (19), and the nine adds of its share of the pixel
# sums
OPS_BWD_COMP = 47


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds for these bytes and f32 operations."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)
