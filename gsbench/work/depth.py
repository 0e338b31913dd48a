"""Operations and bytes of a depth-regularized training step: what the
inverse-depth channel adds to ``counts``' step.

B4's depth variant (``composite_bwd``) reads, beside the 9 attribute
rows, each instance's inverse depth, and writes a tenth gradient row per
instance; per tile pixel it reads, beside ``counts.composite_bwd``'s
colour, T, count and their cotangents, the composited inverse depth and
its cotangent. Per composited pair it adds ``OPS_DEPTH`` operations: d·g_D
and its add into c·g, w·g_D and its add into the tenth sum. The rest of
the step adds the tenth row's way to the Gaussians (the scatter to rank
order, B2's sum and the gather to Gaussian order, as ``counts``' nine),
the chain -g·(1/z)² per Gaussian, and the depth L1 (the rendered inverse
depth, its target and mask read, its cotangent written, per pixel).
"""

from __future__ import annotations

from gsbench.work import OPS_BWD_COMP, OPS_EVAL
from gsbench.work.counts import F, PIX, Shape, Work
from gsbench.work import counts

OPS_DEPTH = 4              # per composited pair in B4
OPS_DEPTH_L1 = 6           # per pixel: the difference, mask, |.|, sum,
#                            and the cotangent's sign and scale


def composite_bwd(s: Shape) -> Work:
    return Work(F * (2 * 10 * s.instances + 2 * s.tiles +
                     11 * PIX * s.tiles),
                (OPS_EVAL + OPS_BWD_COMP + OPS_DEPTH) * s.composited)


def train_step(s: Shape) -> Work:
    n, m = s.gaussians, s.instances
    base = counts.train_step(s)
    b4 = composite_bwd(s)
    b4_base = counts.composite_bwd(s)
    extra = [Work(b4.nbytes - b4_base.nbytes, b4.ops - b4_base.ops),
             Work(F * (m + 2 * n), m + 3 * n),     # the tenth row, chain
             Work(F * 4 * s.pixels, OPS_DEPTH_L1 * s.pixels)]   # depth L1
    return Work(base.nbytes + sum(w.nbytes for w in extra),
                base.ops + sum(w.ops for w in extra))
