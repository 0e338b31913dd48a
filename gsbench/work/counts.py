"""Operations and bytes of one training step or one frame, counted from
the sizes and the reference's counts of the view (``Shape``).

Kernels: B3 (``composite_fwd``), the tile compositor's forward, reads
each instance's attributes once (the conic, the mean, the opacity, the
colour and, for a frame, the depth: 9 or 10 floats) and each tile's range
(2 ints), and writes per tile pixel the colour, T and the count of its
last composited pair (and, for a frame, depth and alpha); B4
(``composite_bwd``) reads the 9 attributes, the ranges, the forward's
colour, T and count and the cotangents of colour and T per tile pixel,
and writes the 9 gradients per instance. Their operations are those of
the pairs composited (``OPS_*``).

The whole step counts every stage the mathematics of a 3DGS step needs,
each input read once and each output written once: preprocess (the 59
floats of a Gaussian's parameters in, its 16 screen quantities out), the
depth order, the expansion into instances with their keys, the tile sort
and the gather of the attributes, the tile ranges, B3, the loss and its
gradient image, B4, the sum of the instance gradients to their
Gaussians, the backward of preprocess, the densification statistics and
Adam (parameters, gradients and both moments in, parameters and moments
out). A frame counts the stages up to B3 and the image it writes.
"""

from __future__ import annotations

from typing import NamedTuple

from gsbench.work import OPS_BWD_COMP, OPS_COMP, OPS_EVAL

F = 4                      # bytes of a float32 or an int32
PIX = 256                  # pixels of a 16x16 tile
SCREEN = 16                # screen floats of a Gaussian (xy, depth,
#                            conic, rgb, opacity, radius, rect, tiles)
OPS_PREPROCESS = 250       # f32 operations of a Gaussian's preprocess
OPS_PREPROCESS_BWD = 500
OPS_LOSS_PIXEL = 2000      # L1 and SSIM with their gradient, per pixel
OPS_ADAM = 12              # per parameter


class Shape(NamedTuple):
    """One view's sizes: Gaussians (capacity), parameters per Gaussian,
    instances composited (the tier caps them), tiles, image pixels and
    the composited pairs."""
    gaussians: int
    params: int
    instances: int
    tiles: int
    pixels: int
    composited: int


class Work(NamedTuple):
    nbytes: float
    ops: float


def composite_fwd(s: Shape, frame: bool) -> Work:
    rows, out = (10, 7) if frame else (9, 5)
    return Work(F * (rows * s.instances + 2 * s.tiles +
                     out * PIX * s.tiles),
                (OPS_EVAL + OPS_COMP) * s.composited)


def composite_bwd(s: Shape) -> Work:
    return Work(F * (2 * 9 * s.instances + 2 * s.tiles + 9 * PIX * s.tiles),
                (OPS_EVAL + OPS_BWD_COMP) * s.composited)


def _front(s: Shape, rows: int) -> Work:
    """Preprocess, depth order, expansion, tile sort and gather, ranges."""
    n, m = s.gaussians, s.instances
    nbytes = (F * (s.params + SCREEN) * n          # preprocess
              + 12 * n                             # depth keys in, order out
              + (F * rows + 20) * n + (F * rows + 8) * m   # expansion
              + 16 * m + (F * rows + 8 + F * rows) * m     # sort, gather
              + 16 * n + 8 * s.tiles)              # ranges
    return Work(nbytes, OPS_PREPROCESS * n)


def train_step(s: Shape) -> Work:
    n, m = s.gaussians, s.instances
    parts = [_front(s, 9), composite_fwd(s, frame=False),
             Work(3 * 3 * F * s.pixels, OPS_LOSS_PIXEL * s.pixels),
             composite_bwd(s),
             Work(F * (9 * m + 3 * n + 9 * n), 9 * m),          # to Gaussians
             Work(F * (9 + 2 * s.params + 2) * n,
                  OPS_PREPROCESS_BWD * n),                      # backward
             Work(F * 9 * n, 10 * n),                           # statistics
             Work(7 * F * s.params * n, OPS_ADAM * s.params * n)]
    return Work(sum(p.nbytes for p in parts), sum(p.ops for p in parts))


def frame(s: Shape) -> Work:
    parts = [_front(s, 10), composite_fwd(s, frame=True),
             Work(F * 7 * (PIX * s.tiles + s.pixels), 0)]       # assemble
    return Work(sum(p.nbytes for p in parts), sum(p.ops for p in parts))
