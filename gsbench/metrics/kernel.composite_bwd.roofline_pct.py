"""B4 (csrc/tile_render_bwd.cu:composite_bwd_kernel) against its
roofline in the training steps: the least time of its counted work
(gsbench.work.counts.composite_bwd, from the reference's composited
pairs of each traced step) over its device time. Moves
train_ms_per_iter."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.roofline_pct(tr, "train", "composite_bwd")
