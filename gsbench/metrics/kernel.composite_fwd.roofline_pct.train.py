"""B3 (csrc/tile_render_fwd.cu:composite_fwd_kernel) against its
roofline in the training steps (gsbench.work.counts.composite_fwd).
Moves train_ms_per_iter."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.roofline_pct(tr, "train", "composite_fwd")
