"""B3 (csrc/tile_render_fwd.cu:composite_fwd_kernel) against its
roofline in the frames, which also write depth and alpha
(gsbench.work.counts.composite_fwd). Moves render_fps."""

from gsbench import readers

UNIT = "%"


def read(tr):
    return readers.roofline_pct(tr, "render", "composite_fwd")
